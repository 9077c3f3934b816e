"""Both CLIs with the robust flags, on the CPU at reduced photon-75m.

- The async Byzantine ``--rollback`` run (NaN attackers, heavy stragglers,
  float32 and int8 uplinks) rolls back at the same updates in both packages
  from a shared checkpoint, with the same ``manifest["robust"]`` (the
  guard-window norms to rel 2e-2: the default compute is bf16).
- Robust checkpoints cross over both ways; kill and resume is bitwise, sync
  and async (every CSV field but the wall clock and ``val_ppl``).
- Every composition refusal has the reference's wording, letter for letter.
"""
import csv
import json
import math
import shutil

import numpy as np
import pytest

from torch_parity import assert_close

torch = pytest.importorskip("torch")

from repro.launch import train as jt  # noqa: E402
from repro_torch.launch import train as tt  # noqa: E402
from repro_torch.tree import params_to_numpy  # noqa: E402

BYZ = ["--aggregation", "async", "--fused-server", "--straggler-profile", "heavy",
       "--dropout-rate", "0.1", "--clients", "4", "--population", "8", "--local-steps", "2",
       "--seq-len", "64", "--byzantine-fraction", "0.25", "--byzantine-kind", "nan",
       "--rollback", "--rollback-window", "2", "--reduced"]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _robust_manifest(ck, rnd):
    with open(ck / f"round_{rnd:06d}" / "manifest.json") as f:
        return json.load(f)["extra"]["aggregator"]["robust"]


def _assert_robust_manifests_agree(t, j):
    for k in ("quarantine", "last_good", "counters"):
        assert t[k] == j[k], k
    assert t["norm_history"] == j["norm_history"] == []
    assert_close(t["guard_window"], j["guard_window"], rtol=2e-2, what="guard_window")


@pytest.mark.parametrize("uplink", ["float32", "int8"])
def test_cli_byzantine_rollback_is_the_references(tmp_path, uplink):
    """The reference CLI's first update is the shared starting point; both
    CLIs resume it for updates 1–5 and roll back at update 3 only."""
    args = BYZ + ["--uplink", uplink]
    ck = tmp_path / "ck"
    jt.run(jt.parse_args(args + ["--rounds", "1", "--ckpt-dir", str(ck)]))
    shutil.copytree(ck, tmp_path / "ck_t")
    jout = jt.run(jt.parse_args(args + ["--rounds", "6", "--ckpt-dir", str(ck), "--resume"]))
    tout = tt.run(tt.parse_args(args + ["--rounds", "6", "--ckpt-dir", str(tmp_path / "ck_t"),
                                        "--resume", "--device", "cpu"]))
    jr = [r["rolled_back"] for r in jout["history"]]
    assert [r["rolled_back"] for r in tout["history"]] == jr == [0.0, 0.0, 1.0, 0.0, 0.0]
    for t, j in zip(tout["history"], jout["history"]):
        assert math.isnan(t["pseudo_grad_norm"]) == math.isnan(j["pseudo_grad_norm"])
    _assert_robust_manifests_agree(_robust_manifest(tmp_path / "ck_t", 5),
                                   _robust_manifest(ck, 5))
    assert all(np.isfinite(x).all() for x in params_to_numpy(tout["state"]["params"]).values())


def test_cli_async_robust_kill_and_resume_is_bitwise(tmp_path):
    args = BYZ + ["--uplink", "int8", "--device", "cpu", "--rounds", "5"]
    ck = tmp_path / "ck"
    tt.run(tt.parse_args(args + ["--ckpt-dir", str(ck), "--log", str(tmp_path / "a.csv")]))
    want_robust = _robust_manifest(ck, 4)
    shutil.rmtree(ck / "round_000004")
    shutil.rmtree(ck / "round_000003")  # killed after update 2's checkpoint
    tt.run(tt.parse_args(args + ["--ckpt-dir", str(ck), "--resume",
                                 "--log", str(tmp_path / "b.csv")]))
    want, got = _rows(tmp_path / "a.csv")[3:], _rows(tmp_path / "b.csv")
    assert [r["rolled_back"] for r in got] == ["1.0", "0.0"]
    for w, g in zip(want, got):
        for k in w:
            if k not in ("seconds", "val_ppl"):
                assert g[k] == w[k], k
    assert _robust_manifest(ck, 4) == want_robust
    i = args.index("--rollback-window")
    with pytest.raises(SystemExit, match="rollback-window"):
        tt.run(tt.parse_args(args[:i] + ["--rollback-window", "3"] + args[i + 2:]
                             + ["--ckpt-dir", str(ck), "--resume"]))


SYNC = ["--reduced", "--local-steps", "2", "--clients", "3", "--population", "6",
        "--seq-len", "64", "--robust-agg", "median", "--screen", "--rollback",
        "--rollback-window", "2"]


def test_cli_sync_robust_kill_and_resume_is_bitwise(tmp_path):
    args = SYNC + ["--device", "cpu", "--rounds", "3"]
    ck = tmp_path / "ck"
    tt.run(tt.parse_args(args + ["--ckpt-dir", str(ck), "--log", str(tmp_path / "a.csv")]))
    want_robust = _robust_manifest(ck, 2)
    shutil.rmtree(ck / "round_000002")
    tt.run(tt.parse_args(args + ["--ckpt-dir", str(ck), "--resume",
                                 "--log", str(tmp_path / "b.csv")]))
    (want,), (got,) = _rows(tmp_path / "a.csv")[2:], _rows(tmp_path / "b.csv")
    for k in want:
        if k not in ("seconds", "val_ppl"):
            assert got[k] == want[k], k
    assert got["rolled_back"] == "0.0"
    assert _robust_manifest(ck, 2) == want_robust


def test_robust_checkpoints_cross_over_between_the_packages(tmp_path):
    """Sync: the reference's round-0 checkpoint with its robust manifest
    resumes in both CLIs; the port's round-1 checkpoint resumes in the
    reference's CLI."""
    ck = tmp_path / "ck"
    jt.run(jt.parse_args(SYNC + ["--rounds", "1", "--ckpt-dir", str(ck)]))
    shutil.copytree(ck, tmp_path / "ck_t")
    jt.run(jt.parse_args(SYNC + ["--rounds", "2", "--ckpt-dir", str(ck), "--resume"]))
    tout = tt.run(tt.parse_args(SYNC + ["--rounds", "2", "--ckpt-dir", str(tmp_path / "ck_t"),
                                        "--resume", "--device", "cpu"]))
    assert [r["round"] for r in tout["history"]] == [1]
    _assert_robust_manifests_agree(_robust_manifest(tmp_path / "ck_t", 1),
                                   _robust_manifest(ck, 1))
    assert _robust_manifest(tmp_path / "ck_t", 1)["last_good"] == 1
    jout = jt.run(jt.parse_args(SYNC + ["--rounds", "3", "--ckpt-dir", str(tmp_path / "ck_t"),
                                        "--resume"]))
    assert [r["round"] for r in jout["history"]] == [2]
    assert _robust_manifest(tmp_path / "ck_t", 2)["last_good"] == 2
    # the async direction: the port's update-1 checkpoint resumes in the reference
    args = BYZ + ["--uplink", "int8"]
    tt.run(tt.parse_args(args + ["--rounds", "2", "--ckpt-dir", str(tmp_path / "a"),
                                 "--device", "cpu"]))
    jout = jt.run(jt.parse_args(args + ["--rounds", "4", "--ckpt-dir", str(tmp_path / "a"),
                                        "--resume"]))
    assert [r["rolled_back"] for r in jout["history"]] == [0.0, 1.0]


SMALL = ["--reduced", "--rounds", "1", "--local-steps", "2", "--clients", "2",
         "--population", "4", "--seq-len", "64"]
ASYNC_FUSED = ["--aggregation", "async", "--fused-server"]


@pytest.mark.parametrize("extra", [
    ASYNC_FUSED + ["--robust-agg", "trimmed"],
    ASYNC_FUSED + ["--screen"],
    ASYNC_FUSED + ["--rollback"],
    ASYNC_FUSED + ["--cohort-tile", "2"],
    ASYNC_FUSED + ["--keep-opt"],
    ["--byzantine-fraction", "0.5"],
    ["--fused-server", "--robust-agg", "median", "--screen"],
    ["--cohort-tile", "2", "--screen", "--robust-agg", "median"],
    ["--cohort-tile", "2", "--robust-agg", "normclip"],
    ["--trim-fraction", "0.5", "--robust-agg", "trimmed"],
    ["--rollback-factor", "1.0", "--rollback"],
], ids=lambda x: "_".join(a.strip("-") for a in x))
def test_cli_refusals_have_the_references_wording(extra):
    msgs = []
    for mod, dev in ((jt, []), (tt, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            mod.run(mod.parse_args(SMALL + extra + dev))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and len(msgs[0]) > 20, msgs


@pytest.mark.parametrize("extra,match", [
    (["--cohort-tile", "2", "--fused-server"], "tiled partial-sum layout"),
    (["--cohort-tile", "2", "--keep-opt"], "drop --keep-opt or --cohort-tile"),
], ids=["fused", "keep-opt"])
def test_cli_tile_refusals_come_from_the_aggregator_as_in_the_reference(extra, match):
    msgs = []
    for mod, dev in ((jt, []), (tt, ["--device", "cpu"])):
        with pytest.raises(ValueError, match=match) as e:
            mod.run(mod.parse_args(SMALL + extra + dev))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
