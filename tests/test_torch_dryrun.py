"""The port's dry run against the reference's, on the CPU.

- Plans: every assigned arch × supported shape × both production meshes ×
  {federated, centralized, int8 + ``fused_server``, a ``cohort_tile`` as wide
  as the client axis with the top-k uplink} built by the port's
  ``build_step`` equals the reference's ``build_step`` on
  ``jax.sharding.AbstractMesh`` at 16 GiB a device, exactly: every
  argument's shape, dtype and spec (specs as tuples, a one-name tuple entry
  read as the name), ``name``, ``meta``, ``model_flops``, and the per-device
  argument bytes against the reference's ``shard_shape`` sums.
- The CLI (``launch/dryrun.main``) in production mode, and in host mode on
  the CPU with the config lookup patched to ``.reduced()``: exit codes, the
  ``FAIL`` refusal of a step that does not fit, the report JSON's keys, and
  ``roofline/report.py``'s tables rendered from those reports.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import INPUT_SHAPES  # noqa: E402
from repro.configs import get_config as j_cfg  # noqa: E402
from repro.launch.steps import build_step as j_build_step  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.configs import get_config as t_cfg  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.steps import _spec_leaves, arg_bytes_per_device  # noqa: E402
from repro_torch.launch.steps import build_step as t_build_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

GiB16 = 16 * 1024 ** 3


def norm_spec(spec):
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else (None if e == () else e)
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in out)


def _modes(shape_name, client_width):
    if INPUT_SHAPES[shape_name].kind != "train":
        return [{}]
    return [dict(mode="federated"), dict(mode="centralized"),
            dict(uplink="int8", fused_server=True),
            dict(uplink="topk", cohort_tile=client_width)]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_plan_equals_the_references(arch):
    n = 0
    for shape_name in INPUT_SHAPES:
        if not j_cfg(arch).supports_shape(shape_name)[0]:
            assert not t_cfg(arch).supports_shape(shape_name)[0]
            continue
        for multi_pod in (False, True):
            jm = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
                  else AbstractMesh((16, 16), ("data", "model")))
            tm = make_production_mesh(multi_pod=multi_pod, hbm_bytes=GiB16)
            for kw in _modes(shape_name, jm.size // 16):
                js = j_build_step(j_cfg(arch), shape_name, jm, **kw)
                ts = t_build_step(t_cfg(arch), shape_name, tm, **kw)
                what = (shape_name, multi_pod, kw)
                assert (ts.name, ts.meta, ts.model_flops) == (js.name, js.meta, js.model_flops), \
                    what
                jl = jax.tree_util.tree_leaves(js.args)
                tl = [x for a in ts.args for x in tree_leaves(a)]
                sl = [x for a in ts.arg_specs for x in _spec_leaves(a)]
                assert len(jl) == len(tl) == len(sl), what
                for j, t, spec in zip(jl, tl, sl):
                    assert tuple(t.shape) == tuple(j.shape), what
                    assert str(t.dtype).split(".")[-1] == str(j.dtype), what
                    assert t.device.type == "meta"
                    assert norm_spec(spec) == norm_spec(j.sharding.spec), (what, spec, j.sharding)
                want = sum(int(np.prod(x.sharding.shard_shape(x.shape))) * x.dtype.itemsize
                           for x in jl)
                assert arg_bytes_per_device(ts) == want, what
                n += 1
    assert n >= 6


def test_the_cli_plans_for_h100s_by_default():
    """Without a 16 GiB override the production plans take the mesh's
    memory: deepseek-coder-33b at train_4k gets 16 clients on 80 GB cards
    where 16 GiB gives 1."""
    cfg = t_cfg("deepseek-coder-33b")
    h100 = t_build_step(cfg, "train_4k", make_production_mesh(hbm_bytes=80e9))
    small = t_build_step(cfg, "train_4k", make_production_mesh(hbm_bytes=GiB16))
    assert (h100.meta["clients"], small.meta["clients"]) == (16, 1)


def _reduced(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda arch: t_cfg(arch).reduced())


def test_production_cli_writes_one_null_term_report_per_plan(tmp_path, capsys):
    from repro.roofline.analysis import RooflineReport as JReport

    dryrun.main(["--arch", "mamba2-1.3b,qwen3-1.7b", "--shape", "train_4k,long_500k",
                 "--multi-pod", "both", "--train-mode", "both", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    tags = sorted(p[:-len(".json")] for p in os.listdir(tmp_path))
    assert tags == sorted([
        "mamba2-1.3b__long_500k__pod1", "mamba2-1.3b__long_500k__pod2",
        "mamba2-1.3b__train_4k__pod1__centralized", "mamba2-1.3b__train_4k__pod1__federated",
        "mamba2-1.3b__train_4k__pod2__centralized", "mamba2-1.3b__train_4k__pod2__federated",
        "qwen3-1.7b__train_4k__pod1__centralized", "qwen3-1.7b__train_4k__pod1__federated",
        "qwen3-1.7b__train_4k__pod2__centralized", "qwen3-1.7b__train_4k__pod2__federated"])
    assert "SKIP  qwen3-1.7b x long_500k" in out
    assert out.count("not compiled: 256 chips") == out.count("not compiled: 512 chips") == 5
    assert "done; failures: 0" in out
    base = set(JReport("x", 1, 0.0, 0.0, 0.0, {}, {}).to_dict())
    for tag in tags:
        with open(tmp_path / f"{tag}.json") as f:
            r = json.load(f)
        assert base <= set(r) and {"meta", "arch", "shape", "multi_pod", "mode", "mesh",
                                   "arg_bytes_per_device", "plan_s"} <= set(r), tag
        for k in ("flops_per_device", "bytes_per_device", "t_compute_s", "t_memory_s",
                  "bottleneck", "peak_memory_per_device", "useful_flops_ratio"):
            assert r[k] is None, (tag, k)
        assert r["model_flops"] > 0 and r["arg_bytes_per_device"] > 0
        assert r["chips"] == (512 if "pod2" in tag else 256)


def test_host_cli_runs_each_step_and_refuses_what_does_not_fit(tmp_path, monkeypatch, capsys):
    """Host mode on the CPU, reduced configs: decode_32k and long_500k run
    and report measured terms; with the device's memory patched below
    decode_32k's argument bytes, that step is a FAIL line, nothing is
    allocated for it, the other still runs, and the CLI exits 1."""
    from repro_torch.launch import mesh as mesh_mod

    _reduced(monkeypatch)
    argv = ["--mesh", "host", "--device", "cpu", "--arch", "mamba2-1.3b",
            "--shape", "decode_32k,long_500k", "--out", str(tmp_path / "ok")]
    dryrun.main(argv)
    out = capsys.readouterr().out
    assert "done; failures: 0" in out and "cost_analysis: flops=" in out
    for tag in ("mamba2-1.3b__decode_32k__host", "mamba2-1.3b__long_500k__host"):
        with open(tmp_path / "ok" / f"{tag}.json") as f:
            r = json.load(f)
        assert r["mesh"] == "host" and r["chips"] == 1 and r["mode"] == "serve"
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert r["t_collective_s"] == 0.0 and r["bottleneck"] in ("compute", "memory")
        assert r["peak_memory_per_device"] is None  # not measured off the card
        assert r["measured"]["kernels_not_counted"] == {} and r["run_s"] > 0

    monkeypatch.setattr(mesh_mod, "card_memory_bytes", lambda device="cuda": 5_000_000)
    argv[-1] = str(tmp_path / "small")
    with pytest.raises(SystemExit) as exc:
        dryrun.main(argv)
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL  mamba2-1.3b__decode_32k__host: its arguments need" in out
    assert "the device holds 5000000; not allocated" in out
    assert os.listdir(tmp_path / "small") == ["mamba2-1.3b__long_500k__host.json"]
    assert "done; failures: 1" in out


def test_host_cli_runs_a_train_step_with_the_fused_server(tmp_path, monkeypatch, capsys):
    """A reduced federated train step through the host CLI (``--device
    cpu``): the fused server phase is active on the one-device mesh."""
    from repro_torch.configs import INPUT_SHAPES as T_SHAPES
    from repro_torch.configs import InputShape

    _reduced(monkeypatch)
    monkeypatch.setitem(T_SHAPES, "train_4k", InputShape("train_4k", 64, 4, "train"))
    dryrun.main(["--mesh", "host", "--device", "cpu", "--arch", "qwen3-1.7b", "--shape",
                 "train_4k", "--tau-lowered", "1", "--fused-server", "--uplink", "int8",
                 "--out", str(tmp_path)])
    with open(tmp_path / "qwen3-1.7b__train_4k__host__federated.json") as f:
        r = json.load(f)
    assert r["meta"]["fused_server"] and r["meta"]["clients"] == 1
    assert r["meta"]["tokens_per_call"] == 4 * 64
    assert r["useful_flops_ratio"] is not None and 0.1 < r["useful_flops_ratio"] < 1.0


def test_report_renders_plans_and_host_runs(tmp_path, monkeypatch, capsys):
    from repro_torch.roofline import report

    _reduced(monkeypatch)
    dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--multi-pod", "both",
                 "--out", str(tmp_path)])
    dryrun.main(["--mesh", "host", "--device", "cpu", "--arch", "mamba2-1.3b", "--shape",
                 "long_500k", "--out", str(tmp_path)])
    capsys.readouterr()
    rows = report.load(str(tmp_path))
    assert len(rows) == 3
    table = report.dryrun_table(rows).splitlines()
    by_mesh = {line.split("|")[3].strip(): line.split("|") for line in table[2:]}
    assert sorted(by_mesh) == ["16x16", "2x16x16", "host"]
    assert by_mesh["16x16"][5].strip() == "-"  # a plan has no measured peak
    assert by_mesh["host"][5].strip() == "-"  # nor a CPU run
    roof = report.roofline_table(rows).splitlines()
    assert len(roof) == 4  # header, rule, the 16x16 plan, the host run
    plan = next(line for line in roof if "16x16" in line)
    assert plan.count("| - ") >= 5 and "e+" in plan  # null terms; model FLOPs known
    host = next(line for line in roof if "| host |" in line)
    assert "**" in host and host.split("|")[5].strip().endswith("s")
    monkeypatch.setattr("sys.argv", ["report", "--dir", str(tmp_path)])
    report.main()
    assert "### Dry-run table" in capsys.readouterr().out
