"""The two training CLIs share a checkpoint format: ``repro.launch.train``
writes round 0, then each CLI resumes a copy of it to round 1 (the port on the
CPU), and their round-1 CSV rows agree — default bf16 compute, so loosely:
train_loss rel 2e-2, val_ppl rel 5e-2. The port's own checkpoint then loads
into the reference's state template."""
import csv
import shutil

import numpy as np
import pytest

from torch_parity import assert_close

pytest.importorskip("torch")

from repro.checkpoint import load_pytree  # noqa: E402
from repro.launch import train as jt  # noqa: E402
from repro_torch.launch import train as tt  # noqa: E402

COMMON = ["--reduced", "--local-steps", "2", "--clients", "2", "--population", "4",
          "--seq-len", "64", "--fused-server"]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_port_resumes_reference_checkpoint_and_agrees(tmp_path):
    ck = tmp_path / "ck"
    jt.run(jt.parse_args(COMMON + ["--rounds", "1", "--ckpt-dir", str(ck)]))
    shutil.copytree(ck, tmp_path / "ck_j")
    shutil.copytree(ck, tmp_path / "ck_t")

    j_out = jt.run(jt.parse_args(COMMON + [
        "--rounds", "2", "--ckpt-dir", str(tmp_path / "ck_j"), "--resume",
        "--log", str(tmp_path / "j.csv"),
    ]))
    tt.run(tt.parse_args(COMMON + [
        "--rounds", "2", "--ckpt-dir", str(tmp_path / "ck_t"), "--resume",
        "--log", str(tmp_path / "t.csv"), "--device", "cpu",
    ]))

    (jr,), (tr,) = _rows(tmp_path / "j.csv"), _rows(tmp_path / "t.csv")
    assert float(jr["round"]) == float(tr["round"]) == 1.0
    for k in ("selected", "contributors", "effective_k", "uplink_bytes_per_client"):
        assert jr[k] == tr[k], k
    assert_close(float(tr["train_loss"]), float(jr["train_loss"]), rtol=2e-2, what="train_loss")
    assert_close(float(tr["val_ppl"]), float(jr["val_ppl"]), rtol=5e-2, what="val_ppl")

    # and back: the port's round-1 checkpoint has the reference's keys and shapes
    t_npz = tmp_path / "ck_t" / "round_000001" / "server.npz"
    j_npz = tmp_path / "ck_j" / "round_000001" / "server.npz"
    with np.load(t_npz) as t, np.load(j_npz) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    load_pytree(str(t_npz), j_out["state"])
