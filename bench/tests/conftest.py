"""Fixtures of the benchmark's CPU tests: the import paths, and a tiny cell
(each configuration at a few layers and narrow widths, float32 compute) that
the program runs on the CPU through its plain kernels."""
import dataclasses
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = {"photon": "photon-1.3b.train_s2048", "mamba2": "mamba2-1.3b.train_int8"}
TINY = {
    "photon": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512),
    "mamba2": dict(n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16, vocab_size=512),
}
#: limits of the tiny float32 cells: their program reads a hundredth of these
#: numbers or less, the fp8 control more
TINY_LIMITS = {"loss_gap": 1e-5, "pg_gap": 5e-4, "change_gap": 1e-3, "pg_dist": 1e-3}


@pytest.fixture
def tiny_cell(monkeypatch):
    """``make(family)``: that family's cell cut to a CPU size, with the
    program's registry patched to the same numbers."""
    import repro_torch.configs as configs
    from harness import spec

    def make(family: str):
        cell = spec.load_cell(CELLS[family])
        cfg = dict(cell.config, compute_dtype="float32", **TINY[family])
        traffic = dict(cell.traffic, seq_len=64 if family == "photon" else 256,
                       batch=2 if family == "photon" else 1)
        workload = dict(cell.workload, grad_accum=2 if family == "photon" else 1,
                        limits=dict(TINY_LIMITS))
        port = dataclasses.replace(
            configs.get_config(cfg["arch"]),
            **{k: cfg[k] for k in TINY[family]}, compute_dtype="float32",
            **({"ssm_chunk": 64} if family == "mamba2" else {}))
        monkeypatch.setattr(configs, "get_config", lambda name: port)
        return dataclasses.replace(cell, config=cfg, traffic=traffic, workload=workload)

    return make
