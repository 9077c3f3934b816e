"""Fixtures of the benchmark's CPU tests: the import paths, and a tiny cell
of each configuration in ``BENCHMARK.json`` (its first cell, cut to its
family's ``TINY`` sizes, float32 compute) that the program runs on the CPU
through its plain kernels."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
#: each configuration's first cell
CELLS = {c["name"]: next(w["name"] for w in SPEC["workloads"] if w["config"] == c["name"])
         for c in SPEC["configs"]}
CONFIGS = list(CELLS)
#: limits of the tiny float32 cells: their program reads a hundredth of these
#: numbers or less, the fp8 control more
TINY_LIMITS = {"loss_gap": 1e-5, "pg_gap": 5e-4, "change_gap": 1e-3, "pg_dist": 1e-3}


def tiny(cell):
    """``cell`` cut to its family's ``TINY`` sizes, with float32 compute."""
    from reference import layout

    cut = layout.family(cell.config).TINY
    return dataclasses.replace(
        cell, config=dict(cell.config, compute_dtype="float32", **cut["config"]),
        traffic=dict(cell.traffic, **cut["traffic"]),
        workload=dict(cell.workload, **cut["workload"], limits=dict(TINY_LIMITS)))


def as_field(template, value):
    """A configuration file's value in the form of the program's field
    ``template``: lists as tuples where the field holds a tuple."""
    def tuples(v):
        return tuple(map(tuples, v)) if isinstance(v, list) else v
    return tuples(value) if isinstance(template, tuple) else value


@pytest.fixture
def tiny_cell(monkeypatch):
    """``make(config)``: that configuration's tiny cell, with the program's
    registry patched to the same numbers: every field of the program's config
    class that ``harness.program.stated`` holds to the file takes the cut
    file's value."""
    import repro_torch.configs as configs
    from harness import spec
    from harness.program import stated

    def make(config: str):
        cell = tiny(spec.load_cell(CELLS[config]))
        cfg = cell.config
        port = configs.get_config(cfg["arch"])
        port = dataclasses.replace(port, **{k: as_field(getattr(port, k), cfg[k])
                                            for k in stated(cfg, port) if k in cfg})
        monkeypatch.setattr(configs, "get_config", lambda name: port)
        return cell

    return make
