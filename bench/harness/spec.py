"""Finds a cell's files by the names in ``BENCHMARK.json``.

- a configuration: the file its ``configs`` entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<traffic>.json``;
- a cell's own settings (what fits on the chip, how many rounds the reference
  follows, the limits of the comparison): ``workloads/<cell>.json``;
- a per-layer metric's reader: ``metrics/<metric>.py``.

A later change adds a configuration, a mix, a cell or a metric by adding
files and entries; nothing here names one.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports in a run with or without ``--trace``."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, bench_json: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``bench_json``, its files read from that file's
    checkout."""
    root = Path(bench_json).resolve().parent
    bench = root / BENCH.name
    spec = load_json(bench_json)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in {bench_json.name}; "
                         f"known: {[w['name'] for w in spec['workloads']]}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        workload=load_json(bench / "workloads" / f"{name}.json"),
        end_to_end=spec["end_to_end"],
        per_layer=spec["per_layer"],
    )


def environment(cell: Cell) -> None:
    """The run's environment, set before torch starts: kernel and compile
    caches at fixed directories under ``build/`` in the checkout, and the
    cell's CUDA allocator settings (``allocator`` in its workload file)."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    if cell.workload.get("allocator"):
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = cell.workload["allocator"]


def metric_reader(name: str):
    """The ``read(trace) -> float | None`` of ``metrics/<name>.py``."""
    import importlib.util

    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
