#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine it is started on.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json`` and its files under ``bench/``, builds
the program (``src/repro_torch``) from the seed's weights, times whole
federated rounds for ``--seconds``, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics; with
``--trace 1`` the per-layer ones and a ``breakdown``), ``device`` and, last,
``checks``: each compared number with its limit, which also end standard
error. Exits non-zero, printing no result, without as many CUDA cards as
the cell asks for. Kernel and compile caches stay under ``build/`` in the
checkout (``harness/spec.environment``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from harness.spec import environment, load_cell

    cell = load_cell(args.workload)
    environment(cell)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _log(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees {n}. "
             "The benchmark measures the card only and never falls back to the CPU.")
        return 2
    from harness import runner

    _log(f"card: {_power_limit()}")
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                        T_START, log=_log)
    for name, c in result["checks"].items():
        _log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
