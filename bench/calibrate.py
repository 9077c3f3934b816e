#!/usr/bin/env python3
"""Readings of the comparison that decides ``correct``, on the card, at the
cell's own size, many seeds in one process (set-up is long):

    python3 bench/calibrate.py --workload <name> --seeds 11,12,13 \\
        [--control-seeds 11,12,13] [--fault-seeds 11,12,13] \\
        [--witness-seeds 21,22,23] [--out FILE]

One JSON line per seed and kind (``program``, ``control``, ``half_batch``,
``bf16_reference``) with each number and where it was worst. The limits in
``workloads/<name>.json`` are set from these readings; ``PERF.md`` keeps them.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--witness-seeds", type=_ints, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]
    from harness.spec import environment, load_cell

    cell = load_cell(args.workload)
    environment(cell)
    import torch

    if not torch.cuda.is_available():
        print("calibration measures the card only; torch sees no CUDA device", file=sys.stderr)
        return 2
    from harness.calibrate import calibrate
    out = open(args.out, "a") if args.out else None
    try:
        for seed, rows in calibrate(cell, args.seeds, set(args.control_seeds),
                                    set(args.fault_seeds), torch.device("cuda"),
                                    args.witness_seeds):
            for kind, nums in rows.items():
                line = json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                                   "at": time.time(), **{k: v for k, (v, _) in nums.items()},
                                   "where": {k: w for k, (_, w) in nums.items()}})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
