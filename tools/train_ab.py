#!/usr/bin/env python3
"""Time the PyTorch port's photon-75m training rounds from several checkouts,
in turns, on one NVIDIA GPU.

    python3 tools/train_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example the parent commit
unpacked with ``git archive`` next to the working tree). Every ROOT runs in a
process of its own, in the order given, so list them as parent, change,
change, parent to see the spread. Each builds its kernels, then prints one
JSON line with the wall seconds of

  sync   every round of ``repro_torch.launch.train --arch photon-75m
         --fused-server --rounds 4`` (``chip_smoke.py``'s train phase,
         float32 uplink): the launcher's ``seconds``, validation excluded
  async  every update of the same run with ``--aggregation async
         --straggler-profile heavy --dropout-rate 0.1`` (``chip_smoke.py``'s
         train_async phase), where the checkout has the async path (else
         null): the launcher's ``seconds``, which run from the previous
         update's row and so hold its validation

The first round or update of each carries the warm-up. The card's name and
power limit are printed first. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROUNDS = 4
SYNC = ["--arch", "photon-75m", "--fused-server", "--rounds", str(ROUNDS), "--device", "cuda"]
ASYNC = SYNC + ["--aggregation", "async", "--straggler-profile", "heavy",
                "--dropout-rate", "0.1"]


def run_one(root: str) -> dict:
    """The round and update seconds of one checkout (this process imports it)."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch
    from repro_torch.kernels import build as KB
    from repro_torch.launch import train as T

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs it
    torch.backends.cudnn.allow_tf32 = False
    KB.build_all()
    out = {"root": root}
    for name, argv in (("sync", SYNC), ("async", ASYNC)):
        try:
            hist = T.run(T.parse_args(argv))["history"]
        except SystemExit as e:  # a checkout without the async path refuses it
            out[name], out[f"{name}_refused"] = None, str(e)
            continue
        out[name] = [row["seconds"] for row in hist]
        out[f"{name}_loss"] = [row["train_loss"] for row in hist]
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the child process: one root
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    if args.one is not None:
        print(json.dumps(run_one(args.one)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              timeout=900)
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
