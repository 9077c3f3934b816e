#!/usr/bin/env python3
"""The readings pinned for each configuration of ``BENCHMARK.json``, one file
each, ``tests/readings/<config>.json``, and their writer:

    python3 bench/tests/readings.py --config <name>

A file holds what the yardstick reads for the configuration's first cell (its
leaf table, parameter counts, flat buffer length, tokens and model FLOPs of a
round, the server phase's and the int8 codec's bytes) and what the plain
reference reads over the probe rounds of its tiny cell on one thread (each
round's loss and gradient norm, each leaf's norm of the first pseudo-gradient
and of the change). ``test_bench_families.py`` holds the yardstick to the file
of every configuration; a change that adds a configuration adds its file.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

from conftest import CELLS, tiny
from harness import runner, spec
from harness.traffic import Traffic
from reference import bytes as ybytes, flops, layout

DIR = Path(__file__).resolve().parent / "readings"
#: the seed of the tiny cell's weights and tokens
SEED = 2**31 + 29
#: what the reference's rounds give that is pinned
REFERENCE_KEYS = ("loss", "client_grad_norm", "pg_norms", "change_norms")


def path(config: str) -> Path:
    return DIR / f"{config}.json"


def load(config: str) -> dict:
    """The pinned readings of ``config``; a missing file says how to write it."""
    p = path(config)
    if not p.is_file():
        raise FileNotFoundError(
            f"no pinned readings for {config}: {p} is missing; write it with "
            f"`python3 bench/tests/readings.py --config {config}`")
    return json.loads(p.read_text())


def yardstick(config: str) -> dict:
    """The yardstick's numbers for the configuration's first cell."""
    cell = spec.load_cell(CELLS[config])
    cfg, traffic = cell.config, cell.traffic
    np_ = ybytes.model_flat_len(cfg)
    tokens = Traffic(traffic, cfg["vocab_size"], 0, "cpu").tokens_per_round()
    k = traffic["clients_per_round"]
    return {
        "leaves": [[leaf.name, list(leaf.shape), leaf.init, leaf.scale]
                   for leaf in layout.leaves(cfg)],
        "n_params": layout.n_params(cfg),
        "n_params_padded": layout.n_params(cfg, padded=True),
        "model_flat_len": np_,
        "round_tokens": tokens,
        "train_flops": flops.train_flops(cfg, tokens, traffic["seq_len"]),
        "server_apply_bytes": ybytes.server_apply_bytes(np_, k, traffic["outer"]["name"]),
        "int8_codec_bytes": ybytes.int8_codec_bytes(np_, k),
    }


def reference(config: str, seed: int = SEED) -> dict:
    """The plain reference over the tiny cell's probe rounds, on one thread
    (a multi-threaded reduction may round otherwise)."""
    cell = tiny(spec.load_cell(CELLS[config]))
    dev = torch.device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        gen = Traffic(cell.traffic, cell.config["vocab_size"], seed, dev)
        rounds = [gen.round_tokens(r) for r in range(cell.workload["probe_rounds"])]
        ref = runner.follow(cell, seed, rounds, dev)
    finally:
        torch.set_num_threads(threads)
    return {"seed": seed, **{k: ref[k] for k in REFERENCE_KEYS}}


def text(readings: dict) -> str:
    """The file's text: one leaf, and one reading of the tiny cell, a line."""
    leaves = ",\n".join(f"   {json.dumps(x)}" for x in readings["leaves"])
    tiny_ = ",\n".join(f"   {json.dumps(k)}: {json.dumps(v)}" for k, v in readings["tiny"].items())
    rows = [f' "leaves": [\n{leaves}\n ]']
    rows += [f" {json.dumps(k)}: {json.dumps(v)}" for k, v in readings.items()
             if k not in ("leaves", "tiny")]
    rows.append(f' "tiny": {{\n{tiny_}\n }}')
    return "{\n" + ",\n".join(rows) + "\n}\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True, choices=sorted(CELLS))
    args = ap.parse_args(argv)
    readings = dict(yardstick(args.config), tiny=reference(args.config))
    DIR.mkdir(exist_ok=True)
    path(args.config).write_text(text(readings))
    print(path(args.config))
    return 0


if __name__ == "__main__":
    sys.exit(main())
