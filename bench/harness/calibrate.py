"""The readings that the limits of ``correct`` are set from, and the checks
that the comparison fails what it must fail.

For each seed: the program's readings of the cell's probe rounds against the
float32 reference's (the lower readings); on some seeds also

- ``control``: the reference itself in the program's place, with every
  matrix product in fp8 (e4m3 operands, e5m2 gradients), the nearest
  precision below the configuration's bfloat16;
- ``half_batch``: the program with half of every step's tokens left out of
  its loss (a ``loss_mask`` over the second half of each sequence), the mean
  taken over the rest.

and, on the seeds asked for, a witness that needs no program:

- ``bf16_reference``: the reference with every matrix product in bfloat16,
  the configurations' compute type, against the float32 reference on the
  same rounds: what bfloat16 products alone read in each number.

A step that returns its state unchanged needs no run: its pseudo-gradient and
its change are zero, so ``pg_gap`` and ``change_gap`` read exactly 1.
"""
from __future__ import annotations

from typing import Dict, Iterable

import torch

from harness import judge
from harness.program import Program
from harness.runner import _release, follow, probe
from harness.spec import Cell
from harness.traffic import Traffic
from reference import layout
from reference.model import mm_bf16, mm_fp8


def half_batch_feed(tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A broken feed: every sequence's second half is masked out of the loss."""
    mask = torch.ones_like(tokens)
    mask[..., tokens.shape[-1] // 2:] = 0
    return {"tokens": tokens, "loss_mask": mask}


def program_readings(cell: Cell, seed: int, device, feed=None):
    params = layout.make_params(cell.config, seed, device)
    prog = Program(cell.config, cell.traffic, cell.workload, params, seed)
    del params
    gen = Traffic(cell.traffic, cell.config["vocab_size"], seed, device)
    readings, rounds = probe(cell, prog, gen, seed, device, feed)
    del prog
    _release()
    return readings, rounds


def seed_rows(cell: Cell, seed: int, device, control: bool, fault: bool) -> Dict[str, dict]:
    """``{kind: {number: (value, where)}}`` for one seed."""
    prog, rounds = program_readings(cell, seed, device)
    ref = follow(cell, seed, rounds, device)
    _release()
    rows = {"program": judge.numbers(prog, ref),
            "raw": {"program_loss": (prog["loss"], ""), "reference_loss": (ref["loss"], ""),
                    "program_grad_norm": (prog["client_grad_norm"], ""),
                    "reference_grad_norm": (ref["client_grad_norm"], "")}}
    if control:
        ctl = follow(cell, seed, rounds, device, mm=mm_fp8)
        rows["control"] = judge.numbers(ctl, ref)
        rows["raw"]["control_loss"] = (ctl["loss"], "")
        _release()
    if fault:
        broken, _ = program_readings(cell, seed, device, feed=half_batch_feed)
        rows["half_batch"] = judge.numbers(broken, ref)
    return rows


def witness_rows(cell: Cell, seed: int, device) -> Dict[str, dict]:
    """``{"bf16_reference": numbers}`` for one seed's probe rounds."""
    gen = Traffic(cell.traffic, cell.config["vocab_size"], seed, device)
    rounds = [gen.round_tokens(r) for r in range(cell.workload["probe_rounds"])]
    ref = follow(cell, seed, rounds, device)
    _release()
    bf16 = follow(cell, seed, rounds, device, mm=mm_bf16)
    _release()
    return {"bf16_reference": judge.numbers(bf16, ref)}


def calibrate(cell: Cell, seeds: Iterable[int], control_seeds, fault_seeds, device,
              witness_seeds: Iterable[int] = ()):
    for seed in seeds:
        yield seed, seed_rows(cell, seed, device, seed in control_seeds, seed in fault_seeds)
    for seed in witness_seeds:
        yield seed, witness_rows(cell, seed, device)
