"""Parameter layout and seeded weights of each configuration family.

Every parameter is named by its dotted path in the measured program's
parameter tree (``segments.0.pos0.mixer.wq``; a number is a list index), and
layers of one kind are stacked on a leading axis of their count. Names,
shapes and initial values come from the configuration file alone, so the
benchmark hands the same weights to the program and to the plain reference.

A family is one module, ``families/<family>.py``, found by the configuration
file's ``family`` string; no file here names one. It gives:

- ``leaves(cfg) -> List[Leaf]``: every parameter (the order does not matter);
- ``loss(cfg, w, tokens, mm) -> (loss, ce)``: the plain reference model, every
  matrix product through ``mm`` (:mod:`reference.model`);
- ``flops_per_token(cfg, seq_len) -> int``: the model FLOPs of one token's
  forward and backward pass (:mod:`reference.flops`);
- ``TINY``: ``{"config": ..., "traffic": ..., "workload": ...}``, the keys its
  cells change for the CPU tests;
- optionally ``INITS``: further init kinds, ``name -> f(shape, scale,
  generator, device)`` returning float32 values.
"""
from __future__ import annotations

import functools
import importlib.util
import math
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

FAMILIES = Path(__file__).resolve().parent / "families"


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    #: normal | zeros | ones | ssm_a | ssm_dt, or one of the family's ``INITS``
    init: str
    scale: float
    #: a per-layer stack: its leading axis is the layer
    stacked: bool = False
    #: the axis of padded vocabulary rows (the embedding, an untied head)
    vocab_axis: Optional[int] = None


@functools.lru_cache(maxsize=None)
def _load(name: str):
    path = FAMILIES / f"{name}.py"
    if path.parent != FAMILIES or not path.is_file():
        raise ValueError(f"unknown family {name!r}: no reference/families/{name}.py")
    spec = importlib.util.spec_from_file_location("bench_family_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cfg: dict):
    """The module of the configuration's family."""
    return _load(cfg["family"])


def padded_vocab(cfg: dict) -> int:
    m = cfg["vocab_pad_multiple"]
    return (cfg["vocab_size"] + m - 1) // m * m


def layer_groups(signatures: Sequence) -> List[Tuple[str, List[int]]]:
    """The program's grouping of layers into parameter stacks, restated from
    ``transformer.plan_segments``: up to three leading layers of their own,
    then the shortest period (at most 12) whose layers repeat the same
    signatures to the end. Returns ``(prefix, layers)`` per position, in
    order; a position holding more than one layer is a stack."""
    n = len(signatures)
    for r in range(min(3, n) + 1):
        m = n - r
        for p in range(1, min(m, 12) + 1):
            if m % p == 0 and all(signatures[r + i] == signatures[r + i % p] for i in range(m)):
                groups = [(f"segments.{i}.pos0.", [i]) for i in range(r)]
                return groups + [(f"segments.{r}.pos{q}.", list(range(r + q, n, p)))
                                 for q in range(p)]
    return [(f"segments.{i}.pos0.", [i]) for i in range(n)]


def leaves(cfg: dict) -> List[Leaf]:
    """Every parameter of the configuration, sorted by name."""
    return sorted(Leaf(*leaf) for leaf in family(cfg).leaves(cfg))


def stacked(cfg: dict) -> set:
    """The names of the per-layer stacks."""
    return {leaf.name for leaf in leaves(cfg) if leaf.stacked}


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` (any whole ``seed``, also past 2**32)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) % (1 << 63)


def make_leaf(cfg: dict, seed: int, name: str, device) -> torch.Tensor:
    """One leaf's initial float32 values, drawn on ``device`` in one call from
    its own generator: the same ``(seed, name)`` gives the same bits."""
    table = leaves(cfg)
    index = [leaf.name for leaf in table].index(name)
    _, shape, init, scale, _, _ = table[index]
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    if init == "normal":
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(scale)
    extra = getattr(family(cfg), "INITS", {})
    if init in extra:
        return extra[init](shape, scale, gen, device)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    if init == "ssm_a":  # A_log = log(U[1, 16])
        return torch.log1p(u.mul_(15.0))
    if init == "ssm_dt":  # dt bias = softplus^-1(U[1e-3, 1e-1])
        dt = u.mul_(1e-1 - 1e-3).add_(1e-3)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {init!r}")


def make_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf, by name."""
    return {leaf.name: make_leaf(cfg, seed, leaf.name, device) for leaf in leaves(cfg)}


def n_params(cfg: dict, padded: bool = False) -> int:
    """Parameters of the model; the padding rows of the vocabulary-sized
    leaves only if asked (a tied embedding is counted once, though it is also
    the output head)."""
    total = 0
    for leaf in leaves(cfg):
        size = math.prod(leaf.shape)
        if leaf.vocab_axis is not None and not padded:
            size -= size // leaf.shape[leaf.vocab_axis] * (padded_vocab(cfg) - cfg["vocab_size"])
        total += size
    return total
