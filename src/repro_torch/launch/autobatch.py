"""Automatic micro-batch sizing (paper §6.2), the counterpart of
``repro.launch.autobatch``.

The paper binary-searches powers of two on real GPUs until OOM. This module
*estimates* the size from the model's memory model (the reference's formula)
and then verifies it against a measured run: the peak device memory of one
step on the card (``roofline.analysis.measure``), the paper's own method.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import card_memory_bytes


def activation_bytes_per_token(cfg: ModelConfig) -> float:
    """Rough per-token activation residency during one remat'd train step."""
    d = cfg.d_model
    per_layer_carry = 2 * d  # bf16 residual stream saved per layer
    # remat working set ~ a few layer-widths; attention adds the chunked score block
    working = 12 * d
    return cfg.n_layers * per_layer_carry + working


def estimate_micro_batch(
    cfg: ModelConfig,
    seq_len: int,
    *,
    hbm_bytes: Optional[float] = None,
    model_parallel: int = 16,
    param_bytes_per_param: float = 4.0,
    opt_copies: float = 4.0,  # params + m + v + pseudo-grad/momentum
) -> int:
    """Largest power-of-two micro-batch expected to fit; >=1 (0: nothing
    fits). ``hbm_bytes`` is one device's memory, the visible card's by
    default (raises without one)."""
    if hbm_bytes is None:
        hbm_bytes = card_memory_bytes("cuda")
    params_per_dev = cfg.param_count() / model_parallel
    fixed = params_per_dev * param_bytes_per_param * opt_copies
    budget = hbm_bytes * 0.9 - fixed
    if budget <= 0:
        return 0
    per_seq = activation_bytes_per_token(cfg) * seq_len
    n = int(budget // per_seq)
    mb = 1
    while mb * 2 <= n:
        mb *= 2
    return mb if n >= 1 else 0


def verify_micro_batch(measured, hbm_bytes: Optional[float] = None) -> bool:
    """The OOM check of a measured run: its peak device memory
    (``Measured.peak_memory``) within one card's memory (the visible card's
    by default)."""
    if hbm_bytes is None:
        hbm_bytes = card_memory_bytes("cuda")
    return measured.peak_memory is not None and measured.peak_memory <= hbm_bytes
