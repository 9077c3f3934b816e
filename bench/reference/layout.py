"""Parameter layout and seeded weights of each configuration family.

Every parameter is named by its dotted path in the measured program's
parameter tree (``segments.0.pos0.mixer.wq``; a number is a list index), and
layers of one kind are stacked on a leading axis of ``n_layers``. Names,
shapes and initial values come from the configuration file alone, so the
benchmark hands the same weights to the program and to the plain reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

#: (name, shape, init, scale); init is normal | zeros | ones | ssm_a | ssm_dt
Leaf = Tuple[str, Tuple[int, ...], str, float]

BODY = "segments.0.pos0."


def padded_vocab(cfg: dict) -> int:
    m = cfg["vocab_pad_multiple"]
    return (cfg["vocab_size"] + m - 1) // m * m


def leaves(cfg: dict) -> List[Leaf]:
    """Every parameter of the configuration, sorted by name."""
    d, L, std = cfg["d_model"], cfg["n_layers"], cfg["init_std"]
    out_std = std / math.sqrt(2 * L)
    out: List[Leaf] = [("embed", (padded_vocab(cfg), d), "normal", std)]
    if cfg["family"] == "photon":
        h, hd, ff = cfg["n_heads"], d // cfg["n_heads"], cfg["d_ff"]
        out += [
            ("final_norm.scale", (d,), "ones", 0.0),
            ("final_norm.bias", (d,), "zeros", 0.0),
        ]
        for norm in ("norm1", "norm2"):
            out += [(BODY + norm + ".scale", (L, d), "ones", 0.0),
                    (BODY + norm + ".bias", (L, d), "zeros", 0.0)]
        out += [
            (BODY + "mixer.wq", (L, d, h, hd), "normal", std),
            (BODY + "mixer.wk", (L, d, h, hd), "normal", std),
            (BODY + "mixer.wv", (L, d, h, hd), "normal", std),
            (BODY + "mixer.wo", (L, h, hd, d), "normal", out_std),
            (BODY + "ffn.w_in", (L, d, ff), "normal", std),
            (BODY + "ffn.w_out", (L, ff, d), "normal", out_std),
        ]
    elif cfg["family"] == "mamba2":
        di = cfg["ssm_expand"] * d
        g, ds = cfg["ssm_n_groups"], cfg["ssm_state"]
        nh = di // cfg["ssm_head_dim"]
        conv = di + 2 * g * ds
        out += [
            ("final_norm.scale", (d,), "ones", 0.0),
            (BODY + "norm1.scale", (L, d), "ones", 0.0),
            (BODY + "mixer.in_proj", (L, d, 2 * di + 2 * g * ds + nh), "normal", std),
            (BODY + "mixer.conv_w", (L, cfg["ssm_conv_width"], conv), "normal", 0.2),
            (BODY + "mixer.conv_b", (L, conv), "zeros", 0.0),
            (BODY + "mixer.A_log", (L, nh), "ssm_a", 0.0),
            (BODY + "mixer.dt_bias", (L, nh), "ssm_dt", 0.0),
            (BODY + "mixer.D_skip", (L, nh), "ones", 0.0),
            (BODY + "mixer.norm_scale", (L, di), "ones", 0.0),
            (BODY + "mixer.out_proj", (L, di, d), "normal", out_std),
        ]
    else:
        raise ValueError(f"unknown family {cfg['family']!r}")
    return sorted(out)


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` (any whole ``seed``, also past 2**32)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) % (1 << 63)


def make_leaf(cfg: dict, seed: int, name: str, device) -> torch.Tensor:
    """One leaf's initial float32 values, drawn on ``device`` in one call from
    its own generator: the same ``(seed, name)`` gives the same bits."""
    table = leaves(cfg)
    index = [n for n, *_ in table].index(name)
    _, shape, init, scale = table[index]
    if init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    if init == "normal":
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(scale)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    if init == "ssm_a":  # A_log = log(U[1, 16])
        return torch.log1p(u.mul_(15.0))
    if init == "ssm_dt":  # dt bias = softplus^-1(U[1e-3, 1e-1])
        dt = u.mul_(1e-1 - 1e-3).add_(1e-3)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {init!r}")


def make_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf, by name."""
    return {name: make_leaf(cfg, seed, name, device) for name, *_ in leaves(cfg)}


def n_params(cfg: dict, padded: bool = False) -> int:
    """Parameters of the model; the embedding's padding rows only if asked
    (the tied embedding is counted once: it is also the output head)."""
    total = sum(math.prod(shape) for _, shape, _, _ in leaves(cfg))
    if not padded:
        total -= (padded_vocab(cfg) - cfg["vocab_size"]) * cfg["d_model"]
    return total
