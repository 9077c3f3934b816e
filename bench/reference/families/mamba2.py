"""``mamba2``: the Mamba-2 SSD stack (arXiv:2405.21060): RMSNorm, the joint
input projection, a causal depthwise convolution, SiLU, the SSD scan in the
paper's minimal chunked form (:func:`reference.model.ssd`), the skip ``D``,
the gated RMSNorm and the output projection; a final RMSNorm and the tied
embedding as the output head. Every layer is alike, so the program stacks
them all at ``segments.0.pos0``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.layout import Leaf, n_params, padded_vocab
from reference.model import SSD_BLOCK, _lm_loss, _rmsnorm, mm_fp32, ssd

BODY = "segments.0.pos0."

TINY = {
    "config": dict(n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16, vocab_size=512,
                   ssm_chunk=64),
    "traffic": dict(seq_len=256, batch=1),
    "workload": dict(grad_accum=1),
}


def leaves(cfg: dict):
    d, L, std = cfg["d_model"], cfg["n_layers"], cfg["init_std"]
    out_std = std / math.sqrt(2 * L)
    di = cfg["ssm_expand"] * d
    g, ds = cfg["ssm_n_groups"], cfg["ssm_state"]
    nh = di // cfg["ssm_head_dim"]
    conv = di + 2 * g * ds
    out = [
        Leaf("embed", (padded_vocab(cfg), d), "normal", std, vocab_axis=0),
        Leaf("final_norm.scale", (d,), "ones", 0.0),
    ]
    out += [
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
    return [leaf if isinstance(leaf, Leaf) else Leaf(*leaf, stacked=True) for leaf in out]


def flops_per_token(cfg: dict, seq_len: int) -> int:
    """Every parameter's product (the tied embedding once, as the head); the
    SSD scan is not a product of weights and is not counted."""
    return 6 * n_params(cfg)


def loss(cfg: dict, w: dict, tokens: torch.Tensor, mm=mm_fp32):
    """``(loss, ce)`` of tokens (b, S). Each layer's internals are recomputed
    in the backward pass (``torch.utils.checkpoint``): the SSD scan's float32
    intermediates of 48 layers would not fit beside the optimiser state."""
    b, S = tokens.shape
    d, eps = cfg["d_model"], cfg["norm_eps"]
    di = cfg["ssm_expand"] * d
    g, n, pdim = cfg["ssm_n_groups"], cfg["ssm_state"], cfg["ssm_head_dim"]
    nh, W = di // pdim, cfg["ssm_conv_width"]

    def layer(h, l):
        p = lambda name: w[BODY + name][l]  # noqa: E731
        x = _rmsnorm(h, p("norm1.scale"), eps)
        z, xbc, dt = torch.split(mm(x, p("mixer.in_proj")), [di, di + 2 * g * n, nh], dim=-1)
        xp = F.pad(xbc, (0, 0, W - 1, 0))  # causal: W-1 zeros before the sequence
        cw = p("mixer.conv_w")
        xbc = F.silu(sum(xp[:, i:i + S] * cw[i] for i in range(W)) + p("mixer.conv_b"))
        xs, Bm, Cm = torch.split(xbc, [di, g * n, g * n], dim=-1)
        xs = xs.reshape(b, S, nh, pdim)
        Bm = Bm.reshape(b, S, g, n).repeat_interleave(nh // g, dim=2)
        Cm = Cm.reshape(b, S, g, n).repeat_interleave(nh // g, dim=2)
        dt = F.softplus(dt + p("mixer.dt_bias"))  # (b, S, nh)
        A = -torch.exp(p("mixer.A_log"))
        y = ssd(xs * dt[..., None], A * dt, Bm, Cm, SSD_BLOCK)
        y = (y + xs * p("mixer.D_skip")[:, None]).reshape(b, S, di)
        y = _rmsnorm(y * F.silu(z), p("mixer.norm_scale"), eps)
        return h + mm(y, p("mixer.out_proj"))

    h = w["embed"][tokens]
    for l in range(cfg["n_layers"]):
        h = checkpoint(layer, h, l, use_reentrant=False)
    h = _rmsnorm(h, w["final_norm.scale"], eps)
    return _lm_loss(cfg, w, h, tokens, mm)
