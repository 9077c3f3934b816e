"""``photon``: an MPT-style decoder (Photon, arXiv:2405.10853, Table 2):
pre-norm LayerNorm blocks, multi-head causal attention with ALiBi (Press et
al. 2022), a GELU MLP of width ``d_ff``, a final LayerNorm and the tied
embedding as the output head. Every layer is alike, so the program stacks
them all at ``segments.0.pos0``."""
from __future__ import annotations

import math

import torch

from reference.flops import causal_attention_flops_per_token
from reference.layout import Leaf, n_params, padded_vocab
from reference.model import _gelu_tanh, _layernorm, _lm_loss, alibi_slopes, mm_fp32

BODY = "segments.0.pos0."

TINY = {
    "config": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512),
    "traffic": dict(seq_len=64, batch=2),
    "workload": dict(grad_accum=2),
}


def leaves(cfg: dict):
    d, L, std = cfg["d_model"], cfg["n_layers"], cfg["init_std"]
    out_std = std / math.sqrt(2 * L)
    h, hd, ff = cfg["n_heads"], d // cfg["n_heads"], cfg["d_ff"]
    out = [
        Leaf("embed", (padded_vocab(cfg), d), "normal", std, vocab_axis=0),
        Leaf("final_norm.scale", (d,), "ones", 0.0),
        Leaf("final_norm.bias", (d,), "zeros", 0.0),
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
    return [leaf if isinstance(leaf, Leaf) else Leaf(*leaf, stacked=True) for leaf in out]


def flops_per_token(cfg: dict, seq_len: int) -> int:
    """Every parameter's product (the tied embedding once, as the head) and
    causal attention's score and value products."""
    return 6 * n_params(cfg) + causal_attention_flops_per_token(
        cfg["n_layers"], seq_len, cfg["d_model"])


def loss(cfg: dict, w: dict, tokens: torch.Tensor, mm=mm_fp32):
    """``(loss, ce)`` of tokens (b, S)."""
    b, S = tokens.shape
    d, H = cfg["d_model"], cfg["n_heads"]
    hd, eps = d // H, cfg["norm_eps"]
    pos = torch.arange(S, device=tokens.device)
    dist = (pos[:, None] - pos[None, :]).float()
    slopes = torch.tensor(alibi_slopes(H), device=tokens.device)
    bias = -slopes[:, None, None] * dist  # (H, S, S)
    bias = bias.masked_fill(dist < 0, -math.inf)
    h = w["embed"][tokens]
    for l in range(cfg["n_layers"]):
        p = lambda name: w[BODY + name][l]  # noqa: E731
        x = _layernorm(h, p("norm1.scale"), p("norm1.bias"), eps)
        q, k, v = (mm(x, p(f"mixer.{n}").reshape(d, H * hd)).view(b, S, H, hd).transpose(1, 2)
                   for n in ("wq", "wk", "wv"))
        att = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias, dim=-1)
        o = mm(att, v).transpose(1, 2).reshape(b, S, H * hd)
        h = h + mm(o, p("mixer.wo").reshape(H * hd, d))
        x = _layernorm(h, p("norm2.scale"), p("norm2.bias"), eps)
        h = h + mm(_gelu_tanh(mm(x, p("ffn.w_in"))), p("ffn.w_out"))
    h = _layernorm(h, w["final_norm.scale"], w["final_norm.bias"], eps)
    return _lm_loss(cfg, w, h, tokens, mm)
