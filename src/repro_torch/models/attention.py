"""Grouped-query self-attention with ALiBi/RoPE, causal and sliding-window masks —
the train-mode path of ``repro.models.attention``.

The scaled-dot-product core is written in plain einsum/softmax, as the JAX
reference computes it outside any kernel (its flash kernel is never used with
ALiBi). The KV cache and cross-attention wait for the serving slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import ParamDesc, alibi_slopes, apply_rope, rmsnorm

NEG_INF = -1e30


def attn_desc(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    scale = 0.02
    p = {
        "wq": ParamDesc((d, hq, hd), "normal", scale),
        "wk": ParamDesc((d, hkv, hd), "normal", scale),
        "wv": ParamDesc((d, hkv, hd), "normal", scale),
        "wo": ParamDesc((hq, hd, d), "normal", scale / max(1, 2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamDesc((hd,), "ones")
        p["k_norm"] = ParamDesc((hd,), "ones")
    return p


def _f32(x: float) -> float:
    """A Python float holding exactly the float32 value JAX would use."""
    return float(np.float32(x))


def sdpa(
    q: torch.Tensor,  # (B, Sq, Hq, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, hd)
    mask: Optional[torch.Tensor],  # bool, broadcastable to (B, 1, 1, Sq, Sk)
    bias: Optional[torch.Tensor] = None,  # additive, broadcastable to (B, Hq, Sq, Sk)
) -> torch.Tensor:
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    grp = Hq // Hkv
    qr = q.reshape(B, Sq, Hkv, grp, hd)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qr, k).float()
    scores = scores / _f32(np.sqrt(np.float32(hd)))
    if bias is not None:  # (b|1, Hq, Sq, Sk) -> (b|1, Hkv, grp, Sq, Sk)
        scores = scores + bias.reshape(bias.shape[0], Hkv, grp, *bias.shape[-2:])
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqs,bshd->bqhgd", p, v)
    return out.reshape(B, Sq, Hq, hd)


def make_mask(
    q_pos: torch.Tensor,  # (Sq,)
    k_pos: torch.Tensor,  # (Sk,)
    causal: bool,
    window: Optional[int],
) -> torch.Tensor:
    """Boolean mask broadcastable to (B, 1, 1, Sq, Sk)."""
    qp = q_pos[None, None, None, :, None]
    kp = k_pos[None, None, None, None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (qp - kp < window)
    return mask


def _pick_chunk(s: int, preferred: int = 256) -> int:
    for c in (preferred, 128, 512, 64, 250, 375, 32):
        if s % c == 0:
            return c
    return s


def sdpa_chunked(
    q: torch.Tensor,  # (B, Sq, Hq, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    *,
    q_pos: torch.Tensor,  # (Sq,)
    k_pos: torch.Tensor,  # (Sk,)
    causal: bool,
    window: Optional[int],
    slopes: Optional[torch.Tensor],  # ALiBi (Hq,) or None
    chunk: int = 256,
) -> torch.Tensor:
    """Attention one query chunk at a time, so the score block is at most
    (B, H, chunk, Sk) — the reference's structure for S >= 512."""
    B, Sq, Hq, hd = q.shape
    Hkv, Sk = k.shape[2], k.shape[1]
    grp = Hq // Hkv
    chunk = _pick_chunk(Sq, chunk)
    scale = _f32(np.float32(1.0) / np.sqrt(np.float32(hd)))
    kpc = k_pos[None, :]
    outs = []
    for c0 in range(0, Sq, chunk):
        qb, qp = q[:, c0:c0 + chunk], q_pos[c0:c0 + chunk]
        qr = qb.reshape(B, chunk, Hkv, grp, hd)
        s = torch.einsum("bqhgd,bshd->bhgqs", qr, k).float() * scale
        qpc = qp[:, None]
        m = torch.ones((chunk, Sk), dtype=torch.bool, device=q.device)
        if causal:
            m = m & (kpc <= qpc)
        if window is not None:
            m = m & ((qpc - kpc) < window)
        if slopes is not None:
            dist = torch.clamp((qpc - kpc).float(), min=0.0)
            s = s - slopes.reshape(1, Hkv, grp, 1, 1) * dist[None, None, None]
        s = torch.where(m[None, None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhgqs,bshd->bqhgd", p, v).reshape(B, chunk, Hq, hd))
    return torch.cat(outs, dim=1)


def attention(
    cfg,
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    positions: torch.Tensor,  # (S,) absolute token positions
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Self-attention layer, train mode (no cache)."""
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))

    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    k_positions = torch.arange(k.shape[1], device=x.device)
    slopes = alibi_slopes(cfg.n_heads, x.device) if cfg.pos_embedding == "alibi" else None

    if S >= 512:
        out = sdpa_chunked(
            q, k, v, q_pos=positions, k_pos=k_positions, causal=causal,
            window=window, slopes=slopes,
        )
    else:
        mask = make_mask(positions, k_positions, causal, window)
        bias = None
        if slopes is not None:
            dist = (positions[:, None] - k_positions[None, :]).float()
            bias = (-slopes[:, None, None] * torch.clamp(dist, min=0.0))[None]
        out = sdpa(q, k, v, mask, bias)

    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
