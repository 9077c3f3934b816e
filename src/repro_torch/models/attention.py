"""Grouped-query attention with ALiBi/RoPE, causal and sliding-window masks,
cross-attention and the KV cache of prefill/decode — ``repro.models.attention``.

The scaled-dot-product core is written in plain einsum/softmax, as the JAX
reference computes it outside any kernel. Under ``use_pallas``, where the
reference sends the core to its Pallas flash kernel (self-attention without
ALiBi, outside decode, with a window that is None or a Python int), the port
sends it to the CUDA flash kernel through ``kernels/flash_attention/ops``.
Through the model only whisper's encoder gets there: a decoder layer's window
is an entry of the window array, a 0-d tensor.

The port's own route, which the reference lacks: a causal ALiBi
self-attention call in bf16 on the card with no cache and no window runs on
the flash kernel pair for training, forward and backward
(:func:`flash_train_route`). Every call counts its route on the traced
round's ``attn_kernel`` or ``attn_plain`` counter (``obs/phases``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS as FLASH_HEAD_DIMS
from repro_torch.models.common import (  # noqa: F401  alibi_slopes: the reference's name
    ParamDesc,
    alibi_slopes,
    alibi_slopes_on,
    apply_rope,
    rmsnorm,
)
from repro_torch.obs.phases import counter

NEG_INF = -1e30
WINDOW_SENTINEL = 1 << 30  # "no window": mask (qpos - kpos < sentinel) is always true

#: the traced round's counts of attention calls by route
count_kernel_call = counter("attn_kernel")
count_plain_call = counter("attn_plain")


def attn_desc(cfg, cross: bool = False) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    scale = 0.02
    p = {
        "wq": ParamDesc((d, hq, hd), (None, "heads", "head_dim"), "normal", scale),
        "wk": ParamDesc((d, hkv, hd), (None, "kv_heads", "head_dim"), "normal", scale),
        "wv": ParamDesc((d, hkv, hd), (None, "kv_heads", "head_dim"), "normal", scale),
        "wo": ParamDesc((hq, hd, d), ("heads", "head_dim", None), "normal",
                        scale / max(1, 2 * cfg.n_layers) ** 0.5),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = ParamDesc((hd,), (None,), "ones")
        p["k_norm"] = ParamDesc((hd,), (None,), "ones")
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
    window,  # None, an int, or a 0-d tensor (a layer's entry of the window array)
    k_len=None,  # valid KV length for decode (scalar)
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
    if k_len is not None:
        mask = mask & (kp < k_len)
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
    window,
    k_len,
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
        if k_len is not None:
            m = m & (kpc < k_len)
        if slopes is not None:
            dist = torch.clamp((qpc - kpc).float(), min=0.0)
            s = s - slopes.reshape(1, Hkv, grp, 1, 1) * dist[None, None, None]
        s = torch.where(m[None, None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhgqs,bshd->bqhgd", p, v).reshape(B, chunk, Hq, hd))
    return torch.cat(outs, dim=1)


def _no_window(window) -> bool:
    """Whether ``window`` is None or the full-attention sentinel. A layer's
    entry of the window array is a 0-d CPU tensor, read on the host; a window
    on another device is not read (that would wait for the device)."""
    if window is None:
        return True
    if isinstance(window, torch.Tensor):
        return window.device.type == "cpu" and window.ndim == 0 and int(window) == WINDOW_SENTINEL
    return window == WINDOW_SENTINEL


def flash_train_route(cfg, q, *, causal: bool, window, cache, kv_source, k_len) -> bool:
    """Whether this attention call runs on the causal ALiBi flash kernel pair:
    q (B, S, Hq, hd) bf16 on CUDA, ALiBi, causal self-attention with no cache,
    no memory and no KV length, no window, hd 64 or 128. Every other call
    takes the plain core."""
    return (q.device.type == "cuda" and q.dtype == torch.bfloat16
            and cfg.pos_embedding == "alibi" and causal and cache is None
            and kv_source is None and k_len is None and _no_window(window)
            and q.shape[-1] in FLASH_HEAD_DIMS)


def attention(
    cfg,
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    positions: torch.Tensor,  # (S,) absolute token positions
    causal: bool = True,
    window=None,
    cache: Optional[dict] = None,  # {'k': (B, Smax, Hkv, hd), 'v': ...} decode/prefill
    cache_index=None,  # scalar write offset for decode
    kv_source: Optional[torch.Tensor] = None,  # cross-attention memory (B, Skv, D)
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self- or cross-attention layer. Returns ``(y, new_cache)``;
    ``new_cache`` is None without a cache, the computed ``{k, v}`` at prefill
    (for cross-attention, the memory's), and the cache with this step's
    entries written at ``cache_index`` at decode."""
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    kv_in = kv_source if kv_source is not None else x
    k = torch.einsum("bsd,dhk->bshk", kv_in, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", kv_in, p["wv"].to(x.dtype))

    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if kv_source is None and cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        if kv_source is not None and cache_index is None:
            # the cross-attention cache is written once, at prefill: the memory's k/v
            new_cache = {"k": k, "v": v}
        elif cache_index is not None and "k" in cache and cache["k"].shape[1] > S:
            # decode: write S (=1) new entries at cache_index, attend over the full cache
            i = int(cache_index)
            ck, cv = cache["k"].clone(), cache["v"].clone()
            ck[:, i:i + S] = k.to(ck.dtype)
            cv[:, i:i + S] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv}
            k, v = ck.to(q.dtype), cv.to(q.dtype)
        else:
            # prefill: the cache is exactly the computed k/v
            new_cache = {"k": k, "v": v}

    Sk = k.shape[1]
    k_len = None
    if kv_source is None and cache is not None and cache_index is not None and Sk > S:
        k_len = cache_index + S
    if flash_train_route(cfg, q, causal=causal, window=window, cache=cache,
                         kv_source=kv_source, k_len=k_len):
        count_kernel_call()
        out = fa_ops.flash_attention_alibi(q, k, v, alibi_slopes_on(cfg.n_heads, x.device))
        return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), new_cache
    count_plain_call()

    k_positions = torch.arange(Sk, device=x.device)
    slopes = None
    if kv_source is not None:
        eff_causal, eff_window = False, None
    else:
        eff_causal, eff_window = causal, window
        if cfg.pos_embedding == "alibi":
            slopes = alibi_slopes_on(cfg.n_heads, x.device)

    if (use_pallas and slopes is None and kv_source is None and k_len is None
            and (window is None or isinstance(window, int))):
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    elif S >= 512:
        out = sdpa_chunked(
            q, k, v, q_pos=positions, k_pos=k_positions, causal=eff_causal,
            window=eff_window, k_len=k_len, slopes=slopes,
        )
    else:
        mask = (None if kv_source is not None
                else make_mask(positions, k_positions, eff_causal, eff_window, k_len))
        bias = None
        if slopes is not None:
            dist = (positions[:, None] - k_positions[None, :]).float()
            bias = (-slopes[:, None, None] * torch.clamp(dist, min=0.0))[None]
        out = sdpa(q, k, v, mask, bias)

    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), new_cache


def empty_cache_desc(cfg, batch: int, max_len: int, dtype, device="cuda") -> dict:
    """The zero KV cache of one attention layer: ``k`` and ``v`` of
    (batch, max_len, n_kv_heads, head_dim) in ``dtype`` on ``device`` (the
    card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
