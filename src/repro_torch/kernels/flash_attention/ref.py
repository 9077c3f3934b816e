"""Plain-torch oracles of the flash attention kernels. ``attention_ref`` (GQA,
causal, sliding window), as ``repro/kernels/flash_attention/ref.py``: a
softmax over every key, so a row whose keys are all masked gets the mean of v
(the kernel gives 0 there). ``attention_alibi_ref``: causal self-attention
with ALiBi in float32, differentiable, the oracle of the training kernels
(forward and backward)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, Hq, Sq, hd)
    k: torch.Tensor,  # (B, Hkv, Sk, hd)
    v: torch.Tensor,  # (B, Hkv, Sk, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,  # absolute position of q[0] (decode: Sk - Sq)
) -> torch.Tensor:
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    grp = Hq // Hkv
    qr = q.reshape(B, Hkv, grp, Sq, hd).float()
    scores = torch.einsum("bhgqd,bhsd->bhgqs", qr, k.float())
    scores = scores / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bhsd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Sq, hd).to(q.dtype)


def alibi_scores(q: torch.Tensor, k: torch.Tensor, slopes: torch.Tensor):
    """``(s, seen)``: the float32 scores ``scale * q.k - slope * (i - j)``
    (B, Hkv, grp, S, S), -inf where j > i, and the causal mask (S, S)."""
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    grp = Hq // Hkv
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    qr = q.float().reshape(B, Hkv, grp, S, hd)
    s = torch.einsum("bhgqd,bhsd->bhgqs", qr, k.float()) * scale
    pos = torch.arange(S, device=q.device)
    dist = (pos[:, None] - pos[None, :]).float()
    seen = dist >= 0
    s = s - slopes.float().reshape(Hkv, grp, 1, 1) * torch.clamp(dist, min=0.0)
    return torch.where(seen, s, torch.full_like(s, float("-inf"))), seen


def attention_alibi_ref(
    q: torch.Tensor,  # (B, Hq, S, hd)
    k: torch.Tensor,  # (B, Hkv, S, hd)
    v: torch.Tensor,  # (B, Hkv, S, hd)
    slopes: torch.Tensor,  # (Hq,) float32
):
    """Causal ALiBi self-attention in float32: ``(o, lse)``, o (B, Hq, S, hd)
    and each row's log-sum-exp (B, Hq, S), both float32 and differentiable."""
    B, Hq, S, hd = q.shape
    s, _ = alibi_scores(q, k, slopes)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    o = torch.einsum("bhgqs,bhsd->bhgqd", p, v.float())
    return o.reshape(B, Hq, S, hd), lse.reshape(B, Hq, S)
