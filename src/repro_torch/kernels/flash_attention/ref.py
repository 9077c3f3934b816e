"""Plain-torch oracle of the flash attention kernel (GQA, causal, sliding
window), as ``repro/kernels/flash_attention/ref.py``: a softmax over every key,
so a row whose keys are all masked gets the mean of v (the kernel gives 0
there)."""
from __future__ import annotations

from typing import Optional

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
