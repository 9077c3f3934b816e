"""Plain-torch oracle of single-token decode attention over a long KV cache,
as ``repro/kernels/flash_decode/ref.py``: a softmax over every cache slot, so
a row that sees no key gets the mean of v (the kernel gives 0 there)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,  # (B, Hq, hd) — one query token per sequence
    k: torch.Tensor,  # (B, Hkv, S, hd)
    v: torch.Tensor,  # (B, Hkv, S, hd)
    kv_len,  # (B,) or scalar — valid cache length
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    B, Hq, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    grp = Hq // Hkv
    qr = q.reshape(B, Hkv, grp, hd).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qr, k.float()) / torch.sqrt(
        torch.tensor(hd, dtype=torch.float32, device=q.device))
    kv_len = torch.as_tensor(kv_len, device=q.device).broadcast_to((B,))
    pos = torch.arange(S, device=q.device)
    mask = pos[None] < kv_len[:, None]  # (B, S)
    if window is not None:
        mask = mask & (pos[None] > (kv_len - 1 - window)[:, None])
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return out.reshape(B, Hq, hd).to(q.dtype)
