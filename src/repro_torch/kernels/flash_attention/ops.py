"""Flash attention in model layout (B, S, H, hd), the counterpart of
``repro/kernels/flash_attention/ops.py``: swaps the head axis ahead of S for
the kernel and back. The reference picks Pallas block sizes here; the CUDA
kernel tiles by 64 and masks the ragged tail itself, so there is nothing to
pick or pad."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, hd) — model layout
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    if window is not None and not isinstance(window, int):
        raise TypeError("kernel path needs a static window")
    out = flash_attention_fwd(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
        causal=causal, window=window, q_offset=q_offset,
    )
    return out.transpose(1, 2)
