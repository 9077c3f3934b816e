"""Flash attention in model layout (B, S, H, hd), the counterpart of
``repro/kernels/flash_attention/ops.py``. The reference copies q, k and v to
(B, H, S, hd) and picks Pallas block sizes that divide S; here the kernel
reads the model's tensors in place through their strides (the views below
copy nothing), tiles by 64 and masks the ragged tail itself, and writes o in
(B, S, H, hd) memory, so the result comes back contiguous."""
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
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, q_offset=q_offset,
    )
    return out.transpose(1, 2)
