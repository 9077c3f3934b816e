"""Flash decode in model layout, the counterpart of
``repro/kernels/flash_decode/ops.py``: q (B, 1, Hq, hd) and the caches
(B, S, Hkv, hd) as the model keeps them. The reference moves the cache's head
axis ahead of S (a copy under XLA) and picks a Pallas kv block that divides
S; here the kernel reads the cache in place through its strides and masks
the ragged tail itself, so nothing is copied, picked or padded."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_decode.kernel import flash_decode_fwd


def flash_decode(
    q: torch.Tensor,  # (B, 1, Hq, hd) — model layout, single new token
    k_cache: torch.Tensor,  # (B, S, Hkv, hd)
    v_cache: torch.Tensor,
    kv_len,  # scalar or (B,)
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    if window is not None and not isinstance(window, int):
        raise TypeError("kernel path needs a static window")
    B = q.shape[0]
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
    out = flash_decode_fwd(
        q[:, 0].contiguous(), k_cache.movedim(1, 2), v_cache.movedim(1, 2),
        kv_len.broadcast_to((B,)).contiguous(), window=window,
    )
    return out[:, None]  # (B, 1, Hq, hd)
