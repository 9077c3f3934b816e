"""Flash decode in model layout, the counterpart of
``repro/kernels/flash_decode/ops.py``: q (B, 1, Hq, hd) and the caches
(B, S, Hkv, hd) as the model keeps them. The reference moves the cache's head
axis ahead of S (a copy under XLA) and picks a Pallas kv block that divides
S; here the kernel reads the cache in place through its strides and masks
the ragged tail itself, so nothing is copied, picked or padded. An integer
kv_len (a Python or numpy int) goes to the kernel as it is (one length for
every row, no device tensor per call); anything else is broadcast to a (B,)
int32 tensor on q's device."""
from __future__ import annotations

import numbers
from typing import Optional

import torch

# flash_decode_fwd: a public name of the reference's module
from repro_torch.kernels.flash_decode.kernel import _run, flash_decode_fwd  # noqa: F401


def flash_decode(
    q: torch.Tensor,  # (B, 1, Hq, hd) — model layout, single new token
    k_cache: torch.Tensor,  # (B, S, Hkv, hd)
    v_cache: torch.Tensor,
    kv_len,  # int, or a scalar or (B,) tensor
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    if window is not None and not isinstance(window, int):
        raise TypeError("kernel path needs a static window")
    if q.ndim != 4 or k_cache.ndim != 4 or v_cache.ndim != 4:
        raise ValueError(f"flash_decode: q and the caches must be 4-d, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if not isinstance(kv_len, numbers.Integral) or isinstance(kv_len, bool):
        kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
        kv_len = kv_len.broadcast_to((q.shape[0],)).contiguous()
    if q.shape[1] != 1 or not q.is_contiguous():
        q = q[:, :1].contiguous()  # the first new token, as the reference takes it
    # no views: the kernel reads q's (B, 1, Hq, hd) memory as (B, Hq, hd), the
    # caches through their strides with S and Hkv swapped, and o is
    # allocated as (B, 1, Hq, hd)
    B, _, Hq, hd = q.shape
    (kb, ks, kh, kd), (vb, vs, vh, vd) = k_cache.stride(), v_cache.stride()
    (b0, s0, h0, d0), (b1, s1, h1, d1) = k_cache.shape, v_cache.shape
    return _run(q, (B, Hq, hd), k_cache, (b0, h0, s0, d0), (kb, kh, ks, kd),
                v_cache, (b1, h1, s1, d1), (vb, vh, vs, vd), kv_len, window)
