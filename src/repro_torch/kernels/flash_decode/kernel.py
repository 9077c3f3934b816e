"""Flash decode (one query token against a long KV cache) as a CUDA kernel for
Hopper, and its plain PyTorch version.

:func:`flash_decode_fwd` replaces the Pallas TPU kernel
``repro/kernels/flash_decode/kernel.py::flash_decode_fwd`` and keeps its
layout and its function: q (B, Hq, hd), k and v (B, Hkv, S, hd), bf16 or f32,
kv_len (B,) int32; GQA by ``h // (Hq // Hkv)``; row b sees the cache slots
``pos < kv_len[b]`` and, with a window, ``pos > kv_len[b] - 1 - window``; q is
scaled to f32 by ``1/sqrt(hd)`` before the product, the softmax accumulates
in f32 and the output is in q's dtype. A row that sees no key gives 0 (the
kernel divides by ``max(l, 1e-30)``; ``ref.decode_attention_ref`` would give
the mean of v there). hd is 32, 64, 128 or 256; any S (the reference needs a
kv block that divides S). k and v may be strided views — the model's
(B, S, Hkv, hd) cache with its head axis moved is read in place — as long as
each row of hd values is contiguous and 16-byte aligned on the card.

The CUDA source is ``src/repro_torch/csrc/flash_decode.cu``; it says what
bounds the kernel (bytes) and how the seen keys of a row are split over
blocks and merged again. It is built at first use by ``kernels/build.py`` and
bound with ``ctypes``.

A tensor on the CPU goes to :func:`flash_decode_plain`; a CUDA tensor
launches the kernel or raises — there is no fallback.
``flash_decode_fwd.launches`` counts the launches (one per call: the split
pass and the merge pass that follows it).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.build import CSRC, build

SOURCE = CSRC / "flash_decode.cu"
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = (torch.bfloat16, torch.float32)
_INT32 = (-(1 << 31), (1 << 31) - 1)
#: the fewest seen keys a split is given, and the blocks per SM the splits aim at
MIN_SPLIT_KEYS, BLOCKS_PER_SM = 64, 8


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build(SOURCE)[0]))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_decode_fwd.argtypes = [P] * 8 + [I] * 5 + [L] * 6 + [I] * 3 + [ctypes.c_float, I, P]
    lib.flash_decode_fwd.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_scale(hd: int) -> float:
    """``1 / hd ** 0.5`` as the float32 the TPU kernel multiplies q by."""
    return float(np.float32(1.0 / hd ** 0.5))


def heads_per_block(grp: int) -> int:
    """Query heads of one kv head that one block takes (``GT`` in the source)."""
    return 1 if grp == 1 else 2 if grp == 2 else 4


def n_splits(B: int, Hq: int, Hkv: int, S: int, window: Optional[int], n_sm: int) -> int:
    """How many pieces each row's seen keys are cut into: enough blocks for
    ``BLOCKS_PER_SM`` on every SM, but no piece under ``MIN_SPLIT_KEYS`` keys
    of the most a row can see (S, or the window)."""
    grp = Hq // Hkv
    blocks = B * Hkv * -(-grp // heads_per_block(grp))
    span = S if window is None else max(1, min(S, window))
    return max(1, min(-(-BLOCKS_PER_SM * n_sm // blocks), -(-span // MIN_SPLIT_KEYS)))


def _check(q, k, v, kv_len, window) -> None:
    """Raise unless the inputs have the kernel's layout, dtypes and ranges."""
    if q.ndim != 3 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_decode: q must be 3-d and k, v 4-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_decode: q must be bfloat16 or float32, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim must be one of {HEAD_DIMS}, got {hd}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"flash_decode: {name} must be {q.dtype}, got {t.dtype}")
        if tuple(t.shape) != (B, Hkv, S, hd):
            raise ValueError(f"flash_decode: {name} must have shape {(B, Hkv, S, hd)}, "
                             f"got {tuple(t.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_decode: {name} must be contiguous along hd")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (B,):
        raise ValueError(f"flash_decode: kv_len must be ({B},) int32, got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype}")
    for name, t in (("k", k), ("v", v), ("kv_len", kv_len)):
        if t.device != q.device:
            raise ValueError(f"flash_decode: {name} is on {t.device}, q on {q.device}")
    if not q.is_contiguous() or not kv_len.is_contiguous():
        raise ValueError("flash_decode: q and kv_len must be contiguous")
    if min(B, Hq, Hkv, S) < 1 or Hq % Hkv or S > _INT32[1]:
        raise ValueError(f"flash_decode: need nonempty inputs, Hq % Hkv == 0 and S < 2**31, "
                         f"got B {B}, Hq {Hq}, Hkv {Hkv}, S {S}")
    if window is not None and not _INT32[0] <= window <= _INT32[1]:
        raise ValueError(f"flash_decode: window = {window} does not fit in int32")


def flash_decode_fwd(
    q: torch.Tensor,  # (B, Hq, hd) bf16 | f32
    k: torch.Tensor,  # (B, Hkv, S, hd), q's dtype
    v: torch.Tensor,  # (B, Hkv, S, hd), q's dtype
    kv_len: torch.Tensor,  # (B,) int32
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Returns o (B, Hq, hd) in q's dtype."""
    _check(q, k, v, kv_len, window)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    B, Hq, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    grp = Hq // Hkv
    if B > 65535 or Hkv * -(-grp // heads_per_block(grp)) > 65535:
        raise ValueError(f"flash_decode: the grid takes B and Hkv·⌈grp/4⌉ up to 65535, "
                         f"got B {B}, Hkv {Hkv}, grp {grp}")
    item = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s * item % 16 for s in t.stride()[:-1]):
            raise ValueError(f"flash_decode: {name}'s rows must be 16-byte aligned on the card")
    n_split = n_splits(B, Hq, Hkv, S, window, sm_count(q.device.index or 0))
    o = torch.empty_like(q)
    # scratch: each split's m and l, then its (B, Hq, n_split, hd) accumulator
    part = torch.empty(B * Hq * n_split * (hd + 2), dtype=torch.float32, device=q.device)
    ml = B * Hq * n_split * 4
    with torch.cuda.device(q.device):
        err = _library().flash_decode_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), o.data_ptr(),
            part.data_ptr(), part.data_ptr() + ml, part.data_ptr() + 2 * ml,
            B, Hq, Hkv, S, hd, *k.stride()[:3], *v.stride()[:3],
            int(window is not None), 0 if window is None else int(window), n_split,
            sm_scale(hd), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    flash_decode_fwd.launches += 1
    return o


#: launches of the CUDA kernel in this process (plain-version calls not counted)
flash_decode_fwd.launches = 0


def flash_decode_plain(q, k, v, kv_len, *, window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain torch, any device: q scaled to f32
    before the product, unseen slots' scores to -1e30 and their p to 0, the
    sum divided by ``max(l, 1e-30)`` — so a row that sees no key gives 0."""
    B, Hq, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qs = (q.float() * sm_scale(hd)).reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bhgd,bhsd->bhgs", qs, k.float())
    pos = torch.arange(S, device=q.device)[None, :]
    kl = kv_len.to(device=q.device, dtype=torch.int64)[:, None]
    seen = pos < kl
    if window is not None:
        seen = seen & (pos > kl - 1 - window)
    seen = seen[:, None, None, :]
    s = torch.where(seen, s, torch.full_like(s, NEG_INF))
    p = torch.where(seen, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v.float()) / l
    return o.reshape(B, Hq, hd).to(q.dtype)


#: every kernel wrapper of this module, by name (each counts its launches)
KERNELS = {"flash_decode": flash_decode_fwd}
