"""Flash attention forward as a CUDA kernel for Hopper, and its plain PyTorch
version.

:func:`flash_attention_fwd` replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_fwd`` and keeps its
function: q (B, Hq, Sq, hd), k and v (B, Hkv, Sk, hd), bf16 or f32, GQA by
``h // (Hq // Hkv)``, causal and sliding-window masks at absolute query
positions ``q_offset + i``, f32 accumulation, the output in q's dtype. A query
row that sees no key gives 0 (the kernel divides by ``max(l, 1e-30)``;
``ref.attention_ref`` would give the mean of v there). hd is 64 or 128. The
inputs may be any strided views whose hd axis is contiguous and whose rows
are 16-byte aligned, such as the model's (B, S, H, hd) tensors transposed:
the kernel reads them in place. o is allocated in (B, Sq, Hq, hd) memory and
returned as its (B, Hq, Sq, hd) view. The CUDA source is
``src/repro_torch/csrc/flash_attention.cu``: a tensor-core kernel (wgmma, TMA)
for bf16 and a CUDA-core kernel for f32; it says what bounds each and how a
block walks its key tiles. It is built at first use by ``kernels/build.py``
and bound with ``ctypes``.

A tensor on the CPU goes to :func:`flash_attention_plain`; a CUDA tensor
launches the kernel or raises — there is no fallback.
``flash_attention_fwd.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.build import CSRC, build

SOURCE = CSRC / "flash_attention.cu"
NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPES = (torch.bfloat16, torch.float32)
_INT32 = (-(1 << 31), (1 << 31) - 1)
_ALIGN = 16  # bytes: TMA's alignment of a row and of each stride


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build(SOURCE)[0]))
    P, I = ctypes.c_void_p, ctypes.c_int
    L = ctypes.c_int64
    lib.flash_attention_fwd.argtypes = ([P] * 4 + [I] * 6 + [L] * 12 + [I] * 4
                                        + [ctypes.c_float, I, P])
    lib.flash_attention_fwd.restype = I
    return lib


def sm_scale(hd: int) -> float:
    """``1 / hd ** 0.5`` as the float32 the TPU kernel multiplies q by."""
    return float(np.float32(1.0 / hd ** 0.5))


def _strides(t: torch.Tensor):
    """(b, h, s) strides of a 4-d tensor in elements; an axis of size 1 gets
    its contiguous stride (any stride addresses it, and TMA wants a valid one)."""
    (sb, sh, ss, _), (B, H, S, hd) = t.stride(), t.shape
    return sb if B > 1 else H * S * hd, sh if H > 1 else S * hd, ss if S > 1 else hd


def _check(q, k, v, window, q_offset) -> None:
    """Raise unless the inputs have the kernel's layout, dtypes and ranges."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention: q, k, v must be 4-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q must be bfloat16 or float32, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim must be one of {HEAD_DIMS}, got {hd}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must be {q.dtype}, got {t.dtype}")
        if tuple(t.shape) != (B, Hkv, Sk, hd):
            raise ValueError(f"flash_attention: {name} must have shape {(B, Hkv, Sk, hd)}, "
                             f"got {tuple(t.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s hd axis must be contiguous, "
                             f"got strides {t.stride()}")
        size = t.element_size()
        if t.data_ptr() % _ALIGN or any(st * size % _ALIGN for st in _strides(t)):
            raise ValueError(f"flash_attention: {name}'s rows must be {_ALIGN}-byte aligned, "
                             f"got strides {t.stride()} at offset {t.data_ptr() % _ALIGN}")
    if min(B, Hq, Sq, Hkv, Sk) < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: need nonempty inputs and Hq % Hkv == 0, got "
                         f"B {B}, Hq {Hq}, Sq {Sq}, Hkv {Hkv}, Sk {Sk}")
    for name, x in (("window", window), ("q_offset", q_offset)):
        if x is not None and not _INT32[0] <= x <= _INT32[1]:
            raise ValueError(f"flash_attention: {name} = {x} does not fit in int32")


def flash_attention_fwd(
    q: torch.Tensor,  # (B, Hq, Sq, hd) bf16 | f32
    k: torch.Tensor,  # (B, Hkv, Sk, hd), q's dtype
    v: torch.Tensor,  # (B, Hkv, Sk, hd), q's dtype
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Returns o (B, Hq, Sq, hd) in q's dtype: on the card a view of
    (B, Sq, Hq, hd) memory."""
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if max(B, Hq) > 65535:
        raise ValueError(f"flash_attention: the grid takes B and Hq up to 65535, got {B}, {Hq}")
    o = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Sq, Sk, hd, *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            int(bool(causal)), int(window is not None),
            0 if window is None else int(window), int(q_offset), sm_scale(hd),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: error {err} (a CUDA error; "
                           f"1000 + n: the driver refused a TMA tensor map)")
    flash_attention_fwd.launches += 1
    return o


#: launches of the CUDA kernel in this process (plain-version calls not counted)
flash_attention_fwd.launches = 0


def flash_attention_plain(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """The kernel's function in plain torch, any device: q scaled to f32
    before the product, masked scores to -1e30, p zeroed where masked, the
    sum divided by ``max(l, 1e-30)`` — so a row that sees no key gives 0."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qs = (q.float() * sm_scale(hd)).reshape(B, Hkv, Hq // Hkv, Sq, hd)
    s = torch.einsum("bhgqd,bhsd->bhgqs", qs, k.float())
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    seen = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        seen = seen & (k_pos <= q_pos)
    if window is not None:
        seen = seen & (q_pos - k_pos < window)
    s = torch.where(seen, s, torch.full_like(s, NEG_INF))
    p = torch.where(seen, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgqs,bhsd->bhgqd", p, v.float()) / l
    return o.reshape(B, Hq, Sq, hd).to(q.dtype)


#: every kernel wrapper of this module, by name (each counts its launches)
KERNELS = {"flash_attention": flash_attention_fwd}
