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
from repro_torch.kernels.flash_attention.ref import alibi_scores, attention_alibi_ref

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
    S = ctypes.POINTER(ctypes.c_int64)  # a host array of (b, h, s) strides
    lib.flash_attention_alibi_fwd.argtypes = [P] * 7 + [I] * 5 + [S, ctypes.c_float, P]
    lib.flash_attention_alibi_fwd.restype = I
    lib.flash_attention_alibi_bwd.argtypes = [P] * 12 + [I] * 5 + [S, ctypes.c_float, P]
    lib.flash_attention_alibi_bwd.restype = I
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


# ---------------------------------------------------------------------------
# Causal ALiBi self-attention for training: forward and backward
# ---------------------------------------------------------------------------


def lse_len(s: int) -> int:
    """Rows of the log-sum-exp buffer: S rounded up to the kernels' 64-row tiles."""
    return -(-s // 64) * 64


def _check_alibi(q, k, v, slopes) -> None:
    """Raise unless q, k, v and slopes are a causal ALiBi self-attention call
    the kernels take (CPU tensors may be float32 too)."""
    _check(q, k, v, None, 0)
    B, Hq, S, _ = q.shape
    if k.shape[2] != S:
        raise ValueError(f"flash_attention_alibi: self-attention needs Sk == Sq, got "
                         f"{k.shape[2]} and {S}")
    if q.device.type == "cuda" and q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_alibi: the kernels take bfloat16, got {q.dtype}")
    if (slopes.dtype != torch.float32 or tuple(slopes.shape) != (Hq,)
            or slopes.device != q.device or not slopes.is_contiguous()):
        raise ValueError(f"flash_attention_alibi: slopes must be contiguous float32 ({Hq},) on "
                         f"{q.device}, got {slopes.dtype} {tuple(slopes.shape)} on {slopes.device}")
    if max(B, lse_len(S) // 64) > 65535:
        raise ValueError(f"flash_attention_alibi: the grid takes B and S / 64 up to 65535, "
                         f"got {B}, {S}")


def _stride_array(*tensors):
    """The (b, h, s) strides of each tensor, flat, as a host int64 array."""
    flat = [x for t in tensors for x in _strides(t)]
    return (ctypes.c_int64 * len(flat))(*flat)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: error {err} (a CUDA error; 1000 + n: "
                           f"cuTensorMapEncodeTiled refused a TMA tensor map)")


def flash_attention_alibi_fwd(
    q: torch.Tensor,  # (B, Hq, S, hd) bf16 (f32 too on the CPU)
    k: torch.Tensor,  # (B, Hkv, S, hd), q's dtype
    v: torch.Tensor,  # (B, Hkv, S, hd), q's dtype
    slopes: torch.Tensor,  # (Hq,) float32 on q's device
):
    """Causal self-attention with ALiBi: ``s[i][j] = scale * q[i].k[j] -
    slope[h] * (i - j)`` for j <= i. Returns ``(o, o_lo, lse)``: o (B, Hq, S,
    hd) in q's dtype, on the card a view of (B, S, Hq, hd) memory; o_lo, o's
    rounding residual (the f32 result less o, in o's dtype and layout), which
    the backward reads to form D = rowsum(dO * O) to about 16 bits; and each
    row's log-sum-exp (natural log, f32) in a (B, Hq, lse_len(S)) buffer whose
    rows past S are padding. One launch (``.launches``) on the card; the plain
    version on the CPU."""
    _check_alibi(q, k, v, slopes)
    if q.device.type == "cpu":
        return flash_attention_alibi_plain(q, k, v, slopes)
    B, Hq, S, hd = q.shape
    o, o_lo = (torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
               for _ in range(2))
    lse = torch.empty((B, Hq, lse_len(S)), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_alibi_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), o_lo.data_ptr(),
            lse.data_ptr(), slopes.data_ptr(), B, Hq, k.shape[1], S, hd,
            _stride_array(q, k, v, o), sm_scale(hd),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "flash_attention_alibi_fwd")
    flash_attention_alibi_fwd.launches += 1
    return o, o_lo, lse


#: launches of the forward kernel in this process (plain-version calls not counted)
flash_attention_alibi_fwd.launches = 0


def flash_attention_alibi_bwd(q, k, v, o, o_lo, lse, do, slopes):
    """The gradients of :func:`flash_attention_alibi_fwd`: ``(dq, dk, dv)``
    in q's dtype, each in model-layout memory (B, S, H, hd) seen as
    (B, H, S, hd), from the forward's inputs, its o, o_lo (o's strides) and
    lse, and dO (o's shape; any strides whose hd axis is contiguous and rows
    16-byte aligned). Two launches on the card (D and dq, then dk and dv; ``.launches`` counts
    both); the plain version on the CPU."""
    _check_alibi(q, k, v, slopes)
    for name, t in (("o", o), ("o_lo", o_lo), ("do", do)):
        if t.dtype != q.dtype or tuple(t.shape) != tuple(q.shape) or t.device != q.device:
            raise ValueError(f"flash_attention_alibi_bwd: {name} must be {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    B, Hq, S, hd = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, lse_len(S)) \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_alibi_bwd: lse must be the forward's contiguous "
                         f"float32 {(B, Hq, lse_len(S))}, got {lse.dtype} {tuple(lse.shape)}")
    _check(o, k, v, None, 0)
    _check(do, k, v, None, 0)
    if o_lo.stride() != o.stride():
        raise ValueError(f"flash_attention_alibi_bwd: o_lo must have o's strides {o.stride()}, "
                         f"got {o_lo.stride()}")
    if q.device.type == "cpu":
        return flash_attention_alibi_bwd_plain(q, k, v, o, o_lo, lse, do, slopes)
    Hkv = k.shape[1]
    dq = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, S, Hkv, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    dbuf = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_alibi_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), o_lo.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dbuf.data_ptr(), slopes.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, S, hd,
            _stride_array(q, k, v, o, do, dq, dk, dv),
            sm_scale(hd), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "flash_attention_alibi_bwd")
    flash_attention_alibi_bwd.launches += 2
    return dq, dk, dv


#: launches of the two backward kernels in this process (plain-version calls not counted)
flash_attention_alibi_bwd.launches = 0


def flash_attention_alibi_plain(q, k, v, slopes):
    """The forward's function in plain torch, f32 throughout: ``(o in q's
    dtype, its residual o_lo, lse padded to lse_len(S) rows with zeros)``."""
    S = q.shape[2]
    with torch.no_grad():
        o32, lse = attention_alibi_ref(q, k, v, slopes)
    o = o32.to(q.dtype)
    return o, (o32 - o.float()).to(q.dtype), torch.nn.functional.pad(lse, (0, lse_len(S) - S))


def flash_attention_alibi_bwd_plain(q, k, v, o, o_lo, lse, do, slopes):
    """The backward kernels' algorithm in plain torch, f32 throughout: P
    recomputed from the scores and the forward's lse, D = rowsum(dO * (o +
    o_lo)), dS = P * (dP - D); dk and dv summed over the query heads of each
    kv head."""
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    grp = Hq // Hkv
    scale = sm_scale(hd)
    with torch.no_grad():
        s, seen = alibi_scores(q, k, slopes)
        p = torch.where(seen, torch.exp(s - lse[..., :S].reshape(B, Hkv, grp, S, 1)),
                        torch.zeros_like(s))
        dof = do.float().reshape(B, Hkv, grp, S, hd)
        o32 = (o.float() + o_lo.float()).reshape(B, Hkv, grp, S, hd)
        d = (dof * o32).sum(-1, keepdim=True)
        dp = torch.einsum("bhgqd,bhsd->bhgqs", dof, v.float())
        ds = p * (dp - d)
        dq = torch.einsum("bhgqs,bhsd->bhgqd", ds, k.float()) * scale
        dk = torch.einsum("bhgqs,bhgqd->bhsd", ds, q.float().reshape(B, Hkv, grp, S, hd)) * scale
        dv = torch.einsum("bhgqs,bhgqd->bhsd", p, dof)
    return dq.reshape(B, Hq, S, hd).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


#: every kernel wrapper of this module, by name (each counts its launches)
KERNELS = {"flash_attention": flash_attention_fwd,
           "flash_attention_alibi_fwd": flash_attention_alibi_fwd,
           "flash_attention_alibi_bwd": flash_attention_alibi_bwd}
