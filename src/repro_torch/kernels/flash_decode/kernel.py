"""Flash decode (one query token against a long KV cache) as a CUDA kernel for
Hopper, and its plain PyTorch version.

:func:`flash_decode_fwd` replaces the Pallas TPU kernel
``repro/kernels/flash_decode/kernel.py::flash_decode_fwd`` and keeps its
layout and its function: q (B, Hq, hd), k and v (B, Hkv, S, hd), bf16 or f32,
kv_len (B,) int32 or one Python int for every row; GQA by ``h // (Hq // Hkv)``; row b sees the cache slots
``pos < kv_len[b]`` and, with a window, ``pos > kv_len[b] - 1 - window``; q is
scaled to f32 by ``1/sqrt(hd)`` before the product, the softmax accumulates
in f32 and the output is in q's dtype. A row that sees no key gives 0 (the
kernel divides by ``max(l, 1e-30)``; ``ref.decode_attention_ref`` would give
the mean of v there). hd is 32, 64, 128 or 256; any S (the reference needs a
kv block that divides S). k and v may be strided views — the model's
(B, S, Hkv, hd) cache with its head axis moved is read in place — as long as
each row of hd values is contiguous and every stride and base 16-byte
aligned on the card (the kernel reads the cache with TMA). A Python int
kv_len reaches the kernel as an argument: no device tensor is made per call.

The CUDA source is ``src/repro_torch/csrc/flash_decode.cu``; it says what
bounds the kernel (bytes), how a producer warp stages the cache through
shared memory, and how the seen keys of a row are split over blocks and
merged again. It is built at first use by ``kernels/build.py`` and
bound with ``ctypes``.

A tensor on the CPU goes to :func:`flash_decode_plain`; a CUDA tensor
launches the kernel or raises — there is no fallback.
``flash_decode_fwd.launches`` counts the launches (one per call: the split
pass and the merge pass that follows it).
"""
from __future__ import annotations

import ctypes
import functools
import operator
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.kernels.build import CSRC, build

SOURCE = CSRC / "flash_decode.cu"
NEG_INF = -1e30
LOG2E = 1.4426950408889634
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = (torch.bfloat16, torch.float32)
_INT32 = (-(1 << 31), (1 << 31) - 1)
_ALIGN = 16  # bytes: TMA's alignment of the base and of each stride
#: the fewest seen keys a split is given, and the blocks per SM the splits aim at
MIN_SPLIT_KEYS, BLOCKS_PER_SM = 64, 8


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build(SOURCE)[0]))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_decode_fwd.argtypes = ([P] * 8 + [I] * 5 + [L] * 6 + [I] * 4
                                     + [ctypes.c_float, I, P])
    lib.flash_decode_fwd.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_scale(hd: int) -> float:
    """``1 / hd ** 0.5`` as the float32 the TPU kernel multiplies q by."""
    return float(np.float32(1.0 / hd ** 0.5))


@functools.lru_cache(maxsize=None)
def scale_log2(hd: int) -> float:
    """``sm_scale(hd) * log2(e)`` in float32: the kernel's exponentials are 2^x."""
    return float(np.float32(sm_scale(hd)) * np.float32(LOG2E))


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


def _kv_len_int(kv_len) -> Optional[int]:
    """kv_len as a Python int when it is an integer (a Python or numpy int,
    in int32), None when it is a tensor; anything else is refused."""
    if type(kv_len) is int and _INT32[0] <= kv_len <= _INT32[1]:
        return kv_len
    if isinstance(kv_len, torch.Tensor):
        return None
    if isinstance(kv_len, bool):
        raise ValueError("flash_decode: kv_len must be an int or a (B,) int32 tensor, got a bool")
    try:
        n = operator.index(kv_len)
    except TypeError:
        raise ValueError(f"flash_decode: kv_len must be an int or a (B,) int32 tensor, "
                         f"got {type(kv_len).__name__}") from None
    if not _INT32[0] <= n <= _INT32[1]:
        raise ValueError(f"flash_decode: kv_len = {n} does not fit in int32")
    return n


def _check_layout(q_shape, q_contiguous, q_dtype, k_shape, k_stride, k_dtype, v_shape, v_stride,
                  v_dtype, q_device, k_device, v_device, kv_meta, window) -> None:
    """The checks that depend only on shapes, strides, dtypes and devices;
    ``kv_meta`` is None for an int kv_len, else the tensor's (shape, dtype,
    contiguous, device)."""
    B, Hq, hd = q_shape
    Hkv, S = k_shape[1], k_shape[2]
    if q_dtype not in _DTYPES:
        raise ValueError(f"flash_decode: q must be bfloat16 or float32, got {q_dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim must be one of {HEAD_DIMS}, got {hd}")
    for name, shape, stride, dtype in (("k", k_shape, k_stride, k_dtype),
                                       ("v", v_shape, v_stride, v_dtype)):
        if dtype != q_dtype:
            raise ValueError(f"flash_decode: {name} must be {q_dtype}, got {dtype}")
        if shape != (B, Hkv, S, hd):
            raise ValueError(f"flash_decode: {name} must have shape {(B, Hkv, S, hd)}, "
                             f"got {shape}")
        if stride[3] != 1:
            raise ValueError(f"flash_decode: {name} must be contiguous along hd")
    devices = [("k", k_device), ("v", v_device)]
    if kv_meta is not None:
        shape, dtype, contiguous, device = kv_meta
        if dtype != torch.int32 or shape != (B,):
            raise ValueError(f"flash_decode: kv_len must be ({B},) int32, got {shape} {dtype}")
        if not contiguous:
            raise ValueError("flash_decode: kv_len must be contiguous")
        devices.append(("kv_len", device))
    for name, dev in devices:
        if dev != q_device:
            raise ValueError(f"flash_decode: {name} is on {dev}, q on {q_device}")
    if not q_contiguous:
        raise ValueError("flash_decode: q must be contiguous")
    if min(B, Hq, Hkv, S) < 1 or Hq % Hkv or S > _INT32[1]:
        raise ValueError(f"flash_decode: need nonempty inputs, Hq % Hkv == 0 and S < 2**31, "
                         f"got B {B}, Hq {Hq}, Hkv {Hkv}, S {S}")
    if window is not None and not _INT32[0] <= window <= _INT32[1]:
        raise ValueError(f"flash_decode: window = {window} does not fit in int32")


@functools.lru_cache(maxsize=1024)
def _plan(q_shape, q_contiguous, q_dtype, k_shape, k_stride, k_dtype, v_shape, v_stride, v_dtype,
          q_device, k_device, v_device, kv_meta, window) -> Optional[tuple]:
    """Check a layout (cached: one that passed once passes again; one that
    fails raises on every call) and, on the card, compute the launch's
    constant arguments: ((B, Hq, Hkv, S, hd, k strides, v strides),
    (has_window, window, n_split, scale, is_bf16), the scratch's floats, the
    bytes of its m (and of its l) array, device index)."""
    _check_layout(q_shape, q_contiguous, q_dtype, k_shape, k_stride, k_dtype, v_shape, v_stride,
                  v_dtype, q_device, k_device, v_device, kv_meta, window)
    if q_device.type != "cuda":
        return None
    (B, Hq, hd), (_, Hkv, S, _) = q_shape, k_shape
    grp = Hq // Hkv
    if B > 65535 or Hkv * -(-grp // heads_per_block(grp)) > 65535:
        raise ValueError(f"flash_decode: the grid takes B and Hkv·⌈grp/4⌉ up to 65535, "
                         f"got B {B}, Hkv {Hkv}, grp {grp}")
    item = 2 if q_dtype == torch.bfloat16 else 4
    ks, vs = (_strides(st, (B, Hkv, S, hd)) for st in (k_stride, v_stride))
    for name, st in (("q", (hd,)), ("k", ks), ("v", vs)):
        if any(x * item % _ALIGN for x in st):
            raise ValueError(f"flash_decode: {name}'s rows must be 16-byte aligned on the card")
    index = q_device.index if q_device.index is not None else torch.cuda.current_device()
    n_split = n_splits(B, Hq, Hkv, S, window, sm_count(index))
    shape = (B, Hq, Hkv, S, hd, *ks, *vs)
    tail = (int(window is not None), 0 if window is None else int(window), n_split,
            scale_log2(hd), int(q_dtype == torch.bfloat16))
    return shape, tail, B * Hq * n_split * (hd + 2), B * Hq * n_split * 4, index


def _strides(stride, shape):
    """(b, h, s) strides of a (B, H, S, hd) tensor in elements; an axis of
    size 1 gets its contiguous stride (any stride addresses it, and TMA wants
    an aligned one)."""
    (sb, sh, ss, _), (B, H, S, hd) = stride, shape
    return sb if B > 1 else H * S * hd, sh if H > 1 else S * hd, ss if S > 1 else hd


def _stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as an integer handle (the
    value of ``torch.cuda.current_stream(index).cuda_stream``, without
    building a Stream object: a few µs of host time less per call)."""
    return torch._C._cuda_getCurrentRawStream(index)


def flash_decode_fwd(
    q: torch.Tensor,  # (B, Hq, hd) bf16 | f32
    k: torch.Tensor,  # (B, Hkv, S, hd), q's dtype
    v: torch.Tensor,  # (B, Hkv, S, hd), q's dtype
    kv_len: Union[torch.Tensor, int],  # (B,) int32, or one int for every row
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Returns o (B, Hq, hd) in q's dtype."""
    if q.ndim != 3 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_decode: q must be 3-d and k, v 4-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return _run(q, tuple(q.shape), k, tuple(k.shape), k.stride(), v, tuple(v.shape), v.stride(),
               kv_len, window)


def _run(q, q_shape, k, k_shape, k_stride, v, v_shape, v_stride, kv_len, window):
    """The launch behind :func:`flash_decode_fwd` and ``ops.flash_decode``
    (its only callers), on shapes and strides instead of views (each view
    costs the host about 2 µs): q's memory holds (B, Hq, hd)
    contiguously whatever q's own shape (``q_shape``), k and v are read as
    (B, Hkv, S, hd) through the strides given, and o is allocated like q."""
    n_all = _kv_len_int(kv_len)
    kv_meta = None if n_all is not None else (tuple(kv_len.shape), kv_len.dtype,
                                              kv_len.is_contiguous(), kv_len.device)
    dev = q.device
    plan = _plan(q_shape, q.is_contiguous(), q.dtype, k_shape, k_stride, k.dtype, v_shape,
                 v_stride, v.dtype, dev, k.device, v.device, kv_meta, window)
    if plan is None:
        if dev.type != "cpu":
            raise ValueError(f"flash_decode runs on cuda or cpu, not {dev}")
        k, v = (torch.as_strided(t, shape, stride, t.storage_offset())
                for t, shape, stride in ((k, k_shape, k_stride), (v, v_shape, v_stride)))
        o = flash_decode_plain(q.reshape(q_shape), k, v, kv_len, window=window)
        return o.reshape(q.shape)
    shape, tail, part_floats, ml, index = plan
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % _ALIGN:
        raise ValueError("flash_decode: q's, k's and v's rows must be 16-byte aligned on the card")
    o = torch.empty_like(q)
    # scratch: each split's m and l, then its (B, Hq, n_split, hd) accumulator
    part = torch.empty(part_floats, dtype=torch.float32, device=dev)
    pp = part.data_ptr()
    args = (qp, kp, vp, 0 if n_all is not None else kv_len.data_ptr(), o.data_ptr(),
            pp, pp + ml, pp + 2 * ml, *shape, 0 if n_all is None else n_all, *tail)
    if index == torch.cuda.current_device():
        err = _library().flash_decode_fwd(*args, _stream(index))
    else:
        with torch.cuda.device(index):
            err = _library().flash_decode_fwd(*args, _stream(index))
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: error {err} (a CUDA error; "
                           f"1000 + n: the driver refused a TMA tensor map)")
    flash_decode_fwd.launches += 1
    return o


#: launches of the CUDA kernel in this process (plain-version calls not counted)
flash_decode_fwd.launches = 0


def flash_decode_plain(q, k, v, kv_len, *, window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain torch, any device: q scaled to f32
    before the product, unseen slots' scores to -1e30 and their p to 0, the
    sum divided by ``max(l, 1e-30)`` — so a row that sees no key gives 0.
    kv_len is a (B,) tensor or one int for every row."""
    B, Hq, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qs = (q.float() * sm_scale(hd)).reshape(B, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bhgd,bhsd->bhgs", qs, k.float())
    pos = torch.arange(S, device=q.device)[None, :]
    kl = torch.as_tensor(kv_len, device=q.device).to(torch.int64).broadcast_to((B,))[:, None]
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
