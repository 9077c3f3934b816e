"""The fused federation kernels as CUDA kernels for Hopper, and their plain
PyTorch versions.

:func:`server_apply` replaces the Pallas TPU kernel
``repro/kernels/fedcore/kernel.py::server_apply``: one pass over the flat
``(C, Np)`` float32 delta buffer computes the weighted client mean (+ optional
pre-drawn DP noise), the FedAvg / FedMom / FedAdam update of the params and
optimizer lanes, and the squared norms of the pseudo-gradient, of the new
params and of each client's delta. The CUDA source is
``src/repro_torch/csrc/fedcore_server_apply.cu``; it says what bounds the
kernel (memory: ``(C + 2 + 2L)·4·Np`` bytes for L lanes) and how its
reductions stay deterministic.

The uplink codec kernels replace the reference's ``topk_mask_ef``,
``sr_bf16``, ``int8_quant`` and ``int8_dequant``; their source is
``src/repro_torch/csrc/fedcore_codecs.cu``. Each takes the packed cohort
buffer ``(C, Np)`` in one launch (the reference launches per client, and for
int8 per leaf): a (C,) threshold vector for top-k, a (C, leaves) scale table
with the leaves' offsets for int8. Each is bitwise equal to its plain version.

Each source is compiled at first use by ``kernels/build.py`` and bound with
``ctypes`` through a plain C interface. A tensor on the CPU goes to the plain
version; a CUDA tensor launches the kernel or raises — there is no fallback.
Each wrapper counts its launches in ``.launches``, under a lock: the socket
runtime's worker threads launch the codec kernels concurrently.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.compression import quantize_int8, sr_bf16_bits
from repro_torch.core.outer_opt import OUTER_LANES
from repro_torch.kernels.build import CSRC, build

OPTS = {"fedavg": 0, "fedmom": 1, "fedadam": 2}
N_LANES = {name: len(lanes) for name, lanes in OUTER_LANES.items()}
CHUNK = 32  # clients per launch of the server kernel (register accumulators)
GRID = 1024  # blocks of the server kernel; fixed, so the reduction order is too
CODEC_GRID = 8 * 132  # codec kernels' grid cap: 8 blocks of 256 per SM (full occupancy)
_THREADS = 256

SOURCE = CSRC / "fedcore_server_apply.cu"
_COUNT_LOCK = threading.Lock()
CODEC_SOURCE = CSRC / "fedcore_codecs.cu"


def _count(wrapper) -> None:
    with _COUNT_LOCK:
        wrapper.launches += 1


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build(SOURCE)[0]))
    fn = lib.fedcore_server_apply
    fn.argtypes = (
        [ctypes.c_void_p] * 9
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_float] * 8
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _codec_library():
    lib = ctypes.CDLL(str(build(CODEC_SOURCE)[0]))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    sigs = {
        "fedcore_topk_mask_ef": [P, P, P, P, LL, LL, I, P],
        "fedcore_sr_bf16": [P, P, P, LL, I, P],
        "fedcore_int8_quant": [P, P, P, I, P, LL, LL, I, P],
        "fedcore_int8_dequant": [P, P, P, I, P, LL, LL, I, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(deltas2d, wn, params_flat, lanes, opt, bias_corr, noise) -> None:
    if opt not in OPTS:
        raise ValueError(f"unknown outer optimizer {opt!r}")
    if len(lanes) != N_LANES[opt]:
        raise ValueError(f"{opt} takes {N_LANES[opt]} optimizer lanes, got {len(lanes)}")
    if opt == "fedadam" and bias_corr is None:
        raise ValueError("fedadam needs its bias corrections")
    if deltas2d.ndim != 2:
        raise ValueError(f"deltas must be (C, Np), got {tuple(deltas2d.shape)}")
    C, Np = deltas2d.shape
    if C < 1:
        raise ValueError("the kernel needs at least one client")
    if Np % 4:
        raise ValueError(f"Np must be a multiple of 4, got {Np}")
    named = [("deltas", deltas2d, (C, Np)), ("wn", wn, (C,)), ("params", params_flat, (Np,))]
    named += [(f"lane{i}", x, (Np,)) for i, x in enumerate(lanes)]
    if noise is not None:
        named.append(("noise", noise, (Np,)))
    for name, x, shape in named:
        if x.device != deltas2d.device:
            raise ValueError(f"{name} is on {x.device}, deltas on {deltas2d.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for float4 loads")


def server_apply(
    deltas2d: torch.Tensor,  # (C, Np) float32 — packed client deltas
    wn: torch.Tensor,  # (C,) float32 — weights already divided by their sum
    params_flat: torch.Tensor,  # (Np,) float32 — packed params, updated in place
    lanes: Sequence[torch.Tensor],  # outer-optimizer lanes (Np,), updated in place
    *,
    opt: str,  # 'fedavg' | 'fedmom' | 'fedadam'
    lr: float,
    momentum: float = 0.9,
    nesterov: bool = True,
    beta2: float = 0.99,
    eps: float = 1e-8,
    bias_corr: Optional[Tuple[float, float]] = None,  # fedadam (b1c, b2c)
    noise: Optional[torch.Tensor] = None,  # (Np,) float32 pre-scaled DP noise
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused pass. Writes the new params and lanes over ``params_flat`` and
    ``lanes`` and returns ``(pg_sq (), newp_sq (), delta_sq (C,))``."""
    if deltas2d.device.type == "cpu":
        return server_apply_plain(
            deltas2d, wn, params_flat, lanes, opt=opt, lr=lr, momentum=momentum,
            nesterov=nesterov, beta2=beta2, eps=eps, bias_corr=bias_corr, noise=noise,
        )
    if deltas2d.device.type != "cuda":
        raise ValueError(f"server_apply runs on cuda or cpu, not {deltas2d.device}")
    _check(deltas2d, wn, params_flat, lanes, opt, bias_corr, noise)
    C, Np = deltas2d.shape
    fn = _library()
    grid = max(1, min(GRID, -(-(Np // 4) // _THREADS)))
    dev = deltas2d.device
    partials = torch.empty(grid * (2 + C), dtype=torch.float64, device=dev)
    out = torch.empty(2 + C, dtype=torch.float32, device=dev)
    # the running client sum between chunks of CHUNK clients (C > CHUNK only)
    scratch = torch.empty(Np, dtype=torch.float32, device=dev) if C > CHUNK else None
    lane0 = lanes[0].data_ptr() if len(lanes) > 0 else None
    lane1 = lanes[1].data_ptr() if len(lanes) > 1 else None
    b1c, b2c = bias_corr if bias_corr is not None else (1.0, 1.0)
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            deltas2d.data_ptr(), wn.data_ptr(), params_flat.data_ptr(), lane0, lane1,
            noise.data_ptr() if noise is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            partials.data_ptr(), out.data_ptr(),
            Np, C, OPTS[opt], int(bool(nesterov)),
            lr, momentum, f32(1.0 - momentum), beta2, f32(1.0 - beta2), eps, b1c, b2c,
            grid, stream,
        )
    if err != 0:
        raise RuntimeError(f"fedcore server_apply launch failed: CUDA error {err}")
    _count(server_apply)
    return out[0], out[1], out[2:]


#: launches of the CUDA kernel in this process (plain-version calls not counted)
server_apply.launches = 0


@torch.no_grad()
def server_apply_plain(
    deltas2d, wn, params_flat, lanes, *, opt, lr, momentum=0.9, nesterov=True,
    beta2=0.99, eps=1e-8, bias_corr=None, noise=None,
):
    """The same function in plain torch: the reference's flat chain
    (``repro/kernels/fedcore/ops.py`` non-Pallas branch) op for op, any float
    dtype. Same in-place contract and return value as :func:`server_apply`."""
    # Σ_c wn_c·Δ_c client by client, the order the kernel sums in: the
    # reference leaves the order open, and FedAdam's division by sqrt(v)
    # magnifies a reassociated last bit where the moments are small
    pg = deltas2d[0] * wn[0]
    for c in range(1, deltas2d.shape[0]):
        pg = pg + deltas2d[c] * wn[c]
    if noise is not None:
        pg = pg + noise
    p32 = params_flat.float()
    if opt == "fedavg":
        new_p32 = p32 - lr * pg
        new_lanes32 = []
    elif opt == "fedmom":
        m = lanes[0].float()
        new_m = momentum * m + pg
        upd = momentum * new_m + pg if nesterov else new_m
        new_p32 = p32 - lr * upd
        new_lanes32 = [new_m]
    elif opt == "fedadam":
        m = lanes[0].float()
        v = lanes[1].float()
        b1c, b2c = bias_corr
        new_m = momentum * m + (1.0 - momentum) * pg
        new_v = beta2 * v + (1.0 - beta2) * torch.square(pg)
        new_p32 = p32 - lr * (new_m / b1c) / (torch.sqrt(new_v / b2c) + eps)
        new_lanes32 = [new_m, new_v]
    else:
        raise ValueError(f"unknown outer optimizer {opt!r}")
    params_flat.copy_(new_p32.to(params_flat.dtype))
    for lane, new in zip(lanes, new_lanes32):
        lane.copy_(new.to(lane.dtype))
    pg_sq = torch.sum(torch.square(pg))
    newp_sq = torch.sum(torch.square(params_flat.float()))
    delta_sq = torch.sum(torch.square(deltas2d), dim=1)
    return pg_sq, newp_sq, delta_sq


# ---------------------------------------------------------------------------
# Uplink codec kernels (csrc/fedcore_codecs.cu)
# ---------------------------------------------------------------------------


def _check_codec(name: str, named, rows_n: Optional[Tuple[int, int]] = None) -> None:
    """Raise unless every ``(label, tensor, dtype, shape)`` is a contiguous
    CUDA tensor of that dtype and shape on one device, 16-byte aligned, with
    a last dimension that is a positive multiple of 4."""
    dev = named[0][1].device
    for label, x, dtype, shape in named:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: {label} is on {x.device}, expected {dev} (cuda)")
        if x.dtype != dtype:
            raise ValueError(f"{name}: {label} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} must have shape {tuple(shape)}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    if rows_n is not None and (rows_n[0] < 1 or rows_n[1] < 4 or rows_n[1] % 4):
        raise ValueError(f"{name}: rows must be >= 1 and the row length a positive "
                         f"multiple of 4, got {rows_n}")


def _launch(name: str, *args) -> None:
    err = getattr(_codec_library(), f"fedcore_{name}")(*args)
    if err != 0:
        raise RuntimeError(f"fedcore {name} launch failed: CUDA error {err}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def topk_mask_ef(xf: torch.Tensor, thresh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k mask + error feedback over the packed cohort: ``xf`` (C, Np)
    float32 (delta + residual), ``thresh`` (C,) float32, each row's k-th
    magnitude. Returns ``(kept, resid)``: kept = where(|xf| >= t, xf, 0),
    resid = xf − kept (+0.0 where kept, xf where dropped). One launch for the
    cohort."""
    if xf.device.type == "cpu":
        return topk_mask_ef_plain(xf, thresh)
    if xf.ndim != 2:
        raise ValueError(f"topk_mask_ef: xf must be (C, Np), got {tuple(xf.shape)}")
    C, Np = xf.shape
    _check_codec("topk_mask_ef", [("xf", xf, torch.float32, None),
                                  ("thresh", thresh, torch.float32, (C,))], (C, Np))
    kept, resid = torch.empty_like(xf), torch.empty_like(xf)
    with torch.cuda.device(xf.device):
        _launch("topk_mask_ef", xf.data_ptr(), thresh.data_ptr(), kept.data_ptr(),
                resid.data_ptr(), C, Np, CODEC_GRID, _stream(xf.device))
    _count(topk_mask_ef)
    return kept, resid


topk_mask_ef.launches = 0


def topk_mask_ef_plain(xf: torch.Tensor, thresh: torch.Tensor):
    """The same function in plain torch, any leading shape: ``thresh`` has
    one value per row (shape ``xf.shape[:-1]``)."""
    keep = torch.abs(xf) >= thresh.reshape(tuple(thresh.shape) + (1,))
    kept = torch.where(keep, xf, torch.zeros_like(xf))
    # xf − kept: xf − xf where kept; xf itself where dropped, which is xf − 0
    # bit for bit except that a NaN keeps its payload, as XLA's select does
    return kept, torch.where(keep, xf - xf, xf)


def sr_bf16(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding to bf16 by bits: the high half of
    ``(bits(x) + noise) & 0xFFFF0000`` (uint32 wrap), ``noise`` int32 in
    [0, 2¹⁶) of ``x``'s shape. A NaN result is the canonical ±0x7FC0. One
    launch over the whole buffer (the cohort's rows together)."""
    if x.device.type == "cpu":
        return sr_bf16_plain(x, noise)
    _check_codec("sr_bf16", [("x", x, torch.float32, None),
                             ("noise", noise, torch.int32, tuple(x.shape))])
    if x.numel() < 4 or x.numel() % 4:
        raise ValueError(f"sr_bf16: the element count must be a positive multiple of 4, "
                         f"got {x.numel()}")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        _launch("sr_bf16", x.data_ptr(), noise.data_ptr(), out.data_ptr(), x.numel(),
                CODEC_GRID, _stream(x.device))
    _count(sr_bf16)
    return out


sr_bf16.launches = 0


#: the plain version: ``compression.sr_bf16_bits``, the arithmetic the
#: per-leaf ``cast_compress`` runs too (int64 bit work, NaN → ±0x7FC0)
sr_bf16_plain = sr_bf16_bits


def _check_int8(name, data, data_dtype, scales, offsets):
    if data.ndim != 2:
        raise ValueError(f"{name}: expected a (C, Np) buffer, got {tuple(data.shape)}")
    C, Np = data.shape
    L = len(offsets) - 1
    if L < 1 or offsets[0] != 0 or any(b < a for a, b in zip(offsets, offsets[1:])) \
            or offsets[-1] > Np:
        raise ValueError(f"{name}: offsets must rise from 0 to at most {Np}, got {offsets}")
    _check_codec(name, [("data", data, data_dtype, None),
                        ("scales", scales, torch.float32, (C, L))], (C, Np))
    return C, Np, L, _device_offsets(tuple(offsets), data.device)


@functools.lru_cache(maxsize=None)
def _device_offsets(offsets: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The leaf offsets as an int64 tensor on the card, copied once per layout
    and device: a copy from pageable host memory would stall the host on
    every launch."""
    return torch.tensor(offsets, dtype=torch.int64, device=device)


def int8_quant(x: torch.Tensor, scales: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """Per-(client, leaf) symmetric int8 over the packed cohort: ``x`` (C, Np)
    float32, ``scales`` (C, L) float32, ``offsets`` the L+1 leaf boundaries
    in a row. q = clip(round_half_even(x/scale), −127, 127); 0 for a NaN (as
    XLA's saturating convert gives) and past the last leaf. One launch for
    every client and leaf."""
    if x.device.type == "cpu":
        return int8_quant_plain(x, scales, offsets)
    C, Np, L, off = _check_int8("int8_quant", x, torch.float32, scales, offsets)
    q = torch.empty((C, Np), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        _launch("int8_quant", x.data_ptr(), scales.data_ptr(), off.data_ptr(), L,
                q.data_ptr(), C, Np, CODEC_GRID, _stream(x.device))
    _count(int8_quant)
    return q


int8_quant.launches = 0


def int8_quant_plain(x, scales, offsets):
    q = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
    for l, (a, b) in enumerate(zip(offsets, offsets[1:])):
        q[:, a:b] = quantize_int8(x[:, a:b], scales[:, l:l + 1])
    return q


def int8_dequant(q: torch.Tensor, scales: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """q·scale over the packed cohort, the inverse layout of :func:`int8_quant`:
    (C, Np) float32, 0.0 past the last leaf — the buffer ``server_apply``
    reads. One launch for every client and leaf."""
    if q.device.type == "cpu":
        return int8_dequant_plain(q, scales, offsets)
    C, Np, L, off = _check_int8("int8_dequant", q, torch.int8, scales, offsets)
    out = torch.empty((C, Np), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("int8_dequant", q.data_ptr(), scales.data_ptr(), off.data_ptr(), L,
                out.data_ptr(), C, Np, CODEC_GRID, _stream(q.device))
    _count(int8_dequant)
    return out


int8_dequant.launches = 0


def int8_dequant_plain(q, scales, offsets):
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for l, (a, b) in enumerate(zip(offsets, offsets[1:])):
        out[:, a:b] = q[:, a:b].float() * scales[:, l:l + 1]
    return out


#: every kernel wrapper of this module, by name (each counts its launches)
KERNELS = {f.__name__: f for f in (server_apply, topk_mask_ef, sr_bf16, int8_quant,
                                   int8_dequant)}
