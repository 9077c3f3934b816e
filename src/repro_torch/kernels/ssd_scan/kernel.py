"""The Mamba2 SSD chunk scan as a CUDA kernel for Hopper, and its plain
PyTorch version.

:func:`ssd_scan_fwd` replaces the Pallas TPU kernel
``repro/kernels/ssd_scan/kernel.py::ssd_scan_fwd`` and keeps its layout: x
(B, nh, S, hd), dt (B, nh, S) f32, A (nh,) f32, Bm/Cm (B, G, S, ds),
init_state (B, nh, hd, ds) f32; it returns y in x's dtype and the final state
in f32. The CUDA source is ``src/repro_torch/csrc/ssd_scan.cu``; it says what
bounds the function and how one block carries the state of one (b, h) over
its chunks. It has two designs, chosen by :func:`tensor_core_route` before
the launch: bf16 x, B and C with chunk 64, hd 64 or 128 and ds 64 or 128
run on the tensor cores (wgmma; C·Bᵀ once per (b, group, chunk) into a
scratch array, then the chunk loop), everything else on the CUDA cores. It
is built at first use by ``kernels/build.py`` and bound with ``ctypes``.

A tensor on the CPU goes to :func:`ssd_scan_plain`; a CUDA tensor launches the
kernel or raises — there is no fallback. ``ssd_scan_fwd.launches`` counts the
launches (one per call, whichever design runs).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels.build import CSRC, build

SOURCE = CSRC / "ssd_scan.cu"
MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build(SOURCE)[0]))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [P] * 8 + [I] * 8 + [P]
    lib.ssd_scan_fwd.restype = I
    lib.ssd_scan_fwd_tc.argtypes = [P] * 9 + [I] * 6 + [P]
    lib.ssd_scan_fwd_tc.restype = I
    return lib


#: the chunk, head dims and state dims the tensor-core kernel takes (bf16)
TC_CHUNK, TC_HEAD_DIMS, TC_STATE_DIMS = 64, (64, 128), (64, 128)


def tensor_core_route(dtype: torch.dtype, hd: int, ds: int, chunk: int) -> bool:
    """True where the tensor-core kernel runs: bf16 at chunk 64 with hd and
    ds each 64 or 128 (the state's rows of one warpgroup stay in its
    registers). Everything else takes the CUDA-core kernel."""
    return (dtype == torch.bfloat16 and chunk == TC_CHUNK and hd in TC_HEAD_DIMS
            and ds in TC_STATE_DIMS)


def smem_bytes(hd: int, ds: int, chunk: int) -> int:
    """Dynamic shared memory of one block (``smem_floats`` in the source,
    which refuses the launch above the limit as well)."""
    lc, ld = chunk + 4, hd + 4
    return 4 * (2 * ds * lc + ds * ld + chunk * ld + chunk * lc + 4 * chunk)


def _check(x, dt, A, Bm, Cm, init_state, chunk: int) -> None:
    """Raise unless the inputs have the kernel's layout and dtypes."""
    if x.ndim != 4 or Bm.ndim != 4:
        raise ValueError(f"ssd_scan: x and Bm must be 4-d, got {tuple(x.shape)}, {tuple(Bm.shape)}")
    B, nh, S, hd = x.shape
    G, ds = Bm.shape[1], Bm.shape[3]
    if x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: x must be bfloat16 or float32, got {x.dtype}")
    named = [("dt", dt, torch.float32, (B, nh, S)), ("A", A, torch.float32, (nh,)),
             ("Bm", Bm, x.dtype, (B, G, S, ds)), ("Cm", Cm, x.dtype, (B, G, S, ds)),
             ("init_state", init_state, torch.float32, (B, nh, hd, ds))]
    for name, t, dtype, shape in [("x", x, x.dtype, tuple(x.shape))] + named:
        if t.dtype != dtype:
            raise ValueError(f"ssd_scan: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan: {name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: S = {S} must be a multiple of chunk = {chunk}")
    if G < 1 or nh % G:
        raise ValueError(f"ssd_scan: nh = {nh} must be a multiple of G = {G}")


def ssd_scan_fwd(
    x: torch.Tensor,  # (B, nh, S, hd) bf16 | f32
    dt: torch.Tensor,  # (B, nh, S) f32, post-softplus
    A: torch.Tensor,  # (nh,) f32, negative
    Bm: torch.Tensor,  # (B, G, S, ds), x's dtype
    Cm: torch.Tensor,  # (B, G, S, ds), x's dtype
    init_state: torch.Tensor,  # (B, nh, hd, ds) f32
    *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (B, nh, S, hd) in x's dtype, final_state (B, nh, hd, ds) f32)``."""
    _check(x, dt, A, Bm, Cm, init_state, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, init_state, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    B, nh, S, hd = x.shape
    G, ds = Bm.shape[1], Bm.shape[3]
    y = torch.empty_like(x)
    final = torch.empty((B, nh, hd, ds), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if tensor_core_route(x.dtype, hd, ds, chunk):
        if B > 65535 or nh > 65535:
            raise ValueError(f"ssd_scan: the grid takes B and nh up to 65535, got {B}, {nh}")
        if any(t.data_ptr() % 16 for t in (x, Bm, Cm, init_state)):
            raise ValueError("ssd_scan: x, Bm, Cm (read by TMA) and init_state (read in "
                             "pairs) must be 16-byte aligned on the card")
        cb = torch.empty((B, G, S // chunk, chunk, chunk), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            err = _library().ssd_scan_fwd_tc(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                init_state.data_ptr(), y.data_ptr(), final.data_ptr(), cb.data_ptr(),
                B, nh, G, S, hd, ds, stream)
    else:
        if chunk % 4 or hd % 4 or ds % 4:
            raise ValueError(f"ssd_scan: chunk, hd and ds must be multiples of 4, "
                             f"got {chunk}, {hd}, {ds}")
        if smem_bytes(hd, ds, chunk) > MAX_SMEM:
            raise ValueError(f"ssd_scan: hd = {hd}, ds = {ds}, chunk = {chunk} need "
                             f"{smem_bytes(hd, ds, chunk)} bytes of shared memory, above "
                             f"{MAX_SMEM}")
        with torch.cuda.device(x.device):
            err = _library().ssd_scan_fwd(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                init_state.data_ptr(), y.data_ptr(), final.data_ptr(),
                B, nh, G, S, hd, ds, chunk, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: error {err} (a CUDA error; "
                           f"1000 + n: the driver refused a TMA tensor map)")
    ssd_scan_fwd.launches += 1
    return y, final


#: launches of the CUDA kernel in this process (plain-version calls not counted)
ssd_scan_fwd.launches = 0


def ssd_scan_plain(x, dt, A, Bm, Cm, init_state, *, chunk: int = 64):
    """The same function in plain torch: ``_ssd_kernel``'s chunk loop, each
    step batched over (b, h), any device."""
    B, nh, S, hd = x.shape
    rep = nh // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).float()  # (B, nh, S, ds)
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    a = A.float()[None, :, None]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    state = init_state.float()
    ys = []
    for c0 in range(0, S, chunk):
        xc = x[:, :, c0:c0 + chunk].float()
        dtc = dt[:, :, c0:c0 + chunk].float()
        bc, cc = Bh[:, :, c0:c0 + chunk], Ch[:, :, c0:c0 + chunk]
        cum = torch.cumsum(dtc * a, dim=-1)  # (B, nh, l) inclusive
        total = cum[..., -1:]
        dx = xc * dtc[..., None]
        L = torch.where(causal, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
        y_intra = ((cc @ bc.transpose(-1, -2)) * L) @ dx
        y_inter = (cc @ state.transpose(-1, -2)) * torch.exp(cum)[..., None]
        ys.append((y_intra + y_inter).to(x.dtype))
        w = torch.exp(total - cum)
        state = torch.exp(total)[..., None] * state + (dx * w[..., None]).transpose(-1, -2) @ bc
    return (torch.cat(ys, dim=2) if ys else torch.empty_like(x)), state  # S = 0: init


#: every kernel wrapper of this module, by name (each counts its launches)
KERNELS = {"ssd_scan": ssd_scan_fwd}
