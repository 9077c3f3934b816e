"""RMSNorm forward as a CUDA kernel for Hopper, and its plain PyTorch version.

:func:`rmsnorm_fwd` replaces the Pallas TPU kernel
``repro/kernels/rmsnorm/kernel.py::rmsnorm_fwd`` and keeps its function: for
each row of x (R, D), bf16 or f32, ``y = (x · r) · scale`` with ``r = 1 /
sqrt(mean(x²) + eps)``, all in f32, the output in x's dtype. Any R and D (the
reference's row blocks go down to one row). The CUDA source is
``src/repro_torch/csrc/rmsnorm.cu``; it says what bounds the kernel (bytes)
and how a warp owns a row. It is built at first use by ``kernels/build.py``
and bound with ``ctypes``.

A tensor on the CPU goes to :func:`rmsnorm_plain`; a CUDA tensor launches the
kernel or raises — there is no fallback. ``rmsnorm_fwd.launches`` counts the
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CSRC, build

SOURCE = CSRC / "rmsnorm.cu"
_DTYPES = (torch.bfloat16, torch.float32)
_MAX_D = (1 << 31) - 1


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build(SOURCE)[0]))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_fwd.argtypes = [P, P, P, ctypes.c_longlong, I, ctypes.c_float, I, P]
    lib.rmsnorm_fwd.restype = I
    return lib


def _check(x2d, scale) -> None:
    """Raise unless the inputs have the kernel's layout and dtypes."""
    if x2d.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"rmsnorm: x must be 2-d and scale 1-d, got {tuple(x2d.shape)}, "
                         f"{tuple(scale.shape)}")
    R, D = x2d.shape
    if x2d.dtype not in _DTYPES:
        raise ValueError(f"rmsnorm: x must be bfloat16 or float32, got {x2d.dtype}")
    if not scale.is_floating_point():
        raise ValueError(f"rmsnorm: scale must be floating point, got {scale.dtype}")
    if scale.shape[0] != D:
        raise ValueError(f"rmsnorm: scale must have shape ({D},), got {tuple(scale.shape)}")
    if scale.device != x2d.device:
        raise ValueError(f"rmsnorm: scale is on {scale.device}, x on {x2d.device}")
    if not x2d.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    if R < 1 or not 1 <= D <= _MAX_D:
        raise ValueError(f"rmsnorm: need R >= 1 and 1 <= D < 2**31, got R {R}, D {D}")


def rmsnorm_fwd(x2d: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x2d (R, D) bf16 | f32, scale (D,) any float dtype (read as f32).
    Returns y (R, D) in x's dtype."""
    _check(x2d, scale)
    if x2d.device.type == "cpu":
        return rmsnorm_plain(x2d, scale, eps=eps)
    if x2d.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu, not {x2d.device}")
    R, D = x2d.shape
    s32 = scale.float().contiguous()
    y = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        err = _library().rmsnorm_fwd(
            x2d.data_ptr(), s32.data_ptr(), y.data_ptr(), R, D, float(eps),
            int(x2d.dtype == torch.bfloat16), torch.cuda.current_stream(x2d.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {err}")
    rmsnorm_fwd.launches += 1
    return y


#: launches of the CUDA kernel in this process (plain-version calls not counted)
rmsnorm_fwd.launches = 0


def rmsnorm_plain(x2d: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's function in plain torch, any device: the f32 mean of the
    squares, an IEEE square root and a division (not ``rsqrt``, which CUDA
    computes to 2 ulp), then ``(x · r) · scale``."""
    x32 = x2d.float()
    r = torch.reciprocal(torch.sqrt(x32.square().mean(dim=-1, keepdim=True) + eps))
    return ((x32 * r) * scale.float()).to(x2d.dtype)


#: every kernel wrapper of this module, by name (each counts its launches)
KERNELS = {"rmsnorm": rmsnorm_fwd}
