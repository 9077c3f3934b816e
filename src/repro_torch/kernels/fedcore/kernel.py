"""The fused federated server step as a CUDA kernel for Hopper, and its plain
PyTorch version.

:func:`server_apply` replaces the Pallas TPU kernel
``repro/kernels/fedcore/kernel.py::server_apply``: one pass over the flat
``(C, Np)`` float32 delta buffer computes the weighted client mean (+ optional
pre-drawn DP noise), the FedAvg / FedMom / FedAdam update of the params and
optimizer lanes, and the squared norms of the pseudo-gradient, of the new
params and of each client's delta. The CUDA source is
``src/repro_torch/csrc/fedcore_server_apply.cu``; it says what bounds the
kernel (memory: ``(C + 2 + 2L)·4·Np`` bytes for L lanes) and how its
reductions stay deterministic.

The library is compiled with ``nvcc`` at first use into ``build/repro_torch/``
(named by a hash of the source and flags) and bound with ``ctypes`` through a
plain C interface. A tensor on the CPU goes to :func:`server_apply_plain`; a
CUDA tensor launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.outer_opt import OUTER_LANES

OPTS = {"fedavg": 0, "fedmom": 1, "fedadam": 2}
N_LANES = {name: len(lanes) for name, lanes in OUTER_LANES.items()}
MAX_CLIENTS = 32  # the kernel keeps one accumulator per client in registers
GRID = 1024  # blocks of the main kernel; fixed, so the reduction order is too
_THREADS = 256

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "fedcore_server_apply.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
# --fmad=false: round every multiply and add on its own, as the plain version's
# separate torch ops do (FMA contraction would differ from it in the last bit,
# which FedAdam's division by sqrt(v) can amplify where v is small)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the fedcore kernel")


def build() -> Tuple[Path, str]:
    """Compile the kernel library if this source/flags pair has not been built.
    Returns ``(path, compiler_log)``; the log is empty when it was cached."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfedcore-{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder never loads a partial file
    return out, proc.stderr


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.fedcore_server_apply
    fn.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_float] * 8
        + [ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


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
    if not 1 <= C <= MAX_CLIENTS:
        raise ValueError(f"the kernel takes 1..{MAX_CLIENTS} clients, got {C}")
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
    lane0 = lanes[0].data_ptr() if len(lanes) > 0 else None
    lane1 = lanes[1].data_ptr() if len(lanes) > 1 else None
    b1c, b2c = bias_corr if bias_corr is not None else (1.0, 1.0)
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            deltas2d.data_ptr(), wn.data_ptr(), params_flat.data_ptr(), lane0, lane1,
            noise.data_ptr() if noise is not None else None,
            partials.data_ptr(), out.data_ptr(),
            Np, C, OPTS[opt], int(bool(nesterov)),
            lr, momentum, f32(1.0 - momentum), beta2, f32(1.0 - beta2), eps, b1c, b2c,
            grid, stream,
        )
    if err != 0:
        raise RuntimeError(f"fedcore server_apply launch failed: CUDA error {err}")
    server_apply.launches += 1
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
