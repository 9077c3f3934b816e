"""RMSNorm over the last axis for any leading dims, the counterpart of
``repro/kernels/rmsnorm/ops.py``: rows flattened to (R, D) for the kernel and
the result given back in x's shape. The reference picks a Pallas row block
here; the CUDA kernel gives each row its own warp, so there is nothing to
pick."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    shape = x.shape
    out = rmsnorm_fwd(x.reshape(-1, shape[-1]).contiguous(), scale, eps=eps)
    return out.reshape(shape)
