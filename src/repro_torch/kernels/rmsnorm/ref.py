"""Plain-torch oracle of the fused RMSNorm kernel, as
``repro/kernels/rmsnorm/ref.py``: f32 throughout, ``(x · rsqrt(mean(x²) +
eps)) · scale``, rounded to x's dtype."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)
