"""Shared building blocks: parameter descriptions, norms, activations and
positional encodings — the counterpart of ``repro.models.common``.

Every parameter is declared once as a ``ParamDesc(shape, init)``; ``init_params``
materializes a tree of them with a ``torch.Generator`` per leaf, seeded from
the run seed and the leaf's key path (the same path-keyed scheme the JAX
package uses with ``fold_in``; the numbers differ because the generators do).
"""
from __future__ import annotations

import dataclasses
import zlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.tree import flatten_with_paths, tree_flatten, tree_unflatten


@dataclass(frozen=True)
class ParamDesc:
    shape: Tuple[int, ...]
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed'
    scale: float = 0.02


def is_desc(x) -> bool:
    return isinstance(x, ParamDesc)


def zlib_hash(s: str) -> int:
    return zlib.crc32(s.encode()) & 0x7FFFFFFF


def _materialize(desc: ParamDesc, gen: torch.Generator, dtype) -> torch.Tensor:
    if desc.init == "zeros":
        return torch.zeros(desc.shape, dtype=dtype)
    if desc.init == "ones":
        return torch.ones(desc.shape, dtype=dtype)
    if desc.init in ("normal", "embed"):
        x = torch.randn(desc.shape, generator=gen, dtype=torch.float32)
        return (desc.scale * x).to(dtype)
    raise ValueError(f"init {desc.init!r} is not ported yet (ROADMAP.md)")


def init_params(seed: int, desc_tree, dtype=torch.float32, device="cpu"):
    """Materialize a ParamDesc tree: leaf ``path`` draws from a CPU generator
    seeded with ``(seed, crc32(path))``, so values do not depend on the device
    or on the other leaves."""
    out = []
    for path, desc in flatten_with_paths(desc_tree):
        gen = torch.Generator().manual_seed((int(seed) << 32) ^ zlib_hash(path))
        out.append(_materialize(desc, gen, dtype).to(device))
    return tree_unflatten(tree_flatten(desc_tree)[1], out)


def stack_descs(desc_tree, n: int):
    """Prepend a stacking dim of size n to every desc (layer stacks)."""
    leaves, treedef = tree_flatten(desc_tree)
    return tree_unflatten(
        treedef, [dataclasses.replace(d, shape=(n,) + d.shape) for d in leaves]
    )


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    # population variance, as jnp.var
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def norm_desc(cfg, d_model: Optional[int] = None) -> dict:
    d = d_model or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": ParamDesc((d,), "ones")}
    return {"scale": ParamDesc((d,), "ones"), "bias": ParamDesc((d,), "zeros")}


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """ALiBi slopes (Press et al. 2022); handles non-power-of-2 head counts."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    if np.log2(n_heads).is_integer():
        s = pow2_slopes(n_heads)
    else:
        closest = 2 ** int(np.floor(np.log2(n_heads)))
        s = pow2_slopes(closest)
        extra = pow2_slopes(2 * closest)[0::2][: n_heads - closest]
        s = s + extra
    return torch.tensor(np.asarray(s, np.float32), device=device)
