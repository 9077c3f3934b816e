"""Shared building blocks: parameter descriptions, norms, activations and
positional encodings — the counterpart of ``repro.models.common``.

Every parameter is declared once as a ``ParamDesc(shape, axes, init)``:
``init_params`` materializes a tree of them with a ``torch.Generator`` per leaf
(per chunk of a large leaf), seeded from the run seed and the leaf's key path
(the same path-keyed scheme the JAX package uses with ``fold_in``; the numbers
differ because the generators do), and ``param_axes`` extracts the logical
axis of every dim, which ``sharding.specs`` resolves against a mesh.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.tree import flatten_with_paths, tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class ParamDesc:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names per dim (None = replicated)
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed' | 'ssm_a' | 'ssm_dt'
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_desc(x) -> bool:
    return isinstance(x, ParamDesc)


def zlib_hash(s: str) -> int:
    return zlib.crc32(s.encode()) & 0x7FFFFFFF


#: a leaf of more elements than this is drawn in chunks of it, each chunk from
#: its own generator, so one large leaf keeps every host core busy
INIT_CHUNK = 1 << 24


def _materialize(desc: ParamDesc, gen: torch.Generator, numel: int) -> torch.Tensor:
    """``numel`` f32 values of a zeros, ones or SSM leaf's initializer, flat
    (``init_params`` draws the normal leaves into its buffers)."""
    if desc.init == "zeros":
        return torch.zeros(numel)
    if desc.init == "ones":
        return torch.ones(numel)
    if desc.init == "ssm_a":  # A_log ~ log(Uniform[1, 16])
        u = torch.rand(numel, generator=gen, dtype=torch.float32)
        return torch.log(1.0 + 15.0 * u)
    if desc.init == "ssm_dt":  # dt bias: softplus^-1 of Uniform[1e-3, 1e-1]
        dt = 1e-3 + (1e-1 - 1e-3) * torch.rand(numel, generator=gen, dtype=torch.float32)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {desc.init!r}")


def init_params(seed: int, desc_tree, dtype=torch.float32, device="cuda"):
    """Materialize a ParamDesc tree: leaf ``path`` draws from a CPU generator
    seeded with ``(seed, crc32(path))`` — a leaf of more than ``INIT_CHUNK``
    elements draws chunk ``i`` from ``(seed, crc32(f"{path}#{i}"))`` — so
    values do not depend on the device or on the other leaves. The chunks are
    drawn on a pool of host threads, each into its own buffer, and copied
    into the leaves on ``device`` (the card unless the caller asks for the
    CPU; cuda without a card raises). On the ``meta`` device only shapes are
    made."""
    device = resolve_device(device)
    if device.type == "meta":
        return tree_map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), desc_tree)
    items = flatten_with_paths(desc_tree)
    out = [torch.empty(desc.shape, dtype=dtype, device=device) for _, desc in items]
    jobs = []
    for i, (path, desc) in enumerate(items):
        n = out[i].numel()
        if n <= INIT_CHUNK:
            jobs.append((i, path, 0, n))
        else:
            jobs += [(i, f"{path}#{c}", a, min(a + INIT_CHUNK, n))
                     for c, a in enumerate(range(0, n, INIT_CHUNK))]

    cuda = device.type == "cuda"
    local = threading.local()  # each pool thread's host buffer (pinned for a card) and stream

    def fill(job):
        i, key, a, b = job
        desc, dst = items[i][1], out[i].view(-1)[a:b]
        gen = torch.Generator().manual_seed((int(seed) << 32) ^ zlib_hash(key))
        if not hasattr(local, "buf"):
            local.buf = torch.empty(INIT_CHUNK, dtype=torch.float32, pin_memory=cuda)
            local.stream = torch.cuda.Stream(device) if cuda else None
        if desc.init in ("normal", "embed"):
            src = torch.randn(b - a, generator=gen, out=local.buf[:b - a]).mul_(desc.scale)
        else:
            src = _materialize(desc, gen, b - a)
        if cuda:
            with torch.cuda.stream(local.stream):
                dst.copy_(src, non_blocking=True)
            local.stream.synchronize()  # the buffer is refilled next
        else:
            dst.copy_(src)

    if cuda:  # the leaves' memory may still be in use by queued work
        torch.cuda.synchronize(device)
    with ThreadPoolExecutor(max_workers=min(len(jobs), os.cpu_count() or 1) or 1) as pool:
        list(pool.map(fill, jobs))
    return tree_unflatten(tree_flatten(desc_tree)[1], out)


def param_axes(desc_tree):
    """The logical-axes tree (same structure as params; tuple leaves)."""
    return tree_map(lambda d: d.axes, desc_tree)


def param_shapes(desc_tree):
    return tree_map(lambda d: d.shape, desc_tree)


def stack_descs(desc_tree, n: int, stack_axis_name: Optional[str] = None):
    """Prepend a stacking dim of size n to every desc (layer stacks)."""
    leaves, treedef = tree_flatten(desc_tree)
    return tree_unflatten(treedef, [
        dataclasses.replace(d, shape=(n,) + d.shape, axes=(stack_axis_name,) + d.axes)
        for d in leaves
    ])


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
        return {"scale": ParamDesc((d,), (None,), "ones")}
    return {"scale": ParamDesc((d,), (None,), "ones"), "bias": ParamDesc((d,), (None,), "zeros")}


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


@functools.lru_cache(maxsize=None)
def alibi_slopes_on(n_heads: int, device: torch.device) -> torch.Tensor:
    """``alibi_slopes(n_heads, device)``, built once per (n_heads, device):
    the copy to the card, a host sync, is paid at the first call only. The
    tensor is shared; its callers only read it."""
    return alibi_slopes(n_heads, device)
