"""Logical-axis → mesh-axis sharding rules for every (architecture × shape ×
mesh), the counterpart of ``repro.sharding.specs``, over the port's
:class:`~repro_torch.launch.mesh.Mesh` descriptor.

Parameters carry logical axes from their ParamDesc declarations; this module
resolves them to PartitionSpecs against the mesh with divisibility-aware
fallbacks:

  dim % axis == 0  -> shard
  otherwise        -> replicate, or shard head_dim where the head axis cannot

Training/prefill shard batch/client over ('pod','data') and tensor dims over
'model'. Decode shards the KV cache *sequence* over 'model'; long_500k (B=1)
shards the sequence over every mesh axis.

A :class:`PartitionSpec` is a tuple with one entry per tensor dim: None, an
axis name, or a tuple of axis names. Spec trees are nests of dicts and lists
whose leaves are PartitionSpecs (tuples), so they are walked with
:func:`map_leaves`, which stops at tuples.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from repro_torch.launch.mesh import Mesh

# §Perf experiment toggle: replicate (instead of head_dim-sharding) small KV
# projections — removes the per-layer q/kv resharding collective for GQA archs whose
# kv-head count is below the model-axis size. REPRO_KV_REPLICATE=1.
_KV_REPLICATE = os.environ.get("REPRO_KV_REPLICATE", "0") == "1"

# logical axis -> preferred mesh axis (training / generic tensors)
AXIS_RULES = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "ssm_heads": "model",
    "head_dim": None,  # fallback target when the head axis cannot shard (see below)
    "layers": None,  # stacked layer dim: never sharded
}


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name or a tuple of them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def map_leaves(fn, tree, *rest):
    """``fn`` over the leaves of dict/list nests whose leaves may be tuples
    (axes, shapes, PartitionSpecs), the trees walked in step."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, list):
        return [map_leaves(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)]
    return fn(tree, *rest)


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name]


def axes_size(mesh: Mesh, axes) -> int:
    """Devices along ``axes`` (1 for none)."""
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def _resolve_dim(mesh: Mesh, logical: Optional[str], dim: int) -> Optional[str]:
    if logical is None:
        return None
    target = AXIS_RULES.get(logical)
    if target is None or target not in mesh.axis_names:
        return None
    # exact divisibility only: uneven head counts (coder 56, llama4 40,
    # whisper 20) go through the head_dim fallback
    if dim % _axis_size(mesh, target) == 0:
        return target
    return None


def choose_client_mapping(mesh: Mesh, param_count: int, hbm_bytes: Optional[float] = None):
    """Photon client → mesh mapping (§5.1 / Algorithm 1 L.15-24).

    Every federated client holds a full model replica + AdamW state (~16 B/param in
    fp32). Small models: one client per ('pod','data') slice. Models too large for
    one model-parallel slice fall back to the paper's hierarchical mode: fewer
    clients, with the leftover data axis used INSIDE each client for FSDP + data
    parallelism. ``hbm_bytes`` is the memory of one device, the mesh's by default.

    Returns (client_axes, fsdp_axes, n_clients).
    """
    hbm_bytes = mesh.hbm_bytes if hbm_bytes is None else hbm_bytes
    candidates = []
    all_client = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    candidates.append((all_client, ()))
    if "pod" in mesh.axis_names:
        candidates.append((("pod",), ("data",)))
    candidates.append(((), all_client))
    state_bytes = param_count * 16.0  # fp32 params + m + v + pseudo-grad
    for client_axes_, fsdp_axes_ in candidates:
        n_c = axes_size(mesh, client_axes_)
        chips_per_client = mesh.size // n_c
        budget = chips_per_client * hbm_bytes * 0.55  # rest for activations/temps
        if state_bytes <= budget:
            return client_axes_, fsdp_axes_, n_c
    return candidates[-1][0], candidates[-1][1], 1


def add_fsdp_axes(
    spec: PartitionSpec,
    shape: Tuple[int, ...],
    mesh: Mesh,
    fsdp_axes: Tuple[str, ...],
    logical_axes: Tuple[Optional[str], ...] = (),
) -> PartitionSpec:
    """ZeRO-style sharding: place the fsdp axes on the first unsharded NON-STACK dim
    whose size divides them. The 'layers' dim is never fsdp-sharded."""
    if not fsdp_axes:
        return spec
    n = axes_size(mesh, fsdp_axes)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    logical = list(logical_axes) + [None] * (len(shape) - len(logical_axes))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if logical[i] == "layers":
            continue
        if e is None and dim % n == 0 and dim >= n:
            entries[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
            return P(*entries)
    return spec  # nothing divisible: replicate (tiny tensors only)


def param_pspec(mesh: Mesh, axes: Tuple[Optional[str], ...],
                shape: Tuple[int, ...]) -> PartitionSpec:
    resolved = []
    used = set()
    for logical, dim in zip(axes, shape):
        ax = _resolve_dim(mesh, logical, dim)
        if ax in used:  # an axis can appear at most once in a PartitionSpec
            ax = None
        if ax is not None:
            used.add(ax)
        resolved.append(ax)
    # head-count too small to shard (e.g. gemma3's 8 heads over model=16): fall back
    # to sharding head_dim, which keeps the attention parameter mass distributed
    if "model" not in used and "model" in mesh.axis_names:
        n = _axis_size(mesh, "model")
        head_axes = ("heads",) if _KV_REPLICATE else ("heads", "kv_heads")
        if any(a in head_axes for a in axes):
            for i, (logical, dim) in enumerate(zip(axes, shape)):
                if logical == "head_dim" and dim % n == 0:
                    resolved[i] = "model"
                    break
    return P(*resolved)


def client_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes that the federated client dimension shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def n_clients(mesh: Mesh) -> int:
    return axes_size(mesh, client_axes(mesh))


# ---------------------------------------------------------------------------
# Spec tree builders
# ---------------------------------------------------------------------------


def params_pspecs(mesh: Mesh, axes_tree, shapes_tree, fsdp_axes: Tuple[str, ...] = ()):
    """Parameter PartitionSpecs: sharded over 'model' per the logical axes, plus
    optional ZeRO/FSDP sharding over the given leftover axes."""
    return map_leaves(
        lambda a, s: add_fsdp_axes(param_pspec(mesh, a, s), s, mesh, fsdp_axes, a),
        axes_tree, shapes_tree,
    )


def placements(mesh: Mesh, spec: PartitionSpec):
    """A spec as DTensor placements, one per mesh dim: ``Shard(d)`` where
    tensor dim ``d``'s entry names the mesh dim, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            out[mesh.axis_names.index(a)] = Shard(d)
    return tuple(out)


def params_shardings(mesh: Mesh, axes_tree, shapes_tree):
    """The parameter specs as DTensor placements (built without a process
    group: they describe a layout, they place nothing)."""
    specs = params_pspecs(mesh, axes_tree, shapes_tree)
    return map_leaves(lambda p: placements(mesh, p), specs)


def clientize_pspec(mesh: Mesh, spec: PartitionSpec,
                    client_axes_: Optional[Tuple[str, ...]] = None) -> PartitionSpec:
    """Prepend the client axis to a parameter spec (client-stacked params/opt state)."""
    ca = client_axes(mesh) if client_axes_ is None else client_axes_
    return P(ca if ca else None, *spec)


def clientize_tree(mesh: Mesh, spec_tree, client_axes_: Optional[Tuple[str, ...]] = None):
    return map_leaves(lambda p: clientize_pspec(mesh, p, client_axes_), spec_tree)


# ---------------------------------------------------------------------------
# Activations / inputs
# ---------------------------------------------------------------------------


def train_batch_pspec(mesh: Mesh, ndim: int) -> PartitionSpec:
    """Round batches (τ, C, B, ...): client dim over ('pod','data')."""
    return P(None, client_axes(mesh), *([None] * (ndim - 2)))


def central_batch_pspec(mesh: Mesh, ndim: int) -> PartitionSpec:
    """Centralized baseline batches (B, ...): batch over ('pod','data')."""
    return P(client_axes(mesh), *([None] * (ndim - 1)))


def decode_cache_pspec(mesh: Mesh, shape: Tuple[int, ...], kind: str,
                       long_context: bool) -> PartitionSpec:
    """KV cache (B, S, Hkv, hd) / SSM state shardings for serving.

    kind: 'kv' (B,S,Hkv,hd) | 'conv' (B,W,C) | 'ssd' (B,nh,hd,ds) | 'cross' (B,F,H,hd)
    Caches of stacked segments carry a leading layer dim; callers prepend None.
    """
    ca = client_axes(mesh)
    if kind == "kv":
        B = shape[0]
        if long_context or B < max(1, axes_size(mesh, ca)):
            # batch too small to shard: shard sequence over everything
            return P(None, ca + ("model",), None, None)
        return P(ca, "model", None, None)
    if kind == "cross":
        B = shape[0]
        return P(ca, None, None, None) if B >= n_clients(mesh) else P(*([None] * len(shape)))
    if kind == "conv":
        B = shape[0]
        lead = ca if B >= n_clients(mesh) else None
        return P(lead, None, "model" if shape[-1] % mesh.shape["model"] == 0 else None)
    if kind == "ssd":
        B = shape[0]
        lead = ca if B >= n_clients(mesh) else None
        nh = shape[1]
        sharded = nh % mesh.shape["model"] == 0 or nh >= mesh.shape["model"]
        return P(lead, "model" if sharded else None, None, None)
    raise ValueError(kind)


def shard_shape(mesh: Mesh, shape: Tuple[int, ...], spec: PartitionSpec) -> Tuple[int, ...]:
    """One device's block of a ``shape`` tensor laid out by ``spec``; a dim
    that does not divide is refused, as a jit input sharding refuses it."""
    out = []
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        n = axes_size(mesh, e if isinstance(e, tuple) else (e,) if e else ())
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {e!r} ({n})")
        out.append(dim // n)
    return tuple(out)
