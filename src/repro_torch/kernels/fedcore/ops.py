"""Flat-buffer federation ops: tree packing and the fused server phase — the
layer between ``core/federated.py`` and the kernel in ``kernel.py``, the
counterpart of ``repro/kernels/fedcore/ops.py``.

``pack_leaves`` concatenates every leaf of one dtype into one contiguous 1D
buffer, zero-padded to a block multiple, element for element the reference's
layout; ``unpack_leaves`` is its exact inverse and returns views.
Client-axis trees (leaves ``(C, ...)``) pack into one ``(C, N)`` buffer.

:func:`fused_apply_aggregate` is the drop-in for ``core/federated.apply_aggregate``
(same signature and state/metrics contract): one ``server_apply`` pass per
dtype group replaces the per-leaf weighted-mean → DP-noise → outer-update chain,
with the aggregation metrics taken from the kernel's reductions. As in the
reference it differs from the per-leaf path by float reassociation (it scales
by w/Σw before summing) and draws DP noise per flat group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.federated import aggregation_metrics, dp_noise_scale, split_rng
from repro_torch.core.outer_opt import OUTER_LANES, adam_bias_corrections
from repro_torch.kernels.fedcore import kernel as K
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

# the reference's flat-buffer block; the padded length is a multiple of it
BLOCK = 8192


@dataclass(frozen=True)
class FlatSpec:
    """Static layout of a packed leaf list: per-leaf shapes (in pack order),
    the true element count ``n`` and the padded length ``n_pad``."""

    shapes: Tuple[Tuple[int, ...], ...]
    n: int
    n_pad: int

    @property
    def offsets(self) -> Tuple[int, ...]:
        offs, o = [], 0
        for s in self.shapes:
            offs.append(o)
            o += _leaf_size(s)
        return tuple(offs)


def _leaf_size(shape: Tuple[int, ...]) -> int:
    out = 1
    for d in shape:
        out *= d
    return out


def _pad_len(n: int, pad_multiple: int) -> int:
    return ((n + pad_multiple - 1) // pad_multiple) * pad_multiple if n else pad_multiple


def pack_leaves(leaves: Sequence[torch.Tensor], pad_multiple: int = 1
                ) -> Tuple[torch.Tensor, FlatSpec]:
    """Copy same-dtype leaves into one fresh contiguous 1D buffer, zero-padded
    to a multiple of ``pad_multiple`` — fresh, so callers may update it in
    place. Inverse: :func:`unpack_leaves` (bitwise)."""
    shapes = tuple(tuple(l.shape) for l in leaves)
    n = sum(_leaf_size(s) for s in shapes)
    n_pad = _pad_len(n, pad_multiple)
    flat = torch.empty(n_pad, dtype=leaves[0].dtype, device=leaves[0].device)
    for leaf, shape, off in zip(leaves, shapes, FlatSpec(shapes, n, n_pad).offsets):
        flat[off:off + _leaf_size(shape)].copy_(leaf.reshape(-1))
    flat[n:].zero_()
    return flat, FlatSpec(shapes=shapes, n=n, n_pad=n_pad)


def unpack_leaves(flat: torch.Tensor, spec: FlatSpec) -> List[torch.Tensor]:
    """Views of ``flat`` in the leaves' shapes."""
    return [flat[off:off + _leaf_size(shape)].view(shape)
            for shape, off in zip(spec.shapes, spec.offsets)]


def pack_client_leaves(leaves: Sequence[torch.Tensor], c: int, pad_multiple: int = 1
                       ) -> Tuple[torch.Tensor, FlatSpec]:
    """Pack leaves with a leading client axis ``(C, ...)`` into one fresh
    ``(C, N_pad)`` buffer; each row is :func:`pack_leaves` of that client."""
    shapes = tuple(tuple(l.shape[1:]) for l in leaves)
    n = sum(_leaf_size(s) for s in shapes)
    n_pad = _pad_len(n, pad_multiple)
    flat = torch.empty((c, n_pad), dtype=leaves[0].dtype, device=leaves[0].device)
    for leaf, shape, off in zip(leaves, shapes, FlatSpec(shapes, n, n_pad).offsets):
        flat[:, off:off + _leaf_size(shape)].copy_(leaf.reshape(c, -1))
    flat[:, n:].zero_()
    return flat, FlatSpec(shapes=shapes, n=n, n_pad=n_pad)


def dtype_group_indices(leaves: Sequence[torch.Tensor]) -> List[Tuple[Any, List[int]]]:
    """Group leaf indices by dtype, preserving first-seen order."""
    groups: List[Tuple[Any, List[int]]] = []
    seen: Dict[Any, List[int]] = {}
    for i, l in enumerate(leaves):
        if l.dtype not in seen:
            seen[l.dtype] = []
            groups.append((l.dtype, seen[l.dtype]))
        seen[l.dtype].append(i)
    return groups


@torch.no_grad()
def fused_apply_aggregate(
    fed,  # FederatedConfig
    state: Dict[str, Any],
    deltas,  # tree, leaves (C, ...) — pseudo-gradients
    client_weights: Optional[torch.Tensor] = None,
    codec=None,
    *,
    block: int = BLOCK,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Server phase on the flat-buffer layout: one ``server_apply`` pass per
    dtype group. Leaves ``state`` untouched: the kernel writes the new params
    and lanes over freshly packed copies, which the new state then views."""
    if codec is not None:
        raise ValueError("uplink codecs are not ported yet (ROADMAP.md queue A)")
    d_leaves = tree_leaves(deltas)
    C = d_leaves[0].shape[0]
    device = d_leaves[0].device
    if client_weights is not None:
        w = client_weights.float()
        wn = w / torch.clamp(torch.sum(w), min=1e-12)
    else:
        wn = torch.full((C,), 1.0 / C, dtype=torch.float32, device=device)

    ocfg = fed.outer
    lane_names = OUTER_LANES[ocfg.name]
    rnd = state["outer"]["round"] + 1
    bias_corr = adam_bias_corrections(ocfg, rnd) if ocfg.name == "fedadam" else None
    rng, noise_seed = split_rng(state["rng"])
    if fed.dp_noise > 0.0:
        noise_scale = dp_noise_scale(fed, client_weights, C)

    p_leaves, p_treedef = tree_flatten(state["params"])
    lane_leaf_lists = [tree_leaves(state["outer"][name]) for name in lane_names]
    new_p_leaves: List[Optional[torch.Tensor]] = [None] * len(p_leaves)
    new_lane_leaves = [[None] * len(p_leaves) for _ in lane_names]
    pg_sq = torch.zeros((), dtype=torch.float32, device=device)
    newp_sq = torch.zeros((), dtype=torch.float32, device=device)
    delta_sq = torch.zeros((C,), dtype=torch.float32, device=device)

    for gi, (_, idxs) in enumerate(dtype_group_indices(p_leaves)):
        p_flat, spec = pack_leaves([p_leaves[i] for i in idxs], block)
        lanes_flat = [pack_leaves([lanes[i] for i in idxs], block)[0]
                      for lanes in lane_leaf_lists]
        d_flat, _ = pack_client_leaves([d_leaves[i].float() for i in idxs], C, block)
        noise_flat = None
        if fed.dp_noise > 0.0:
            gen = torch.Generator(device=device).manual_seed(
                (noise_seed + gi) & 0xFFFFFFFFFFFFFFFF
            )
            noise_flat = torch.zeros(spec.n_pad, dtype=torch.float32, device=device)
            noise_flat[:spec.n] = noise_scale * torch.randn(
                spec.n, generator=gen, dtype=torch.float32, device=device
            )
        g_pg_sq, g_np_sq, g_dsq = K.server_apply(
            d_flat, wn, p_flat, lanes_flat,
            opt=ocfg.name, lr=ocfg.lr, momentum=ocfg.momentum, nesterov=ocfg.nesterov,
            beta2=ocfg.beta2, eps=ocfg.eps, bias_corr=bias_corr, noise=noise_flat,
        )
        del d_flat, noise_flat
        pg_sq = pg_sq + g_pg_sq
        newp_sq = newp_sq + g_np_sq
        delta_sq = delta_sq + g_dsq
        for leaf, i in zip(unpack_leaves(p_flat, spec), idxs):
            new_p_leaves[i] = leaf
        for li, nl_flat in enumerate(lanes_flat):
            for leaf, i in zip(unpack_leaves(nl_flat, spec), idxs):
                new_lane_leaves[li][i] = leaf

    new_outer: Dict[str, Any] = {"round": rnd}
    for name, leaves in zip(lane_names, new_lane_leaves):
        new_outer[name] = tree_unflatten(p_treedef, leaves)
    metrics = dict(
        aggregation_metrics(torch.sqrt(delta_sq), torch.sqrt(pg_sq), client_weights),
        global_model_norm=torch.sqrt(newp_sq),
    )
    new_state = {
        "params": tree_unflatten(p_treedef, new_p_leaves),
        "outer": new_outer,
        "round": state["round"] + 1,
        "rng": rng,
    }
    return new_state, metrics
