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
by w/Σw before summing) and draws DP noise per flat group. With a codec it
decodes the payloads first.

The fused uplink codecs (:class:`FusedTopKCodec`, :class:`FusedBf16Codec`,
:class:`FusedInt8Codec`) are drop-in ``core/compression`` codecs on the same
layout: the cohort's deltas pack into one ``(C, Np)`` buffer and one codec
kernel launch encodes (and for int8 decodes) every client and leaf at once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.compression import (
    Bf16Codec,
    Int8Codec,
    TopKCodec,
    _topk_index_nbytes,
    init_error_feedback,  # noqa: F401  (the reference module's public name)
    int8_payload_leaves,
    int8_scale,
)
from repro_torch.core.federated import aggregation_metrics, dp_noise_scale, split_rng
from repro_torch.core.outer_opt import OUTER_LANES, adam_bias_corrections
from repro_torch.kernels.fedcore import kernel as K
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

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


def pack_flat(tree, pad_multiple: int = 1) -> Tuple[torch.Tensor, Any, FlatSpec]:
    """Tree-level packing of a single-dtype tree: ``(flat (N_pad,), treedef,
    spec)``; :func:`unpack_flat` inverts it bitwise."""
    leaves, treedef = tree_flatten(tree)
    flat, spec = pack_leaves(leaves, pad_multiple)
    return flat, treedef, spec


def unpack_flat(flat: torch.Tensor, treedef, spec: FlatSpec):
    return tree_unflatten(treedef, unpack_leaves(flat, spec))


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


def unpack_client_leaves(flat: torch.Tensor, spec: FlatSpec) -> List[torch.Tensor]:
    """Views of a ``(C, N_pad)`` buffer in the leaves' ``(C, ...)`` shapes."""
    c = flat.shape[0]
    return [flat[:, off:off + _leaf_size(shape)].view((c,) + shape)
            for shape, off in zip(spec.shapes, spec.offsets)]


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
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Server phase on the flat-buffer layout: one ``server_apply`` pass per
    dtype group. Leaves ``state`` untouched: the kernel writes the new params
    and lanes over freshly packed copies, which the new state then views."""
    if codec is not None:
        deltas = codec.decode_cohort(deltas)
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
        p_flat, spec = pack_leaves([p_leaves[i] for i in idxs], BLOCK)
        lanes_flat = [pack_leaves([lanes[i] for i in idxs], BLOCK)[0]
                      for lanes in lane_leaf_lists]
        d_flat, _ = pack_client_leaves([d_leaves[i].float() for i in idxs], C, BLOCK)
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


# ---------------------------------------------------------------------------
# Fused uplink codecs — drop-in Codec subclasses (core/compression seam)
# ---------------------------------------------------------------------------


def _one_client(codec, delta, residual=None, **kw):
    """``encode`` of one client through the cohort path (a cohort of one)."""
    add = lambda t: tree_map(lambda x: x[None], t) if t is not None else None  # noqa: E731
    payload, res = codec.encode_cohort(add(delta), add(residual), **kw)
    take = lambda t: tree_map(lambda x: x[0], t) if t is not None else None  # noqa: E731
    return take(payload), take(res)


@dataclass(frozen=True)
class FusedTopKCodec(TopKCodec):
    """Flat-buffer top-k with error feedback: each client's delta packs into
    one row of a ``(C, Np)`` buffer, its threshold is the k-th magnitude of the
    row's real entries (k = max(1, ⌊N·k_fraction⌋) — a global budget, where the
    per-leaf codec gives every tensor its own k), and one ``topk_mask_ef``
    launch masks, selects and updates the residual of the whole cohort.
    Entries tied at the threshold are all kept, as in the reference."""

    def threshold(self, xf: torch.Tensor, n: int) -> torch.Tensor:
        """(C,) k-th magnitude of each row's first ``n`` entries: a selection
        outside the kernel, as ``lax.top_k`` is in the reference. Only its
        value matters, so the order of ties does not."""
        k = max(1, int(n * self.k_fraction))
        return torch.topk(torch.abs(xf[:, :n]), k, dim=1, sorted=False).values.amin(dim=1)

    def encode_cohort(self, deltas, residuals=None, rngs=None):
        leaves, treedef = tree_flatten(deltas)
        C = leaves[0].shape[0]
        x_flat, spec = pack_client_leaves([x.float() for x in leaves], C, BLOCK)
        if residuals is not None:
            x_flat += pack_client_leaves(tree_leaves(residuals), C, BLOCK)[0]
        kept, new_e = K.topk_mask_ef(x_flat, self.threshold(x_flat, spec.n))
        # payload values ship in the delta's own dtype; the residual stays f32
        payload = [k.to(d.dtype) for k, d in zip(unpack_client_leaves(kept, spec), leaves)]
        return (tree_unflatten(treedef, payload),
                tree_unflatten(treedef, unpack_client_leaves(new_e, spec)))

    def encode(self, delta, residual=None, rng=None):
        return _one_client(self, delta, residual)

    def nbytes(self, params_like) -> float:
        n = sum(x.numel() for x in tree_leaves(params_like))
        return float(max(1, int(n * self.k_fraction))) * (4.0 + _topk_index_nbytes(n))

    def payload_nbytes(self, payload) -> float:
        # the same GLOBAL budget as nbytes, not the per-leaf count
        return self.nbytes(payload)


class FusedBf16Codec(Bf16Codec):
    """Flat-buffer bf16 stochastic rounding: the per-leaf noise packs flat and
    one ``sr_bf16`` launch rounds the whole cohort. Given the same noise the
    payload is bitwise the per-leaf codec's. Without an rng it is the
    deterministic round-to-nearest cast, with no kernel."""

    def encode_cohort(self, deltas, residuals=None, rngs=None):
        if rngs is None:
            return super().encode_cohort(deltas, residuals)
        leaves, treedef = tree_flatten(deltas)
        C = leaves[0].shape[0]
        x_flat, spec = pack_client_leaves([x.float() for x in leaves], C, BLOCK)
        noise = self.cohort_noise(leaves, rngs)
        z_flat, _ = pack_client_leaves([z.to(torch.int32) for z in noise], C, BLOCK)
        out = K.sr_bf16(x_flat, z_flat)
        return tree_unflatten(treedef, unpack_client_leaves(out, spec)), residuals

    def encode(self, delta, residual=None, rng=None):
        if rng is None:
            return super().encode(delta, residual)
        return _one_client(self, delta, residual, rngs=[rng])


class FusedInt8Codec(Int8Codec):
    """Per-tensor symmetric int8 over the packed cohort: the per-(client, leaf)
    absmax scales come from a torch reduction (an XLA reduction in the
    reference), then one ``int8_quant`` launch quantizes every client and
    leaf; decode is one ``int8_dequant`` launch. The payload keeps the
    reference's ``{"q": int8 leaf, "scale": f32}`` format, bitwise."""

    def encode_cohort(self, deltas, residuals=None, rngs=None):
        leaves, treedef = tree_flatten(deltas)
        C = leaves[0].shape[0]
        xs = [x.float() for x in leaves]
        x_flat, spec = pack_client_leaves(xs, C, BLOCK)
        scales = torch.stack([int8_scale(x.reshape(C, -1), dim=1) for x in xs], dim=1)
        q = K.int8_quant(x_flat, scales.contiguous(), spec.offsets + (spec.n,))
        payload = [{"q": ql, "scale": scales[:, l]}
                   for l, ql in enumerate(unpack_client_leaves(q, spec))]
        return tree_unflatten(treedef, payload), residuals

    def decode_cohort(self, payloads):
        entries, treedef = int8_payload_leaves(payloads)
        C = entries[0]["q"].shape[0]
        q_flat, spec = pack_client_leaves([e["q"] for e in entries], C, BLOCK)
        # a scale that crossed the wire arrives as (C, 1), not (C,)
        scales = torch.stack([e["scale"].reshape(C) for e in entries], dim=1).contiguous()
        out = K.int8_dequant(q_flat, scales, spec.offsets + (spec.n,))
        return tree_unflatten(treedef, unpack_client_leaves(out, spec))

    def encode(self, delta, residual=None, rng=None):
        return _one_client(self, delta, residual)

    def decode(self, payload):
        return tree_map(lambda x: x[0], self.decode_cohort(tree_map(lambda x: x[None], payload)))


# ---------------------------------------------------------------------------
# Analytic bytes-moved accounting (the reference's byte models, unchanged)
# ---------------------------------------------------------------------------


def server_apply_bytes(
    n: int, c: int, opt: str, dp_noise: bool = False, fused: bool = False,
    dtype_bytes: int = 4,
) -> float:
    """Device-memory bytes one server apply moves, counting each primitive
    pass over params-sized data (the per-leaf chain materializes each step).
    Fused kernel: read CN + params + lanes [+ noise N], write params + lanes."""
    lanes = {"fedavg": 0, "fedmom": 1, "fedadam": 2}[opt]
    if fused:
        reads = c * n + n + lanes * n + (n if dp_noise else 0)
        writes = n + lanes * n
        return float(dtype_bytes) * (reads + writes)
    weigh = 2 * c * n  # x * w broadcast materializes (C, N)
    reduce = c * n + n
    divide = 2 * n
    noise = 3 * n if dp_noise else 0  # gen write + (pg, noise) read + write
    outer = {
        "fedavg": 3 * n,  # read p, pg; write p
        "fedmom": 9 * n,  # mom update 3N + nesterov combine 3N + params 3N
        "fedadam": 10 * n,  # m 3N + v 3N + params read p,m,v write p 4N
    }[opt]
    metrics = c * n + 2 * n  # delta norms + pg norm + model norm
    return float(dtype_bytes) * (weigh + reduce + divide + noise + outer + metrics)


def topk_encode_bytes(n: int, fused: bool = False, dtype_bytes: int = 4) -> float:
    """Bytes one top-k+EF encode moves over the n-element delta. Per leaf: xf
    add (3n), abs (2n), mask compare (2n), select (3n), residual subtract (3n)
    and the selection's own read (n). Fused: xf add (3n) + selection read (n)
    + one mask/EF pass (read xf, write kept + residual = 3n)."""
    if fused:
        return float(dtype_bytes) * (3 * n + n + 3 * n)
    return float(dtype_bytes) * (3 * n + 2 * n + n + 2 * n + 3 * n + 3 * n)
