"""Pseudo-gradient compression for the client→server uplink, the counterpart
of ``repro.core.compression`` (Algorithm 1 L.26 PostProcess):

  - bf16 stochastic-rounding cast            (2x uplink reduction, unbiased)
  - per-tensor int8 quantization             (~4x, scale per tensor)
  - top-k sparsification with error feedback (10-100x, stateful residual per client)

The primitives (``cast_compress`` / ``int8_compress`` / ``topk_compress``) act
on one pseudo-gradient tree. The :class:`Codec` objects wrap them into the
uplink the federated round consumes (``core/federated.py``): ``encode`` runs
client-side and its payload is what crosses the wire; ``decode`` restores a
float32 tree server-side; ``nbytes`` / ``payload_nbytes`` are the analytic
and the measured bytes of one upload, and agree.

The reference vmaps ``encode`` / ``decode`` over the client axis; here that
batch dimension is written out as :meth:`Codec.encode_cohort` /
:meth:`Codec.decode_cohort`, which loop over clients. The fused flat-buffer
codecs (``kernels/fedcore``) override them to run one kernel launch for the
whole cohort.

Randomness: torch cannot reproduce JAX's threefry streams. An ``rng`` here is
a ``(2,)`` uint32 key like the server's rng lane, and the stochastic-rounding
noise is drawn from ``torch.Generator``s seeded from it by this package's own
rule (:func:`leaf_seeds`). ``cast_compress`` and ``Bf16Codec.encode`` also
take the noise itself (``noise=``, uint32 values in [0, 2¹⁶) as int32/int64
tensors), and a bf16 codec draws a cohort's noise in one method,
``cohort_noise``, so a test can hand both packages the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_stack, tree_unflatten

# ---------------------------------------------------------------------------
# casting (with optional stochastic rounding)
# ---------------------------------------------------------------------------


def leaf_seeds(rng, n: int) -> List[int]:
    """``n`` generator seeds derived from a ``(2,)`` uint32 key: this
    package's stand-in for ``jax.random.split(rng, n)``."""
    words = np.random.SeedSequence([int(x) for x in np.asarray(rng, np.uint32)])
    return [int(s) for s in words.generate_state(n, np.uint64)]


def draw_sr_noise(leaves: Sequence[torch.Tensor], rng) -> List[torch.Tensor]:
    """Per-leaf stochastic-rounding noise: int32 uniform in [0, 2¹⁶), one
    generator per leaf on the leaf's device, seeded by :func:`leaf_seeds`."""
    out = []
    for leaf, seed in zip(leaves, leaf_seeds(rng, len(leaves))):
        gen = torch.Generator(device=leaf.device).manual_seed(seed)
        out.append(torch.randint(0, 1 << 16, tuple(leaf.shape), generator=gen,
                                 dtype=torch.int32, device=leaf.device))
    return out


def sr_bf16_bits(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding to bf16 at the bit level: add the noise to the f32
    pattern (uint32 wrap), truncate to the high half. Works in int64 (torch
    has no uint32 arithmetic) and builds the bf16 bits directly; a NaN result
    is the canonical quiet NaN with its sign, as XLA's convert gives."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = ((bits + noise.to(torch.int64)) & 0xFFFF0000) >> 16
    nan = ((hi & 0x7F80) == 0x7F80) & ((hi & 0x007F) != 0)
    hi = torch.where(nan, (hi & 0x8000) | 0x7FC0, hi)
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi).to(torch.int16)
    return hi.view(torch.bfloat16)


def cast_compress(tree, dtype=torch.bfloat16, rng=None, noise=None):
    """Cast to a narrow dtype; with ``rng`` (or pre-drawn ``noise``, a tree
    like ``tree``), stochastic rounding keeps the cast unbiased — bf16 only.
    Without either, the deterministic round-to-nearest cast."""
    if rng is None and noise is None:
        return tree_map(lambda x: x.to(dtype), tree)
    if dtype != torch.bfloat16:
        raise ValueError(f"stochastic rounding is bf16-only, got {dtype}")
    leaves, treedef = tree_flatten(tree)
    noise_leaves = tree_leaves(noise) if noise is not None else draw_sr_noise(leaves, rng)
    return tree_unflatten(treedef, [sr_bf16_bits(x, z) for x, z in zip(leaves, noise_leaves)])


def cast_decompress(tree, dtype=torch.float32):
    return tree_map(lambda x: x.to(dtype), tree)


# ---------------------------------------------------------------------------
# top-k sparsification with error feedback
# ---------------------------------------------------------------------------


def init_error_feedback(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), tree)


def topk_indices(flat_abs: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest entries' indices, ties toward the lower flat index — the
    order ``lax.top_k`` documents. ``torch.topk`` documents none, so this is a
    stable descending sort."""
    return torch.sort(flat_abs, descending=True, stable=True).indices[:k]


def topk_compress(tree, k_fraction: float, error=None) -> Tuple[Any, Any]:
    """Keep exactly ``k = max(1, int(size·k_fraction))`` entries per tensor by
    magnitude; the dropped mass accumulates in the ``error`` residual (error
    feedback) and is re-added next round. Returns ``(sparse_tree, new_error)``.
    The residual is per-client state."""
    if error is None:
        error = init_error_feedback(tree)

    def one(x, e):
        xf = x.float() + e
        flat = xf.reshape(-1)
        k = max(1, int(flat.numel() * k_fraction))
        idx = topk_indices(torch.abs(flat), k)
        kept = torch.zeros_like(flat)
        kept[idx] = flat[idx]
        kept = kept.reshape(xf.shape)
        return kept.to(x.dtype), xf - kept

    leaves, treedef = tree_flatten(tree)
    out = [one(x, e) for x, e in zip(leaves, tree_leaves(error))]
    return (tree_unflatten(treedef, [o[0] for o in out]),
            tree_unflatten(treedef, [o[1] for o in out]))


# ---------------------------------------------------------------------------
# int8 quantization
# ---------------------------------------------------------------------------


def int8_scale(xf: torch.Tensor, dim=None) -> torch.Tensor:
    """max(absmax, 1e-12)/127 in float32, the reference's per-tensor scale
    (per row of ``dim`` when given). The divisor is a tensor on the data's
    device: a CUDA tensor divided by a Python number is multiplied by its
    reciprocal, which is not the IEEE quotient in the last bit."""
    absmax = torch.amax(torch.abs(xf)) if dim is None else torch.amax(torch.abs(xf), dim=dim)
    return torch.clamp(absmax, min=1e-12) / torch.full((), 127.0, device=absmax.device)


def quantize_int8(xf: torch.Tensor, scale) -> torch.Tensor:
    """clip(round_half_even(xf/scale), −127, 127) as int8, and 0 where that is
    NaN: XLA's f32 → int8 convert saturates and sends NaN to 0, a torch cast
    of NaN is undefined."""
    r = torch.round(xf / scale)
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    return torch.clamp(r, -127, 127).to(torch.int8)


def int8_compress(tree):
    """Per-tensor symmetric int8 quantization. Returns a tree of {q, scale}."""

    def one(x):
        xf = x.float()
        scale = int8_scale(xf)
        return {"q": quantize_int8(xf, scale), "scale": scale}

    return tree_map(one, tree)


def _is_int8_payload(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def _int8_entries_into(node, entries: List[dict]):
    """``node`` with each ``{q, scale}`` entry replaced by None, appending the
    entries in leaf order (module level, not a recursive closure: that would
    keep ``entries`` in a reference cycle until the garbage collector runs)."""
    if _is_int8_payload(node):
        entries.append(node)
        return None
    if isinstance(node, dict):
        return {k: _int8_entries_into(node[k], entries) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_int8_entries_into(x, entries) for x in node)
    raise TypeError(f"not an int8 payload node: {type(node).__name__}")


def int8_payload_leaves(payload) -> Tuple[List[dict], Any]:
    """The ``{q, scale}`` entries of an int8 payload in leaf order, and a
    treedef of the tree they replace (dicts here are tree nodes)."""
    entries: List[dict] = []
    return entries, tree_flatten(_int8_entries_into(payload, entries))[1]


def int8_decompress(ctree, like=None):
    """The f32 tree of an int8 payload tree (``like`` is unused, as in the
    reference)."""
    entries, treedef = int8_payload_leaves(ctree)
    return tree_unflatten(treedef, [c["q"].float() * c["scale"] for c in entries])


# ---------------------------------------------------------------------------
# uplink byte accounting
# ---------------------------------------------------------------------------

# CLI spelling → canonical scheme name (the ``--uplink`` flag speaks the short form)
SCHEME_ALIASES = {
    "bf16": "bfloat16",
    "identity": "float32",
    "fp32": "float32",
}


def _canon_scheme(scheme: str) -> str:
    return SCHEME_ALIASES.get(scheme, scheme)


def _topk_index_nbytes(n_total: int) -> float:
    """Bytes per sparse index on the wire, sized to the ONE flat packed buffer:
    uint16 up to 64K parameters, uint32 up to 4G, uint64 beyond."""
    if n_total <= 1 << 16:
        return 2.0
    if n_total <= 1 << 32:
        return 4.0
    return 8.0


def uplink_bytes(tree, scheme: str = "float32", k_fraction: float = 0.01) -> float:
    """Bytes a client transmits per upload under each scheme: int8 pays one
    float32 scale per tensor; top-k pays (float32 value + flat-buffer index)
    per kept entry, with ``topk_compress``'s per-tensor k."""
    scheme = _canon_scheme(scheme)
    leaves = tree_leaves(tree)
    n = sum(x.numel() for x in leaves)
    if scheme == "float32":
        return 4.0 * n
    if scheme == "bfloat16":
        return 2.0 * n
    if scheme == "int8":
        return 1.0 * n + 4.0 * len(leaves)
    if scheme == "topk":
        kept = sum(max(1, int(x.numel() * k_fraction)) for x in leaves)
        return float(kept) * (4.0 + _topk_index_nbytes(n))
    raise ValueError(scheme)


# ---------------------------------------------------------------------------
# Codec abstraction — what the federated round plugs in
# ---------------------------------------------------------------------------


def _client(tree, c: int):
    return tree_map(lambda x: x[c], tree)


class Codec:
    """An uplink codec: ``encode(delta, residual=None, rng=None) -> (payload,
    new_residual)`` and ``decode(payload) -> float32 tree``, plus byte
    accounting. Stateless codecs return the residual unchanged (``None``);
    stateful ones (:class:`TopKCodec`) carry the per-client error-feedback
    residual, which the caller keys by population client id."""

    name: str = "float32"
    stateful: bool = False  # encode carries an error-feedback residual
    needs_rng: bool = False  # encode uses randomness (stochastic rounding)

    def init_residual(self, params):
        """Zero residual state shaped like ``params`` (stateful codecs only)."""
        return None

    def encode(self, delta, residual=None, rng=None):
        return delta, residual

    def decode(self, payload):
        return payload

    def encode_cohort(self, deltas, residuals=None, rngs=None):
        """``encode`` over the leading client axis of ``deltas`` (and of
        ``residuals``; ``rngs`` one key per client): stacked payloads and
        stacked new residuals (``None`` for stateless codecs)."""
        C = tree_leaves(deltas)[0].shape[0]
        outs = [self.encode(_client(deltas, c),
                            _client(residuals, c) if residuals is not None else None,
                            rng=rngs[c] if rngs is not None else None)
                for c in range(C)]
        payload = tree_stack([o[0] for o in outs])
        new_res = tree_stack([o[1] for o in outs]) if outs[0][1] is not None else None
        return payload, new_res

    def decode_cohort(self, payloads):
        """``decode`` over the leading client axis: float32 leaves (C, ...)."""
        C = tree_leaves(payloads)[0].shape[0]
        return tree_stack([self.decode(_client(payloads, c)) for c in range(C)])

    def nbytes(self, params_like) -> float:
        """Analytic bytes per upload for a ``params_like``-shaped delta."""
        return uplink_bytes(params_like, self.name)

    def payload_nbytes(self, payload) -> float:
        """Actual bytes of one encoded payload (agrees with nbytes)."""
        return float(sum(x.numel() * x.element_size() for x in tree_leaves(payload)))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name})"


class IdentityCodec(Codec):
    """Uncompressed float32 uplink: encode/decode are exact identities."""

    name = "float32"


class Bf16Codec(Codec):
    """bfloat16 cast with stochastic rounding (unbiased). Without an rng key
    (and without ``noise``) the cast is deterministic round-to-nearest."""

    name = "bfloat16"
    needs_rng = True

    def encode(self, delta, residual=None, rng=None, noise=None):
        return cast_compress(delta, torch.bfloat16, rng=rng, noise=noise), residual

    def decode(self, payload):
        return cast_decompress(payload, torch.float32)

    def cohort_noise(self, leaves, rngs) -> List[torch.Tensor]:
        """The cohort's rounding noise, leaves ``(C, ...)``: client c's rows
        drawn from ``rngs[c]`` as :func:`draw_sr_noise` draws them. The one
        place the round draws it, so a test can substitute given bits."""
        per = [draw_sr_noise([x[c] for x in leaves], rng) for c, rng in enumerate(rngs)]
        return [torch.stack([p[i] for p in per]) for i in range(len(leaves))]

    def encode_cohort(self, deltas, residuals=None, rngs=None):
        if rngs is None:
            return super().encode_cohort(deltas, residuals)
        leaves, treedef = tree_flatten(deltas)
        noise = self.cohort_noise(leaves, rngs)
        return tree_unflatten(treedef, [sr_bf16_bits(x, z) for x, z in zip(leaves, noise)]), \
            residuals


class Int8Codec(Codec):
    """Per-tensor symmetric int8: payload leaves are {'q': int8, 'scale': f32}."""

    name = "int8"

    def encode(self, delta, residual=None, rng=None):
        return int8_compress(delta), residual

    def decode(self, payload):
        return int8_decompress(payload)


@dataclass(frozen=True)
class TopKCodec(Codec):
    """Top-k magnitude sparsification with per-client error feedback. The
    payload is the dense-with-zeros sparse tree; ``nbytes`` prices (value,
    flat index) per kept entry."""

    k_fraction: float = 0.05

    name = "topk"
    stateful = True
    _index_nbytes = staticmethod(_topk_index_nbytes)

    def __post_init__(self):
        if not 0.0 < self.k_fraction <= 1.0:
            raise ValueError(f"k_fraction must be in (0, 1], got {self.k_fraction}")

    def init_residual(self, params):
        return init_error_feedback(params)

    def encode(self, delta, residual=None, rng=None):
        return topk_compress(delta, self.k_fraction, residual)

    def decode(self, payload):
        return payload

    def decode_cohort(self, payloads):
        return payloads

    def nbytes(self, params_like) -> float:
        return uplink_bytes(params_like, "topk", self.k_fraction)

    def payload_nbytes(self, payload) -> float:
        # exactly k entries per leaf cross the wire, counted analytically: a
        # kept entry whose value is 0.0 still ships its (index, value) pair
        leaves = tree_leaves(payload)
        idx = self._index_nbytes(sum(x.numel() for x in leaves))
        kept = sum(max(1, int(x.numel() * self.k_fraction)) for x in leaves)
        return float(kept) * (4.0 + idx)


UPLINK_SCHEMES = ("float32", "bf16", "int8", "topk")


def get_codec(scheme: str, topk_fraction: float = 0.05, fused: bool = False) -> Codec:
    """Factory keyed by the ``--uplink`` spelling (aliases accepted).
    ``fused=True`` (the ``--fused-server`` path) returns the flat-buffer codecs
    of ``kernels/fedcore``, whose encode/decode run the CUDA codec kernels on
    the card. The identity codec has no fused variant."""
    canon = _canon_scheme(scheme)
    if canon == "float32":
        return IdentityCodec()
    if fused:
        # deferred: kernels/fedcore imports this module for the base classes
        from repro_torch.kernels.fedcore import FusedBf16Codec, FusedInt8Codec, FusedTopKCodec

        if canon == "bfloat16":
            return FusedBf16Codec()
        if canon == "int8":
            return FusedInt8Codec()
        if canon == "topk":
            return FusedTopKCodec(k_fraction=topk_fraction)
    if canon == "bfloat16":
        return Bf16Codec()
    if canon == "int8":
        return Int8Codec()
    if canon == "topk":
        return TopKCodec(k_fraction=topk_fraction)
    raise ValueError(f"unknown uplink scheme {scheme!r}; choose from {UPLINK_SCHEMES}")
