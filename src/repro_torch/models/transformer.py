"""Pattern-aware transformer engine — the counterpart of
``repro.models.transformer``: decoder stacks of attention or SSM layers with
dense or mixture-of-experts FFNs, and whisper's encoder-decoder (a
non-causal audio encoder, learned decoder positions, cross-attention with a
cache written at prefill).

Layers are grouped into *segments* by ``plan_segments`` exactly as the
reference groups them: a short prefix plus a periodic body whose parameters
are stacked on a leading ``layers`` axis. The reference runs the body (and
the encoder's stack) with ``lax.scan``; here a Python loop walks the stacked
axis, and the caches of a body are stacked on the same axis. The parameter
and cache trees therefore have the reference's key paths and shapes leaf for
leaf.

Modes: 'train' (no cache), 'prefill' (returns the cache), 'decode' (one token,
updates the cache).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamDesc, apply_norm, norm_desc, stack_descs
from repro_torch.tree import tree_flatten, tree_map, tree_stack, tree_unflatten

WINDOW_SENTINEL = attn_mod.WINDOW_SENTINEL


@dataclass(frozen=True)
class SegmentPlan:
    kinds: Tuple[LayerKind, ...]  # one per position within the body
    n_repeat: int  # stack length (1 = executed inline)
    first_layer: int  # absolute index of this segment's first layer

    @property
    def period(self) -> int:
        return len(self.kinds)

    @property
    def n_layers(self) -> int:
        return self.period * self.n_repeat

    def window_array(self, all_kinds: List[LayerKind]) -> torch.Tensor:
        """(n_repeat, period) int32 window per layer (sentinel = full attention).
        Each layer gets its entry as a 0-d tensor, as the reference's layers
        get theirs from a jnp array (never a Python int)."""
        w = np.full((self.n_repeat, self.period), WINDOW_SENTINEL, dtype=np.int64)
        for r in range(self.n_repeat):
            for p in range(self.period):
                k = all_kinds[self.first_layer + r * self.period + p]
                if k.window is not None:
                    w[r, p] = k.window
        return torch.from_numpy(np.minimum(w, WINDOW_SENTINEL).astype(np.int32))


def plan_segments(kinds: List[LayerKind], max_period: int = 12) -> List[SegmentPlan]:
    n = len(kinds)
    sigs = [k.signature for k in kinds]
    for r in range(0, min(3, n) + 1):
        m = n - r
        if m == 0:
            break
        for p in range(1, max_period + 1):
            if m % p:
                continue
            if all(sigs[r + i] == sigs[r + (i % p)] for i in range(m)):
                segs = [
                    SegmentPlan(kinds=(kinds[i],), n_repeat=1, first_layer=i)
                    for i in range(r)
                ]
                segs.append(
                    SegmentPlan(
                        kinds=tuple(kinds[r : r + p]), n_repeat=m // p, first_layer=r
                    )
                )
                return segs
    return [SegmentPlan(kinds=(k,), n_repeat=1, first_layer=i) for i, k in enumerate(kinds)]


def _layer_desc(cfg: ModelConfig, kind: LayerKind) -> dict:
    d = {"norm1": norm_desc(cfg)}
    if kind.mixer == "attn":
        d["mixer"] = attn_mod.attn_desc(cfg)
    else:
        d["mixer"] = ssm_mod.ssm_desc(cfg)
    if kind.cross_attn:
        d["norm_cross"] = norm_desc(cfg)
        d["cross_attn"] = attn_mod.attn_desc(cfg, cross=True)
    if kind.ffn == "dense":
        d["norm2"] = norm_desc(cfg)
        d["ffn"] = moe_mod.dense_ffn_desc(cfg, cfg.d_ff)
    elif kind.ffn == "moe":
        d["norm2"] = norm_desc(cfg)
        d["ffn"] = moe_mod.moe_ffn_desc(cfg)
    return d


def _segment_desc(cfg: ModelConfig, seg: SegmentPlan) -> dict:
    body = {f"pos{p}": _layer_desc(cfg, k) for p, k in enumerate(seg.kinds)}
    if seg.n_repeat > 1:
        body = stack_descs(body, seg.n_repeat, stack_axis_name="layers")
    return body


def model_desc(cfg: ModelConfig) -> dict:
    d: Dict[str, Any] = {
        "embed": ParamDesc((cfg.padded_vocab, cfg.d_model), ("vocab", None), "embed"),
    }
    if cfg.pos_embedding == "learned":
        d["pos_embed"] = ParamDesc((cfg.max_seq_len, cfg.d_model), (None, None), "embed")
    d["segments"] = [_segment_desc(cfg, s) for s in plan_segments(cfg.layer_kinds())]
    d["final_norm"] = norm_desc(cfg)
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDesc((cfg.d_model, cfg.padded_vocab), (None, "vocab"), "normal")
    if cfg.enc_dec:
        d["encoder"] = {
            "audio_pos": ParamDesc((cfg.n_audio_frames, cfg.d_model), (None, None), "embed"),
            "segments": [_segment_desc(cfg, s) for s in plan_segments(cfg.encoder_layer_kinds())],
            "final_norm": norm_desc(cfg),
        }
    return d


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def _layer_cache(cfg: ModelConfig, kind: LayerKind, batch: int, max_len: int, dtype, device):
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def kv(length):
        shape = (batch, length, hkv, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    c: Dict[str, Any] = {"mixer": kv(max_len) if kind.mixer == "attn"
                         else ssm_mod.empty_ssm_cache(cfg, batch, device)}
    if kind.cross_attn:
        c["cross"] = kv(cfg.n_audio_frames)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """Zero caches in the reference's layout on ``device`` (the card unless the
    caller asks for the CPU, or ``meta``); a stacked body's leaves are
    expanded views of one layer's zeros (the reference broadcasts them)."""
    device = resolve_device(device)
    out = []
    for seg in plan_segments(cfg.layer_kinds()):
        body = {
            f"pos{p}": _layer_cache(cfg, k, batch, max_len, dtype, device)
            for p, k in enumerate(seg.kinds)
        }
        if seg.n_repeat > 1:
            body = tree_map(lambda x: x[None].expand((seg.n_repeat,) + x.shape), body)
        out.append(body)
    return out


# ---------------------------------------------------------------------------
# Layer / segment application
# ---------------------------------------------------------------------------


def _apply_layer(
    cfg: ModelConfig,
    kind: LayerKind,
    p: dict,
    h: torch.Tensor,
    *,
    window,
    positions: torch.Tensor,
    cache: Optional[dict],
    cache_index,
    enc_out: Optional[torch.Tensor],
    decode: bool,
    use_pallas: bool,
) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """Returns ``(h, new_cache, aux)``; ``aux`` is the MoE layer's
    load-balance loss (the number 0.0 for other layers)."""
    aux = 0.0
    new_cache: Dict[str, Any] = {}
    x = apply_norm(cfg, p["norm1"], h)
    mixer_cache = cache.get("mixer") if cache else None
    if kind.mixer == "attn":
        a, mc = attn_mod.attention(
            cfg, p["mixer"], x, positions=positions, causal=True, window=window,
            cache=mixer_cache, cache_index=cache_index, use_pallas=use_pallas,
        )
    else:
        a, mc = ssm_mod.ssm_block(
            cfg, p["mixer"], x, cache=mixer_cache, decode=decode, use_pallas=use_pallas
        )
    if mc is not None:
        new_cache["mixer"] = mc
    h = h + a

    if kind.cross_attn:
        xc = apply_norm(cfg, p["norm_cross"], h)
        if decode:  # the memory's k/v, written at prefill
            cc = cache["cross"]
            ca = _cross_attend_cached(p["cross_attn"], xc, cc)
            new_cache["cross"] = cc
        else:
            ca, cc = attn_mod.attention(
                cfg, p["cross_attn"], xc, positions=positions, causal=False,
                cache={} if cache is not None else None, kv_source=enc_out,
            )
            if cc is not None:
                new_cache["cross"] = cc
        h = h + ca

    if kind.ffn != "none":
        x2 = apply_norm(cfg, p["norm2"], h)
        if kind.ffn == "dense":
            f = moe_mod.dense_ffn(cfg, p["ffn"], x2)
        else:
            f, aux = moe_mod.moe_ffn(cfg, p["ffn"], x2)
        h = h + f
    return h, (new_cache if (cache is not None or decode) else None), aux


def _cross_attend_cached(p: dict, x: torch.Tensor, cross_cache: dict) -> torch.Tensor:
    """Decode-time cross-attention against the encoder k/v cached at prefill."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k, v = cross_cache["k"].to(x.dtype), cross_cache["v"].to(x.dtype)
    out = attn_mod.sdpa(q, k, v, mask=None)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


class _StackGrads:
    """The gradient buffers of one forward's stacked leaves, filled row by row
    in the backward (:class:`_LayerViews`)."""

    def __init__(self, stacked: List[torch.Tensor]):
        self.like = [(x.shape, x.dtype, x.device) for x in stacked]
        self.bufs: Optional[List[torch.Tensor]] = None


class _LayerViews(torch.autograd.Function):
    """Row ``r`` of each stacked leaf, as views: one layer's weights.

    The ``n_repeat`` nodes of a forward are chained through ``link`` (an empty
    tensor), so the backward runs them from the top layer that took a gradient
    down to layer 0. Each writes its layer's gradients into row ``r`` of one
    buffer per leaf, allocated by the first to run, and layer 0's hands the
    whole buffers to the leaves. A plain ``x[r]`` would give each layer a
    zero-filled stack-sized gradient to add into the leaf's; an ``unbind``
    would hold every layer's gradient apart until one ``stack`` at the end,
    which left the allocator freeing and retrying at mamba2-1.3b's size."""

    @staticmethod
    def forward(ctx, grads: _StackGrads, r: int, link, *stacked):
        ctx.grads, ctx.r = grads, r
        ctx.set_materialize_grads(False)
        link = stacked[0].new_empty(0) if stacked else torch.empty(0)  # a cache may have no leaf
        return (link,) + tuple(x[r] for x in stacked)

    @staticmethod
    @once_differentiable
    def backward(ctx, _link_grad, *layer_grads):
        grads, r = ctx.grads, ctx.r
        if grads.bufs is None:
            grads.bufs = [torch.empty(s, dtype=d, device=dev) for s, d, dev in grads.like]
            for buf in grads.bufs:
                buf[r + 1:].zero_()  # the layers above took no gradient
        for buf, g in zip(grads.bufs, layer_grads):
            if g is None:
                buf[r].zero_()
            else:
                buf[r].copy_(g)
        if r != 0:
            return (None, None, None) + (None,) * len(layer_grads)
        bufs, grads.bufs = grads.bufs, None
        return (None, None, None) + tuple(bufs)


def layer_views(seg_params, n_repeat: int) -> list:
    """The ``n_repeat`` per-layer trees of a stacked tree, as views of each
    leaf's rows (the tree itself when ``n_repeat`` is 1), taken through
    :class:`_LayerViews`, whose backward fills each leaf's gradient row by
    row. Without a gradient the views are plain rows (the caches' too)."""
    if n_repeat == 1:
        return [seg_params]
    leaves, treedef = tree_flatten(seg_params)
    grads, link, out = _StackGrads(leaves), None, []
    for r in range(n_repeat):
        link, *views = _LayerViews.apply(grads, r, link, *leaves)
        out.append(tree_unflatten(treedef, views))
    return out


def _apply_segment(
    cfg: ModelConfig,
    seg: SegmentPlan,
    seg_params: dict,
    h: torch.Tensor,
    *,
    all_kinds: List[LayerKind],
    positions: torch.Tensor,
    seg_cache,
    cache_index,
    enc_out,
    decode: bool,
    use_pallas: bool,
    remat: bool = False,
):
    """Runs the body ``n_repeat`` times; returns ``(h, new_cache, aux)`` with
    the per-repeat caches stacked on a leading axis, as the reference's scan,
    and the layers' MoE losses summed per repeat, then over repeats.

    With ``remat`` (and not decoding) every layer runs under
    ``torch.utils.checkpoint``: the backward pass recomputes one layer's
    internals at a time from its input, as the reference's per-layer
    ``jax.checkpoint`` does."""
    windows = seg.window_array(all_kinds)  # (n_repeat, period)

    def layer(kind, p, h, window, cache):
        return _apply_layer(cfg, kind, p, h, window=window, positions=positions, cache=cache,
                            cache_index=cache_index, enc_out=enc_out, decode=decode,
                            use_pallas=use_pallas)

    if remat and not decode:
        plain = layer

        def layer(*args):
            return checkpoint(plain, *args, use_reentrant=False)

    layer_params = layer_views(seg_params, seg.n_repeat)
    layer_caches = ([None] * seg.n_repeat if seg_cache is None
                    else layer_views(seg_cache, seg.n_repeat))
    new_caches = []
    aux_acc = 0.0
    for r, (params_r, cache_r) in enumerate(zip(layer_params, layer_caches)):
        new_cache_r = {}
        aux_r = 0.0
        for pidx, kind in enumerate(seg.kinds):
            key = f"pos{pidx}"
            h, nc, aux = layer(kind, params_r[key], h, windows[r, pidx],
                               cache_r.get(key) if cache_r else None)
            if nc is not None:
                new_cache_r[key] = nc
            aux_r = aux_r + aux
        new_caches.append(new_cache_r)
        aux_acc = aux_acc + aux_r
    if seg.n_repeat == 1:
        return h, (new_caches[0] or None), aux_acc
    return h, tree_stack(new_caches), aux_acc


# ---------------------------------------------------------------------------
# Encoder (audio, non-causal)
# ---------------------------------------------------------------------------


def _encode(cfg: ModelConfig, enc_params: dict, audio_embed: torch.Tensor,
            use_pallas: bool) -> torch.Tensor:
    """The audio encoder: frame embeddings plus ``audio_pos``, then every
    encoder layer (non-causal self-attention, which ``use_pallas`` sends to
    the flash kernel, and the dense FFN), then the final norm."""
    n_frames = audio_embed.shape[1]
    h = audio_embed + enc_params["audio_pos"][None, :n_frames].to(audio_embed.dtype)
    positions = torch.arange(n_frames, device=audio_embed.device)

    def enc_layer(h, p):
        x = apply_norm(cfg, p["norm1"], h)
        a, _ = attn_mod.attention(cfg, p["mixer"], x, positions=positions, causal=False,
                                  use_pallas=use_pallas)
        h = h + a
        x2 = apply_norm(cfg, p["norm2"], h)
        return h + moe_mod.dense_ffn(cfg, p["ffn"], x2)

    for seg, seg_params in zip(plan_segments(cfg.encoder_layer_kinds()), enc_params["segments"]):
        for params_r in layer_views(seg_params, seg.n_repeat):
            h = enc_layer(h, params_r["pos0"])
    return apply_norm(cfg, enc_params["final_norm"], h)


# ---------------------------------------------------------------------------
# Public forward
# ---------------------------------------------------------------------------


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,  # (B, S) integer
    *,
    audio_embed: Optional[torch.Tensor] = None,  # (B, F, D) for enc-dec (stub frontend)
    mode: str = "train",  # 'train' | 'prefill' | 'decode'
    cache=None,
    cache_index=None,  # decode: position of the first new token (an int)
    remat: bool = False,  # per-layer recomputation in the backward pass
    use_pallas: bool = False,
    logits_mode: str = "full",  # 'full' | 'last' | 'hidden' (return pre-head h)
):
    """Returns ``(logits (B,S,V) | hidden (B,S,D), aux, new_cache)``; ``aux``
    is the MoE auxiliary loss summed over layers (0 without MoE layers);
    ``new_cache`` is None in train mode."""
    assert mode in ("train", "prefill", "decode")
    decode = mode == "decode"
    B, S = tokens.shape
    compute_dtype = getattr(torch, cfg.compute_dtype)
    h = params["embed"][tokens.long()].to(compute_dtype)

    if decode:
        assert cache_index is not None
        positions = cache_index + torch.arange(S, device=tokens.device)
    else:
        positions = torch.arange(S, device=tokens.device)

    if cfg.pos_embedding == "learned":
        # dynamic_slice_in_dim's clamp: the slice stays inside the table
        start = min(max(int(cache_index) if decode else 0, 0), cfg.max_seq_len - S)
        h = h + params["pos_embed"][start:start + S].to(compute_dtype)

    enc_out = None
    if cfg.enc_dec and not decode:
        if audio_embed is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: it needs audio_embed")
        enc_out = _encode(cfg, params["encoder"], audio_embed.to(compute_dtype), use_pallas)

    all_kinds = cfg.layer_kinds()
    segs = plan_segments(all_kinds)
    if mode == "prefill" and cache is None:
        cache = _prefill_placeholder_cache(segs)

    aux_total = 0.0
    new_cache = [] if (cache is not None or decode) else None
    for seg, seg_params, seg_cache in zip(
        segs, params["segments"], cache if cache is not None else [None] * len(segs)
    ):
        h, seg_new_cache, aux = _apply_segment(
            cfg, seg, seg_params, h, all_kinds=all_kinds, positions=positions,
            seg_cache=seg_cache, cache_index=cache_index, enc_out=enc_out, decode=decode,
            use_pallas=use_pallas, remat=remat,
        )
        aux_total = aux_total + aux
        if new_cache is not None:
            new_cache.append(seg_new_cache)

    h = apply_norm(cfg, params["final_norm"], h)
    aux_total = torch.as_tensor(aux_total, dtype=torch.float32, device=h.device)
    if logits_mode == "hidden":
        return h, aux_total, new_cache
    if logits_mode == "last":
        h = h[:, -1:]
    return project_logits(cfg, params, h), aux_total, new_cache


def project_logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", h, params["embed"].to(h.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"].to(h.dtype))
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits


def _prefill_placeholder_cache(segs):
    """Prefill computes the cache from scratch; the placeholder asks each layer
    to return its cache."""
    return [{f"pos{p}": {"mixer": {}} for p in range(seg.period)} for seg in segs]
