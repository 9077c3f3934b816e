"""Pattern-aware transformer engine, train mode — the counterpart of
``repro.models.transformer``.

Layers are grouped into *segments* by ``plan_segments`` exactly as the
reference groups them: a short prefix plus a periodic body whose parameters
are stacked on a leading ``layers`` axis. The reference runs the body with
``lax.scan``; here a Python loop walks the stacked axis. The parameter tree
therefore has the reference's key paths and shapes leaf for leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import LayerKind, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ParamDesc, apply_norm, norm_desc, stack_descs
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class SegmentPlan:
    kinds: Tuple[LayerKind, ...]  # one per position within the body
    n_repeat: int  # stack length (1 = executed inline)
    first_layer: int  # absolute index of this segment's first layer

    @property
    def period(self) -> int:
        return len(self.kinds)


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
    if kind.mixer != "attn" or kind.cross_attn or kind.ffn != "dense":
        raise NotImplementedError(
            f"layer kind {kind} is not ported yet: the port has the dense "
            f"attention decoder only (ROADMAP.md queue A)"
        )
    return {
        "norm1": norm_desc(cfg),
        "mixer": attn_mod.attn_desc(cfg),
        "norm2": norm_desc(cfg),
        "ffn": moe_mod.dense_ffn_desc(cfg, cfg.d_ff),
    }


def _segment_desc(cfg: ModelConfig, seg: SegmentPlan) -> dict:
    body = {f"pos{p}": _layer_desc(cfg, k) for p, k in enumerate(seg.kinds)}
    if seg.n_repeat > 1:
        body = stack_descs(body, seg.n_repeat)
    return body


def model_desc(cfg: ModelConfig) -> dict:
    if cfg.enc_dec or cfg.pos_embedding == "learned":
        raise NotImplementedError(
            f"{cfg.name}: learned positions and encoder-decoder models are not "
            f"ported yet (ROADMAP.md queue A)"
        )
    d: Dict[str, Any] = {
        "embed": ParamDesc((cfg.padded_vocab, cfg.d_model), "embed"),
        "segments": [_segment_desc(cfg, s) for s in plan_segments(cfg.layer_kinds())],
        "final_norm": norm_desc(cfg),
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDesc((cfg.d_model, cfg.padded_vocab), "normal")
    return d


def _apply_layer(cfg: ModelConfig, p: dict, h: torch.Tensor, *, window,
                 positions: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, p["norm1"], h)
    h = h + attn_mod.attention(cfg, p["mixer"], x, positions=positions, causal=True,
                               window=window)
    x2 = apply_norm(cfg, p["norm2"], h)
    return h + moe_mod.dense_ffn(cfg, p["ffn"], x2)


def forward(
    cfg: ModelConfig,
    params: dict,
    tokens: torch.Tensor,  # (B, S) integer
    *,
    logits_mode: str = "full",  # 'full' | 'hidden' (return pre-head h)
):
    """Train-mode forward. Returns ``(logits (B,S,V) | hidden (B,S,D), aux)``;
    ``aux`` is the MoE auxiliary loss, 0 for the dense decoder."""
    B, S = tokens.shape
    compute_dtype = getattr(torch, cfg.compute_dtype)
    h = params["embed"][tokens.long()].to(compute_dtype)
    positions = torch.arange(S, device=tokens.device)

    all_kinds = cfg.layer_kinds()
    for seg, seg_params in zip(plan_segments(all_kinds), params["segments"]):
        for r in range(seg.n_repeat):
            params_r = (
                seg_params if seg.n_repeat == 1
                else tree_map(lambda x: x[r], seg_params)
            )
            for pidx, kind in enumerate(seg.kinds):
                h = _apply_layer(cfg, params_r[f"pos{pidx}"], h, window=kind.window,
                                 positions=positions)

    h = apply_norm(cfg, params["final_norm"], h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if logits_mode == "hidden":
        return h, aux
    return project_logits(cfg, params, h), aux


def project_logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", h, params["embed"].to(h.dtype))
    else:
        logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"].to(h.dtype))
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits
