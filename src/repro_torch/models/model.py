"""Public model API, the counterpart of ``repro.models.model``:

    model = Model(cfg)
    params = model.init(seed, device="cuda")
    loss, metrics = model.loss(params, batch, remat=True)
    logits, cache = model.prefill(params, batch, use_pallas=True)
    logits, cache = model.decode_step(params, cache, tokens, cache_index)

An encoder-decoder model (whisper) takes its audio frame embeddings as
``batch["audio_embed"]`` (B, F, D) in ``loss``, ``forward`` and ``prefill``;
decode steps read the cross-attention cache that prefill wrote.

The backward pass is autograd over the plain torch ops; the reference has no
custom VJP on this path either.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import init_params, param_axes, param_shapes


def _ce_sums(logits: torch.Tensor, labels: torch.Tensor):
    """Σ nll, Σ lse², Σ correct and the count over the labels ≥ 0 (float32)."""
    logits = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - ll, torch.zeros_like(ll))
    zsq = torch.where(valid, torch.square(lse), torch.zeros_like(lse))
    acc = valid & (torch.argmax(logits, dim=-1) == safe)
    return nll.sum(), zsq.sum(), acc.sum().float(), valid.sum()


def _ce_finish(nll_sum, zsq_sum, acc_sum, n_valid, z_loss: float):
    n_valid_f = torch.clamp(n_valid, min=1).float()
    ce = nll_sum / n_valid_f
    metrics = {"ce": ce, "n_tokens": n_valid_f, "accuracy": acc_sum / n_valid_f}
    loss = ce
    if z_loss:
        zl = z_loss * zsq_sum / n_valid_f
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) integer; -1 = ignore
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Softmax cross-entropy over the labels ≥ 0: ``(loss, {"ce", "n_tokens",
    "z_loss" (when ``z_loss``), "accuracy"})``, loss = ce + z_loss·mean(lse²)."""
    return _ce_finish(*_ce_sums(logits, labels), z_loss)


def chunked_cross_entropy(
    cfg,
    params,
    h: torch.Tensor,  # (B, S, D) pre-head hidden states
    labels: torch.Tensor,  # (B, S) integer; -1 = ignore
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LM head + :func:`cross_entropy` over sequence chunks, so the
    (B, chunk, V) logits block is the largest vocab-sized temporary."""
    B, S, D = h.shape
    V = cfg.vocab_size
    # chunk: largest power-of-two divisor of S with B*chunk*V*4B <= ~1 GB
    budget = max(1, (1 << 30) // max(1, B * V * 4))
    chunk = 1
    while chunk * 2 <= min(budget, 512) and S % (chunk * 2) == 0:
        chunk *= 2
    if S % chunk:
        chunk = 1

    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    sums = [zero, zero, zero, torch.zeros((), dtype=torch.int64, device=h.device)]
    for c0 in range(0, S, chunk):
        logits = transformer.project_logits(cfg, params, h[:, c0:c0 + chunk])
        sums = [a + b for a, b in zip(sums, _ce_sums(logits, labels[:, c0:c0 + chunk]))]
    return _ce_finish(*sums, z_loss)


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._desc = transformer.model_desc(cfg)

    # -- parameters -----------------------------------------------------
    def desc(self):
        return self._desc

    def init(self, seed: int, device="cuda", dtype=None):
        """The weights on ``device`` (the card unless the caller asks for the
        CPU, or ``meta`` for shapes only); cuda without a card raises."""
        dtype = dtype or getattr(torch, self.cfg.param_dtype)
        return init_params(seed, self._desc, dtype, resolve_device(device))

    def axes(self):
        """The logical axis of every dim of every leaf (``sharding.specs``)."""
        return param_axes(self._desc)

    def shapes(self):
        return param_shapes(self._desc)

    def abstract_params(self, dtype=None):
        """The params tree as ``meta`` tensors: shapes and dtypes, no memory."""
        return self.init(0, device="meta", dtype=dtype)

    def loss(self, params, batch: Dict[str, torch.Tensor], *, remat: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token LM loss. batch['tokens'] (B,S); optional batch['loss_mask'].
        ``remat`` recomputes each layer in the backward pass."""
        tokens = batch["tokens"].long()
        h, aux, _ = transformer.forward(self.cfg, params, tokens,
                                        audio_embed=batch.get("audio_embed"), remat=remat,
                                        logits_mode="hidden")
        labels = torch.cat(
            [tokens[:, 1:], torch.full((tokens.shape[0], 1), -1, dtype=tokens.dtype,
                                       device=tokens.device)], dim=1
        )
        if "loss_mask" in batch:
            labels = torch.where(batch["loss_mask"] > 0, labels, torch.full_like(labels, -1))
        loss, metrics = chunked_cross_entropy(self.cfg, params, h, labels, self.cfg.z_loss)
        if self.cfg.is_moe:
            loss = loss + self.cfg.router_aux_coef * aux
            metrics["moe_aux"] = aux
        metrics["loss"] = loss
        return loss, metrics

    def forward(self, params, batch: Dict[str, torch.Tensor], *, mode: str = "train",
                cache=None, cache_index=None, remat: bool = False, use_pallas: bool = False):
        """``(logits, aux, new_cache)`` of ``transformer.forward``."""
        return transformer.forward(
            self.cfg, params, batch["tokens"], audio_embed=batch.get("audio_embed"), mode=mode,
            cache=cache, cache_index=cache_index, remat=remat, use_pallas=use_pallas,
        )

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
        """Zero caches on ``device`` (the card unless the caller asks for the
        CPU, or ``meta``); cuda without a card raises."""
        return transformer.init_cache(self.cfg, batch, max_len, dtype, device)

    def prefill(self, params, batch, *, use_pallas: bool = False):
        """Fills the cache; returns next-token logits (last position only — the
        full (B, S, V) logits tensor is never materialized)."""
        logits, _, cache = transformer.forward(
            self.cfg, params, batch["tokens"], audio_embed=batch.get("audio_embed"),
            mode="prefill", use_pallas=use_pallas, logits_mode="last",
        )
        return logits, cache

    def decode_step(self, params, cache, tokens, cache_index, *, use_pallas: bool = False):
        """tokens: (B, 1) — one new token per sequence; cache_index: its position."""
        logits, _, new_cache = self.forward(
            params, {"tokens": tokens}, mode="decode", cache=cache, cache_index=cache_index,
            use_pallas=use_pallas,
        )
        return logits, new_cache


def build_model(name_or_cfg) -> Model:
    if isinstance(name_or_cfg, str):
        from repro_torch.configs import get_config

        return Model(get_config(name_or_cfg))
    return Model(name_or_cfg)
