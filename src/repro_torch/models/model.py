"""Public model API, the counterpart of ``repro.models.model``:

    model = Model(cfg)
    params = model.init(seed, device="cuda")
    loss, metrics = model.loss(params, batch)

The backward pass is autograd over the plain torch ops; the reference has no
custom VJP on this path either.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import init_params


def chunked_cross_entropy(
    cfg,
    params,
    h: torch.Tensor,  # (B, S, D) pre-head hidden states
    labels: torch.Tensor,  # (B, S) integer; -1 = ignore
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LM head + softmax cross-entropy over sequence chunks, so the
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
    nll_sum, zsq_sum, acc_sum = zero, zero, zero
    n_valid = torch.zeros((), dtype=torch.int64, device=h.device)
    for c0 in range(0, S, chunk):
        lab = labels[:, c0:c0 + chunk].long()
        logits = transformer.project_logits(cfg, params, h[:, c0:c0 + chunk]).float()
        lse = torch.logsumexp(logits, dim=-1)
        valid = lab >= 0
        safe = torch.where(valid, lab, torch.zeros_like(lab))
        ll = torch.gather(logits, -1, safe[..., None])[..., 0]
        nll = torch.where(valid, lse - ll, torch.zeros_like(ll))
        zsq = torch.where(valid, torch.square(lse), torch.zeros_like(lse))
        acc = valid & (torch.argmax(logits, dim=-1) == safe)
        nll_sum = nll_sum + nll.sum()
        zsq_sum = zsq_sum + zsq.sum()
        acc_sum = acc_sum + acc.sum().float()
        n_valid = n_valid + valid.sum()

    n_valid_f = torch.clamp(n_valid, min=1).float()
    ce = nll_sum / n_valid_f
    metrics = {"ce": ce, "n_tokens": n_valid_f, "accuracy": acc_sum / n_valid_f}
    loss = ce
    if z_loss:
        zl = z_loss * zsq_sum / n_valid_f
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._desc = transformer.model_desc(cfg)

    def init(self, seed: int, device="cpu", dtype=None):
        dtype = dtype or getattr(torch, self.cfg.param_dtype)
        return init_params(seed, self._desc, dtype, device)

    def loss(self, params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token LM loss. batch['tokens'] (B,S); optional batch['loss_mask']."""
        tokens = batch["tokens"].long()
        h, aux = transformer.forward(self.cfg, params, tokens, logits_mode="hidden")
        labels = torch.cat(
            [tokens[:, 1:], torch.full((tokens.shape[0], 1), -1, dtype=tokens.dtype,
                                       device=tokens.device)], dim=1
        )
        if "loss_mask" in batch:
            labels = torch.where(batch["loss_mask"] > 0, labels, torch.full_like(labels, -1))
        loss, metrics = chunked_cross_entropy(self.cfg, params, h, labels, self.cfg.z_loss)
        metrics["loss"] = loss
        return loss, metrics


def build_model(name_or_cfg) -> Model:
    if isinstance(name_or_cfg, str):
        from repro_torch.configs import get_config

        return Model(get_config(name_or_cfg))
    return Model(name_or_cfg)
