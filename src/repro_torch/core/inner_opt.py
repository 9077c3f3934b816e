"""Local (client-side) optimizers: AdamW and SGD, the cosine learning-rate
schedule and global-norm clipping — the counterpart of ``repro.core.inner_opt``.

Scalars the reference computes as float32 arrays (the learning rate, the bias
corrections) are computed here on the host in numpy float32, so a step needs no
device round trip and uses the same float32 values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.tree import global_norm


@dataclass(frozen=True)
class InnerOptConfig:
    name: str = "adamw"  # 'adamw' | 'sgd'
    lr_max: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 1e-5
    grad_clip: float = 1.0
    # cosine schedule (synchronized across sequential steps, paper Table 3)
    warmup_steps: int = 100
    total_steps: int = 10_000
    alpha: float = 0.1  # lr_min = alpha * lr_max


def cosine_lr(cfg: InnerOptConfig, step: int) -> float:
    """The learning rate at sequential step ``step``, in float32."""
    f32 = np.float32
    s = f32(step)
    warm = f32(cfg.lr_max) * s / f32(max(1.0, cfg.warmup_steps))
    prog = np.clip(
        (s - f32(cfg.warmup_steps)) / f32(max(1.0, cfg.total_steps - cfg.warmup_steps)),
        f32(0.0), f32(1.0),
    )
    lr_min = cfg.alpha * cfg.lr_max
    cos = f32(lr_min) + f32(0.5 * (cfg.lr_max - lr_min)) * (
        f32(1.0) + np.cos(f32(np.pi) * prog)
    )
    return float(warm if s < f32(cfg.warmup_steps) else cos)


def clip_by_global_norm(leaves: List[torch.Tensor], max_norm: float):
    """Scale the leaves so their global norm is at most ``max_norm``; returns
    ``(clipped, raw_norm)`` with the norm left on the device."""
    gn = global_norm(leaves)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return [x * scale.to(x.dtype) for x in leaves], gn


def init_inner_state(cfg: InnerOptConfig, leaves: List[torch.Tensor]) -> Dict[str, Any]:
    """Optimizer state over a flat leaf list (the params tree's flatten order)."""
    zeros = lambda: [torch.zeros_like(p) for p in leaves]  # noqa: E731
    if cfg.name == "adamw":
        return {"m": zeros(), "v": zeros(), "count": 0}
    if cfg.name == "sgd":
        return {"mom": zeros(), "count": 0}
    raise ValueError(cfg.name)


@torch.no_grad()
def inner_update(
    cfg: InnerOptConfig,
    params: List[torch.Tensor],
    grads: List[torch.Tensor],
    state: Dict[str, Any],
    global_step: int,  # sequential step index for the cosine schedule
) -> Tuple[List[torch.Tensor], Dict[str, Any], Dict[str, Any]]:
    """One local optimizer step over flat leaf lists. Returns
    ``(params, state, metrics)``; weight decay applies to every leaf."""
    grads, raw_norm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = cosine_lr(cfg, global_step)
    count = state["count"] + 1

    if cfg.name == "adamw":
        c = np.float32(count)
        b1c = float(np.float32(1.0) - np.float32(cfg.beta1) ** c)
        b2c = float(np.float32(1.0) - np.float32(cfg.beta2) ** c)
        new_m = [cfg.beta1 * m + (1 - cfg.beta1) * g.to(m.dtype)
                 for m, g in zip(state["m"], grads)]
        new_v = [cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g.to(v.dtype))
                 for v, g in zip(state["v"], grads)]
        new_params = []
        for p, m, v in zip(params, new_m, new_v):
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p
            new_params.append((p - lr * step).to(p.dtype))
        new_state = {"m": new_m, "v": new_v, "count": count}
    else:  # sgd with heavy-ball momentum
        new_mom = [0.9 * mom + g.to(mom.dtype) for mom, g in zip(state["mom"], grads)]
        new_params = [(p - lr * (mom + cfg.weight_decay * p)).to(p.dtype)
                      for p, mom in zip(params, new_mom)]
        new_state = {"mom": new_mom, "count": count}

    metrics = {"lr": lr, "grad_norm": raw_norm, "applied_update_norm": lr * raw_norm}
    return new_params, new_state, metrics
