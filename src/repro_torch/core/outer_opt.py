"""Server-side (outer) optimizers on the aggregated pseudo-gradient — FedAvg,
FedMom (Nesterov) and FedAdam, the counterpart of ``repro.core.outer_opt``.

Convention: pseudo-gradient Δ = θ_global − mean_k θ_k (Algorithm 1, L.7–9), so
θ ← θ − η_s · f(Δ). The optimizer lanes are trees shaped like the params.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map


@dataclass(frozen=True)
class OuterOptConfig:
    name: str = "fedavg"  # 'fedavg' | 'fedmom' | 'fedadam'
    lr: float = 1.0  # η_s
    momentum: float = 0.9  # μ_s
    nesterov: bool = True
    beta2: float = 0.99  # fedadam
    eps: float = 1e-8


#: the params-shaped state lanes each outer optimizer carries
OUTER_LANES = {"fedavg": (), "fedmom": ("momentum",), "fedadam": ("m", "v")}


def init_outer_state(cfg: OuterOptConfig, params) -> Dict[str, Any]:
    if cfg.name not in OUTER_LANES:
        raise ValueError(cfg.name)
    state: Dict[str, Any] = {"round": 0}
    for lane in OUTER_LANES[cfg.name]:
        state[lane] = tree_map(torch.zeros_like, params)
    return state


def adam_bias_corrections(cfg: OuterOptConfig, rnd: int) -> Tuple[float, float]:
    """FedAdam's (1 − μ^t, 1 − β₂^t) at outer step ``rnd``, in float32."""
    c = np.float32(rnd)
    return (float(np.float32(1.0) - np.float32(cfg.momentum) ** c),
            float(np.float32(1.0) - np.float32(cfg.beta2) ** c))


@torch.no_grad()
def outer_update(
    cfg: OuterOptConfig,
    global_params,
    pseudo_grad,  # Δ, same tree as params
    state: Dict[str, Any],
) -> Tuple[Any, Dict[str, Any]]:
    rnd = state["round"] + 1
    if cfg.name == "fedavg":
        new_params = tree_map(
            lambda p, d: (p - cfg.lr * d).to(p.dtype), global_params, pseudo_grad
        )
        return new_params, {"round": rnd}

    if cfg.name == "fedmom":
        new_mom = tree_map(
            lambda b, d: cfg.momentum * b + d.to(b.dtype), state["momentum"], pseudo_grad
        )
        if cfg.nesterov:
            upd = tree_map(
                lambda b, d: cfg.momentum * b + d.to(b.dtype), new_mom, pseudo_grad
            )
        else:
            upd = new_mom
        new_params = tree_map(
            lambda p, u: (p - cfg.lr * u).to(p.dtype), global_params, upd
        )
        return new_params, {"momentum": new_mom, "round": rnd}

    if cfg.name == "fedadam":
        new_m = tree_map(
            lambda m, d: cfg.momentum * m + (1 - cfg.momentum) * d.to(m.dtype),
            state["m"], pseudo_grad,
        )
        new_v = tree_map(
            lambda v, d: cfg.beta2 * v + (1 - cfg.beta2) * torch.square(d.to(v.dtype)),
            state["v"], pseudo_grad,
        )
        b1c, b2c = adam_bias_corrections(cfg, rnd)
        new_params = tree_map(
            lambda p, m, v: (p - cfg.lr * (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)).to(p.dtype),
            global_params, new_m, new_v,
        )
        return new_params, {"m": new_m, "v": new_v, "round": rnd}

    raise ValueError(cfg.name)
