"""Federated pre-training rounds (Photon, Algorithm 1), the synchronous path of
``repro.core.federated``.

One round:

  1. every cohort client starts from θ_global,
  2. runs τ local inner-optimizer steps on its own batches,
  3. uploads its pseudo-gradient Δ_k = θ_global − θ_k (DP-clipped when asked),
  4. the server takes ONE weighted mean of the Δ_k, adds optional DP noise,
  5. and applies the outer optimizer (FedAvg / FedMom / FedAdam).

:func:`run_clients` is steps 1–3 and :func:`apply_aggregate` steps 4–5;
:func:`federated_round` composes them, with ``apply_fn`` as the seam where
``--fused-server`` plugs in ``kernels.fedcore.fused_apply_aggregate``. The
reference vmaps over the client axis inside one jitted scan; here the clients
run one after another in a Python loop, and the deltas leave as stacked
``(C, ...)`` float32 leaves — the layout the fused server phase consumes.

Server state is ``{"params", "outer", "round", "rng"}`` with the reference's
key paths. ``rng`` is kept as the reference's ``(2,)`` uint32 key, but this
package advances it by its own rule (:func:`split_rng`): it seeds only the DP
noise, which no test compares bitwise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.inner_opt import InnerOptConfig, init_inner_state, inner_update
from repro_torch.core.outer_opt import OuterOptConfig, init_outer_state, outer_update
from repro_torch.tree import global_norm, tree_flatten, tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class FederatedConfig:
    clients_per_round: int = 8  # K — the cohort width
    local_steps: int = 500  # τ (paper §6.5)
    inner: InnerOptConfig = field(default_factory=InnerOptConfig)
    outer: OuterOptConfig = field(default_factory=OuterOptConfig)
    keep_inner_state: bool = False  # paper Fig 10 'FedAvg-KeepOpt'
    grad_accum: int = 1  # micro-batches per local step
    fedprox_mu: float = 0.0  # FedProx proximal term strength
    dp_clip: float = 0.0  # per-client pseudo-gradient clip (0 = off)
    dp_noise: float = 0.0  # Gaussian noise std on the aggregate (0 = off)
    pseudo_grad_dtype: str = "float32"  # 'bfloat16' = legacy flat-cast uplink


# ---------------------------------------------------------------------------
# State and the rng lane
# ---------------------------------------------------------------------------


def prng_key(seed: int) -> np.ndarray:
    """The ``(2,)`` uint32 key ``jax.random.PRNGKey(seed)`` holds."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.asarray([s >> 32, s & 0xFFFFFFFF], np.uint32)


def split_rng(rng: np.ndarray) -> Tuple[np.ndarray, int]:
    """``(next_key, noise_seed)``: this package's rule for advancing the rng
    lane once per server step (the reference's ``jax.random.split``)."""
    words = np.random.SeedSequence([int(x) for x in np.asarray(rng, np.uint32)])
    w = words.generate_state(4, np.uint32)
    return w[:2].copy(), (int(w[2]) << 32) | int(w[3])


def init_federated_state(fed: FederatedConfig, params, rng: Optional[np.ndarray] = None
                         ) -> Dict[str, Any]:
    state: Dict[str, Any] = {
        "params": params,
        "outer": init_outer_state(fed.outer, params),
        "round": 0,
        "rng": np.asarray(rng if rng is not None else prng_key(0), np.uint32),
    }
    if fed.keep_inner_state:
        C = fed.clients_per_round
        stacked = lambda p: torch.zeros((C,) + tuple(p.shape), dtype=p.dtype,  # noqa: E731
                                        device=p.device)
        lanes = ("m", "v") if fed.inner.name == "adamw" else ("mom",)
        state["inner"] = {lane: tree_map(stacked, params) for lane in lanes}
        state["inner"]["count"] = np.zeros((C,), np.int32)
    return state


# ---------------------------------------------------------------------------
# Client phase
# ---------------------------------------------------------------------------


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _accum_value_and_grad(loss_fn, treedef, leaves, batch, n_micro: int):
    """Loss, metrics and gradients, averaged over ``n_micro`` micro-batches."""
    if n_micro > 1:
        micro = [
            {k: v.reshape((n_micro, v.shape[0] // n_micro) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()}
            for i in range(n_micro)
        ]
    else:
        micro = [batch]
    acc_grads = acc_loss = acc_metrics = None
    for mb in micro:
        xs = [x.detach().requires_grad_(True) for x in leaves]
        loss, metrics = loss_fn(tree_unflatten(treedef, xs), mb)
        grads = torch.autograd.grad(loss, xs)
        loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
        if n_micro == 1:
            return loss, metrics, list(grads)
        if acc_grads is None:
            acc_grads = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                         for x in leaves]
            acc_loss = torch.zeros((), dtype=torch.float32, device=loss.device)
            acc_metrics = {k: torch.zeros_like(v) for k, v in metrics.items()}
        acc_grads = [a + g / n_micro for a, g in zip(acc_grads, grads)]
        acc_metrics = {k: acc_metrics[k] + v / n_micro for k, v in metrics.items()}
        acc_loss = acc_loss + loss / n_micro
    return acc_loss, acc_metrics, acc_grads


def _step_weights(C: int, tau: int, part: Optional[np.ndarray],
                  tau_steps: Optional[np.ndarray]):
    """(τ, C) float32 weights that reduce per-client step metrics to one value
    per step, and the (τ,) index of the step each row reads (dead steps — no
    active client — forward-fill from the last live one)."""
    if tau_steps is None:
        if part is None:
            return None, np.arange(tau)  # plain mean over clients
        eff_k = np.maximum(np.sum(part), np.float32(1.0))
        return np.broadcast_to(part / eff_k, (tau, C)), np.arange(tau)
    act = (np.arange(tau)[:, None] < np.asarray(tau_steps)[None, :]).astype(np.float32)
    raw = act * part[None, :] if part is not None else act
    n_active = raw.sum(axis=1, dtype=np.float32)
    step_w = raw / np.maximum(n_active, np.float32(1.0))[:, None]
    t_idx = np.arange(tau)
    last_live = np.maximum(np.maximum.accumulate(np.where(n_active > 0, t_idx, -1)), 0)
    return step_w, last_live


def run_clients(
    loss_fn: Callable,  # (params, batch) -> (loss, metrics_dict)
    fed: FederatedConfig,
    state: Dict[str, Any],  # needs 'params', 'round' (+ 'inner' when keep_inner_state)
    batches: Dict[str, torch.Tensor],  # leaves (τ, C, ...)
    client_weights=None,  # (C,) elastic participation weights
    tau_steps: Optional[np.ndarray] = None,  # (C,) realized per-client steps τ_i
) -> Tuple[Any, Dict[str, Any]]:
    """Client phase (Algorithm 1, L.4–7). Returns ``(deltas, aux)``: deltas
    are (C, ...) float32 leaves; ``aux`` holds the client-side metric pieces.

    ``tau_steps`` is the straggler partial-progress budget: client c runs its
    first τ_c steps and holds its params after that. A zero-weight client
    still trains (its delta is weighted out), as in the reference."""
    C, tau = fed.clients_per_round, fed.local_steps
    elastic = client_weights is not None
    part = None
    if elastic:
        w_host = _host_f32(client_weights)
        part = (w_host > 0).astype(np.float32)
        metric_w = part / np.maximum(np.sum(part), np.float32(1.0))
    global_leaves, treedef = tree_flatten(state["params"])
    device = global_leaves[0].device
    seq_step0 = int(state["round"]) * tau
    if tau_steps is not None:
        tau_steps = np.asarray(tau_steps, np.int64)

    deltas = [torch.empty((C,) + tuple(g.shape), dtype=torch.float32, device=device)
              for g in global_leaves]
    client_sum = [torch.zeros(g.shape, dtype=g.dtype, device=device) for g in global_leaves]
    client_norms = []
    inner_out = None
    if fed.keep_inner_state:
        inner_out = tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else np.array(x),
            state["inner"],
        )
    records: List[List[Optional[Dict[str, Any]]]] = [[None] * C for _ in range(tau)]

    for c in range(C):
        params = [g.detach().clone() for g in global_leaves]
        if fed.keep_inner_state:
            inner = {k: [x[c].clone() for x in tree_leaves(v)]
                     for k, v in state["inner"].items() if k != "count"}
            inner["count"] = int(state["inner"]["count"][c])
        else:
            inner = init_inner_state(fed.inner, params)
        steps = tau if tau_steps is None else int(min(tau, tau_steps[c]))
        for t in range(steps):
            batch_t = {k: v[t, c] for k, v in batches.items()}
            loss, metrics, grads = _accum_value_and_grad(
                loss_fn, treedef, params, batch_t, fed.grad_accum
            )
            if fed.fedprox_mu > 0.0:
                grads = [g + fed.fedprox_mu * (p - gp)
                         for g, p, gp in zip(grads, params, global_leaves)]
            params, inner, opt_metrics = inner_update(
                fed.inner, params, grads, inner, seq_step0 + t
            )
            records[t][c] = dict(metrics, **opt_metrics)

        with torch.no_grad():
            for i, (g, p) in enumerate(zip(global_leaves, params)):
                deltas[i][c] = g.float() - p.float()
            client_norms.append(global_norm(params))
            wc = float(w_host[c]) if elastic else 1.0
            for acc, p in zip(client_sum, params):
                acc.add_(p * wc if elastic else p)
        if fed.keep_inner_state and (not elastic or w_host[c] > 0):
            # a zero-weight client never really ran: it keeps its old state
            for k, lane in inner_out.items():
                if k == "count":
                    lane[c] = inner["count"]
                else:
                    for dst, src in zip(tree_leaves(lane), inner[k]):
                        dst[c] = src
        del params, inner

    with torch.no_grad():
        if fed.dp_clip > 0.0:
            norms = torch.sqrt(sum(torch.sum(torch.square(d).reshape(C, -1), dim=1)
                                   for d in deltas))
            scale = torch.clamp(fed.dp_clip / (norms + 1e-9), max=1.0)
            deltas = [d * scale.reshape((-1,) + (1,) * (d.ndim - 1)) for d in deltas]
        if fed.pseudo_grad_dtype != "float32":
            dt = getattr(torch, fed.pseudo_grad_dtype)
            deltas = [d.to(dt).float() for d in deltas]

        client_norms = torch.stack(client_norms)
        if elastic:
            client_norm_mean = torch.sum(client_norms * torch.from_numpy(metric_w).to(device))
            w_sum = float(np.maximum(np.sum(w_host), np.float32(1e-12)))
            avg_client_norm = global_norm([s / w_sum for s in client_sum])
        else:
            client_norm_mean = torch.mean(client_norms)
            avg_client_norm = global_norm([s / C for s in client_sum])

    step_w, last_live = _step_weights(C, tau, part, tau_steps)
    keys = next(r for row in records for r in row if r is not None).keys()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    step_metrics = {}
    for k in keys:
        v = torch.stack([
            torch.stack([torch.as_tensor(records[t][c][k], dtype=torch.float32, device=device)
                         if records[t][c] is not None else zero for c in range(C)])
            for t in range(tau)
        ])  # (τ, C)
        if step_w is None:
            per_step = torch.mean(v, dim=1)
        else:
            per_step = torch.sum(v * torch.from_numpy(np.ascontiguousarray(step_w)).to(device),
                                 dim=1)
        step_metrics[k] = per_step[torch.from_numpy(last_live).to(device)]

    aux = {
        "inner": inner_out,
        "step_metrics": step_metrics,
        "client_model_norm_mean": client_norm_mean,
        "avg_client_model_norm": avg_client_norm,
    }
    return tree_unflatten(treedef, deltas), aux


# ---------------------------------------------------------------------------
# Server phase
# ---------------------------------------------------------------------------


def aggregation_metrics(
    delta_norms: torch.Tensor,  # (C,) per-client delta norms
    pg_norm: torch.Tensor,  # () norm of the aggregated (post-noise) pseudo-gradient
    client_weights: Optional[torch.Tensor],  # (C,) or None (flat mean)
) -> Dict[str, torch.Tensor]:
    """The scalar aggregation monitors (paper Figs 7, 8), shared by the
    per-leaf server phase and the fused flat-buffer one — one formula set, the
    reference's. Non-finite client norms are masked out of every reduction and
    counted in ``nonfinite_deltas``."""
    c = delta_norms.shape[0]
    finite = torch.isfinite(delta_norms)
    zero = torch.zeros_like(delta_norms)
    dn = torch.where(finite, delta_norms, zero)
    if client_weights is not None:
        w = torch.where(finite, client_weights.float(), zero)
        part = (w > 0).float()
        eff_k = torch.clamp(torch.sum(part), min=1.0)
        metric_w = part / eff_k
        w_sum = torch.sum(w)
        w_sq_sum = torch.sum(torch.square(w))
        sum_sq = torch.sum(torch.square(w * dn))
        norm_of_sum_sq = torch.square(pg_norm) * torch.square(w_sum)
        off_diag = torch.square(w_sum) - w_sq_sum
        pairwise_dot = torch.where(
            eff_k > 1.5,
            (norm_of_sum_sq - sum_sq) / torch.clamp(off_diag, min=1e-12),
            sum_sq / torch.clamp(w_sq_sum, min=1e-12),
        )
        mean_sq_norm = sum_sq / torch.clamp(w_sq_sum, min=1e-12)
        w_norm = w / torch.clamp(w_sum, min=1e-12)
        weight_entropy = -torch.sum(torch.where(
            w_norm > 0, w_norm * torch.log(torch.clamp(w_norm, min=1e-30)),
            torch.zeros_like(w_norm),
        ))
        effective_clients = torch.sum(part)
        delta_norm_mean = torch.sum(dn * metric_w)
    else:
        sum_sq = torch.sum(torch.square(dn))
        norm_of_sum_sq = torch.square(pg_norm) * c * c
        pairwise_dot = (norm_of_sum_sq - sum_sq) / max(1, c * (c - 1))
        mean_sq_norm = sum_sq / c
        weight_entropy = torch.log(torch.tensor(float(c), device=dn.device))
        effective_clients = torch.sum(finite.float())
        delta_norm_mean = torch.sum(dn) / torch.clamp(torch.sum(finite.float()), min=1.0)
    consensus = pairwise_dot / (mean_sq_norm + 1e-12)
    return {
        "pseudo_grad_norm": pg_norm,
        "client_delta_norm_mean": delta_norm_mean,
        "client_consensus": consensus,
        "effective_clients": effective_clients,
        "weight_entropy": weight_entropy,
        "nonfinite_deltas": torch.sum((~finite).float()),
    }


def _client_norms(deltas) -> torch.Tensor:
    leaves = tree_leaves(deltas)
    C = leaves[0].shape[0]
    return torch.sqrt(sum(torch.sum(torch.square(x.float()).reshape(C, -1), dim=1)
                          for x in leaves))


def dp_noise_scale(fed: FederatedConfig, client_weights, C: int):
    """Std of the DP noise on the aggregate: the worst single client's share,
    max_k w_k/Σw (1/C for the flat mean), times ``dp_noise``."""
    if client_weights is None:
        return fed.dp_noise / C
    w = client_weights.float()
    return fed.dp_noise * torch.max(w) / torch.clamp(torch.sum(w), min=1e-12)


@torch.no_grad()
def apply_aggregate(
    fed: FederatedConfig,
    state: Dict[str, Any],  # needs 'params', 'outer', 'round', 'rng'
    deltas,  # tree with leading client axis (C, ...)
    client_weights: Optional[torch.Tensor] = None,  # (C,) aggregation weights
    codec=None,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Server phase (Algorithm 1, L.8–9), per leaf: ONE weighted mean of the
    pseudo-gradients, optional DP noise, the outer update. Leaves ``state``
    untouched and returns the new one."""
    if codec is not None:
        raise ValueError("uplink codecs are not ported yet (ROADMAP.md queue A)")
    if client_weights is not None:
        w = client_weights.float()
        w_sum = torch.clamp(torch.sum(w), min=1e-12)
        pseudo_grad = tree_map(
            lambda x: torch.sum(x * w.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype),
                                dim=0) / w_sum.to(x.dtype),
            deltas,
        )
    else:
        pseudo_grad = tree_map(lambda x: torch.mean(x, dim=0), deltas)
    return _finish_aggregate(fed, state, pseudo_grad, _client_norms(deltas), client_weights)


def _finish_aggregate(fed, state, pseudo_grad, delta_norms, client_weights):
    """rng split → optional DP noise → outer update → metrics → new state."""
    rng, noise_seed = split_rng(state["rng"])
    if fed.dp_noise > 0.0:
        scale = dp_noise_scale(fed, client_weights, delta_norms.shape[0])
        leaves, treedef = tree_flatten(pseudo_grad)
        gen = torch.Generator(device=leaves[0].device).manual_seed(noise_seed)
        leaves = [l + scale * torch.randn(l.shape, generator=gen, dtype=l.dtype,
                                          device=l.device) for l in leaves]
        pseudo_grad = tree_unflatten(treedef, leaves)

    new_global, new_outer = outer_update(fed.outer, state["params"], pseudo_grad, state["outer"])
    metrics = dict(
        aggregation_metrics(delta_norms, global_norm(pseudo_grad), client_weights),
        global_model_norm=global_norm(new_global),
    )
    new_state = {"params": new_global, "outer": new_outer, "round": state["round"] + 1,
                 "rng": rng}
    return new_state, metrics


def federated_round(
    loss_fn: Callable,
    fed: FederatedConfig,
    state: Dict[str, Any],
    batches: Dict[str, torch.Tensor],  # leaves (τ, C, ...)
    client_weights: Optional[torch.Tensor] = None,
    tau_steps: Optional[np.ndarray] = None,
    apply_fn: Optional[Callable] = None,  # server-phase override (the fused kernel path)
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One full round — :func:`run_clients` then the server phase
    (``apply_fn`` or :func:`apply_aggregate`, same signature and contract)."""
    deltas, aux = run_clients(loss_fn, fed, state, batches, client_weights=client_weights,
                              tau_steps=tau_steps)
    new_state, agg_metrics = (apply_fn or apply_aggregate)(
        fed, state, deltas, client_weights=client_weights
    )
    del deltas
    sm = aux["step_metrics"]
    metrics = {
        "train_loss": sm["loss"][-1],
        "train_loss_mean": torch.mean(sm["loss"]),
        "client_grad_norm": sm["grad_norm"][-1],
        "applied_update_norm": sm["applied_update_norm"][-1],
        "lr": sm["lr"][-1],
        "client_model_norm_mean": aux["client_model_norm_mean"],
        "avg_client_model_norm": aux["avg_client_model_norm"],
        **agg_metrics,
    }
    if fed.keep_inner_state:
        new_state["inner"] = aux["inner"]
    return new_state, metrics
