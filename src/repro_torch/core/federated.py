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
``--fused-server`` plugs in ``kernels.fedcore.fused_apply_aggregate`` (and a
robust rule, ``core/robust``, plugs in its own). A cohort can also cross the
round in tiles (:func:`run_client_tile`, :func:`apply_aggregate_partial`);
:func:`centralized_step` is the single-node baseline the paper compares
against. The
reference vmaps over the client axis inside one jitted scan; here the clients
run one after another in a Python loop, and the deltas leave as stacked
``(C, ...)`` float32 leaves — the layout the fused server phase consumes.

Server state is ``{"params", "outer", "round", "rng"}`` with the reference's
key paths. ``rng`` is kept as the reference's ``(2,)`` uint32 key, but this
package advances it by its own rule (:func:`split_rng`): it seeds only the DP
noise, which no test compares bitwise.

With an uplink ``codec`` (``core/compression``) the clients' deltas leave
:func:`run_clients` as encoded payloads, one cohort encode
(``codec.encode_cohort``), and the server phase decodes them first. A
stateful codec's error-feedback residuals are per-client state: the cohort's
rows come in as ``residuals`` and the updated rows go out, kept in a
population-keyed :class:`SparseResidualStore` by the aggregator.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compression import Codec
from repro_torch.core.inner_opt import InnerOptConfig, init_inner_state, inner_update
from repro_torch.core.outer_opt import OuterOptConfig, init_outer_state, outer_update
from repro_torch.tree import (
    global_norm,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_stack,
    tree_unflatten,
)


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


def fold_in(rng: np.ndarray, data: int) -> np.ndarray:
    """A ``(2,)`` uint32 key that depends only on ``rng`` and ``data``: this
    package's stand-in for ``jax.random.fold_in`` (its bits are not JAX's)."""
    seq = np.random.SeedSequence([int(x) for x in np.asarray(rng, np.uint32)] + [int(data)])
    return seq.generate_state(2, np.uint32)


def uplink_keys(state: Dict[str, Any], C: int) -> List[np.ndarray]:
    """One ``(2,)`` uint32 key per cohort client for the codec's randomness,
    derived from the rng lane and the round, never consumed: the server's
    DP-noise draw is untouched (the reference's fold_in + split)."""
    rng = np.asarray(state["rng"] if "rng" in state else prng_key(0), np.uint32)
    seq = np.random.SeedSequence([int(x) for x in rng] + [int(state["round"]), 0x5EED])
    words = seq.generate_state(2 * C, np.uint32)
    return [words[2 * c:2 * c + 2].copy() for c in range(C)]


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
    codec: Optional[Codec] = None,  # uplink codec; encodes the emitted deltas
    residuals=None,  # (C, ...) per-client error-feedback residuals
) -> Tuple[Any, Dict[str, Any]]:
    """Client phase (Algorithm 1, L.4–7). Returns ``(deltas, aux)``: deltas
    are (C, ...) float32 leaves, or with a ``codec`` the encoded payloads;
    ``aux`` holds the client-side metric pieces, and for a stateful codec the
    updated ``residuals`` rows and their ``uplink_residual_norm``.

    ``tau_steps`` is the straggler partial-progress budget: client c runs its
    first τ_c steps and holds its params after that. A zero-weight client
    still trains (its delta is weighted out), as in the reference, but keeps
    its old residual bitwise: it never uploaded."""
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
        out = new_residuals = None
        if codec is not None:  # encoded uplink: deltas leave as codec payloads
            rngs = uplink_keys(state, C) if codec.needs_rng else None
            if codec.stateful and residuals is None:  # first-ever upload
                residuals = tree_map(lambda d: torch.zeros_like(d), tree_unflatten(treedef, deltas))
            out, new_residuals = codec.encode_cohort(
                tree_unflatten(treedef, deltas), residuals if codec.stateful else None, rngs
            )
            if codec.stateful and elastic:
                # a masked client never uploaded: its residual stays bitwise
                keep = torch.from_numpy(w_host > 0).to(device)
                new_residuals = tree_map(
                    lambda n, o: torch.where(keep.reshape((-1,) + (1,) * (n.ndim - 1)), n, o),
                    new_residuals, residuals,
                )
        elif fed.pseudo_grad_dtype != "float32":
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
    if new_residuals is not None:
        with torch.no_grad():
            res_norms = _client_norms(new_residuals)  # (C,) EF telemetry
            aux["residuals"] = new_residuals
            aux["uplink_residual_norm"] = (
                torch.sum(res_norms * torch.from_numpy(metric_w).to(device)) if elastic
                else torch.mean(res_norms)
            )
    return (out if codec is not None else tree_unflatten(treedef, deltas)), aux


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


def _weigh_clients(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """A (C,) weight vector broadcast over a (C, ...) leaf: x_k ← w_k x_k."""
    return x * weights.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)


def _safe_weight_sum(weights: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sum(weights), min=1e-12)  # all-masked round → zero update


def _weighted_mean_clients(tree, weights: torch.Tensor):
    """Σ_k w_k x_k / Σ_k w_k over the leading client axis of every leaf."""
    w_sum = _safe_weight_sum(weights)
    return tree_map(lambda x: torch.sum(_weigh_clients(x, weights), dim=0) / w_sum.to(x.dtype),
                    tree)


#: the round metrics a traced round's span and gauges carry (the reference's)
TRACE_METRIC_KEYS = (
    "train_loss",
    "pseudo_grad_norm",
    "client_consensus",
    "weight_entropy",
    "effective_clients",
    "model_norm",
)


def trace_attrs(metrics: Dict[str, Any], keys=TRACE_METRIC_KEYS) -> Dict[str, float]:
    """Host floats of a round's telemetry metrics: the one device read a
    traced round pays, and only when tracing is on."""
    return {k: float(metrics[k]) for k in keys if k in metrics}


@torch.no_grad()
def apply_aggregate(
    fed: FederatedConfig,
    state: Dict[str, Any],  # needs 'params', 'outer', 'round', 'rng'
    deltas,  # tree with leading client axis (C, ...)
    client_weights: Optional[torch.Tensor] = None,  # (C,) aggregation weights
    codec=None,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Server phase (Algorithm 1, L.8–9), per leaf: ONE weighted mean of the
    pseudo-gradients (decoded first when a ``codec`` encoded them), optional DP
    noise, the outer update. Leaves ``state`` untouched and returns the new one."""
    if codec is not None:
        deltas = codec.decode_cohort(deltas)
    if client_weights is not None:
        pseudo_grad = _weighted_mean_clients(deltas, client_weights.float())
    else:
        pseudo_grad = tree_map(lambda x: torch.mean(x, dim=0), deltas)
    return _finish_aggregate(fed, state, pseudo_grad, _client_norms(deltas), client_weights)


def _finish_aggregate(fed, state, pseudo_grad, delta_norms, client_weights):
    """rng split → optional DP noise → outer update → metrics → new state: the
    shared tail of every server phase (the robust rules and the tiled round
    swap only the pseudo-gradient in front of it)."""
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
    codec: Optional[Codec] = None,  # uplink codec (encode client-side, decode server-side)
    residuals=None,  # (C, ...) cohort error-feedback residuals
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One full round — :func:`run_clients` then the server phase
    (``apply_fn`` or :func:`apply_aggregate`, same signature and contract).
    For a stateful codec the cohort's updated residual rows come back as
    ``new_state["uplink_residuals"]``, with ``uplink_residual_norm`` in the
    metrics; :func:`federated_round_with_uplink` keeps them population-keyed."""
    deltas, aux = run_clients(loss_fn, fed, state, batches, client_weights=client_weights,
                              tau_steps=tau_steps, codec=codec, residuals=residuals)
    new_state, agg_metrics = (apply_fn or apply_aggregate)(
        fed, state, deltas, client_weights=client_weights, codec=codec
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
    if "residuals" in aux:
        new_state["uplink_residuals"] = aux["residuals"]
        metrics["uplink_residual_norm"] = aux["uplink_residual_norm"]
    return new_state, metrics


# ---------------------------------------------------------------------------
# Population-keyed error-feedback residual store
# ---------------------------------------------------------------------------


def init_uplink_residuals(codec: Optional[Codec], params, population: int):
    """The dense per-client error-feedback store: one zero residual row per
    POPULATION client, leaves (P, ...) float32; ``None`` for stateless codecs."""
    if codec is None or not codec.stateful:
        return None
    return tree_map(lambda p: torch.zeros((population,) + tuple(p.shape), dtype=torch.float32,
                                          device=p.device), params)


class SparseResidualStore:
    """Population-keyed error-feedback store that materializes rows only for
    clients that have ever sat in a cohort: an ``id → row`` map, each row a
    params-shaped float32 tree on the params' device. Its observable semantics
    are the dense store's (:func:`init_uplink_residuals`): a never-materialized
    id gathers as the zero row; memory is ``O(#ever-selected · N)``.

    Checkpointing: :meth:`stacked` emits the rows as one ``(n_ids, ...)`` tree
    in sorted-id order (the manifest records :meth:`ids`); :meth:`to_dense`
    gives the legacy dense layout and :meth:`from_dense` ingests it, leaving
    all-zero rows unmaterialized."""

    def __init__(self, params_like):
        # shapes only: meta tensors hold no memory; rows live on the params' device
        self._template = tree_map(lambda p: torch.empty(p.shape, device="meta"), params_like)
        self._device = tree_leaves(params_like)[0].device
        self._rows: Dict[int, Any] = {}

    @classmethod
    def create(cls, codec: Optional[Codec], params) -> Optional["SparseResidualStore"]:
        """``None`` for stateless codecs — mirrors :func:`init_uplink_residuals`."""
        if codec is None or not codec.stateful:
            return None
        return cls(params)

    def _zeros(self, lead: Tuple[int, ...] = ()):
        return tree_map(lambda t: torch.zeros(lead + tuple(t.shape), dtype=torch.float32,
                                              device=self._device), self._template)

    # ---- row accounting ----

    def ids(self) -> List[int]:
        """Sorted population ids that own a materialized row."""
        return sorted(self._rows)

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, cid) -> bool:
        return int(cid) in self._rows

    @property
    def row_nbytes(self) -> int:
        return sum(4 * t.numel() for t in tree_leaves(self._template))

    @property
    def nbytes(self) -> int:
        """Exact bytes held: rows × params size. The dense equivalent is P × params."""
        return len(self._rows) * self.row_nbytes

    def row(self, cid):
        """One client's row; never-materialized ids read as the zero row."""
        cid = int(cid)
        return self._rows[cid] if cid in self._rows else self._zeros()

    # ---- the gather/scatter contract the round uses ----

    def gather(self, ids):
        """Stacked ``(C, ...)`` cohort rows (unmaterialized ids are zero)."""
        rows = [self.row(i) for i in np.asarray(ids).tolist()]
        return tree_stack(rows)

    def scatter(self, ids, stacked, mask=None) -> None:
        """Write a cohort's updated rows back, materializing on first touch.
        ``mask[k]`` False skips slot ``k`` (a padding slot). Each row is a copy,
        so a row never pins the cohort buffer it came from."""
        for k, cid in enumerate(np.asarray(ids).tolist()):
            if mask is not None and not bool(mask[k]):
                continue
            self._rows[int(cid)] = tree_map(lambda x: x[k].clone(), stacked)

    # ---- checkpoint lanes ----

    def stacked(self):
        """All rows as one ``(n_ids, ...)`` tree in sorted-id order."""
        ids = self.ids()
        if not ids:
            return self._zeros((0,))
        return tree_stack([self._rows[i] for i in ids])

    def to_dense(self, population: int):
        """Materialize the legacy dense ``(P, ...)`` layout."""
        dense = self._zeros((population,))
        for cid in self.ids():
            for d, r in zip(tree_leaves(dense), tree_leaves(self._rows[cid])):
                d[cid] = r
        return dense

    @classmethod
    def from_stacked(cls, params_like, ids, stacked) -> "SparseResidualStore":
        """Rebuild from the canonical checkpoint lane (manifest ids + stacked rows)."""
        store = cls(params_like)
        store.scatter([int(i) for i in ids], stacked)
        return store

    @classmethod
    def from_dense(cls, params_like, dense) -> "SparseResidualStore":
        """Ingest a legacy dense ``(P, ...)`` store; all-zero rows stay
        unmaterialized (a zero row and no row gather alike)."""
        store = cls(params_like)
        leaves = tree_leaves(dense)
        owned = torch.zeros(leaves[0].shape[0], dtype=torch.bool, device=leaves[0].device)
        for leaf in leaves:
            owned |= torch.any(leaf.reshape(leaf.shape[0], -1) != 0, dim=1)
        for cid in torch.nonzero(owned).flatten().tolist():
            store._rows[int(cid)] = tree_map(lambda x: x[cid].clone(), dense)
        return store


def federated_round_with_uplink(
    loss_fn: Callable,
    fed: FederatedConfig,
    codec: Optional[Codec],
    state: Dict[str, Any],
    batches: Dict[str, torch.Tensor],
    client_weights: Optional[torch.Tensor] = None,
    selected=None,  # (C,) population ids bound to the client axis
    tau_steps: Optional[np.ndarray] = None,
    apply_fn: Optional[Callable] = None,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """:func:`federated_round` wired to a dense population-keyed residual
    store ``state["uplink_residuals"]`` (leaves (P, ...)): the cohort's rows
    are gathered by ``selected``, the round runs, and the updated rows scatter
    back (masked clients' rows come back bitwise unchanged). Stateless codecs
    (and ``codec=None``) reduce to plain :func:`federated_round`."""
    if codec is None or not codec.stateful:
        return federated_round(loss_fn, fed, state, batches, client_weights=client_weights,
                               tau_steps=tau_steps, apply_fn=apply_fn, codec=codec)
    if selected is None:
        raise ValueError("stateful uplink codec requires the cohort's population ids")
    store = state["uplink_residuals"]
    core = {k: v for k, v in state.items() if k != "uplink_residuals"}
    sel = torch.as_tensor(np.asarray(selected, np.int64))
    cohort_res = tree_map(lambda r: r.index_select(0, sel.to(r.device)), store)
    new_core, metrics = federated_round(
        loss_fn, fed, core, batches, client_weights=client_weights, tau_steps=tau_steps,
        apply_fn=apply_fn, codec=codec, residuals=cohort_res,
    )
    new_cohort_res = new_core.pop("uplink_residuals")
    new_core["uplink_residuals"] = tree_map(
        lambda r, n: r.index_copy(0, sel.to(r.device), n), store, new_cohort_res
    )
    return new_core, metrics


# ---------------------------------------------------------------------------
# Streamed cohorts: tile client phase + partial-sum server phase
# ---------------------------------------------------------------------------
#
# A cohort of C clients crosses the client phase C_tile clients at a time.
# Each tile forwards Σ_k w_k Δ_k and its clients' delta norms; the server sums
# the tiles and divides by Σ w once (the ``hierarchical_mean`` algebra), so the
# (C, N) delta buffer is bounded by C_tile. With one tile the op sequence is
# ``apply_aggregate``'s weighted mean split in two: bitwise the flat round.

#: rng tag of tiles t > 0; tile 0 keeps the round's own rng lane
TILE_RNG_TAG = 0x7113


def tile_rng(rng: np.ndarray, tile_index: int) -> np.ndarray:
    """The rng lane of tile ``tile_index``: tile 0 is the round's rng itself
    (the one-tile ≡ flat identity); later tiles fold in ``TILE_RNG_TAG + t``
    by this package's :func:`fold_in`, so their codec keys differ."""
    if tile_index == 0:
        return rng
    return fold_in(rng, TILE_RNG_TAG + tile_index)


def run_client_tile(
    loss_fn: Callable,
    fed: FederatedConfig,  # clients_per_round == C_tile
    state: Dict[str, Any],  # needs 'params', 'round', 'rng' (the tile's rng lane)
    batches: Dict[str, torch.Tensor],  # leaves (τ, C_tile, ...)
    client_weights: torch.Tensor,  # (C_tile,) — required: padding slots weigh 0
    codec: Optional[Codec] = None,
    residuals=None,  # (C_tile, ...) error-feedback rows
    tau_steps: Optional[np.ndarray] = None,  # (C_tile,)
    return_deltas: bool = False,  # also return the decoded (C_tile, ...) deltas
) -> Dict[str, Any]:
    """One cohort tile of a streamed round: :func:`run_clients` on C_tile
    clients, folded to the partial sums the server phase needs:
    ``delta_sum`` (Σ_k w_k Δ_k, decoded), ``delta_norms`` (C_tile,),
    ``eff_k`` and the client-side metric pieces (recombined across tiles by
    :func:`combine_tile_metrics`); ``residuals`` and ``uplink_residual_norm``
    for a stateful codec. ``return_deltas`` adds the decoded deltas, which the
    robust tiled fold needs (order statistics are not recoverable from a
    sum); without it they are freed when this returns."""
    if fed.keep_inner_state:
        raise ValueError(
            "streamed cohorts cannot keep per-client inner state across rounds "
            "(the (C,)-batched inner store is exactly the memory term tiling "
            "removes); use keep_inner_state=False"
        )
    deltas, aux = run_clients(loss_fn, fed, state, batches, client_weights=client_weights,
                              tau_steps=tau_steps, codec=codec, residuals=residuals)
    with torch.no_grad():
        if codec is not None:
            deltas = codec.decode_cohort(deltas)
        w = client_weights.float()
        out = {
            "delta_sum": tree_map(lambda x: torch.sum(_weigh_clients(x, w), dim=0), deltas),
            "delta_norms": _client_norms(deltas),
            "eff_k": torch.sum((w > 0).float()),
            "step_metrics": aux["step_metrics"],
            "client_model_norm_mean": aux["client_model_norm_mean"],
            "avg_client_model_norm": aux["avg_client_model_norm"],
        }
    if "residuals" in aux:
        out["residuals"] = aux["residuals"]
        out["uplink_residual_norm"] = aux["uplink_residual_norm"]
    if return_deltas:
        out["deltas"] = deltas
    return out


@torch.no_grad()
def apply_aggregate_partial(
    fed: FederatedConfig,
    state: Dict[str, Any],  # needs 'params', 'outer', 'round', 'rng'
    delta_sum,  # tree: Σ over every tile of Σ_k w_k Δ_k (no client axis)
    client_weights: torch.Tensor,  # (C_total,) the whole cohort's weights, pads at 0
    delta_norms: torch.Tensor,  # (C_total,) decoded per-client delta norms
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Server phase of a streamed round: the one divide of the two-tier
    aggregation, then :func:`_finish_aggregate` — :func:`apply_aggregate` with
    the weighted mean's numerator summed by the tiles, op for op, so a
    one-tile round is bitwise the flat round. Padding slots add exact zeros
    to the sum, nothing to Σw or max w, and the metrics mask them by w > 0."""
    w = client_weights.float()
    w_sum = _safe_weight_sum(w)
    pseudo_grad = tree_map(lambda s: s / w_sum.to(s.dtype), delta_sum)
    return _finish_aggregate(fed, state, pseudo_grad, delta_norms, client_weights)


def combine_tile_metrics(tile_outs) -> Dict[str, torch.Tensor]:
    """The client-side half of :func:`federated_round`'s metrics from the
    tiles' outputs. One tile passes through verbatim (the flat round's
    assembly). More tiles fold each tile's participation-weighted means by its
    effective client count: exact for the per-step series, an approximation
    for ``avg_client_model_norm`` and ``uplink_residual_norm`` (a norm of a
    mean does not decompose across tiles; both are monitors only)."""
    if len(tile_outs) == 1:
        t = tile_outs[0]
        sm = t["step_metrics"]
        out = {
            "train_loss": sm["loss"][-1],
            "train_loss_mean": torch.mean(sm["loss"]),
            "client_grad_norm": sm["grad_norm"][-1],
            "applied_update_norm": sm["applied_update_norm"][-1],
            "lr": sm["lr"][-1],
            "client_model_norm_mean": t["client_model_norm_mean"],
            "avg_client_model_norm": t["avg_client_model_norm"],
        }
        if "uplink_residual_norm" in t:
            out["uplink_residual_norm"] = t["uplink_residual_norm"]
        return out

    eff = torch.stack([t["eff_k"].float() for t in tile_outs])
    tile_w = eff / torch.clamp(torch.sum(eff), min=1.0)  # an all-pad tile weighs 0

    def fold(vals):
        v = torch.stack(vals)
        return torch.sum(v * tile_w.reshape((-1,) + (1,) * (v.ndim - 1)), dim=0)

    sm = {k: fold([t["step_metrics"][k] for t in tile_outs])
          for k in tile_outs[0]["step_metrics"]}
    out = {
        "train_loss": sm["loss"][-1],
        "train_loss_mean": torch.mean(sm["loss"]),
        "client_grad_norm": sm["grad_norm"][-1],
        "applied_update_norm": sm["applied_update_norm"][-1],
        "lr": sm["lr"][-1],
        "client_model_norm_mean": fold([t["client_model_norm_mean"] for t in tile_outs]),
        "avg_client_model_norm": fold([t["avg_client_model_norm"] for t in tile_outs]),
    }
    if "uplink_residual_norm" in tile_outs[0]:
        out["uplink_residual_norm"] = fold([t["uplink_residual_norm"] for t in tile_outs])
    return out


# ---------------------------------------------------------------------------
# Centralized baseline (the paper's comparison target)
# ---------------------------------------------------------------------------


def _inner_tree(inner_state: Dict[str, Any], treedef) -> Dict[str, Any]:
    return {k: v if k == "count" else tree_unflatten(treedef, v)
            for k, v in inner_state.items()}


def init_centralized_state(inner: InnerOptConfig, params) -> Dict[str, Any]:
    """``{"params", "inner", "step"}`` with the reference's key paths: the
    inner lanes are params-shaped trees, ``count`` and ``step`` ints."""
    leaves, treedef = tree_flatten(params)
    return {"params": params, "inner": _inner_tree(init_inner_state(inner, leaves), treedef),
            "step": 0}


def centralized_step(
    loss_fn: Callable,
    inner: InnerOptConfig,
    state: Dict[str, Any],
    batch: Dict[str, torch.Tensor],  # leaves (B, ...) — the whole global batch
    grad_accum: int = 1,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One synchronous data-parallel step on a single node: the gradient of
    the global batch (averaged over ``grad_accum`` micro-batches), then the
    inner optimizer. Returns ``(new_state, metrics)``; ``state`` is left as
    it was."""
    leaves, treedef = tree_flatten(state["params"])
    loss, metrics, grads = _accum_value_and_grad(loss_fn, treedef, leaves, batch, grad_accum)
    inner_state = {k: v if k == "count" else tree_leaves(v) for k, v in state["inner"].items()}
    new_leaves, new_inner, opt_metrics = inner_update(inner, leaves, grads, inner_state,
                                                      int(state["step"]))
    metrics = dict(metrics, **opt_metrics)
    with torch.no_grad():
        metrics["global_model_norm"] = global_norm(new_leaves)
    new_state = {"params": tree_unflatten(treedef, new_leaves),
                 "inner": _inner_tree(new_inner, treedef), "step": int(state["step"]) + 1}
    return new_state, metrics


# ---------------------------------------------------------------------------
# Hierarchical (two-level) aggregation — Photon's sub-federation (Alg. 1 L.19–24)
# ---------------------------------------------------------------------------


@torch.no_grad()
def hierarchical_mean(deltas, n_groups: int, weights: Optional[torch.Tensor] = None):
    """Two-phase mean: a partial aggregate within each of ``n_groups`` islands,
    then across islands. With ``weights`` (C,) each island forwards Σ_k w_k Δ_k
    and the server divides once by the real Σ w: uneven islands zero-pad the
    client axis to a multiple of ``n_groups`` (a pad weighs 0 and adds exact
    zeros). The unweighted form cannot mark a pad absent and raises
    ``ValueError`` when C does not divide."""
    if weights is None:

        def two_level(x):
            if x.shape[0] % n_groups != 0:
                raise ValueError(
                    f"client axis of size {x.shape[0]} does not divide into {n_groups} equal "
                    "groups; pass weights= to use the zero-weight padding path"
                )
            grouped = x.reshape((n_groups, x.shape[0] // n_groups) + tuple(x.shape[1:]))
            return torch.mean(torch.mean(grouped, dim=1), dim=0)

        return tree_map(two_level, deltas)

    w = weights.float()
    w_sum = _safe_weight_sum(w)  # the real clients only
    c = int(w.shape[0])
    pad = (-c) % n_groups
    w_padded = torch.cat([w, torch.zeros((pad,), dtype=torch.float32, device=w.device)]) \
        if pad else w

    def two_level_weighted(x):
        if pad:
            x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                                          device=x.device)], dim=0)
        grouped = _weigh_clients(x, w_padded).reshape(
            (n_groups, (c + pad) // n_groups) + tuple(x.shape[1:]))
        return torch.sum(torch.sum(grouped, dim=1), dim=0) / w_sum.to(x.dtype)

    return tree_map(two_level_weighted, deltas)
