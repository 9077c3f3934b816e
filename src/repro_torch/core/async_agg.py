"""Asynchronous buffered aggregation — Photon's FedBuff-style aggregator, the
counterpart of ``repro.core.async_agg``.

Clients pull the current global model when they become free, train at their
own speed and push their pseudo-gradient when they finish. The server buffers
the deltas and applies one outer update per ``M`` buffered deltas, so a slow
client lands in a later buffer instead of being cut at the deadline:

  ================================  =============================================
  Photon / FedBuff concept          This module
  ================================  =============================================
  model version ``t`` on server     ``state['round']``, bumped once per flush
  client trains against version t'  the delta's tag ``client_round``
  staleness ``s = t − t'``          computed at admission from the tag
  staleness discount                ``w̃ = w / (1 + s)^α`` (:func:`staleness_discount`)
  buffer of M deltas                the ``(M, ...)`` ``buffer`` lanes + ``buf_count``
  stale-update rejection            ``max_staleness``: older deltas are refused
  server update on the buffer       :func:`flush_buffer` → the sync round's
                                    ``apply_aggregate`` (or the ``--fused-server``
                                    ``fused_apply_aggregate``: one ``server_apply``
                                    pass over the ``(M, N)`` buffer on the card)
  ================================  =============================================

State is the sync server state plus ``buffer`` (leaves ``(M, ...)`` float32
on the params' device), ``buf_weights`` and ``buf_staleness`` (``(M,)``
float32, host tensors: the admission decision is made on the host, so it
never waits for the card) and ``buf_count`` (an int, as ``round`` is). The
key paths, shapes and dtypes are the reference's, so the state round-trips
through either package's checkpoints.

Where the reference is functional, this port writes in place: an admission
copies the delta into slot ``buf_count`` of the buffer it was given, and the
state it returns shares that buffer. The buffer belongs to one owner (the
aggregator); the state passed in must not be used again, as the reference's
donated state is not. A flush builds fresh ``params`` and outer lanes and
never writes the old ones, so a params tree held elsewhere (an in-flight
client's snapshot) stays valid.

With ``buffer_size == K``, ``staleness_alpha == 0`` and every client
completing in the round, admission then flush is bitwise this package's
synchronous round (tested).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compression import Codec
from repro_torch.core.federated import FederatedConfig, apply_aggregate, init_federated_state
from repro_torch.tree import global_norm, tree_leaves, tree_map

#: the keys of a flush's metrics (the server phase's, then the buffer's)
FLUSH_METRICS = (
    "pseudo_grad_norm", "client_delta_norm_mean", "client_consensus", "effective_clients",
    "weight_entropy", "nonfinite_deltas", "global_model_norm",
    "buffer_fill", "buffer_occupancy", "staleness_mean", "staleness_max",
)


@dataclass(frozen=True)
class AsyncAggConfig:
    buffer_size: int = 4  # M — deltas per outer update (FedBuff's K)
    staleness_alpha: float = 0.5  # discount exponent; 0 = no discount
    max_staleness: int = 0  # reject deltas older than this (0 = accept any age)

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {self.buffer_size}")
        if self.staleness_alpha < 0.0:
            raise ValueError(f"staleness_alpha must be >= 0, got {self.staleness_alpha}")
        if self.max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {self.max_staleness}")


def init_async_state(fed: FederatedConfig, acfg: AsyncAggConfig, params,
                     rng: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """The sync server state plus the empty buffer lanes. Async clients are
    stateless (paper §7.8): no inner lanes are kept."""
    state = init_federated_state(replace(fed, keep_inner_state=False), params, rng)
    m = acfg.buffer_size
    state["buffer"] = tree_map(
        lambda p: torch.zeros((m,) + tuple(p.shape), dtype=torch.float32, device=p.device),
        params,
    )
    state["buf_weights"] = torch.zeros((m,), dtype=torch.float32)
    state["buf_staleness"] = torch.zeros((m,), dtype=torch.float32)
    state["buf_count"] = 0
    return state


def staleness_discount(weight, staleness, alpha: float) -> torch.Tensor:
    """FedBuff's polynomial discount w / (1 + s)^α in float32, s clamped at 0.
    Non-increasing in s; α = 0 returns the weight bitwise ((1+s)^0 = 1.0)."""
    s = torch.clamp(torch.as_tensor(staleness, dtype=torch.float32), min=0.0)
    return torch.as_tensor(weight, dtype=torch.float32) / (1.0 + s) ** alpha


@torch.no_grad()
def flush_buffer(fed: FederatedConfig, acfg: AsyncAggConfig, state: Dict[str, Any],
                 apply_fn=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One outer update from the buffered deltas, then an empty buffer.

    The server phase (``apply_fn``, by default ``apply_aggregate``) runs over
    the whole ``(M, ...)`` buffer with the discounted weights: empty slots
    weigh zero, so a partial flush aggregates only what arrived. A flush of
    an EMPTY buffer keeps ``params``, ``outer``, ``round`` and ``rng`` as
    they were (a zero step would still decay FedMom/FedAdam lanes and age
    every in-flight client); its metrics are the server phase's all the same,
    as in the reference."""
    core = {k: state[k] for k in ("params", "outer", "round", "rng")}
    device = tree_leaves(state["buffer"])[0].device
    new_core, metrics = (apply_fn or apply_aggregate)(
        fed, core, state["buffer"], client_weights=state["buf_weights"].to(device)
    )
    count = int(state["buf_count"])
    if count == 0:
        new_core = core
    stal = state["buf_staleness"].numpy()
    metrics = dict(
        metrics,
        buffer_fill=float(count),
        buffer_occupancy=float(np.float32(count) / np.float32(acfg.buffer_size)),
        staleness_mean=float(np.sum(stal, dtype=np.float32) / np.float32(max(count, 1))),
        staleness_max=float(np.max(stal)),
    )
    m = acfg.buffer_size
    new_state = dict(
        new_core,
        buffer=state["buffer"],  # stale rows are dead: their weights are zero
        buf_weights=torch.zeros((m,), dtype=torch.float32),
        buf_staleness=torch.zeros((m,), dtype=torch.float32),
        buf_count=0,
    )
    return new_state, metrics


@torch.no_grad()
def admit_delta(
    fed: FederatedConfig,
    acfg: AsyncAggConfig,
    state: Dict[str, Any],
    delta,  # params-shaped pseudo-gradient, or a codec payload (no client axis)
    client_round: int,  # the model version the delta was computed against
    weight,  # pre-discount aggregation weight (n_k or 1)
    auto_flush: bool = True,  # flush here when the buffer fills
    codec: Optional[Codec] = None,  # uplink codec: the payload is decoded at the door
    apply_fn=None,  # server-phase override for the flush
    screen: bool = False,  # the delta screen at the door (core/robust.py)
    norm_bound=None,  # the admission norm bound under the screen (None: none)
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Admit one pseudo-gradient into the buffer; with ``auto_flush``, flush
    when it fills.

    With a ``codec`` the payload is decoded first, before the accept test, as
    in the reference: a refused int8 upload still runs its decode. Staleness
    is ``round − client_round`` clamped at 0. A zero-weight arrival, one
    staler than ``max_staleness`` (when that is > 0) and any arrival at a
    full buffer are refused without taking a slot; a full buffer never
    overwrites one. The admission scalars are host floats.

    ``screen`` arms the payload defense: a non-finite decoded delta is always
    refused, and with ``norm_bound`` one whose norm is above it (compared in
    float32); neither takes a slot. A screened admission reports
    ``delta_norm`` and ``screened``.

    ``metrics`` holds ``accepted``, ``staleness``, ``discounted_weight`` and
    ``buf_count``; with ``auto_flush`` also every :data:`FLUSH_METRICS` key
    (zero when no flush ran) and ``flushed``."""
    if codec is not None:
        delta = codec.decode(delta)
    staleness = max(float(int(state["round"]) - int(client_round)), 0.0)
    w = torch.as_tensor(weight, dtype=torch.float32)
    disc = staleness_discount(w, staleness, acfg.staleness_alpha)
    accept = float(w) > 0.0
    if acfg.max_staleness > 0:
        accept = accept and staleness <= float(acfg.max_staleness)
    screen_metrics: Dict[str, Any] = {}
    if screen:
        dn = float(global_norm(delta))
        ok = math.isfinite(dn)  # NaN/inf payloads never reach a buffer slot
        if norm_bound is not None:
            ok = ok and dn <= float(np.float32(norm_bound))
        accept = accept and ok
        screen_metrics = {"delta_norm": dn, "screened": 0.0 if ok else 1.0}
    accept = accept and int(state["buf_count"]) < acfg.buffer_size
    if accept:
        idx = int(state["buf_count"])
        for b, d in zip(tree_leaves(state["buffer"]), tree_leaves(delta)):
            b[idx].copy_(d)
        state["buf_weights"][idx] = disc
        state["buf_staleness"][idx] = staleness
        state = dict(state, buf_count=idx + 1)
    metrics: Dict[str, Any] = {
        "accepted": 1.0 if accept else 0.0,
        "staleness": staleness,
        "discounted_weight": float(disc) if accept else 0.0,
        **screen_metrics,
    }
    if auto_flush:
        if state["buf_count"] >= acfg.buffer_size:
            state, flush_metrics = flush_buffer(fed, acfg, state, apply_fn=apply_fn)
        else:
            flush_metrics = dict.fromkeys(FLUSH_METRICS, 0.0)
        metrics.update(flush_metrics)
        metrics["flushed"] = 1.0 if float(flush_metrics["buffer_fill"]) > 0 else 0.0
    metrics["buf_count"] = float(state["buf_count"])
    return state, metrics


def admission_record(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Host view of one admission: ``accepted`` as a bool, the scalars as floats."""
    rec = {
        "accepted": bool(float(metrics["accepted"]) > 0),
        "staleness": float(metrics["staleness"]),
        "discounted_weight": float(metrics["discounted_weight"]),
    }
    if "buf_count" in metrics:
        rec["buf_count"] = float(metrics["buf_count"])
    return rec


def admit_deltas(
    fed: FederatedConfig,
    acfg: AsyncAggConfig,
    state: Dict[str, Any],
    deltas,  # leaves (N, ...): N arrivals (or codec payloads) in admission order
    client_rounds,  # (N,) round tags
    weights,  # (N,) pre-discount weights
    codec: Optional[Codec] = None,
    apply_fn=None,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Admit N arrivals in order, flushing whenever the buffer fills (N > M
    is fine). Metrics come back stacked, one float32 entry per arrival."""
    rounds = np.asarray(client_rounds, np.int64)
    ws = np.asarray(weights.cpu() if isinstance(weights, torch.Tensor) else weights,
                    np.float32)
    rows = []
    for i in range(len(rounds)):
        d = tree_map(lambda x: x[i], deltas)
        state, m = admit_delta(fed, acfg, state, d, int(rounds[i]), ws[i], codec=codec,
                               apply_fn=apply_fn)
        rows.append(m)
    stacked = {k: torch.tensor([float(r[k]) for r in rows], dtype=torch.float32)
               for k in rows[0]}
    return state, stacked
