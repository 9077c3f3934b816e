"""Backend-pluggable federation driver: the seam between the simulated
in-process timeline and the cross-process socket runtime
(``repro.runtime.driver``'s counterpart).

The event order, admission, residual custody and the checkpoint schema live
in :class:`~repro_torch.core.aggregator.AsyncBufferAggregator`; what varies is
who executes a dispatched slot's local training. That seam is
:class:`ClientBackend`:

    submit(assignment)        — a slot was dispatched (fired from the
                                aggregator's ``_on_dispatch`` hook, restored
                                slots included)
    result(index, timeout)    — block until the slot's upload is available
    commit(index, result)     — the upload was processed in event order

Assignments are self-describing and pure: the params snapshot and version
fixed at dispatch, the client's error-feedback row, the per-dispatch codec
key ``fold_in(uplink_rng, index)`` (the rule ``AsyncFederationDriver`` uses),
the realized τ_i and the data cursor. A client holds at most one slot, so the
row and cursor a slot carries cannot change before it completes: executing an
assignment twice gives the same result, which is what makes lease-expiry
redispatch and first-result-wins dedup safe.

:class:`FederationDriver` over :class:`LocalClientBackend` is bitwise the
port's :class:`~repro_torch.core.aggregator.AsyncFederationDriver`; the
socket backend (``runtime/server.py``) is another backend.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.aggregator import AsyncBufferAggregator
from repro_torch.core.async_agg import AsyncAggConfig  # noqa: F401  (the reference's public name)
from repro_torch.core.compression import Codec
from repro_torch.core.federated import FederatedConfig, run_clients
from repro_torch.core.sampler import ParticipationConfig
from repro_torch.tree import global_norm, tree_map


@dataclass
class Assignment:
    """One dispatched slot's work order — everything a worker needs, nothing
    the worker must remember."""

    index: int  # dispatch index: the idempotency key
    client: int  # population client id (data + residual ownership)
    version: int  # model version the snapshot was taken at
    local_steps: int  # realized τ_i under partial progress (0 → full τ)
    params: Any  # params snapshot (by reference: no params tensor is written in place)
    residual: Any = None  # (1, ...) error-feedback row, stateful codecs only
    rng: Any = None  # per-dispatch (2,) uint32 codec key, codec runs only
    stream_state: Any = None  # JSON data cursor (the socket runtime ships it)


@dataclass
class ClientResult:
    """One slot's upload: exactly what crosses the uplink, plus bookkeeping."""

    index: int
    client: int
    payload: Any  # encoded codec payload (client axis stripped)
    residual: Any  # updated (1, ...) error-feedback row, stateful codecs only
    loss: float  # last local-step train loss
    stream_state: Any = None  # advanced data cursor (socket runtime)


class ClientBackend:
    """Executes assignments; owns nothing resumable except data cursors."""

    def submit(self, assignment: Assignment) -> None:
        raise NotImplementedError

    def result(self, index: int, timeout: Optional[float] = None) -> ClientResult:
        """Block until slot ``index`` completed. Raises ``TimeoutError`` after
        ``timeout`` seconds so the driver can interleave deadline flushes."""
        raise NotImplementedError

    def commit(self, index: int, result: ClientResult) -> None:
        """Called in event order after the driver processed ``result``."""

    def apply_knob_update(self, update, acfg) -> None:
        """The control loop applied a :class:`~repro_torch.control.KnobUpdate`
        server-side; ``acfg`` is the async config after it. Assignments need
        nothing: admission and flush live in the aggregator."""

    def close(self) -> None:
        pass


def build_client_phase(loss_fn: Callable, fed: FederatedConfig, codec: Optional[Codec],
                       partial_progress: bool):
    """The C = 1 client phase every backend runs, ``(params, version,
    batches, extra) -> (deltas, aux)``: ``run_clients`` with the call
    ``AsyncFederationDriver`` makes, so every backend computes the same bits.
    ``extra`` holds ``rng`` (with a codec), ``res`` (a stateful codec) and
    ``tau`` (partial progress)."""
    fed1 = replace(fed, clients_per_round=1, keep_inner_state=False)
    stateful = codec is not None and codec.stateful

    def client_phase(params, version: int, batches, extra: Dict[str, Any]):
        st: Dict[str, Any] = {"params": params, "round": int(version)}
        kw: Dict[str, Any] = {}
        if codec is not None:
            st["rng"] = extra["rng"]
        if stateful:
            kw["residuals"] = extra["res"]
        if partial_progress:
            kw["tau_steps"] = extra["tau"]
        return run_clients(loss_fn, fed1, st, batches, codec=codec, **kw)

    return client_phase


def execute_assignment(client_phase, fed: FederatedConfig, partial_progress: bool,
                       stateful: bool, params, version: int, batches, rng=None,
                       residual=None, local_steps: int = 0):
    """Run one assignment through ``client_phase``: ``(payload, residual row
    or None, last local-step loss)``."""
    extra: Dict[str, Any] = {}
    if rng is not None:
        extra["rng"] = np.asarray(rng, np.uint32)
    if partial_progress:
        extra["tau"] = np.asarray([int(local_steps) or fed.local_steps], np.int32)
    if stateful:
        extra["res"] = residual
    deltas, aux = client_phase(params, version, batches, extra)
    payload = tree_map(lambda d: d[0], deltas)
    return (payload, aux["residuals"] if stateful else None,
            float(aux["step_metrics"]["loss"][-1]))


class LocalClientBackend(ClientBackend):
    """In-process execution: an assignment runs when the driver asks for its
    result, in event order — the instant ``AsyncFederationDriver`` runs
    ``make_batches`` and the client phase, so the data draws and every float
    are the same."""

    def __init__(self, loss_fn: Callable, fed: FederatedConfig, pcfg: ParticipationConfig,
                 make_batches: Callable[[int], Dict[str, Any]], codec: Optional[Codec] = None):
        self.fed = fed
        self.make_batches = make_batches
        self._stateful = codec is not None and codec.stateful
        self._partial = pcfg.partial_progress
        self._client_fn = build_client_phase(loss_fn, fed, codec, pcfg.partial_progress)
        self._pending: Dict[int, Assignment] = {}
        self.n_client_phases = 0  # one codec encode each

    def submit(self, a: Assignment) -> None:
        self._pending[a.index] = a

    def result(self, index: int, timeout: Optional[float] = None) -> ClientResult:
        a = self._pending.pop(index)
        batches = self.make_batches(a.client)
        self.n_client_phases += 1
        payload, residual, loss = execute_assignment(
            self._client_fn, self.fed, self._partial, self._stateful, a.params, a.version,
            batches, rng=a.rng, residual=a.residual, local_steps=a.local_steps)
        return ClientResult(index=index, client=a.client, payload=payload, residual=residual,
                            loss=loss)


class FederationDriver(AsyncBufferAggregator):
    """Event-driven federation over a pluggable :class:`ClientBackend`.

    Results are admitted strictly in simulated-event order (the heap's pop
    order), whatever order they arrive in: a reorder buffer keyed by
    dispatch index. With pure assignments this makes the socket runtime's
    final state bitwise the in-process driver's for the same seeds.

    ``flush_deadline`` (wall seconds) arms the partial-participation escape
    hatch: when the next in-order result stalls longer, the server flushes
    what the buffer holds; an empty-buffer deadline flush changes no state.
    ``None`` keeps exact parity with the in-process driver."""

    def __init__(self, backend: ClientBackend, fed: FederatedConfig, acfg, pcfg, *,
                 flush_deadline: Optional[float] = None, **kw):
        # the backend must exist before super().__init__: construction fires
        # _on_dispatch for the initial K slots (or the restored manifest's)
        self.backend = backend
        self.flush_deadline = flush_deadline
        super().__init__(fed, acfg, pcfg, **kw)

    # --- dispatch → assignment -------------------------------------------
    def _on_dispatch(self, ev, snapshot, version: int) -> None:
        if not ev.completes:
            return  # unavailable or dropped clients never upload
        rng = residual = None
        if self.codec is not None:
            rng = self.dispatch_key(ev.index)
        if self.residuals is not None:
            residual = self._res_gather(self.residuals, ev.client)
        self.backend.submit(Assignment(
            index=ev.index, client=ev.client, version=version,
            local_steps=(ev.local_steps if self.pcfg.partial_progress else 0),
            params=snapshot, residual=residual, rng=rng,
        ))

    def _notify_knobs(self, update) -> None:
        self.backend.apply_knob_update(update, self.acfg)

    # --- event loop -------------------------------------------------------
    def _await_result(self, index: int, rows: List[Dict[str, Any]]) -> ClientResult:
        while True:
            try:
                return self.backend.result(index, timeout=self.flush_deadline)
            except TimeoutError:
                # deadline flush: rounds keep progressing while a slot stalls;
                # an empty one changes no state
                if int(self.state["buf_count"]) > 0:
                    rows.append(self._flush_row(self.flush(), deadline=True))
                else:
                    self.flush()
                    if self.tracer.enabled:
                        self.tracer.point("deadline_flush_empty", parent=self._round_span,
                                          stalled_index=index)
                        self.tracer.count("deadline_flushes_empty")

    def step(self) -> List[Dict[str, Any]]:
        """Advance by one completion event; this step's flush rows (deadline
        flushes and the buffer-full flush)."""
        rows: List[Dict[str, Any]] = []
        ev, snapshot, version = self._pop_completion()
        if ev.completes:
            staleness = int(self.state["round"]) - version
            rejected = 0 < self.acfg.max_staleness < staleness
            # the worker may already be training a known-stale slot: its
            # result is still fetched, so the data cursor advances as in-process
            res = self._await_result(ev.index, rows)
            if rejected and self.residuals is None:
                self.work_wasted += ev.duration
                self._trace_complete(ev, "rejected_stale", staleness=staleness)
            elif (self.robust_state is not None
                  and self.robust_state.is_quarantined(int(ev.client), int(self.state["round"]))):
                # fetched (the slot retires, the cursor advances) but never admitted
                self.work_wasted += ev.duration
                self._trace_complete(ev, "quarantined")
            else:
                if self.residuals is not None:
                    # the residual is the client's, whatever the door decides
                    self._res_scatter(self.residuals, ev.client, res.residual)
                    self._res_norms.append(float(global_norm(res.residual)))
                self.uplink_bytes_total += self._bytes_per_upload
                m = self.admit(res.payload, version, self.event_weight(ev))
                self._note_admission(ev, m)
                rec = self._trace_admit(ev, m)
                if float(m["accepted"]) > 0:
                    self.work_completed += ev.duration
                    self._staleness.append(float(m["staleness"]))
                    self._losses.append(res.loss)
                    self._trace_complete(ev, "admitted", staleness=rec.get("staleness"))
                else:  # refused at the door: kept out of the flush row
                    self.work_wasted += ev.duration
                    self._trace_complete(ev, "rejected", staleness=rec.get("staleness"))
            self.backend.commit(ev.index, res)
            if self.should_flush():
                rows.append(self._flush_row(self.flush()))
        else:
            self.work_wasted += ev.duration
            self._trace_complete(ev, "no_show")
        self._dispatch()
        return rows

    def run_updates(self, n_updates: int,
                    on_update: Optional[Callable[[int, Dict[str, Any]], None]] = None,
                    max_events: Optional[int] = None) -> List[Dict[str, Any]]:
        """Run until ``n_updates`` outer updates (deadline flushes count)."""
        history: List[Dict[str, Any]] = []
        budget = max_events if max_events is not None else 1000 * max(1, n_updates)
        while len(history) < n_updates and budget > 0:
            budget -= 1
            for row in self.step():
                if len(history) >= n_updates:
                    break
                row["update"] = len(history)
                history.append(row)
                if on_update is not None:
                    on_update(len(history) - 1, row)
        if len(history) < n_updates:
            raise RuntimeError(
                f"event budget exhausted after {len(history)}/{n_updates} outer "
                f"updates — mostly-offline population, zero weights, or "
                f"max_staleness rejecting everything; raise max_events or "
                f"loosen the configuration"
            )
        return history
