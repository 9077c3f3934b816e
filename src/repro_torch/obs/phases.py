"""Phase spans inside a traced synchronous round: the port's own addition to
``obs`` (the reference traces only the ``round`` span).

``SyncAggregator`` opens :func:`round_phases` around a flat round when its
tracer is on. The round's code marks its phases with :func:`phase`, which
returns a shared no-op context whenever no traced round is open in this
thread: async, tiled and socket-runtime rounds, and every untraced round, pay
one context-variable read and allocate nothing.

The tree under a round ``r{rid}`` (ids are the round's, a client's or a
step's id plus a suffix)::

    prologue      r{rid}/prologue           client weights to the device, residual gather
    clients       r{rid}/clients            run_clients
      buffers     r{rid}/buffers            weights to the host, the (C, N) delta buffer, sums
      client      r{rid}/c{c}               one cohort slot
        init      r{rid}/c{c}/init          params clone, inner state
        step      r{rid}/c{c}/s{t}          one local step
          fwd_bwd r{rid}/c{c}/s{t}/fb       every micro-batch's forward and backward
          opt     r{rid}/c{c}/s{t}/opt      FedProx term, clip, inner update
        delta     r{rid}/c{c}/delta         g - p into the buffer, norms, weighted sum
      encode      r{rid}/encode             DP clip, cohort encode, pseudo-grad cast
      step_metrics r{rid}/step_metrics      per-step metrics, cohort norms
    server        r{rid}/server             the server phase (apply_fn)
      decode      r{rid}/decode             cohort decode
      apply       r{rid}/apply              packing, server_apply or the per-leaf mean, outer update
    epilogue      r{rid}/epilogue           the round's metrics
    scatter       r{rid}/scatter            updated residual rows into the store
    screen        r{rid}/screen             the delta screen's flags read back
    readout       r{rid}/readout            the traced attrs' host reads

``encode``, ``decode``, ``scatter`` and ``screen`` open only where that work
runs. Every device operation of the round runs inside exactly one leaf.

Besides the spans, the round counts events: code that has events to count
registers a name with :func:`counter` and calls the function it returns at
each one. The round's E event carries every registered name as
``<name>_n``, 0 where none happened.

Each span is a Tracer span (B at its start; its E event is stamped at its end
and emitted when the round closes, carrying ``syncs`` and, on CUDA,
``dev_s``) and a ``torch.profiler.record_function("fed::<name>")`` range, so
a profiler places its ops and idle gaps under the phase. On CUDA each span
records a timing event on the current stream at both ends; they are read once
the readout's host reads have drained the stream. Meanwhile
``torch.cuda.set_sync_debug_mode("warn")`` reports every host synchronisation
as a warning, which is counted on the innermost open span. The round's E event
gets the rollup (:meth:`RoundPhases.finish`).
"""
from __future__ import annotations

import time
import warnings
from collections import defaultdict
from collections import Counter
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from typing import Any, Callable, Dict, List, Optional

import torch

#: the text of the warning ``set_sync_debug_mode("warn")`` raises at each sync
SYNC_WARNING = "called a synchronizing CUDA operation"

#: spans whose id prefixes their children's
_ANCHORS = ("round", "client", "step")
#: id suffixes that are not the span's name
_SUFFIX = {"client": "c", "step": "s", "fwd_bwd": "fb"}

#: the names registered with :func:`counter`; each appears in every round's
#: rollup as ``<name>_n``
COUNTERS: List[str] = []

_NULL = nullcontext()
_ROUND: ContextVar[Optional["RoundPhases"]] = ContextVar("repro_torch_round_phases",
                                                         default=None)


def phase(name: str, index: Optional[int] = None):
    """A phase span of the traced round open in this thread, or a no-op.
    ``index`` numbers a ``client`` or a ``step``."""
    rec = _ROUND.get()
    return _NULL if rec is None else rec.span(name, index)


def counter(name: str) -> Callable[[], None]:
    """Register ``name`` in :data:`COUNTERS` and return the function that
    counts one ``name`` event on the traced round open in this thread
    (nothing outside one)."""
    if name not in COUNTERS:
        COUNTERS.append(name)

    def count() -> None:
        rec = _ROUND.get()
        if rec is not None:
            rec.counts[name] += 1

    return count


class _Span:
    __slots__ = ("name", "sid", "ev0", "rf", "end_ev", "ev1", "host_s", "syncs")

    def __init__(self, name, sid, ev0, rf):
        self.name, self.sid, self.ev0, self.rf = name, sid, ev0, rf
        self.end_ev = self.ev1 = None
        self.host_s = 0.0
        self.syncs = 0


class RoundPhases:
    """The phase spans of one round under the open span ``round_id``."""

    def __init__(self, tracer, round_id: str, device: torch.device, log: List):
        self.tracer = tracer
        self.cuda = torch.device(device).type == "cuda"
        self._log, self._seen = log, 0
        self._held: List = []  # caught warnings that are not syncs
        self._root = self._open("round", round_id)
        self._stack = [self._root]
        self._closed: List[_Span] = []
        self.counts: Counter = Counter()

    def _open(self, name: str, sid: str) -> _Span:
        ev0 = None
        if self.cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        rf = torch.profiler.record_function(f"fed::{name}")
        rf.__enter__()
        return _Span(name, sid, ev0, rf)

    def _close(self, sp: _Span) -> None:
        sp.rf.__exit__(None, None, None)
        if self.cuda:
            sp.ev1 = torch.cuda.Event(enable_timing=True)
            sp.ev1.record()

    def _drain(self) -> None:
        """Count the syncs reported since the last boundary on the innermost
        open span."""
        top = self._stack[-1] if self._stack else None
        for w in self._log[self._seen:]:
            if SYNC_WARNING in str(w.message):
                if top is not None:
                    top.syncs += 1
            else:
                self._held.append(w)
        self._seen = len(self._log)

    @contextmanager
    def span(self, name: str, index: Optional[int]):
        self._drain()
        anchor = next(s.sid for s in reversed(self._stack) if s.name in _ANCHORS)
        sid = f"{anchor}/{_SUFFIX.get(name, name)}{'' if index is None else index}"
        t0 = time.perf_counter()
        self.tracer.begin(name, span_id=sid, parent=self._stack[-1].sid)
        sp = self._open(name, sid)
        self._stack.append(sp)
        try:
            yield
        finally:
            self._drain()
            self._stack.pop()
            self._close(sp)
            sp.end_ev = self.tracer.stamp_end(sid)
            sp.host_s = sp.end_ev.mono - t0
            self._closed.append(sp)

    def finish(self) -> Dict[str, Any]:
        """Close the round's own range, read the device times, emit the phase
        spans' E events and return the round's rollup: ``<name>_s``,
        ``<name>_n`` and, on CUDA, ``<name>_dev_s`` for every phase name,
        ``<name>_n`` for every counter, ``host_syncs`` (all but the
        readout's) and the round's ``dev_s``."""
        self._drain()
        self._stack = []
        self._close(self._root)
        if self.cuda:
            # the readout's host reads drained the stream: this waits only for
            # the events recorded after them
            self._root.ev1.synchronize()
        out: Dict[str, Any] = defaultdict(float)
        syncs = self._root.syncs
        for sp in self._closed:
            attrs = sp.end_ev.attrs
            attrs["syncs"] = sp.syncs
            out[f"{sp.name}_s"] += sp.host_s
            out[f"{sp.name}_n"] += 1
            if self.cuda:
                attrs["dev_s"] = sp.ev0.elapsed_time(sp.ev1) / 1e3
                out[f"{sp.name}_dev_s"] += attrs["dev_s"]
            if sp.name != "readout":
                syncs += sp.syncs
            self.tracer.emit(sp.end_ev)
        out = {k: int(v) if k.endswith("_n") else v for k, v in out.items()}
        out.update({f"{name}_n": self.counts[name] for name in COUNTERS})
        out["host_syncs"] = syncs
        if self.cuda:
            out["dev_s"] = self._root.ev0.elapsed_time(self._root.ev1) / 1e3
        self._closed = []
        return out


def round_phases(tracer, round_id: str, device):
    """Record the phase spans of the round whose span ``round_id`` the caller
    has opened: a context that yields the :class:`RoundPhases`, whose
    :meth:`~RoundPhases.finish` gives the round's E event its rollup, or
    None with a disabled tracer. Warnings other than syncs are raised again
    on the way out."""
    return _recording(tracer, round_id, device) if tracer.enabled else _NULL


@contextmanager
def _recording(tracer, round_id: str, device):
    cuda = torch.device(device).type == "cuda"
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        mode = torch.cuda.get_sync_debug_mode() if cuda else 0
        rec = RoundPhases(tracer, round_id, device, log)
        token = _ROUND.set(rec)
        try:
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            yield rec
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
            _ROUND.reset(token)
            rec._drain()
            if rec._stack:  # the round raised before finish(): close its range
                rec._root.rf.__exit__(None, None, None)
    for w in rec._held:
        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno, source=w.source)
