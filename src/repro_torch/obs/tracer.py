"""Zero-dependency in-process tracer, ``repro.obs.tracer``'s copy.

One :class:`Tracer` instance per process. It owns three stores:

* an optional :class:`~repro_torch.obs.events.JsonlSink` — every span boundary,
  instant and counter snapshot is appended as a structured event;
* thread-safe **counters** and **gauges** — the live signal plane the
  Prometheus-style metrics endpoint renders (``obs/metrics.py``);
* a bounded **ring buffer** of recent events — in-memory flight recorder for
  tests and debugging, never unbounded.

The disabled path is the contract that lets instrumentation live inside hot
loops: ``NULL_TRACER`` (and any ``Tracer(enabled=False)``) makes every method
a constant-time early return that allocates nothing, takes no lock, reads no
clock and touches no device value — guarded by the overhead test in
``tests/test_obs.py`` and, more importantly, by the bitwise-parity tests:
tracing on or off, the aggregation math produces identical bits because the
tracer only ever *reads* host-side floats the metrics path already computed.

Span identity is caller-supplied and deterministic (see ``obs/events.py``);
``begin``/``end`` are split so spans can cross call boundaries (a dispatch
span opens at dispatch and closes rounds later at admission), while ``span()``
wraps the common enclosed case.
"""
from __future__ import annotations

import threading
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

from .events import Event, JsonlSink, make_event


class Tracer:
    """Per-process trace/metrics recorder.

    Args:
        sink: event sink (``JsonlSink`` or anything with ``emit/flush/close``).
            ``None`` keeps counters/gauges/ring live with no file IO — what
            ``--metrics-port`` without ``--trace`` uses.
        proc: this process's role label (``"server"``, ``"w0"``, ...).
        trace_id: run id shared by all processes of one deployment
            (``launch/train.py`` derives it from the seed).
        enabled: ``False`` turns every method into a no-op.
        ring_size: bound on the in-memory flight recorder.
    """

    def __init__(
        self,
        sink: Optional[JsonlSink] = None,
        proc: str = "proc",
        trace_id: str = "trace",
        enabled: bool = True,
        ring_size: int = 4096,
    ):
        self.enabled = enabled
        self.sink = sink
        self.proc = proc
        self.trace_id = trace_id
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.ring: deque = deque(maxlen=ring_size)
        self._open_parents: Dict[str, Optional[str]] = {}

    # -- event plumbing ----------------------------------------------------
    def _emit(self, ev: Event) -> None:
        with self._lock:
            self.ring.append(ev)
        if self.sink is not None:
            self.sink.emit(ev)

    # -- spans -------------------------------------------------------------
    def begin(
        self,
        name: str,
        span_id: Optional[str] = None,
        parent: Optional[str] = None,
        **attrs: Any,
    ) -> str:
        """Open a span; returns its id (defaults to ``name``)."""
        if not self.enabled:
            return span_id or name
        sid = span_id or name
        with self._lock:
            self._open_parents[sid] = parent
        self._emit(
            make_event(name, "B", self.proc, self.trace_id, sid, parent, attrs)
        )
        return sid

    def end(self, span_id: str, **attrs: Any) -> None:
        """Close a span by id; ``attrs`` (e.g. the outcome) land on the E event."""
        if not self.enabled:
            return
        ev = self.stamp_end(span_id)
        ev.attrs.update(attrs)
        self._emit(ev)

    def stamp_end(self, span_id: str) -> Optional[Event]:
        """Close a span by id and return its E event, stamped now but not
        emitted: the caller adds attrs it learns later and passes it to
        :meth:`emit` (``obs/phases``: device times read after the round)."""
        if not self.enabled:
            return None
        with self._lock:
            parent = self._open_parents.pop(span_id, None)
        return make_event("end", "E", self.proc, self.trace_id, span_id, parent, {})

    def emit(self, ev: Event) -> None:
        """Record an event made by :meth:`stamp_end`."""
        if self.enabled:
            self._emit(ev)

    @contextmanager
    def span(
        self,
        name: str,
        span_id: Optional[str] = None,
        parent: Optional[str] = None,
        **attrs: Any,
    ):
        """Context-manager form for spans enclosed in one call frame."""
        if not self.enabled:
            yield span_id or name
            return
        sid = self.begin(name, span_id, parent, **attrs)
        try:
            yield sid
        finally:
            self.end(sid)

    # -- instants / counters / gauges --------------------------------------
    def point(
        self, name: str, parent: Optional[str] = None, **attrs: Any
    ) -> None:
        """Record an instant event (lease grant, admit, fault, ...)."""
        if not self.enabled:
            return
        self._emit(
            make_event(name, "i", self.proc, self.trace_id, "", parent, attrs)
        )

    def count(self, name: str, delta: float = 1.0) -> None:
        """Increment a monotonic counter (rendered as ``*_total``)."""
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + delta

    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time gauge. Callers pass plain host floats only —
        never tensors: gauges are read from the metrics HTTP thread, which
        must not touch the device."""
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = float(value)

    # -- lifecycle ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Consistent copy of counters + gauges (for the endpoint/tests)."""
        with self._lock:
            return {"counters": dict(self.counters), "gauges": dict(self.gauges)}

    def flush(self) -> None:
        """Push buffered events to disk — called before ``os._exit`` kills."""
        if self.sink is not None:
            self.sink.flush()

    def close(self) -> None:
        """Emit a final counter snapshot ("C" event) and close the sink."""
        if not self.enabled:
            return
        snap = self.snapshot()
        self._emit(
            make_event(
                "counters", "C", self.proc, self.trace_id, "", None,
                {"counters": snap["counters"], "gauges": snap["gauges"]},
            )
        )
        if self.sink is not None:
            self.sink.close()


class _NullTracer(Tracer):
    """The shared disabled tracer: importable, falsy-enabled, state-free."""

    def __init__(self):
        super().__init__(sink=None, proc="null", trace_id="null", enabled=False)


#: Module-level disabled tracer. Instrumented code defaults its ``tracer``
#: attribute to this so hot paths read one ``self.tracer.enabled`` bool (or
#: pay a single early-returning call) and nothing else.
NULL_TRACER = _NullTracer()


def get_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Normalize an optional tracer argument to a real instance."""
    return tracer if tracer is not None else NULL_TRACER
