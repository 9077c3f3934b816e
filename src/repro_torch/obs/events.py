"""Versioned structured-event schema and append-only JSONL sink: a copy of
``repro.obs.events`` (stdlib only), so a trace either package writes loads in
the other.

One :class:`Event` is one fact about the federation runtime: a span boundary
(``ph`` = ``"B"``/``"E"``), an instant (``"i"``) or a counter snapshot
(``"C"``). Every event carries BOTH clocks:

* ``ts`` — wall-clock ``time.time()`` seconds. The only clock that is
  comparable ACROSS processes (all runtime processes share a host), so the
  merged timeline and the Chrome-trace export order events by it.
* ``mono`` — ``time.perf_counter()`` seconds. Monotonic but per-process, so it
  is the only clock DURATIONS may be computed from (span duration =
  ``E.mono − B.mono`` within one process; never across processes).

Identity: ``trace`` names the run (derived from the seed — every process of
one deployment shares it), ``span`` names the unit of work and ``parent``
links it upward. Span ids are DETERMINISTIC, keyed by the federation's own
coordinates rather than random uuids: the server's round span is
``u{version}``, a dispatched slot's span is ``d{index}`` (the dispatch cursor
— the same idempotency key the lease/redispatch machinery uses), and a
worker's execution of that slot is ``d{index}@{worker}``. Determinism is what
lets three processes' logs merge into one coherent tree with no id handshake:
the ids ride the wire (``runtime/transport`` frame meta) only so a worker
never has to re-derive them.

Durability discipline (the checkpoint module's atomic-write pattern, adapted
to an append-only log): ``os.replace`` cannot commit individual appends, so
the commit point moves to the LINE — each event is serialized to one complete
``\\n``-terminated line and handed to the OS in ONE buffered-write + flush.
A crash (chaos ``os._exit`` included) can therefore tear at most the final
line of a file; :func:`read_events` silently drops a torn TRAILING line but
raises loudly on a corrupt interior line, which can only mean real file
damage — the same "complete or absent, never silently wrong" contract the
checkpoint manifests give resume.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

#: Version tag of the event schema. Bump on incompatible layout changes;
#: :func:`decode_event` refuses a mismatched tag instead of misreading records.
EVENT_SCHEMA_VERSION = 1

#: Allowed event phases (Chrome-trace vocabulary, the subset we emit):
#: span begin / span end / instant / counter snapshot.
PHASES = ("B", "E", "i", "C")


@dataclass
class Event:
    name: str  # what happened ("dispatch", "flush", "fault", ...)
    ph: str  # phase: "B" | "E" | "i" | "C"
    ts: float  # wall clock (time.time) — cross-process ordering
    mono: float  # perf_counter — same-process durations ONLY
    proc: str  # process role ("server", "w0", ...)
    pid: int  # os pid: distinguishes respawned incarnations of one role
    trace: str  # run id (shared by every process of one deployment)
    span: str = ""  # span id ("" for bare instants)
    parent: Optional[str] = None  # parent span id
    attrs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.ph not in PHASES:
            raise ValueError(f"event phase {self.ph!r} not in {PHASES}")


def encode_event(ev: Event) -> Dict[str, Any]:
    """Event → plain-JSON dict (schema-versioned)."""
    return {
        "v": EVENT_SCHEMA_VERSION,
        "name": ev.name,
        "ph": ev.ph,
        "ts": ev.ts,
        "mono": ev.mono,
        "proc": ev.proc,
        "pid": ev.pid,
        "trace": ev.trace,
        "span": ev.span,
        "parent": ev.parent,
        "attrs": ev.attrs,
    }


def decode_event(d: Dict[str, Any]) -> Event:
    """Inverse of :func:`encode_event`; refuses unknown schema versions."""
    v = d.get("v")
    if v != EVENT_SCHEMA_VERSION:
        raise ValueError(
            f"event schema version {v!r} != supported {EVENT_SCHEMA_VERSION}"
        )
    return Event(
        name=d["name"],
        ph=d["ph"],
        ts=float(d["ts"]),
        mono=float(d["mono"]),
        proc=d["proc"],
        pid=int(d["pid"]),
        trace=d["trace"],
        span=d.get("span", ""),
        parent=d.get("parent"),
        attrs=d.get("attrs", {}),
    )


def make_event(
    name: str,
    ph: str,
    proc: str,
    trace: str,
    span: str = "",
    parent: Optional[str] = None,
    attrs: Optional[Dict[str, Any]] = None,
) -> Event:
    """Stamp an event with both clocks and this process's pid."""
    return Event(
        name=name,
        ph=ph,
        ts=time.time(),
        mono=time.perf_counter(),
        proc=proc,
        pid=os.getpid(),
        trace=trace,
        span=span,
        parent=parent,
        attrs=attrs or {},
    )


class JsonlSink:
    """Append-only JSONL event sink, one complete line per event.

    Thread-safe (the socket server emits from accept/serve threads). Opened in
    append mode so a respawned worker incarnation extends the same file — the
    ``pid`` field keeps incarnations distinguishable. ``flush()`` pushes
    buffered lines to the OS; the chaos monkey calls it before ``os._exit`` so
    a kill's own fault event survives the kill.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        # line-buffered text append: one write() per complete line below
        self._f = open(path, "a", encoding="utf-8")

    def emit(self, ev: Event) -> None:
        line = json.dumps(encode_event(ev), separators=(",", ":")) + "\n"
        with self._lock:
            if self._f.closed:
                return  # post-close stragglers (daemon threads) drop silently
            self._f.write(line)  # ONE write: the line is the commit unit

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def read_events(path: str) -> List[Event]:
    """Parse one process's JSONL event log.

    A torn TRAILING line (crash mid-append — the one tear the line-commit
    discipline permits) is dropped silently; an unparseable INTERIOR line
    means real corruption and raises with the line number.
    """
    out: List[Event] = []
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    # a complete file ends with "\n" → last split element is ""; anything else
    # in the final slot is a torn tail
    body, tail = lines[:-1], lines[-1]
    for i, line in enumerate(body):
        if not line:
            continue
        try:
            out.append(decode_event(json.loads(line)))
        except (json.JSONDecodeError, KeyError, ValueError) as e:
            raise ValueError(f"{path}:{i + 1}: corrupt event line: {e}") from e
    if tail:
        try:
            out.append(decode_event(json.loads(tail)))
        except (json.JSONDecodeError, KeyError, ValueError):
            pass  # torn tail: the event never committed
    return out


def load_run(source: Union[str, Sequence[str]]) -> List[Event]:
    """Merge one run's event files into a single wall-clock-ordered timeline.

    ``source`` is a directory (every ``*.jsonl`` inside) or an explicit list
    of files. The sort is stable on (ts, mono) so same-process order survives
    wall-clock ties.
    """
    if isinstance(source, str):
        if os.path.isdir(source):
            paths = sorted(
                os.path.join(source, n)
                for n in os.listdir(source)
                if n.endswith(".jsonl")
            )
        else:
            paths = [source]
    else:
        paths = list(source)
    if not paths:
        raise FileNotFoundError(f"no .jsonl event files under {source!r}")
    events: List[Event] = []
    for p in paths:
        events.extend(read_events(p))
    events.sort(key=lambda e: (e.ts, e.mono))
    return events


def span_pairs(events: Iterable[Event]):
    """Pair B/E events into completed spans; return ``(closed, open)``.

    A closed span is a dict ``{name, span, parent, proc, pid, ts, dur, attrs}``
    with ``dur`` from the SAME process's monotonic clock and ``attrs`` the
    union of begin- and end-attrs (end wins — that is where outcomes land).
    Open spans are the unmatched B events. Spans are keyed by
    ``(proc, pid, span)``: a respawned incarnation re-opening a span id never
    closes its dead predecessor's.
    """
    opened: Dict[tuple, Event] = {}
    closed: List[Dict[str, Any]] = []
    for ev in events:
        key = (ev.proc, ev.pid, ev.span)
        if ev.ph == "B":
            opened[key] = ev
        elif ev.ph == "E":
            b = opened.pop(key, None)
            if b is None:
                continue  # E without B: dropped begin (pre-attach) — ignore
            closed.append(
                {
                    "name": b.name,
                    "span": b.span,
                    "parent": b.parent,
                    "proc": b.proc,
                    "pid": b.pid,
                    "ts": b.ts,
                    "dur": max(0.0, ev.mono - b.mono),
                    "attrs": {**b.attrs, **ev.attrs},
                }
            )
    return closed, list(opened.values())
