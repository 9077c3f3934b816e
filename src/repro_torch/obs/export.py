"""Chrome trace-event export and per-round rollups (``repro.obs.export``'s copy).

``chrome_trace`` converts one run's merged event timeline into the Chrome
trace-event JSON format — load the output at ``ui.perfetto.dev`` (or
``chrome://tracing``) to see the federation as a waterfall:

* one **process** row per runtime process (server, w0, w1, ...; respawned
  incarnations of one role share the row but keep distinct pids in args);
* on the server, one **track** (thread row) per population client slot —
  track 0 carries run/round/flush spans, track ``1 + client`` carries that
  client's dispatch spans, so K concurrently-leased slots render as K
  parallel bars exactly like the simulator's Gantt intuition;
* workers render pull → train → push as nested bars on their own row.

Timestamps: Chrome wants microseconds. Bar *placement* uses the wall clock
(the cross-process axis); bar *width* uses the same-process monotonic delta
(the only valid duration source) — see ``obs/events.py``. Unclosed spans
(crash, still-in-flight at exit without finalization) are emitted with the
remainder of their process's observed timeline as width and tagged
``"unclosed": true`` rather than dropped: a crashed worker's half-open
assignment bar IS the signal.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

from .events import Event, span_pairs

#: attrs key that assigns a span to a display track (thread row).
TRACK_ATTR = "track"


def _track(ev_attrs: Dict[str, Any]) -> int:
    try:
        return int(ev_attrs.get(TRACK_ATTR, 0))
    except (TypeError, ValueError):
        return 0


def chrome_trace(events: Iterable[Event]) -> Dict[str, Any]:
    """Merged event list → Chrome trace-event JSON object."""
    events = list(events)
    procs: List[str] = []
    for ev in events:
        if ev.proc not in procs:
            procs.append(ev.proc)
    pid_of = {p: i + 1 for i, p in enumerate(procs)}

    out: List[Dict[str, Any]] = []
    # process / thread naming metadata
    tracks_seen: Dict[tuple, None] = {}
    for p in procs:
        out.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid_of[p],
                "tid": 0,
                "args": {"name": p},
            }
        )

    closed, unclosed = span_pairs(events)
    # end of each process's observed timeline — width for unclosed spans
    last_mono: Dict[tuple, float] = {}
    for ev in events:
        key = (ev.proc, ev.pid)
        last_mono[key] = max(last_mono.get(key, ev.mono), ev.mono)

    def slice_event(
        name: str,
        proc: str,
        ts: float,
        dur: float,
        attrs: Dict[str, Any],
        span: str,
        extra: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        tid = _track(attrs)
        tracks_seen[(pid_of[proc], tid)] = None
        args = {k: v for k, v in attrs.items() if k != TRACK_ATTR}
        args["span"] = span
        if extra:
            args.update(extra)
        return {
            "ph": "X",
            "name": name,
            "pid": pid_of[proc],
            "tid": tid,
            "ts": ts * 1e6,
            "dur": max(dur, 0.0) * 1e6,
            "cat": "fed",
            "args": args,
        }

    for sp in closed:
        out.append(
            slice_event(
                sp["name"], sp["proc"], sp["ts"], sp["dur"], sp["attrs"], sp["span"]
            )
        )
    for ev in unclosed:
        dur = last_mono.get((ev.proc, ev.pid), ev.mono) - ev.mono
        out.append(
            slice_event(
                ev.name, ev.proc, ev.ts, dur, ev.attrs, ev.span,
                extra={"unclosed": True, "pid_real": ev.pid},
            )
        )
    for ev in events:
        if ev.ph == "i":
            tid = _track(ev.attrs)
            tracks_seen[(pid_of[ev.proc], tid)] = None
            out.append(
                {
                    "ph": "i",
                    "s": "p",  # process-scoped instant marker
                    "name": ev.name,
                    "pid": pid_of[ev.proc],
                    "tid": tid,
                    "ts": ev.ts * 1e6,
                    "cat": "fed",
                    "args": {k: v for k, v in ev.attrs.items() if k != TRACK_ATTR},
                }
            )

    for (pid, tid) in sorted(tracks_seen):
        name = "main" if tid == 0 else f"slot c{tid - 1}"
        out.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": pid,
                "tid": tid,
                "args": {"name": name},
            }
        )

    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events: Iterable[Event], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(events), f)


def round_rollups(events: Iterable[Event]) -> List[Dict[str, Any]]:
    """Per-round rollup rows from the server's ``flush`` instants.

    Each flush instant already carries the host-side flush metrics row
    (round, buffer fill, staleness stats, mean train loss, sim time, whether
    it was a deadline flush); the rollup adds the admissions that fed it.
    """
    rows: List[Dict[str, Any]] = []
    admits_since: List[Dict[str, Any]] = []
    for ev in sorted(events, key=lambda e: (e.ts, e.mono)):
        if ev.name == "admit" and ev.ph == "i":
            admits_since.append(ev.attrs)
        elif ev.name == "flush" and ev.ph == "i":
            row = dict(ev.attrs)
            accepted = [a for a in admits_since if a.get("accepted")]
            row["n_admitted"] = len(accepted)
            row["n_rejected"] = len(admits_since) - len(accepted)
            stal = [a.get("staleness", 0.0) for a in accepted]
            row["staleness_admitted_max"] = max(stal) if stal else 0.0
            rows.append(row)
            admits_since = []
    return rows
