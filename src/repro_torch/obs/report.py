"""``python -m repro_torch.obs.report`` — turn a run's JSONL event logs into
the round table, straggler/staleness breakdown and fault-injection audit
(``repro.obs.report``'s copy; it reads either package's traces).

Usage::

    python -m repro_torch.obs.report TRACE_DIR [more.jsonl ...] \
        [--check] [--expect-faults] [--chrome out.json] [--json]

``--check`` validates the merged timeline's structural invariants and exits
nonzero on violation — CI runs it against the chaos demo's trace:

* every server **dispatch span is closed with a terminal outcome**
  (``admitted`` / ``rejected_stale`` / ``rejected`` / ``no_show`` /
  ``inflight_at_exit``) — a dispatch the server forgot about is a leaked slot;
* **no orphan dispatch ids**: every worker-side assignment span parents into
  an existing server dispatch span (the wire-propagated ids line up);
* **no silently-unclosed spans**: an open span is only excused when its exact
  process *incarnation* (proc, pid) logged a chaos ``kill`` fault — a crash
  may leave half-open spans, but then the crash itself must be in the audit;
* every **norm-visible injected payload corruption** (``corrupt_nan`` /
  ``corrupt_inf`` fault instants) was defended against — screened at the
  door, quarantined, dedup-dropped, or unwound by a later rollback
  (:func:`corruption_coverage`);
* with ``--expect-faults``: the audit is non-empty (chaos actually fired).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Sequence

from repro_torch.metrics.fedmetrics import staleness_stats

from .events import Event, load_run, span_pairs
from .export import round_rollups, write_chrome_trace

#: outcomes a dispatch span may legally close with
TERMINAL_OUTCOMES = (
    "admitted", "rejected", "rejected_stale", "no_show", "inflight_at_exit",
    "quarantined",
)

#: corruption kinds the delta screen is REQUIRED to catch: they make the
#: delta norm non-finite, which the admission screen rejects unconditionally.
#: ``scale`` may legitimately pass during the screen's warmup window,
#: ``sign_flip`` is norm-invariant (a robust rule's problem, not the
#: screen's), and ``replay`` is a valid-looking stale payload (the
#: staleness/dedup machinery's problem) — none of those three can be audited
#: as must-screen.
SCREENABLE_CORRUPTIONS = ("nan", "inf")


def dispatch_table(events: Sequence[Event]) -> List[Dict[str, Any]]:
    """One row per dispatch index: the full lease/retry/redispatch lifecycle."""
    closed, opened = span_pairs(events)
    rows: Dict[str, Dict[str, Any]] = {}
    for sp in closed:
        if sp["name"] == "dispatch":
            rows[sp["span"]] = {
                "span": sp["span"],
                "index": sp["attrs"].get("index"),
                "client": sp["attrs"].get("client"),
                "version": sp["attrs"].get("version"),
                "outcome": sp["attrs"].get("outcome"),
                "staleness": sp["attrs"].get("staleness"),
                "dur": sp["dur"],
                "leases": [],
                "pushes": [],
                "workers": [],
            }
    for ev in opened:
        if ev.name == "dispatch":
            rows[ev.span] = {
                "span": ev.span,
                "index": ev.attrs.get("index"),
                "client": ev.attrs.get("client"),
                "version": ev.attrs.get("version"),
                "outcome": None,
                "staleness": None,
                "dur": None,
                "leases": [],
                "pushes": [],
                "workers": [],
            }
    for ev in events:
        if ev.ph != "i":
            continue
        span = f"d{ev.attrs.get('index')}"
        if span not in rows:
            continue
        if ev.name == "lease_grant":
            rows[span]["leases"].append(
                {
                    "worker": ev.attrs.get("worker"),
                    "regrant": bool(ev.attrs.get("regrant")),
                    "expired": bool(ev.attrs.get("expired")),
                }
            )
        elif ev.name == "push_recv":
            rows[span]["pushes"].append(
                {"worker": ev.attrs.get("worker"), "dup": bool(ev.attrs.get("dup"))}
            )
    for sp in closed:
        if sp["name"] == "assignment" and sp["parent"] in rows:
            rows[sp["parent"]]["workers"].append(f"{sp['proc']}:{sp['pid']}")
    return sorted(
        rows.values(), key=lambda r: (r["index"] if r["index"] is not None else -1)
    )


def fault_audit(events: Sequence[Event]) -> List[Dict[str, Any]]:
    """Every injected fault: who, what kind, when."""
    return [
        {"proc": ev.proc, "pid": ev.pid, "ts": ev.ts, **ev.attrs}
        for ev in events
        if ev.name == "fault" and ev.ph == "i"
    ]


def straggler_breakdown(events: Sequence[Event]) -> Dict[str, Any]:
    """Admitted-staleness histogram + dispatch-outcome counts + lease stats."""
    admits = [ev.attrs for ev in events if ev.name == "admit" and ev.ph == "i"]
    accepted = [a for a in admits if a.get("accepted")]
    table = dispatch_table(events)
    outcomes: Dict[str, int] = {}
    regrants = expiries = 0
    for row in table:
        key = row["outcome"] or "open"
        outcomes[key] = outcomes.get(key, 0) + 1
        regrants += sum(1 for l in row["leases"] if l["regrant"])
        expiries += sum(1 for l in row["leases"] if l["expired"])
    dups = sum(
        1 for ev in events
        if ev.name == "push_recv" and ev.ph == "i" and ev.attrs.get("dup")
    )
    out = staleness_stats([a.get("staleness", 0.0) for a in accepted])
    out.update(
        {
            "dispatches": len(table),
            "admitted": len(accepted),
            "rejected": len(admits) - len(accepted),
            "outcomes": outcomes,
            "lease_regrants": regrants,
            "lease_expiries": expiries,
            "dedup_drops": dups,
        }
    )
    return out


def corruption_coverage(events: Sequence[Event]) -> List[str]:
    """Audit that every *norm-visible* injected payload corruption (NaN/Inf —
    the kinds the delta screen must reject unconditionally) was actually
    defended against. A corruption at dispatch index ``i`` is accounted for
    when any of these holds:

    * a ``screen_reject`` instant exists for index ``i`` (the door caught it);
    * the dispatch closed with a non-``admitted`` outcome (quarantined sender,
      staleness rejection, the frame never arrived, still in flight at exit);
    * the dispatch saw duplicate pushes (redispatch raced a clean execution —
      first-result-wins may have admitted the clean twin, and the trace cannot
      tell which push carried the poison);
    * a ``rollback`` instant fires at or after the corruption (the divergence
      guard unwound whatever got through).

    A NaN/Inf corruption that was admitted with none of those excuses is a
    defense failure and fails ``--check``.
    """
    problems: List[str] = []
    screened = {
        ev.attrs.get("index")
        for ev in events
        if ev.name == "screen_reject" and ev.ph == "i"
    }
    rollbacks = [ev.ts for ev in events if ev.name == "rollback" and ev.ph == "i"]
    rows = {r["index"]: r for r in dispatch_table(events)}
    for ev in events:
        if ev.name != "fault" or ev.ph != "i":
            continue
        kind = str(ev.attrs.get("kind", ""))
        if not kind.startswith("corrupt_"):
            continue
        if kind[len("corrupt_"):] not in SCREENABLE_CORRUPTIONS:
            continue
        idx = ev.attrs.get("index")
        if idx in screened:
            continue
        row = rows.get(idx)
        if row is None or row["outcome"] != "admitted":
            continue
        if any(p["dup"] for p in row["pushes"]):
            continue
        if any(ts >= ev.ts for ts in rollbacks):
            continue
        problems.append(
            f"injected {kind} at dispatch index {idx} was ADMITTED with no "
            f"screen_reject, no quarantine, and no subsequent rollback"
        )
    return problems


def check_run(events: Sequence[Event], expect_faults: bool = False) -> List[str]:
    """Structural invariants of a merged timeline; returns human-readable
    problems (empty list == pass)."""
    problems: List[str] = []
    closed, opened = span_pairs(events)

    killed = {
        (ev.proc, ev.pid)
        for ev in events
        if ev.name == "fault" and ev.attrs.get("kind") == "kill"
    }
    for ev in opened:
        if (ev.proc, ev.pid) in killed:
            continue  # chaos-killed incarnation: half-open spans are the record
        problems.append(
            f"unclosed span {ev.span!r} ({ev.name}) in {ev.proc}:{ev.pid} "
            f"with no kill fault recorded for that incarnation"
        )

    dispatch_ids = {sp["span"] for sp in closed if sp["name"] == "dispatch"}
    dispatch_ids |= {ev.span for ev in opened if ev.name == "dispatch"}
    for sp in closed:
        if sp["name"] == "dispatch":
            outcome = sp["attrs"].get("outcome")
            if outcome not in TERMINAL_OUTCOMES:
                problems.append(
                    f"dispatch span {sp['span']!r} closed with non-terminal "
                    f"outcome {outcome!r}"
                )
    for sp in closed:
        if sp["name"] == "assignment" and sp["parent"] not in dispatch_ids:
            problems.append(
                f"orphan assignment span {sp['span']!r} in {sp['proc']}: "
                f"parent dispatch {sp['parent']!r} unknown to the server"
            )
    for ev in opened:
        if ev.name == "assignment" and ev.parent not in dispatch_ids:
            problems.append(
                f"orphan open assignment span {ev.span!r} in {ev.proc}: "
                f"parent dispatch {ev.parent!r} unknown to the server"
            )

    problems.extend(corruption_coverage(events))

    if expect_faults and not fault_audit(events):
        problems.append("expected injected faults but the audit is empty")
    return problems


def _fmt_table(rows: List[Dict[str, Any]], cols: List[str]) -> str:
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows)) for c in cols}
    head = "  ".join(c.ljust(widths[c]) for c in cols)
    lines = [head, "  ".join("-" * widths[c] for c in cols)]
    for r in rows:
        lines.append("  ".join(str(r.get(c, "")).ljust(widths[c]) for c in cols))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="Summarize and validate a federation run's trace JSONL.",
    )
    ap.add_argument("sources", nargs="+", help="trace dir or .jsonl files")
    ap.add_argument("--check", action="store_true",
                    help="validate timeline invariants; exit 1 on violation")
    ap.add_argument("--expect-faults", action="store_true",
                    help="with --check: fail if no injected faults are recorded")
    ap.add_argument("--chrome", metavar="OUT",
                    help="also write a Chrome/Perfetto trace JSON")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of tables")
    args = ap.parse_args(argv)

    source = args.sources[0] if len(args.sources) == 1 else args.sources
    events = load_run(source)

    rollups = round_rollups(events)
    table = dispatch_table(events)
    faults = fault_audit(events)
    breakdown = straggler_breakdown(events)

    if args.chrome:
        write_chrome_trace(events, args.chrome)

    if args.json:
        print(json.dumps(
            {"rounds": rollups, "dispatches": table, "faults": faults,
             "breakdown": breakdown},
            indent=2, default=str,
        ))
    else:
        print(f"== events: {len(events)} ==")
        if rollups:
            print("\n== round table ==")
            cols = [c for c in ("round", "buf_count", "n_admitted", "n_rejected",
                                "staleness_mean", "staleness_admitted_max",
                                "train_loss", "sim_time", "deadline")
                    if any(c in r for r in rollups)]
            print(_fmt_table(rollups, cols))
        if table:
            print("\n== dispatch lifecycle ==")
            view = [
                {
                    "span": r["span"],
                    "client": r["client"],
                    "version": r["version"],
                    "outcome": r["outcome"] or "open",
                    "leases": len(r["leases"]),
                    "regrants": sum(1 for l in r["leases"] if l["regrant"]),
                    "pushes": len(r["pushes"]),
                    "dups": sum(1 for p in r["pushes"] if p["dup"]),
                }
                for r in table
            ]
            print(_fmt_table(view, ["span", "client", "version", "outcome",
                                    "leases", "regrants", "pushes", "dups"]))
        print("\n== straggler / staleness breakdown ==")
        for k, v in breakdown.items():
            print(f"  {k}: {v}")
        print(f"\n== fault audit ({len(faults)} injected) ==")
        for f in faults:
            print(f"  {f.get('kind', '?'):6s} {f['proc']}:{f['pid']} "
                  f"role={f.get('role', '?')}")

    if args.check:
        problems = check_run(events, expect_faults=args.expect_faults)
        if problems:
            print("\nCHECK FAILED:", file=sys.stderr)
            for p in problems:
                print(f"  - {p}", file=sys.stderr)
            return 1
        print("\ncheck: OK (all spans accounted for, no orphan dispatches)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
