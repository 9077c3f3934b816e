"""Federation telemetry: structured events, tracing, export, metrics
(``repro.obs``'s copy). The subsystem is zero-dependency (stdlib only)
and strictly read-only with respect to the aggregation math: enabling tracing
leaves every result bitwise unchanged (tested in ``tests/test_torch_obs.py``).
"""
from .events import (
    EVENT_SCHEMA_VERSION,
    Event,
    JsonlSink,
    decode_event,
    encode_event,
    load_run,
    make_event,
    read_events,
    span_pairs,
)
from .export import chrome_trace, round_rollups, write_chrome_trace
from .metrics import MetricsServer, observe_staleness, render_metrics
from .report import check_run, dispatch_table, fault_audit, straggler_breakdown
from .tracer import NULL_TRACER, Tracer, get_tracer

__all__ = [
    "EVENT_SCHEMA_VERSION",
    "Event",
    "JsonlSink",
    "MetricsServer",
    "NULL_TRACER",
    "Tracer",
    "check_run",
    "chrome_trace",
    "dispatch_table",
    "fault_audit",
    "straggler_breakdown",
    "decode_event",
    "encode_event",
    "get_tracer",
    "load_run",
    "make_event",
    "observe_staleness",
    "read_events",
    "render_metrics",
    "round_rollups",
    "span_pairs",
    "write_chrome_trace",
]
