"""Prometheus-style text metrics endpoint for the federation server
(``repro.obs.metrics``' copy).

``MetricsServer`` wraps stdlib ``http.server`` (zero dependencies) around a
:class:`~repro_torch.obs.tracer.Tracer`'s live counters/gauges and serves them as
text exposition at ``/metrics``. The launcher starts it with
``--metrics-port`` (0 picks a free port, printed at startup).

Thread-safety contract: the HTTP handler runs on its own thread, so it may
only read the tracer's **plain-float** counter/gauge stores (mutated under the
tracer lock) and the ``extra()`` callback's plain-float dict. It must never
touch a tensor: a device read from that thread would wait on (and race) the
event loop's stream. Everything numeric is therefore converted to host floats
on the event-loop thread *before* it lands in a gauge.

Staleness histogram: admitted deltas' ages are bucketed with the same edges
``metrics/fedmetrics.staleness_stats`` uses for its CSV histogram
(0 / 1 / ≤3 / ≤7 / +Inf), rendered cumulatively as a Prometheus histogram.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from repro_torch.metrics.fedmetrics import _STALENESS_BUCKETS

from .tracer import Tracer

#: Cumulative upper edges of the admitted-staleness histogram, derived from
#: the fedmetrics bucket table so CSV rows and the endpoint tell one story.
STALENESS_EDGES = tuple(hi for _, hi in _STALENESS_BUCKETS if hi is not None)

METRIC_PREFIX = "fed_"


def observe_staleness(tracer: Tracer, staleness: float) -> None:
    """Record one admitted delta's age into the histogram counters."""
    if not tracer.enabled:
        return
    for edge in STALENESS_EDGES:
        if staleness <= edge:
            tracer.count(f"staleness_le_{edge}")
    tracer.count("staleness_le_inf")
    tracer.count("staleness_sum", float(staleness))


def render_metrics(
    tracer: Tracer,
    extra: Optional[Callable[[], Dict[str, float]]] = None,
    prefix: str = METRIC_PREFIX,
) -> str:
    """Render counters/gauges (+ extra gauges) as Prometheus text exposition."""
    snap = tracer.snapshot()
    lines = []

    hist = {k: v for k, v in snap["counters"].items() if k.startswith("staleness_le_")}
    plain = {k: v for k, v in snap["counters"].items()
             if not k.startswith(("staleness_le_", "staleness_sum"))}

    for name in sorted(plain):
        metric = f"{prefix}{name}_total"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {plain[name]:g}")

    if hist:
        metric = f"{prefix}staleness_admitted_rounds"
        lines.append(f"# TYPE {metric} histogram")
        for edge in STALENESS_EDGES:
            lines.append(
                f'{metric}_bucket{{le="{edge}"}} {hist.get(f"staleness_le_{edge}", 0.0):g}'
            )
        total = hist.get("staleness_le_inf", 0.0)
        lines.append(f'{metric}_bucket{{le="+Inf"}} {total:g}')
        lines.append(f"{metric}_sum {snap['counters'].get('staleness_sum', 0.0):g}")
        lines.append(f"{metric}_count {total:g}")

    gauges = dict(snap["gauges"])
    if extra is not None:
        try:
            gauges.update({k: float(v) for k, v in extra().items()})
        except Exception:
            pass  # a flaky extras provider must not take down the endpoint
    for name in sorted(gauges):
        metric = f"{prefix}{name}"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {gauges[name]:g}")

    return "\n".join(lines) + "\n"


class MetricsServer:
    """Background HTTP server exposing ``/metrics`` for one tracer."""

    def __init__(
        self,
        tracer: Tracer,
        host: str = "127.0.0.1",
        port: int = 0,
        extra: Optional[Callable[[], Dict[str, float]]] = None,
    ):
        self.tracer = tracer
        self.extra = extra
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self.path.rstrip("/") not in ("", "/metrics".rstrip("/"), "/metrics"):
                    self.send_error(404)
                    return
                body = render_metrics(outer.tracer, outer.extra).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr noise
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)
