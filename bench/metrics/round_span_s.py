"""Median length of the program's own ``round`` span (``obs`` Tracer, on in
the traced run only) over the timed window's rounds, in seconds."""
import statistics


def read(trace):
    spans = [s["dur"] for s in trace["spans"] if s["name"] == "round"]
    return statistics.median(spans) if spans else None
