"""The whole round's share of the chip's bf16 peak: its model FLOPs
(``reference/flops.py``) over the median length of the program's own
``round`` span over the window's rounds (as ``round_span_s``, which no
profiler stretches), over 989 TFLOP/s."""
import statistics

from reference.peaks import BF16_FLOPS


def read(trace):
    spans = [s["dur"] for s in trace["spans"] if s["name"] == "round"]
    if not spans or statistics.median(spans) <= 0:
        return None
    return 100.0 * trace["model_flops"] / statistics.median(spans) / BF16_FLOPS
