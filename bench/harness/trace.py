"""The traced run's readings: one round under ``torch.profiler``, read from the
raw profiler events (``key_averages()`` takes minutes over a round's
~10⁵ ops; the raw events take seconds).

:func:`profile` returns what the per-layer readers (``metrics/<name>.py``)
read, and the ``breakdown`` of the result line: the device operations that
took most time, and the longest idle gaps of the device by the host op that
was running at the time.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def reduce_events(events, window_s: float) -> dict:
    """Device intervals, the busy union, device time by host op, and idle
    gaps by host op, from the profiler's raw events."""
    from torch.autograd import DeviceType

    kernels, cpu = [], []
    for e in events:
        # a user annotation is a ``record_function`` range mirrored onto the
        # device's timeline, with no device work of its own
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            start = e.start_ns()
            kernels.append((e.name(), start, start + e.duration_ns(), e.linked_correlation_id()))
        elif (e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0
              and not e.is_async() and e.name() != "[memory]"):
            cpu.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
    op_of = {corr: name for _, _, name, corr in cpu if corr}
    by_op: Dict[str, float] = defaultdict(float)
    for name, a, b, corr in kernels:
        by_op[op_of.get(corr, name)] += (b - a) / 1e9
    busy = _union([(a, b) for _, a, b, _ in kernels])
    busy_s = sum(b - a for a, b in busy) / 1e9
    # each gap goes to the innermost host op open at its midpoint: a sweep
    # with a heap of the open ops, latest start on top
    gaps: Dict[str, float] = defaultdict(float)
    cpu.sort()
    open_ops: list = []
    i = 0
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        mid = (end + nxt) // 2
        while i < len(cpu) and cpu[i][0] <= mid:
            heapq.heappush(open_ops, (-cpu[i][0], cpu[i][1], cpu[i][2]))
            i += 1
        while open_ops and open_ops[0][1] < mid:
            heapq.heappop(open_ops)
        gaps[open_ops[0][2] if open_ops else "host (no profiled op)"] += (nxt - end) / 1e9
    return {
        "kernels": [(name, (b - a) / 1e9) for name, a, b, _ in kernels],
        "busy_s": busy_s,
        "window_s": window_s,
        "breakdown": {"device_ops": _top(by_op), "idle_gaps": _top(gaps)},
    }


def profile(step: Callable[[], None], host_ops: bool) -> dict:
    """Run ``step`` (which ends in a device synchronisation) under the
    profiler: the device's activity alone, or with every host op as well
    (which slows the host several-fold, so its window is not the round's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return reduce_events(prof.profiler.kineto_results.events(), window_s)
