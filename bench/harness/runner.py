"""One run of one cell: set-up, the timed window, the traced rounds, and the
comparison with the plain reference.

Set-up builds one aggregator from the seed's weights and drives it through
the cell's first ``probe_rounds`` rounds, through the window's own call and
feed; those rounds also warm up every shape the window uses. What the
comparison needs is read from them before the window moves the weights on:
each round's loss and last-step gradient norm, the first round's
pseudo-gradient (from the outer optimiser's state; kept whole in host memory
where the cell compares ``pg_dist``) and the change in the weights after the
last of them. The window then continues the same
aggregator. Once it has closed and the program's state is freed, the plain
reference follows the same rounds from the same weights and tokens.
"""
from __future__ import annotations

import gc
import math
import sys
import time
import traceback
from typing import Dict, List

import torch

from harness import judge, trace as tracing
from harness.program import Program
from harness.spec import Cell, metric_reader
from harness.traffic import Traffic
from reference import bytes as ybytes, federated, flops, layout
from reference.federated import leaf_norm
from reference.model import mm_fp32
from reference.peaks import BF16_FLOPS

#: top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def probe(cell: Cell, prog: Program, gen: Traffic, seed: int, device, feed=None):
    """The set-up's rounds: ``(readings, tokens of each round)``. ``feed``
    maps a round's tokens to the batch the program gets (the fault checks
    plant a broken feed here)."""
    cfg = cell.config
    theta0 = lambda n: layout.make_leaf(cfg, seed, n, device)  # noqa: E731
    out: Dict[str, object] = {"loss": [], "client_grad_norm": []}
    rounds = []
    for r in range(cell.workload["probe_rounds"]):
        tokens = gen.round_tokens(r)
        rounds.append(tokens)
        m = prog.round(r, feed(tokens) if feed else {"tokens": tokens})
        out["loss"].append(float(m["train_loss_mean"]))
        out["client_grad_norm"].append(float(m["client_grad_norm"]))
        if r == 0:
            pg = {n: prog.pseudo_grad_leaf(n, theta0(n)) for n, *_ in layout.leaves(cfg)}
            out["pg_norms"] = {n: leaf_norm(x) for n, x in pg.items()}
            if "pg_dist" in cell.workload["limits"]:
                out["pg"] = {n: x.cpu() for n, x in pg.items()}
            del pg
    out["change_norms"] = {n: leaf_norm(prog.leaf(n) - theta0(n)) for n, *_ in layout.leaves(cfg)}
    return out, rounds


def follow(cell: Cell, seed: int, rounds, device, mm=mm_fp32) -> dict:
    """The plain reference over the probe rounds, from the seed's weights."""
    cfg = cell.config
    theta = layout.make_params(cfg, seed, device)
    return federated.run(cfg, cell.traffic, theta, rounds,
                         lambda n: layout.make_leaf(cfg, seed, n, device), mm=mm,
                         keep_pg="pg_dist" in cell.workload["limits"])


def _release():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def end_to_end(cell: Cell, window: dict) -> Dict[str, float]:
    """The end-to-end metrics of the window, by name."""
    s = cell.traffic["seq_len"]
    tokens = window["rounds"] * window["tokens_per_round"]
    values = {
        "train_tokens_per_s": tokens / window["wall_s"],
        "mfu": 100.0 * flops.train_flops(cell.config, tokens, s) / window["wall_s"] / BF16_FLOPS,
        "peak_mem_gb": window["peak_bytes"] / 1e9,
        "setup_s": window["setup_s"],
    }
    return {m["name"]: values[m["name"]] for m in cell.metrics(trace=False)}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        log=print, feed=None) -> dict:
    """The result line of one run (``feed`` as in :func:`probe`)."""
    from repro_torch.obs.tracer import Tracer

    cfg, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    tracer = Tracer(proc="bench", trace_id=f"{cell.name}-{seed}") if trace else None
    params = layout.make_params(cfg, seed, device)
    prog = Program(cfg, traffic, cell.workload, params, seed, tracer=tracer)
    del params
    gen = Traffic(traffic, cfg["vocab_size"], seed, device)
    readings, rounds = probe(cell, prog, gen, seed, device, feed)
    attempted = len(rounds)
    failed = sum(1 for x in readings["loss"] if not math.isfinite(x))

    # the window: whole rounds back to back until one ends past ``seconds``
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    r, done, m = len(rounds), 0, None
    times = []
    while True:
        attempted += 1
        try:
            batch = {"tokens": gen.round_tokens(r)}
            m = prog.round(r, feed(batch["tokens"]) if feed else batch)
            loss = float(m["train_loss"])
            if cuda:
                torch.cuda.synchronize()
        except Exception:  # a round that raises is a failed round; the run goes on to report
            log(traceback.format_exc())
            failed += 1
            break
        if not math.isfinite(loss):
            failed += 1
        times.append(time.perf_counter() - t0 - sum(times))
        r += 1
        done += 1
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    window = {"rounds": done, "wall_s": wall, "setup_s": setup_s,
              "tokens_per_round": gen.tokens_per_round(),
              "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    retries = torch.cuda.memory_stats().get("num_alloc_retries") if cuda else None
    log(f"window: {done} rounds in {wall:.3f} s after {setup_s:.3f} s of set-up; "
        f"peak {window['peak_bytes'] / 1e9:.3f} GB; allocator retries {retries}; "
        f"rounds (s): {[round(t, 3) for t in times]}")

    result: dict = {"correct": False, "attempted": attempted, "failed": failed}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(window["peak_bytes"])}
    if trace:
        metrics = _traced(cell, prog, gen, r, tracer, device_info, result)
    else:
        metrics = {k: {"value": v, "unit": _unit(cell, k)}
                   for k, v in end_to_end(cell, window).items() if done}
    result["metrics"] = metrics
    result["device"] = device_info

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules loaded that the benchmark may not load: {bad}")
    prog = m = None
    _release()

    t_ref = time.perf_counter()
    ref = follow(cell, seed, rounds, device)
    log(f"reference: {len(rounds)} rounds in {time.perf_counter() - t_ref:.1f} s")
    nums = judge.numbers(readings, ref)
    ok, rows = judge.judge(nums, cell.workload["limits"])
    for k, (v, where) in sorted(nums.items()):
        log(f"reading {k} = {v!r} ({where})")
    result["correct"] = bool(ok and failed == 0 and done > 0)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result


def _unit(cell: Cell, name: str) -> str:
    return next(m["unit"] for m in cell.end_to_end + cell.per_layer if m["name"] == name)


def _traced(cell: Cell, prog: Program, gen: Traffic, r: int, tracer, device_info,
            result) -> Dict[str, dict]:
    """Two more rounds under the profiler; the per-layer metrics of this cell."""
    from repro_torch.obs.events import span_pairs

    traffic = cell.traffic
    first_timed = cell.workload["probe_rounds"]
    spans = [s for s in span_pairs(tracer.ring)[0]
             if s["name"] == "round" and s["attrs"].get("round", -1) >= first_timed]

    def one_round():
        nonlocal r
        with torch.profiler.record_function("bench::round_tokens"):
            tokens = gen.round_tokens(r)
        with torch.profiler.record_function("bench::run_round"):
            float(prog.round(r, {"tokens": tokens})["train_loss"])
        r += 1

    # one round with the device's activity alone: its window is the round's;
    # one more with the host's ops too, for the breakdown by host op
    tr = tracing.profile(one_round, host_ops=False)
    tr["breakdown"] = tracing.profile(one_round, host_ops=True)["breakdown"]
    result["attempted"] += 2
    tr.update(
        spans=spans,
        local_steps=traffic["clients_per_round"] * traffic["local_steps"],
        model_flops=flops.train_flops(cell.config, gen.tokens_per_round(), traffic["seq_len"]),
        np=ybytes.model_flat_len(cell.config),
        clients=traffic["clients_per_round"],
        outer=traffic["outer"]["name"],
    )
    device_info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    result["breakdown"] = tr["breakdown"]
    out = {}
    for m in cell.metrics(trace=True):
        v = metric_reader(m["name"])(tr)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
