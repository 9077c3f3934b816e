"""The phase spans inside a traced synchronous round (``repro_torch.obs.phases``)
and the benchmark's readers of them, on the CPU with the quadratic model.

- The tree: ids, parents and counts of a round at C = 3, τ = 2, with the
  float32 uplink through the per-leaf server phase and with the int8 codec
  through the fused one; the round's rollup keys (no device times on the CPU).
- Under ``torch.profiler`` every aten op of the round runs inside exactly one
  leaf's ``fed::`` range.
- A sync warning raised inside a span is counted on that span; other warnings
  pass through.
- Untraced, tiled and async rounds emit no phase span.
- The JSONL trace loads, checks and exports to Chrome with the phase spans;
  the tracer's ring holds eight photon-shaped rounds whole.
- Each reader of ``bench/metrics`` reads hand-made round spans and is silent
  where its keys are missing.
"""
import importlib.util
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one torch thread)

import repro_torch.core as T  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
from repro_torch.core import federated as F  # noqa: E402
from repro_torch.obs import phases as PH  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

LEAVES = {"prologue", "buffers", "init", "fwd_bwd", "opt", "delta", "encode", "step_metrics",
          "decode", "apply", "epilogue", "readout"}


def _quad(params, batch):
    loss = torch.mean(torch.square(batch["x"] @ params["w"] + params["b"][0] - batch["y"]))
    return loss, {"loss": loss}


def _params():
    rng = np.random.default_rng(0)
    return tree_map(torch.from_numpy, {
        "w": rng.standard_normal((4, 4)).astype(np.float32),
        "b": [(rng.standard_normal(4) * 0.1).astype(np.float32)]})


def _batches(tau, c, seed=1):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal((tau, c, 8, 4)).astype(np.float32))
            for k in ("x", "y")}


def _agg(tracer, C=3, tau=2, codec=None, **kw):
    fed = T.FederatedConfig(clients_per_round=C, local_steps=tau)
    pcfg = T.ParticipationConfig(population=2 * C, clients_per_round=C)
    c = T.get_codec(codec, 0.25, fused=True) if codec else None
    return T.SyncAggregator(_quad, fed, pcfg, seed=2, tracer=tracer, codec=c,
                            fused_server=codec is not None, params=_params(), **kw)


def _rounds(agg, n, tau=2, C=3):
    for r in range(n):
        agg.run_round(_batches(tau, C, seed=r), agg.plan(r))


def _expected_tree(C, tau, codec):
    """(name, id, parent) of every phase span of round 0."""
    out = [("prologue", "r0/prologue", "r0"), ("clients", "r0/clients", "r0"),
           ("buffers", "r0/buffers", "r0/clients")]
    for c in range(C):
        cid = f"r0/c{c}"
        out += [("client", cid, "r0/clients"), ("init", f"{cid}/init", cid)]
        for t in range(tau):
            sid = f"{cid}/s{t}"
            out += [("step", sid, cid), ("fwd_bwd", f"{sid}/fb", sid),
                    ("opt", f"{sid}/opt", sid)]
        out.append(("delta", f"{cid}/delta", cid))
    if codec:
        out.append(("encode", "r0/encode", "r0/clients"))
    out += [("step_metrics", "r0/step_metrics", "r0/clients"), ("server", "r0/server", "r0")]
    if codec:
        out.append(("decode", "r0/decode", "r0/server"))
    out += [("apply", "r0/apply", "r0/server"), ("epilogue", "r0/epilogue", "r0"),
            ("readout", "r0/readout", "r0")]
    return out


@pytest.mark.parametrize("codec", [None, "int8"], ids=["float32", "int8"])
def test_a_traced_sync_round_has_the_phase_tree_and_its_rollup(codec):
    C, tau = 3, 2
    tracer = TO.Tracer(proc="server")
    _rounds(_agg(tracer, C, tau, codec), 1, tau, C)
    closed, opened = TO.span_pairs(list(tracer.ring))
    assert not opened
    phases = [(s["name"], s["span"], s["parent"]) for s in closed if s["name"] != "round"]
    assert sorted(phases) == sorted(_expected_tree(C, tau, codec))
    (rnd,) = [s for s in closed if s["name"] == "round"]
    a = rnd["attrs"]
    assert a["fwd_bwd_n"] == a["opt_n"] == a["step_n"] == C * tau
    assert a["client_n"] == a["init_n"] == a["delta_n"] == C
    names = {n for n, _, _ in phases}
    rollup = {f"{n}_{k}" for n in names for k in ("s", "n")} | {"host_syncs"}
    counters = {f"{n}_n" for n in PH.COUNTERS}
    assert set(a) == rollup | counters | {"round", "effective_k", "track",
                                          *F.TRACE_METRIC_KEYS} - {"model_norm"}
    assert a["host_syncs"] == 0 and not any(k.endswith("dev_s") for k in a)
    assert all(a[k] == 0 for k in counters)  # the quadratic model has no attention
    for s in closed:
        if s["name"] != "round":
            assert s["attrs"] == {"syncs": 0}, s
            assert a[f"{s['name']}_s"] >= s["dur"] >= 0.0
    # a parent closes after its children and covers them on the host clock
    ends = {s["span"]: s["ts"] + s["dur"] for s in closed}
    for s in closed:
        if s["parent"]:
            assert s["ts"] >= next(p["ts"] for p in closed if p["span"] == s["parent"])
            assert ends[s["span"]] <= ends[s["parent"]] + 1e-6


def test_a_traced_round_counts_each_attention_call_at_its_route():
    """Reduced photon-75m on the CPU: every attention call of the round (2
    layers, C = 2 clients, τ = 2 steps, one micro-batch each) takes the plain
    core, and none the kernel; a round outside a trace counts nothing."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import attention as A, build_model

    cfg = dataclasses.replace(get_config("photon-75m").reduced(), compute_dtype="float32")
    model = build_model(cfg)
    C, tau = 2, 2
    tracer = TO.Tracer(proc="server")
    fed = T.FederatedConfig(clients_per_round=C, local_steps=tau)
    pcfg = T.ParticipationConfig(population=2 * C, clients_per_round=C)
    agg = T.SyncAggregator(model.loss, fed, pcfg, seed=2, tracer=tracer,
                           params=model.init(0, device="cpu"))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (tau, C, 2, 16))
    agg.run_round({"tokens": torch.from_numpy(tokens.astype(np.int32))}, agg.plan(0))
    closed, _ = TO.span_pairs(list(tracer.ring))
    (rnd,) = [s for s in closed if s["name"] == "round"]
    assert rnd["attrs"]["attn_plain_n"] == cfg.n_layers * C * tau
    assert rnd["attrs"]["attn_kernel_n"] == 0
    A.count_plain_call()  # no traced round is open: a no-op


def test_every_aten_op_of_a_profiled_round_runs_in_exactly_one_leaf():
    from torch.profiler import ProfilerActivity, profile

    for codec in (None, "int8"):
        agg = _agg(TO.Tracer(proc="server"), codec=codec)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _rounds(agg, 1)
        events = list(prof.events())
        fed = [e for e in events if e.name.startswith("fed::")]
        (rnd,) = [e for e in fed if e.name == "fed::round"]

        def inside(e, r):
            return r.time_range.start <= e.time_range.start and \
                e.time_range.end <= r.time_range.end

        leaves = [r for r in fed if not any(o is not r and inside(o, r) for o in fed)]
        assert {r.name[len("fed::"):] for r in leaves} == LEAVES - (
            set() if codec else {"encode", "decode"})
        ops = [e for e in events if e.name.startswith("aten::") and inside(e, rnd)]
        assert len(ops) > 100
        for op in ops:
            assert sum(inside(op, r) for r in leaves) == 1, op.name
        # every phase span but clients, the 3 clients' and 6 steps' spans and server
        assert len(leaves) == len(_expected_tree(3, 2, codec)) - 11


def test_a_sync_inside_a_span_counts_there_and_other_warnings_pass(monkeypatch):
    real = F.inner_update

    def syncing_update(*args, **kw):
        warnings.warn(PH.SYNC_WARNING + " (Triggered internally at CUDAFunctions.cpp)")
        return real(*args, **kw)

    def noisy_metrics(metrics, keys=F.TRACE_METRIC_KEYS):
        warnings.warn("not a sync", UserWarning)
        return real_attrs(metrics, keys)

    real_attrs = F.trace_attrs
    monkeypatch.setattr(F, "inner_update", syncing_update)
    monkeypatch.setattr("repro_torch.core.aggregator.trace_attrs", noisy_metrics)
    tracer = TO.Tracer(proc="server")
    with pytest.warns(UserWarning, match="not a sync") as caught:
        _rounds(_agg(tracer), 1)
    assert not any(PH.SYNC_WARNING in str(w.message) for w in caught)
    closed, _ = TO.span_pairs(list(tracer.ring))
    syncs = {s["span"]: s["attrs"].get("syncs") for s in closed}
    assert all(syncs[f"r0/c{c}/s{t}/opt"] == 1 for c in range(3) for t in range(2))
    assert syncs["r0/readout"] == syncs["r0/c0/s0/fb"] == syncs["r0/c0/s0"] == 0
    (rnd,) = [s for s in closed if s["name"] == "round"]
    assert rnd["attrs"]["host_syncs"] == 6


def test_untraced_tiled_and_async_rounds_emit_no_phase_span(tmp_path):
    assert PH.phase("fwd_bwd") is PH.phase("opt", 3)  # the shared no-op: nothing open
    agg = _agg(None)
    _rounds(agg, 1)
    assert PH._ROUND.get() is None
    tracer = TO.Tracer(proc="server")
    _rounds(_agg(tracer, cohort_tile=2), 2)
    closed, opened = TO.span_pairs(list(tracer.ring))
    assert [s["span"] for s in closed] == ["r0", "r1"] and not opened
    assert set(closed[0]["attrs"]) == {"round", "effective_k", "track",
                                       *F.TRACE_METRIC_KEYS} - {"model_norm"}
    acfg = T.AsyncAggConfig(buffer_size=2, staleness_alpha=0.5)
    fed = T.FederatedConfig(clients_per_round=2, local_steps=2)
    pcfg = T.ParticipationConfig(population=4, clients_per_round=2)
    tracer = TO.Tracer(proc="server")
    drv = T.AsyncFederationDriver(_quad, fed, acfg, pcfg, lambda c: _batches(2, 1, c),
                                  seed=3, tracer=tracer, params=_params(), rng=T.prng_key(0))
    drv.run_updates(2)
    names = {e.name for e in tracer.ring}
    assert not names & (LEAVES | {"clients", "client", "step", "server"})


def test_the_trace_checks_and_exports_the_phase_spans(tmp_path):
    path = tmp_path / "sync.jsonl"
    tracer = TO.Tracer(TO.JsonlSink(str(path)), proc="server", trace_id="t")
    _rounds(_agg(tracer, codec="int8"), 2)
    tracer.close()
    events = TO.load_run(str(path))
    assert TO.check_run(events) == []
    closed, opened = TO.span_pairs(events)
    assert not opened and len(closed) == 2 * len(_expected_tree(3, 2, "int8")) + 2
    slices = [e for e in TO.chrome_trace(events)["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in slices} == LEAVES | {"round", "clients", "client", "step",
                                                    "server"}
    fb = [e for e in slices if e["args"]["span"] == "r1/c2/s1/fb"]
    assert len(fb) == 1 and fb[0]["args"]["syncs"] == 0 and fb[0]["dur"] > 0
    # the loaded timeline is in time order: every span's B precedes its children's
    order = [e.span for e in events if e.ph == "B"]
    assert order.index("r1/c0") < order.index("r1/c0/s0") < order.index("r1/c0/s0/fb")


def test_the_ring_holds_every_event_of_eight_photon_shaped_rounds():
    """Photon's cell: C = 2, τ = 4, float32 uplink through the fused server
    phase. 39 spans, 78 events a round: eight rounds and the benchmark's
    probe and profiled rounds stay far inside the 4,096-event ring."""
    tracer = TO.Tracer(proc="server")
    fed = T.FederatedConfig(clients_per_round=2, local_steps=4)
    pcfg = T.ParticipationConfig(population=8, clients_per_round=2)
    agg = T.SyncAggregator(_quad, fed, pcfg, seed=2, tracer=tracer, fused_server=True,
                           params=_params())
    _rounds(agg, 8, tau=4, C=2)
    assert len(tracer.ring) == 8 * 78 < tracer.ring.maxlen
    closed, opened = TO.span_pairs(list(tracer.ring))
    rounds = [s for s in closed if s["name"] == "round"]
    assert not opened and [s["span"] for s in rounds] == [f"r{r}" for r in range(8)]
    assert all(s["attrs"]["fwd_bwd_n"] == 8 and s["attrs"]["client_n"] == 2 for s in rounds)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name, ROOT / "bench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _round_span(**attrs):
    return {"name": "round", "span": "r2", "dur": 5.0, "attrs": dict(round=2, **attrs)}


@pytest.mark.parametrize("name,attrs,want", [
    ("fwd_bwd_ms", [dict(fwd_bwd_dev_s=8.0, fwd_bwd_n=8), dict(fwd_bwd_dev_s=10.4, fwd_bwd_n=8),
                    dict(fwd_bwd_dev_s=9.6, fwd_bwd_n=8)], 1200.0),
    ("inner_opt_ms", [dict(opt_dev_s=0.28, opt_n=4), dict(opt_dev_s=0.32, opt_n=4)], 75.0),
    ("server_phase_ms", [dict(server_dev_s=0.03), dict(server_dev_s=0.02),
                         dict(server_dev_s=0.025)], 25.0),
    ("uplink_codec_ms", [dict(encode_dev_s=0.006, decode_dev_s=0.007)], 13.0),
    ("host_syncs_per_round", [dict(host_syncs=31), dict(host_syncs=31),
                              dict(host_syncs=40)], 31.0),
])
def test_each_span_reader_takes_the_median_and_is_silent_without_its_keys(name, attrs, want):
    read = _reader(name)
    spans = [_round_span(**a) for a in attrs] + [{"name": "other", "dur": 1.0, "attrs": attrs[0]}]
    trace = {"spans": spans, "kernels": [], "busy_s": 1.0, "window_s": 1.0}
    assert read(trace) == pytest.approx(want)
    # a parent without phase spans: round spans with the traced attrs alone
    bare = {"spans": [_round_span(train_loss=3.0), {"name": "round", "dur": 4.0}]}
    assert read(bare) is None and read({"spans": []}) is None
    if name == "uplink_codec_ms":  # the float32 uplink: encode-free, decode-free
        assert read({"spans": [_round_span(server_dev_s=0.02, encode_dev_s=0.001)]}) is None
