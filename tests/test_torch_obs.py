"""The port's telemetry (``repro_torch.obs``) against the reference's, on the CPU.

- Events: the same event through either package's sink writes the same JSONL
  bytes; each package loads the other's files; torn tails and interior
  corruption as the reference.
- The same traced run in both packages (async on the quadratic model with the
  float32 and the int8 uplink; async with the delta screen and a NaN
  attacker, for ``screen_reject``; two sync rounds) gives the same event
  sequence: names, phases, span ids, parents and every attr apart from the
  clocks and pids (host floats of the loss and norms to rel 1e-5).
- ``check_run``, ``round_rollups`` and ``dispatch_table`` of each package
  read either package's trace equal; the Prometheus text is identical for
  the same counters; the report CLI runs.
- Tracing is read-only: a traced run is bitwise the untraced one.
- Both CLIs' traced async ``--rollback`` runs from a shared checkpoint emit
  the ``rollback`` instant at the same update.
"""
import dataclasses
import json
import math
import shutil
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one torch thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.obs as JO  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.obs as TO  # noqa: E402
from repro.launch import train as jt  # noqa: E402
from repro_torch.launch import train as tt  # noqa: E402
from repro_torch.obs import report as TR  # noqa: E402
from repro_torch.tree import params_to_numpy, tree_map  # noqa: E402

# ---------------------------------------------------------------------------
# events and sinks
# ---------------------------------------------------------------------------


def _events(mod):
    return [
        mod.Event("round", "B", 1.5, 0.25, "server", 11, "t", "u0", None, {"round": 0}),
        mod.Event("dispatch", "B", 1.6, 0.3, "server", 11, "t", "d0", "u0",
                  {"index": 0, "client": 3, "completes": True, "track": 4}),
        mod.Event("admit", "i", 1.7, 0.4, "server", 11, "t", "", "d0",
                  {"accepted": True, "staleness": 0.0, "w": 0.1 + 0.2}),
        mod.Event("end", "E", 1.8, 0.45, "server", 11, "t", "d0", "u0",
                  {"outcome": "admitted", "staleness": 0.0}),
        mod.Event("counters", "C", 1.9, 0.5, "server", 11, "t", "", None,
                  {"counters": {"admits": 1.0}, "gauges": {}}),
    ]


def test_both_sinks_write_the_same_jsonl_and_read_each_other(tmp_path):
    for mod, name in ((JO, "j.jsonl"), (TO, "t.jsonl")):
        sink = mod.JsonlSink(str(tmp_path / name))
        for ev in _events(mod):
            sink.emit(ev)
        sink.close()
    raw = (tmp_path / "t.jsonl").read_bytes()
    assert raw == (tmp_path / "j.jsonl").read_bytes()
    for reader in (JO.read_events, TO.read_events):
        for name in ("j.jsonl", "t.jsonl"):
            got = [TO.encode_event(e) if isinstance(e, TO.Event) else JO.encode_event(e)
                   for e in reader(str(tmp_path / name))]
            assert got == [TO.encode_event(e) for e in _events(TO)]
    # a torn trailing line is dropped, a torn interior line raises
    with open(tmp_path / "t.jsonl", "ab") as f:
        f.write(b'{"v": 1, "name": "to')
    assert len(TO.read_events(str(tmp_path / "t.jsonl"))) == 5
    (tmp_path / "bad.jsonl").write_bytes(raw.replace(b'"admit"', b'"adm', 1))
    with pytest.raises(ValueError, match="corrupt event line"):
        TO.read_events(str(tmp_path / "bad.jsonl"))
    with pytest.raises(ValueError, match="schema version"):
        TO.decode_event(dict(TO.encode_event(_events(TO)[0]), v=99))


def test_tracer_spans_counters_and_the_null_tracer():
    t = TO.Tracer(proc="server", trace_id="t")
    with t.span("flush", span_id="f0", parent="u0", round=1):
        t.point("admit", parent="d0", accepted=True)
    t.count("admits")
    t.count("admits", 2.0)
    t.gauge("round", 3)
    assert t.snapshot() == {"counters": {"admits": 3.0}, "gauges": {"round": 3.0}}
    closed, opened = TO.span_pairs(list(t.ring))
    assert [c["span"] for c in closed] == ["f0"] and not opened
    assert closed[0]["parent"] == "u0" and closed[0]["attrs"] == {"round": 1}
    n = TO.NULL_TRACER
    assert n.begin("x", span_id="s") == "s" and not n.enabled
    n.count("x")
    n.point("x")
    assert n.snapshot() == {"counters": {}, "gauges": {}} and len(n.ring) == 0
    assert TO.get_tracer(None) is TO.NULL_TRACER


def test_prometheus_text_is_the_references_and_is_served(tmp_path):
    tracers = (JO.Tracer(proc="s"), TO.Tracer(proc="s"))
    for mod, t in zip((JO, TO), tracers):
        for name in ("pulls", "pushes", "pulls", "admits"):
            t.count(name)
        t.count("bytes_tx", 123456789.0)
        for s in (0.0, 1.0, 2.0, 5.0, 9.0, 1.0):
            mod.observe_staleness(t, s)
        t.gauge("round", 7)
        t.gauge("train_loss", 0.1 + 0.2)
    extra = lambda: {"workers_alive": 2.0, "control_buffer_size": 4.0}  # noqa: E731
    text = TO.render_metrics(tracers[1], extra)
    assert text == JO.render_metrics(tracers[0], extra)
    assert 'fed_staleness_admitted_rounds_bucket{le="3"} 4' in text
    srv = TO.MetricsServer(tracers[1], port=0, extra=extra)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            assert r.read().decode() == text
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the same traced run in both packages (the quadratic model)
# ---------------------------------------------------------------------------

TAU = 3


def _quad_j(params, batch):
    loss = jnp.mean(jnp.square(batch["x"] @ params["w"] + params["b"][0] - batch["y"]))
    return loss, {"loss": loss}


def _quad_t(params, batch):
    loss = torch.mean(torch.square(batch["x"] @ params["w"] + params["b"][0] - batch["y"]))
    return loss, {"loss": loss}


def _np_params():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((4, 4)).astype(np.float32),
            "b": [(rng.standard_normal(4) * 0.1).astype(np.float32)]}


def _np_batches(cid, c=1):
    rng = np.random.default_rng(100 + cid)
    return {k: rng.standard_normal((TAU, c, 8, 4)).astype(np.float32) for k in ("x", "y")}


def _async_driver(mod, tracer, codec=None, robust=None, byzantine=0.0):
    sgd = mod.InnerOptConfig(name="sgd", lr_max=0.05, weight_decay=0.0, grad_clip=1e9,
                             warmup_steps=0, total_steps=10_000, alpha=1.0)
    fed = mod.FederatedConfig(clients_per_round=2, local_steps=TAU, inner=sgd,
                              outer=mod.OuterOptConfig(name="fedavg", lr=1.0))
    acfg = mod.AsyncAggConfig(buffer_size=2, staleness_alpha=0.5)
    pcfg = mod.ParticipationConfig(population=6, clients_per_round=2, dropout_rate=0.1,
                                   straggler=mod.STRAGGLER_PROFILES["heavy"])
    if mod is J:
        kw = dict(params=jax.tree_util.tree_map(jnp.asarray, _np_params()),
                  rng=jax.random.PRNGKey(0))
        mb = lambda c: jax.tree_util.tree_map(jnp.asarray, _np_batches(c))  # noqa: E731
        loss = _quad_j
    else:
        kw = dict(params=tree_map(torch.from_numpy, _np_params()), rng=T.prng_key(0))
        mb = lambda c: tree_map(torch.from_numpy, _np_batches(c))  # noqa: E731
        loss = _quad_t
    drv = mod.AsyncFederationDriver(loss, fed, acfg, pcfg, mb, seed=3, codec=codec,
                                    robust=robust, tracer=tracer, **kw)
    drv.corrupt_fn = mod.make_byzantine_fn(byzantine, "nan", 6)
    return drv


def _same_attrs(a, b, where):
    assert sorted(a) == sorted(b), (where, a, b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            _same_attrs(x, y, where)
        elif isinstance(x, float) and not float(x).is_integer():
            assert math.isclose(x, y, rel_tol=1e-5, abs_tol=1e-7), (where, k, x, y)
        else:
            assert x == y and type(x) is type(y), (where, k, x, y)


def _assert_same_sequence(jev, tev):
    assert [(e.name, e.ph) for e in tev] == [(e.name, e.ph) for e in jev]
    for j, t in zip(jev, tev):
        where = (j.name, j.span)
        assert (t.proc, t.trace, t.span, t.parent) == (j.proc, j.trace, j.span, j.parent), where
        _same_attrs(j.attrs, t.attrs, where)


def _traced_pair(tmp_path, build, n):
    files = {}
    for mod, omod, name in ((J, JO, "j"), (T, TO, "t")):
        path = str(tmp_path / f"{name}.jsonl")
        tracer = omod.Tracer(omod.JsonlSink(path), proc="server", trace_id="t")
        build(mod, tracer, n)
        tracer.close()
        files[name] = path
    return files


def _run_async(codec_name=None, robust=False, byzantine=0.0):
    def build(mod, tracer, n):
        codec = getattr(mod, codec_name)() if codec_name else None
        rcfg = mod.RobustAggConfig(screen=True, screen_warmup=2) if robust else None
        drv = _async_driver(mod, tracer, codec, rcfg, byzantine)
        drv.run_updates(n)
        drv.finalize_trace()
    return build


@pytest.mark.parametrize("codec,robust,byzantine", [
    (None, False, 0.0), ("Int8Codec", False, 0.0), (None, True, 0.2)],
    ids=["float32", "int8", "screen-nan-attacker"])
def test_a_traced_async_run_is_the_references_event_sequence(tmp_path, codec, robust,
                                                             byzantine):
    files = _traced_pair(tmp_path, _run_async(codec, robust, byzantine), 6)
    jev, tev = JO.load_run(files["j"]), TO.load_run(files["t"])
    _assert_same_sequence(jev, tev)
    names = {e.name for e in tev}
    assert {"round", "dispatch", "admit", "flush", "end", "counters"} <= names
    if byzantine:
        assert "screen_reject" in names
        assert any(e.attrs.get("outcome") == "quarantined" for e in tev)
    # each package reads the other's trace as it reads its own
    for path in files.values():
        j, t = JO.load_run(path), TO.load_run(path)
        assert TO.check_run(t) == JO.check_run(j) == []
        assert TO.round_rollups(t) == JO.round_rollups(j) and len(TO.round_rollups(t)) == 6
        assert TO.dispatch_table(t) == JO.dispatch_table(j)
        assert TO.straggler_breakdown(t) == JO.straggler_breakdown(j)
        assert TO.chrome_trace(t) == JO.chrome_trace(j)


def test_traced_sync_rounds_are_the_references_event_sequence(tmp_path):
    def build(mod, tracer, n):
        sgd = mod.InnerOptConfig(name="sgd", lr_max=0.05, weight_decay=0.0, grad_clip=1e9,
                                 warmup_steps=0, total_steps=10_000, alpha=1.0)
        fed = mod.FederatedConfig(clients_per_round=3, local_steps=TAU, inner=sgd)
        pcfg = mod.ParticipationConfig(population=6, clients_per_round=3, dropout_rate=0.3)
        if mod is J:
            agg = J.SyncAggregator(_quad_j, fed, pcfg, seed=2, tracer=tracer,
                                   params=jax.tree_util.tree_map(jnp.asarray, _np_params()))
            batches = jax.tree_util.tree_map(jnp.asarray, _np_batches(0, 3))
        else:
            agg = T.SyncAggregator(_quad_t, fed, pcfg, seed=2, tracer=tracer,
                                   params=tree_map(torch.from_numpy, _np_params()))
            batches = tree_map(torch.from_numpy, _np_batches(0, 3))
        for r in range(n):
            agg.run_round(batches, agg.plan(r))
    files = _traced_pair(tmp_path, build, 3)
    jev, tev = JO.load_run(files["j"]), TO.load_run(files["t"])
    # the port adds phase spans inside each round (obs/phases) and their
    # rollup on the round's E event: compare the reference's spans and keys
    ref_spans = {e.span for e in jev}
    ref_keys = {k for e in jev for k in e.attrs}
    own = [dataclasses.replace(e, attrs={k: v for k, v in e.attrs.items() if k in ref_keys})
           for e in tev if e.span in ref_spans]
    _assert_same_sequence(jev, own)
    ends = [e for e in own if e.ph == "E"]
    assert len(ends) == 3 and {"train_loss", "pseudo_grad_norm"} <= set(ends[0].attrs)
    # the port's extra spans: each round's phase tree, ids under the round's
    extra = [e for e in tev if e.ph == "B" and e.span not in ref_spans]
    ids = {e.span for e in extra}
    assert len(extra) == 3 * (8 + 3 * (3 + 3 * TAU))
    assert {e.span.split("/")[0] for e in extra} == {"r0", "r1", "r2"}
    assert all(e.parent in ids | {e.span.split("/")[0]} for e in extra)


@pytest.mark.parametrize("codec", [None, "int8", "topk"])
def test_tracing_leaves_the_async_run_bitwise_unchanged(tmp_path, codec):
    def run(tracer):
        c = T.get_codec(codec, 0.25, fused=True) if codec else None
        drv = _async_driver(T, tracer, c)
        return drv, drv.run_updates(5)

    tracer = TO.Tracer(TO.JsonlSink(str(tmp_path / "t.jsonl")), proc="server")
    (a, ha), (b, hb) = run(None), run(tracer)
    b.finalize_trace()
    tracer.close()
    assert ha == hb
    ta, ma = a.checkpoint()
    tb, mb = b.checkpoint()
    assert ma == mb
    for k, v in params_to_numpy(ta).items():
        np.testing.assert_array_equal(params_to_numpy(tb)[k], v, err_msg=k)
    assert TO.check_run(TO.load_run(str(tmp_path))) == []


def test_tracing_leaves_sync_rounds_bitwise_unchanged(tmp_path):
    fed = T.FederatedConfig(clients_per_round=3, local_steps=TAU)
    pcfg = T.ParticipationConfig(population=6, clients_per_round=3, dropout_rate=0.3)
    batches = tree_map(torch.from_numpy, _np_batches(0, 3))
    for codec in (None, "int8"):  # the per-leaf server phase; the int8 uplink, fused
        out = []
        for tracer in (None, TO.Tracer(TO.JsonlSink(str(tmp_path / f"{codec}.jsonl")),
                                       proc="server")):
            agg = T.SyncAggregator(_quad_t, fed, pcfg, seed=2, tracer=tracer,
                                   codec=T.get_codec(codec, 0.25, fused=True) if codec else None,
                                   fused_server=codec is not None,
                                   params=tree_map(torch.from_numpy, _np_params()))
            rows = [{k: float(v) for k, v in agg.run_round(batches, agg.plan(r)).items()}
                    for r in range(3)]
            out.append((rows, params_to_numpy(agg.state["params"])))
        assert out[0][0] == out[1][0], codec
        for k, v in out[0][1].items():
            np.testing.assert_array_equal(out[1][1][k], v, err_msg=f"{codec} {k}")


def test_report_cli_checks_and_exports_a_trace(tmp_path, capsys):
    files = _traced_pair(tmp_path, _run_async(), 3)
    assert TR.main([files["t"], "--check", "--chrome", str(tmp_path / "c.json")]) == 0
    assert "check: OK" in capsys.readouterr().out
    assert json.loads((tmp_path / "c.json").read_text())["traceEvents"]
    assert TR.main([str(tmp_path), "--json"]) == 0  # both files merged
    rep = json.loads(capsys.readouterr().out)
    assert len(rep["rounds"]) == 6 and rep["breakdown"]["admitted"] == 12
    # a leaked span fails the check
    with open(files["t"], "a") as f:
        ev = TO.make_event("dispatch", "B", "server", "t", span="d999", parent="u0")
        f.write(json.dumps(TO.encode_event(ev)) + "\n")
    assert TR.main([files["t"], "--check"]) == 1


BYZ = ["--aggregation", "async", "--fused-server", "--straggler-profile", "heavy",
       "--dropout-rate", "0.1", "--clients", "4", "--population", "8", "--local-steps", "2",
       "--seq-len", "64", "--byzantine-fraction", "0.25", "--byzantine-kind", "nan",
       "--rollback", "--rollback-window", "2", "--reduced", "--eval-batches", "1"]


def test_both_clis_trace_the_rollback_at_the_same_update(tmp_path):
    """The reference CLI's first update is the shared start; both CLIs resume
    it traced, roll back at update 3, and their traces agree event for event
    (names, spans, parents, outcomes) with the ``rollback`` instant's attrs
    equal."""
    ck = tmp_path / "ck"
    jt.run(jt.parse_args(BYZ + ["--rounds", "1", "--ckpt-dir", str(ck)]))
    shutil.copytree(ck, tmp_path / "ck_t")
    jt.run(jt.parse_args(BYZ + ["--rounds", "5", "--ckpt-dir", str(ck), "--resume",
                                "--trace", str(tmp_path / "j.jsonl")]))
    tt.run(tt.parse_args(BYZ + ["--rounds", "5", "--ckpt-dir", str(tmp_path / "ck_t"),
                                "--resume", "--trace", str(tmp_path / "t.jsonl"),
                                "--device", "cpu"]))
    jev, tev = JO.load_run(str(tmp_path / "j.jsonl")), TO.load_run(str(tmp_path / "t.jsonl"))
    assert [(e.name, e.ph, e.span, e.parent) for e in tev] == \
        [(e.name, e.ph, e.span, e.parent) for e in jev]
    for j, t in zip(jev, tev):
        for k in ("outcome", "index", "client", "version", "accepted", "round"):
            assert t.attrs.get(k) == j.attrs.get(k), (j.name, j.span, k)
    rb = [e.attrs for e in tev if e.name == "rollback"]
    assert rb == [e.attrs for e in jev if e.name == "rollback"] == \
        [{"round": 3, "restored_round": 2}]
    assert TO.check_run(tev) == []


def test_cli_serves_metrics_and_traces_a_sync_run(tmp_path, capsys):
    """``--trace`` and ``--metrics-port 0`` on the sync CLI: the port is
    printed, and the trace holds one closed round span per round, each with
    its closed phase spans under it."""
    path = tmp_path / "sync.jsonl"
    tt.run(tt.parse_args(["--reduced", "--rounds", "2", "--local-steps", "2", "--clients", "2",
                          "--population", "4", "--seq-len", "64", "--eval-batches", "1",
                          "--device", "cpu", "--trace", str(path), "--metrics-port", "0"]))
    assert "metrics serving on 127.0.0.1:" in capsys.readouterr().out
    events = TO.load_run(str(path))
    closed, opened = TO.span_pairs(events)
    assert [c["span"] for c in closed if c["name"] == "round"] == ["r0", "r1"] and not opened
    assert all(c["span"].split("/")[0] in ("r0", "r1") for c in closed)
    assert events[-1].name == "counters" and events[-1].attrs["counters"]["rounds"] == 2.0
