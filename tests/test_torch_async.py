"""The port's asynchronous buffered aggregation against the reference, on the CPU.

- ``AsyncTimeline.dispatch(n)`` is bitwise the reference's (numpy only).
- The buffer door and the flush: the same deltas through the reference's
  jitted ``admit_delta`` / ``flush_buffer`` and the port's. Admission lanes
  are bitwise, apart from the discounted weight with α ≠ 0, which is held to
  2 float32 ulp (``pow`` is computed by two libraries); flushed params to
  abs 1e-7 + rel 1e-6 and the flush metrics to rel 1e-5, as the server-phase
  parity tests hold them.
- The port's own identities are bitwise: M = K, α = 0 admission then flush
  is its sync round (plain and fused server), kill and resume through
  ``CheckpointManager`` is the uninterrupted run, in-flight snapshots survive
  a flush, and a checkpoint survives the next admission.
- The drivers of both packages on a reduced photon-75m (float32 compute,
  4 updates, heavy stragglers, dropout 0.2, ``max_staleness`` 2): the
  dispatch cursor, the simulated clock, the admitted staleness, the buffer
  fill and the work and byte totals are bitwise; the pseudo-gradient norm
  and the train loss to rel 1e-5; params to abs 1e-4 (a third of AdamW's
  lr_max), with at most 16 entries above 1e-5 (see the test).
- Checkpoints cross over in both directions through the two CLIs (default
  bf16 compute: losses to rel 2e-2, val_ppl 5e-2, as ``test_torch_train.py``).
- The CLI refuses what the reference refuses, and resumes bitwise.
"""
import csv
import dataclasses
import json
import shutil

import numpy as np
import pytest

from torch_parity import assert_close, jax_flat, jax_to_torch

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.core.async_agg as JA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import build_client_streams as j_streams  # noqa: E402
from repro.data import round_batches as j_round_batches  # noqa: E402
from repro.launch import train as jt  # noqa: E402
from repro.metrics import fedmetrics as JM  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.compression import get_codec as t_get_codec  # noqa: E402
from repro_torch.data import build_client_streams as t_streams  # noqa: E402
from repro_torch.data import round_batches as t_round_batches  # noqa: E402
from repro_torch.kernels.fedcore import fused_apply_aggregate  # noqa: E402
from repro_torch.launch import train as tt  # noqa: E402
from repro_torch.metrics import fedmetrics as TM  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.tree import clone, params_to_numpy, tree_leaves, tree_map  # noqa: E402

HEAVY = "heavy"


# ---------------------------------------------------------------------------
# helpers: a quadratic model and its inputs
# ---------------------------------------------------------------------------


def _quad_t(params, batch):
    loss = torch.mean(torch.square(batch["x"] @ params["w"] + params["b"][0] - batch["y"]))
    return loss, {"loss": loss}


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 4)).astype(np.float32),
            "b": [(rng.standard_normal(4) * 0.1).astype(np.float32)]}


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np_batches(tau, c, seed=1, n=8):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((tau, c, n, 4)).astype(np.float32),
            "y": rng.standard_normal((tau, c, n, 4)).astype(np.float32)}


def _sgd(mod, lr=0.1):
    return mod.InnerOptConfig(name="sgd", lr_max=lr, weight_decay=0.0, grad_clip=1e9,
                              warmup_steps=0, total_steps=10_000, alpha=1.0)


def _feds(c, tau, outer="fedavg", lr=1.0, **kw):
    return tuple(mod.FederatedConfig(clients_per_round=c, local_steps=tau, inner=_sgd(mod),
                                     outer=mod.OuterOptConfig(name=outer, lr=lr), **kw)
                 for mod in (J, T))


def _flat(tree):
    return params_to_numpy(tree)


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


# ---------------------------------------------------------------------------
# the dispatch timeline and the metrics (numpy only: bitwise)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,partial", [("uniform", False), ("markov", False),
                                           ("uniform", True), ("markov", True)])
def test_async_timeline_is_bitwise_the_reference(model, partial):
    kw = dict(population=16, clients_per_round=4, model=model, dropout_rate=0.2,
              weighting="examples", partial_progress=partial, local_steps=8 if partial else 0)
    jcfg = J.ParticipationConfig(straggler=J.STRAGGLER_PROFILES[HEAVY], **kw)
    tcfg = T.ParticipationConfig(straggler=T.STRAGGLER_PROFILES[HEAVY], **kw)
    jtl, ttl = J.AsyncTimeline(jcfg, 7), T.AsyncTimeline(tcfg, 7)
    assert T.AsyncTimeline.CONNECT_COST == J.AsyncTimeline.CONNECT_COST
    events = [ttl.dispatch(n) for n in range(199)]
    kinds = set()
    for n, got in enumerate(events):
        want = jtl.dispatch(n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), n
        for f in dataclasses.fields(want):
            assert type(getattr(got, f.name)) is type(getattr(want, f.name)), (n, f.name)
        kinds.add((got.completes, got.weight > 0, got.local_steps))
    # every branch ran: completions, no-shows, and (partial) budgets below τ
    assert (True, True, 0 if not partial else 8) in kinds
    assert any(not c for c, _, _ in kinds)
    if partial:
        assert any(0 < ls < 8 for _, _, ls in kinds)
    # dispatch n is pure in (cfg, seed, n): a fresh timeline replays any of them
    fresh = T.AsyncTimeline(tcfg, 7)
    for n in (198, 0, 57):
        assert fresh.dispatch(n) == events[n]


def test_staleness_discount_is_monotone_exact_at_zero_and_the_reference():
    s = torch.arange(0, 20, dtype=torch.float32)
    for alpha in (0.25, 0.5, 1.0, 2.0):
        d = T.staleness_discount(torch.tensor(3.0), s, alpha).numpy()
        assert (np.diff(d) < 0).all() and d[0] == 3.0, alpha
        want = np.asarray(J.staleness_discount(jnp.asarray(3.0), jnp.asarray(s.numpy()), alpha))
        # pow comes from two libraries: 2 float32 ulp
        np.testing.assert_array_max_ulp(d, want, maxulp=2)
    w = np.asarray([0.7, 1.3], np.float32)
    got = T.staleness_discount(torch.from_numpy(w), torch.ones(2), 0.0).numpy()
    np.testing.assert_array_equal(got, w)  # α = 0: the weight, bitwise
    assert T.staleness_discount(2.0, -3.0, 0.5).item() == 2.0  # staleness clamps at 0


def test_staleness_metrics_are_the_references():
    for ages in ([], [0.0], [0, 1, 2, 3, 4, 7, 8, 30, 1, 1], [5.0, 5.0]):
        assert TM.staleness_stats(ages) == JM.staleness_stats(ages)
        np.testing.assert_array_equal(TM.staleness_hist_counts(ages),
                                      JM.staleness_hist_counts(ages))
    for a, b in ((3.0, 1.5), (2.0, 0.0), (0.0, 4.0)):
        assert TM.wallclock_speedup(a, b) == JM.wallclock_speedup(a, b)


def test_async_config_rejects_degenerate_values():
    for kw in (dict(buffer_size=0), dict(buffer_size=-1), dict(staleness_alpha=-0.1),
               dict(max_staleness=-1)):
        with pytest.raises(ValueError):
            T.AsyncAggConfig(**kw)


# ---------------------------------------------------------------------------
# the buffer door and the flush against the reference
# ---------------------------------------------------------------------------


def _deltas(n, seed=5):
    rng = np.random.default_rng(seed)
    p = _np_params()
    return [tree_map(lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(np.float32), p)
            for _ in range(n)]


def _both_states(jfed, tfed, acfg_kw, params, rng_seed=3):
    jacfg, tacfg = J.AsyncAggConfig(**acfg_kw), T.AsyncAggConfig(**acfg_kw)
    js = J.init_async_state(jfed, jacfg, _j(params), jax.random.PRNGKey(rng_seed))
    ts = T.init_async_state(tfed, tacfg, _t(params), np.asarray(jax.random.PRNGKey(rng_seed)))
    return jacfg, tacfg, js, ts


def _assert_lanes_match(ts, js, *, disc_ulp=0):
    tf, jf = _flat({k: ts[k] for k in ("buffer", "buf_staleness", "buf_count", "round")}), \
        jax_flat({k: js[k] for k in ("buffer", "buf_staleness", "buf_count", "round")})
    assert sorted(tf) == sorted(jf)
    for k in jf:
        assert tf[k].dtype == jf[k].dtype and tf[k].shape == jf[k].shape, k
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    np.testing.assert_array_max_ulp(ts["buf_weights"].numpy(), np.asarray(js["buf_weights"]),
                                    maxulp=disc_ulp)


def test_admission_door_tags_staleness_and_refuses_as_the_reference():
    jfed, tfed = _feds(3, 2)
    acfg_kw = dict(buffer_size=3, staleness_alpha=0.5, max_staleness=2)
    jacfg, tacfg, js, ts = _both_states(jfed, tfed, acfg_kw, _np_params())
    js = dict(js, round=jnp.asarray(5, jnp.int32))
    ts["round"] = 5  # the server is at version 5
    admit_j = jax.jit(lambda s, d, r, w: J.admit_delta(jfed, jacfg, s, d, r, w, auto_flush=False))
    # (tag, weight): fresh; 3 old > max 2; from the future (clamps to 0);
    # zero weight; 2 old = max; then the buffer is full
    arrivals = [(5, 1.0), (2, 1.0), (7, 2.0), (5, 0.0), (3, 1.5), (5, 1.0)]
    outcomes = []
    for (tag, w), d in zip(arrivals, _deltas(len(arrivals))):
        js, jm = admit_j(js, _j(d), jnp.asarray(tag, jnp.int32), jnp.asarray(w, jnp.float32))
        ts, tm = T.admit_delta(tfed, tacfg, ts, _t(d), tag, w, auto_flush=False)
        assert tm["accepted"] == float(jm["accepted"])
        assert tm["staleness"] == float(jm["staleness"])
        assert tm["buf_count"] == float(jm["buf_count"])
        np.testing.assert_array_max_ulp(np.float32(tm["discounted_weight"]),
                                        np.asarray(jm["discounted_weight"]), maxulp=2)
        rec_t, rec_j = T.admission_record(tm), JA.admission_record(jm)
        assert sorted(rec_t) == sorted(rec_j)
        for k in ("accepted", "staleness", "buf_count"):
            assert rec_t[k] == rec_j[k], k
        outcomes.append(tm["accepted"])
    assert outcomes == [1.0, 0.0, 1.0, 0.0, 1.0, 0.0]
    _assert_lanes_match(ts, js, disc_ulp=2)

    js, jfm = jax.jit(lambda s: J.flush_buffer(jfed, jacfg, s))(js)
    ts, tfm = T.flush_buffer(tfed, tacfg, ts)
    assert ts["round"] == int(js["round"]) == 6 and ts["buf_count"] == 0
    for k, v in jax_flat(js["params"]).items():
        assert_close(_flat(ts["params"])[k], v, atol=1e-7, rtol=1e-6, what=k)
    assert sorted(tfm) == sorted(jfm) == sorted(T.async_agg.FLUSH_METRICS)
    for k in jfm:
        assert_close(float(tfm[k]), float(jfm[k]), atol=1e-7, rtol=1e-5, what=k)
    _assert_lanes_match(ts, js)  # zeroed weights and staleness, stale rows kept


def test_partial_flush_then_empty_flush_match_the_reference():
    jfed, tfed = _feds(4, 2, outer="fedadam", lr=0.5)
    jacfg, tacfg, js, ts = _both_states(jfed, tfed, dict(buffer_size=4, staleness_alpha=0.0),
                                        _np_params())
    for d in _deltas(2, seed=9):
        js, _ = J.admit_delta(jfed, jacfg, js, _j(d), jnp.asarray(0, jnp.int32),
                              jnp.asarray(1.0), auto_flush=False)
        ts, _ = T.admit_delta(tfed, tacfg, ts, _t(d), 0, 1.0, auto_flush=False)
    flush_j = jax.jit(lambda s: J.flush_buffer(jfed, jacfg, s))
    for step in ("partial", "empty"):
        before = {k: clone(ts[k]) for k in ("params", "outer", "round", "rng")}
        js, jfm = flush_j(js)
        ts, tfm = T.flush_buffer(tfed, tacfg, ts)
        for lane in ("params", "outer"):
            for k, v in jax_flat(js[lane]).items():
                assert_close(_flat(ts[lane])[k], v, atol=1e-7, rtol=1e-5, what=lane + k)
        for k in jfm:
            assert_close(float(tfm[k]), float(jfm[k]), atol=1e-7, rtol=1e-5,
                         what=f"{step} {k}")
        assert ts["round"] == int(js["round"])
        if step == "partial":
            assert tfm["buffer_fill"] == 2.0 and tfm["buffer_occupancy"] == 0.5
        else:  # nothing buffered: the core lanes are bitwise as they were
            assert tfm["buffer_fill"] == 0.0 and ts["round"] == 1
            _assert_trees_equal({k: ts[k] for k in before}, before)


def test_admit_deltas_is_sequential_admits_and_the_reference():
    jfed, tfed = _feds(4, 2)
    jacfg, tacfg, js, ts = _both_states(jfed, tfed, dict(buffer_size=2, staleness_alpha=0.5),
                                        _np_params())
    ds = _deltas(4, seed=11)
    stacked = tree_map(lambda *xs: np.stack(xs), *ds)
    w = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    tags = np.zeros(4, np.int32)
    js, jms = J.admit_deltas(jfed, jacfg, js, _j(stacked), jnp.asarray(tags), jnp.asarray(w))
    seq = T.init_async_state(tfed, tacfg, _t(_np_params()), np.asarray(jax.random.PRNGKey(3)))
    ts, tms = T.admit_deltas(tfed, tacfg, ts, _t(stacked), tags, w)
    np.testing.assert_array_equal(tms["flushed"].numpy(), [0.0, 1.0, 0.0, 1.0])
    np.testing.assert_array_equal(tms["staleness"].numpy(), [0.0, 0.0, 1.0, 1.0])
    for k in ("flushed", "staleness", "accepted", "buf_count", "buffer_fill"):
        np.testing.assert_array_equal(tms[k].numpy(), np.asarray(jms[k]), err_msg=k)
    np.testing.assert_array_max_ulp(tms["discounted_weight"].numpy(),
                                    np.asarray(jms["discounted_weight"]), maxulp=2)
    for k in ("pseudo_grad_norm", "global_model_norm", "staleness_mean"):
        assert_close(tms[k].numpy(), np.asarray(jms[k]), atol=1e-7, rtol=1e-5, what=k)
    for i, d in enumerate(ds):
        seq, _ = T.admit_delta(tfed, tacfg, seq, _t(d), 0, w[i])
    _assert_trees_equal({k: seq[k] for k in ("params", "buffer", "round", "rng")},
                        {k: ts[k] for k in ("params", "buffer", "round", "rng")})
    for k, v in jax_flat(js["params"]).items():
        assert_close(_flat(ts["params"])[k], v, atol=1e-7, rtol=1e-6, what=k)


def test_int8_payload_is_decoded_at_the_door_even_when_refused():
    jfed, tfed = _feds(2, 2)
    jacfg, tacfg, js, ts = _both_states(jfed, tfed, dict(buffer_size=2, staleness_alpha=0.0,
                                                         max_staleness=1), _np_params())
    codec = t_get_codec("int8", fused=True)
    calls = []
    decode = codec.decode
    codec.decode = lambda p: calls.append(1) or decode(p)
    js = dict(js, round=jnp.asarray(3, jnp.int32))
    ts["round"] = 3
    for tag in (3, 0):  # admitted, then refused as too stale
        payload, _ = codec.encode(_t(_deltas(1, seed=tag)[0]))
        ts, tm = T.admit_delta(tfed, tacfg, ts, payload, tag, 1.0, auto_flush=False,
                               codec=codec)
        js, jm = J.admit_delta(jfed, jacfg, js, _j(tree_map(lambda x: x.numpy(), payload)),
                               jnp.asarray(tag, jnp.int32), jnp.asarray(1.0), auto_flush=False,
                               codec=J.get_codec("int8"))
        assert tm["accepted"] == float(jm["accepted"]) == (1.0 if tag == 3 else 0.0)
    assert len(calls) == 2  # the refused upload was decoded too
    _assert_lanes_match(ts, js)  # int8 decode is exact: the buffer rows are bitwise


def test_robust_door_is_refused_naming_the_roadmap():
    """The robust door (``screen`` / ``norm_bound``, ROADMAP.md queue A item
    4): a non-finite delta and one over the bound are refused without taking
    a slot, a clean one is admitted (``test_torch_robust.py`` holds it to the
    reference's door)."""
    jfed, tfed = _feds(2, 2)
    _, tacfg, _, ts = _both_states(jfed, tfed, dict(buffer_size=2), _np_params())
    clean = _t(_deltas(1)[0])
    for delta, bound, accepted in ((tree_map(lambda x: x * float("nan"), clean), None, 0.0),
                                   (clean, 1e-6, 0.0), (clean, None, 1.0)):
        ts, m = T.admit_delta(tfed, tacfg, ts, delta, 0, 1.0, auto_flush=False, screen=True,
                              norm_bound=bound)
        assert (m["accepted"], m["screened"]) == (accepted, 1.0 - accepted)
    assert ts["buf_count"] == 1


# ---------------------------------------------------------------------------
# the port's own identities: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("outer,dp_noise", [("fedavg", 0.0), ("fedmom", 0.01)])
def test_async_round_is_bitwise_the_ports_sync_round(outer, dp_noise, fused):
    """M = K, α = 0, every client completing in the round: admission then
    flush is this package's ``federated_round``, rng lane and DP noise
    included, round after round."""
    tau, c = 3, 4
    _, fed = _feds(c, tau, outer=outer, lr=0.7, dp_noise=dp_noise)
    acfg = T.AsyncAggConfig(buffer_size=c, staleness_alpha=0.0)
    apply_fn = fused_apply_aggregate if fused else None
    w = torch.tensor([1.0, 2.0, 0.5, 3.0])
    s_sync = T.init_federated_state(fed, _t(_np_params()), T.prng_key(3))
    s_async = T.init_async_state(fed, acfg, _t(_np_params()), T.prng_key(3))
    for r in range(3):
        b = _t(_np_batches(tau, c, seed=20 + r))
        s_sync, m_sync = T.federated_round(_quad_t, fed, s_sync, b, client_weights=w,
                                           apply_fn=apply_fn)
        deltas, _ = T.run_clients(_quad_t, fed, s_async, b, client_weights=w)
        for k in range(c):
            s_async, m = T.admit_delta(fed, acfg, s_async, tree_map(lambda x: x[k], deltas),
                                       r, w[k], auto_flush=False)
            assert m["staleness"] == 0.0 and m["accepted"] == 1.0
        assert s_async["buf_count"] == c
        s_async, fm = T.flush_buffer(fed, acfg, s_async, apply_fn=apply_fn)
        _assert_trees_equal({k: s_async[k] for k in ("params", "outer", "round", "rng")},
                            {k: s_sync[k] for k in ("params", "outer", "round", "rng")})
        assert s_async["round"] == r + 1 and fm["buffer_fill"] == c
        for k in ("pseudo_grad_norm", "client_consensus", "global_model_norm"):
            assert float(fm[k]) == float(m_sync[k]), k


def _t_driver(codec=None, partial=False, state=None, dispatch=None, pop=8, k=4, fused=False,
              max_staleness=0, make_batches=None):
    tau = 3
    _, fed = _feds(k, tau)
    fed = dataclasses.replace(fed, inner=_sgd(T, lr=0.05))
    acfg = T.AsyncAggConfig(buffer_size=2, staleness_alpha=0.5, max_staleness=max_staleness)
    pcfg = T.ParticipationConfig(
        population=pop, clients_per_round=k, dropout_rate=0.1,
        straggler=T.STRAGGLER_PROFILES[HEAVY], weighting="examples",
        partial_progress=partial, local_steps=tau if partial else 0,
    )
    drv = T.AsyncFederationDriver(
        _quad_t, fed, acfg, pcfg,
        make_batches or (lambda cid: _t(_np_batches(tau, 1, seed=100 + cid))),
        seed=3, params=_t(_np_params()), rng=T.prng_key(1), codec=codec, state=state,
        dispatch=dispatch, fused_server=fused,
    )
    return drv, fed, acfg, pcfg


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "update"} for r in rows]


@pytest.mark.parametrize("uplink,partial", [("float32", False), ("float32", True),
                                            ("topk", False), ("bf16", False)],
                         ids=["plain", "partial", "topk", "bf16"])
def test_kill_and_resume_is_bitwise_the_uninterrupted_run(tmp_path, uplink, partial):
    """Checkpoint mid-run through ``CheckpointManager``, rebuild a driver
    from it, and the continuation is the uninterrupted run: rows, state,
    manifest, residual rows, the codec's rng lane and the totals."""
    codec = lambda: None if uplink == "float32" else t_get_codec(uplink, 0.25, fused=True)  # noqa: E731
    drv_a, fed, acfg, pcfg = _t_driver(codec(), partial, fused=True)
    hist_a = drv_a.run_updates(6)

    drv_b, *_ = _t_driver(codec(), partial, fused=True)
    drv_b.run_updates(3)
    tree, manifest = drv_b.checkpoint()
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save_server(2, tree, extra={"aggregator": manifest})
    like = T.AsyncBufferAggregator.checkpoint_template(
        fed, acfg, pcfg, _t(_np_params()), codec(), uplink_ids=manifest.get("uplink_ids"))
    restored, man = ckpt.load_server(2, like)
    assert man["extra"]["aggregator"] == manifest  # JSON floats are exact

    drv_c, *_ = _t_driver(codec(), partial, state=restored, dispatch=man["extra"]["aggregator"],
                          fused=True)
    assert drv_c.n_dispatched == drv_b.n_dispatched and drv_c.sim_time == drv_b.sim_time
    assert drv_c._busy == drv_b._busy
    hist_c = drv_c.run_updates(3)
    assert _strip(hist_a[3:]) == _strip(hist_c)
    tree_a, man_a = drv_a.checkpoint()
    tree_c, man_c = drv_c.checkpoint()
    assert man_a == man_c
    _assert_trees_equal(tree_a, tree_c)
    assert (drv_a.work_completed, drv_a.work_wasted, drv_a.uplink_bytes_total) == \
        (drv_c.work_completed, drv_c.work_wasted, drv_c.uplink_bytes_total)
    if uplink == "topk":
        assert len(man_a["uplink_ids"]) > 0 and "uplink_rng" in tree_a
    # the wrong kind is refused
    with pytest.raises(ValueError, match="does not match"):
        _t_driver(codec(), partial, state=restored, dispatch=dict(manifest, kind="sync"))


def test_driver_never_runs_a_client_twice_at_once_and_counts_its_work():
    drv, *_ = _t_driver(pop=4, k=4)
    for _ in range(40):
        running = [ev.client for _, _, ev, _, _ in drv._heap if ev.duration > 0]
        assert len(running) == len(set(running)), running
        drv.step()
    assert drv.n_flushes == drv.state["round"] > 0
    assert drv.n_client_phases == drv.n_admissions > 0


@pytest.mark.parametrize("uplink", ["float32", "topk"])
def test_stale_uploads_keep_the_references_order_of_side_effects(uplink):
    """Every completion draws its batches. A completion certain to be refused
    for staleness skips its compute — unless an error-feedback codec must
    advance the client's residual: then it trains, uploads (its bytes are
    counted) and the door refuses it."""
    drawn = []

    def make_batches(cid):
        drawn.append(cid)
        return _t(_np_batches(3, 1, seed=100 + cid))

    codec = t_get_codec("topk", 0.25, fused=True) if uplink == "topk" else None
    drv, *_ = _t_driver(codec, max_staleness=1, make_batches=make_batches)
    completions = []
    pop = drv._pop_completion
    drv._pop_completion = lambda: completions.append(pop()) or completions[-1]
    drv.run_updates(8)
    done = [ev.client for ev, _, _ in completions if ev.completes]
    assert drawn == done
    assert drv.uplink_bytes_total == drv.n_client_phases * drv._bytes_per_upload
    refused = drv.n_admissions - 8 * 2  # the 8 flushes took M = 2 deltas each
    if uplink == "topk":
        assert drv.n_client_phases == drv.n_admissions == len(done) and refused > 0
        assert set(drv.residuals.ids()) == set(done)
    else:
        assert drv.n_client_phases == drv.n_admissions < len(done) and refused == 0


def test_inflight_snapshots_and_checkpoints_are_not_written_in_place():
    drv, *_ = _t_driver(codec=t_get_codec("topk", 0.25, fused=True), fused=True)
    snaps = [(idx, snap, _flat(snap)) for _, idx, _, snap, _ in drv._heap if snap is not None]
    assert snaps
    rows = drv.run_updates(2)  # two flushes replace params while the slots are in flight
    assert drv.state["round"] == 2 and rows[-1]["buffer_fill"] == 2
    for idx, snap, before in snaps:
        np.testing.assert_equal(_flat(snap), before)  # bit-identical after the flushes
    # a checkpoint taken now is unchanged by the next admissions and flush
    tree, manifest = drv.checkpoint()
    frozen = {k: v.copy() for k, v in _flat(tree).items()}
    drv.run_updates(1)
    assert drv.n_admissions > 0
    np.testing.assert_equal(_flat(tree), frozen)
    assert manifest["cursor"] < drv.n_dispatched


# ---------------------------------------------------------------------------
# the drivers of both packages on a reduced photon-75m
# ---------------------------------------------------------------------------

P_TAU, P_B, P_S, P_K, P_P = 2, 2, 32, 4, 8


@pytest.mark.parametrize("partial", [False, True], ids=["plain", "partial"])
def test_drivers_of_both_packages_agree_on_reduced_photon(partial):
    jcfg = dataclasses.replace(j_get_config("photon-75m").reduced(), compute_dtype="float32")
    tcfg = dataclasses.replace(t_get_config("photon-75m").reduced(), compute_dtype="float32")
    jm, tm = j_build(jcfg), t_build(tcfg)
    params = jm.init(jax.random.PRNGKey(0))
    fed_kw = dict(clients_per_round=P_K, local_steps=P_TAU)
    inner_kw = dict(warmup_steps=1, total_steps=8 * P_TAU)
    jfed = J.FederatedConfig(inner=J.InnerOptConfig(**inner_kw), **fed_kw)
    tfed = T.FederatedConfig(inner=T.InnerOptConfig(**inner_kw), **fed_kw)
    acfg_kw = dict(buffer_size=2, staleness_alpha=0.5, max_staleness=2)
    pkw = dict(population=P_P, clients_per_round=P_K, dropout_rate=0.2, weighting="examples",
               partial_progress=partial, local_steps=P_TAU if partial else 0)
    js, ts = (j_streams(P_P, P_S, jcfg.vocab_size, heterogeneous=False, seed=0),
              t_streams(P_P, P_S, tcfg.vocab_size, heterogeneous=False, seed=0))
    jdrv = J.AsyncFederationDriver(
        lambda p, b: jm.loss(p, b), jfed, J.AsyncAggConfig(**acfg_kw),
        J.ParticipationConfig(straggler=J.STRAGGLER_PROFILES[HEAVY], **pkw),
        lambda c: {k: jnp.asarray(v) for k, v in j_round_batches([js[c]], P_TAU, P_B).items()},
        seed=1, params=params, rng=jax.random.PRNGKey(1), fused_server=True)
    tdrv = T.AsyncFederationDriver(
        tm.loss, tfed, T.AsyncAggConfig(**acfg_kw),
        T.ParticipationConfig(straggler=T.STRAGGLER_PROFILES[HEAVY], **pkw),
        lambda c: {k: torch.from_numpy(v) for k, v in t_round_batches([ts[c]], P_TAU, P_B).items()},
        seed=1, params=jax_to_torch(params), rng=T.prng_key(1), fused_server=True)
    jrows, trows = jdrv.run_updates(4), tdrv.run_updates(4)
    assert (tdrv.n_dispatched, tdrv.sim_time, tdrv.work_completed, tdrv.work_wasted,
            tdrv.uplink_bytes_total) == (jdrv.n_dispatched, jdrv.sim_time,
                                         jdrv.work_completed, jdrv.work_wasted,
                                         jdrv.uplink_bytes_total)
    assert sorted(tdrv._busy) == sorted(jdrv._busy)
    for t, j in zip(trows, jrows):
        for k in ("sim_time", "admitted_staleness", "buffer_fill", "buffer_occupancy",
                  "staleness_mean", "staleness_max", "uplink_bytes_total", "update"):
            assert t[k] == j[k], k
        assert_close(t["pseudo_grad_norm"], j["pseudo_grad_norm"], rtol=1e-5,
                     what="pseudo_grad_norm")
        assert_close(t["train_loss_mean"], j["train_loss_mean"], rtol=1e-5, what="train_loss")
    assert sum(len(r["admitted_staleness"]) for r in trows) == 8
    # AdamW normalizes each step, so an entry whose gradient sits at float32
    # noise may move by up to lr_max (3e-4) in one package and not the other:
    # every entry within lr_max/3, and at most 16 of the ~1.05M above 1e-5
    n_loose = 0
    for k, v in jax_flat(jdrv.state["params"]).items():
        got = _flat(tdrv.state["params"])[k]
        assert_close(got, v, atol=1e-4, what=k)
        n_loose += int((np.abs(got - v) > 1e-5).sum())
    assert n_loose <= 16, n_loose


def test_fused_topk_selection_through_the_door_is_the_references():
    """Top-k is held by its selections: the same delta and residual row
    through each package's fused top-k encode at C = 1 and into the buffer."""
    from repro.kernels.fedcore import FusedTopKCodec as JTopK

    rng = np.random.default_rng(21)
    p = _np_params()
    delta, res = (tree_map(lambda x: (rng.standard_normal(x.shape) * s).astype(np.float32), p)
                  for s in (1e-2, 3e-3))
    jcodec, tcodec = JTopK(k_fraction=0.25), t_get_codec("topk", 0.25, fused=True)
    jpay, jres = jcodec.encode(_j(delta), _j(res))
    tpay, tres = tcodec.encode(_t(delta), _t(res))
    for got, want in ((tpay, jpay), (tres, jres)):
        got, want = _flat(got), jax_flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sum(int((x != 0).sum()) for x in tree_leaves(tpay)) == 5  # max(1, ⌊20·0.25⌋)
    jfed, tfed = _feds(2, 2)
    jacfg, tacfg, js, ts = _both_states(jfed, tfed, dict(buffer_size=2), p)
    js, _ = J.admit_delta(jfed, jacfg, js, jpay, jnp.asarray(0, jnp.int32), jnp.asarray(1.0),
                          auto_flush=False, codec=jcodec)
    ts, _ = T.admit_delta(tfed, tacfg, ts, tpay, 0, 1.0, auto_flush=False, codec=tcodec)
    _assert_lanes_match(ts, js)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

ASYNC = ["--reduced", "--local-steps", "2", "--clients", "2", "--population", "4",
         "--seq-len", "64", "--fused-server", "--aggregation", "async", "--buffer-size", "2",
         "--straggler-profile", "heavy", "--dropout-rate", "0.1"]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_async_checkpoints_cross_over_between_the_packages(tmp_path):
    topk = ASYNC + ["--uplink", "topk"]
    ck = tmp_path / "ck"
    jt.run(jt.parse_args(topk + ["--rounds", "1", "--ckpt-dir", str(ck)]))
    shutil.copytree(ck, tmp_path / "ck_j")
    shutil.copytree(ck, tmp_path / "ck_t")
    jt.run(jt.parse_args(topk + ["--rounds", "2", "--ckpt-dir", str(tmp_path / "ck_j"),
                                 "--resume", "--log", str(tmp_path / "j.csv")]))
    tt.run(tt.parse_args(topk + ["--rounds", "2", "--ckpt-dir", str(tmp_path / "ck_t"),
                                 "--resume", "--log", str(tmp_path / "t.csv"),
                                 "--device", "cpu"]))
    (jr,), (tr,) = _rows(tmp_path / "j.csv"), _rows(tmp_path / "t.csv")
    for k in ("update", "sim_time", "buffer_fill", "staleness_mean", "staleness_max",
              "staleness_hist_0", "staleness_hist_1", "deltas_admitted", "wallclock_speedup",
              "work_completed", "work_wasted", "uplink_bytes_total",
              "uplink_bytes_per_client"):
        assert float(jr[k]) == float(tr[k]), k
    assert_close(float(tr["train_loss"]), float(jr["train_loss"]), rtol=2e-2, what="train_loss")
    assert_close(float(tr["val_ppl"]), float(jr["val_ppl"]), rtol=5e-2, what="val_ppl")
    assert_close(float(tr["uplink_residual_norm"]), float(jr["uplink_residual_norm"]),
                 rtol=5e-2, what="uplink_residual_norm")

    # the port's update-1 checkpoint has the reference's keys, shapes, dtypes and manifest
    rnd = "round_000001"
    mans = {}
    for name in ("ck_t", "ck_j"):
        with open(tmp_path / name / rnd / "manifest.json") as f:
            mans[name] = json.load(f)["extra"]["aggregator"]
    assert mans["ck_t"] == mans["ck_j"]
    with np.load(tmp_path / "ck_t" / rnd / "server.npz") as t, \
            np.load(tmp_path / "ck_j" / rnd / "server.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in ("['inflight_params']", "['uplink_residuals']", "['uplink_rng']", "['buffer']"):
            assert any(f.startswith(k) for f in j.files), k
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
        for k in ("['buf_count']", "['buf_staleness']", "['round']"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # ... and the reference resumes it
    out = jt.run(jt.parse_args(topk + ["--rounds", "3", "--ckpt-dir", str(tmp_path / "ck_t"),
                                       "--resume"]))
    assert [int(r["update"]) for r in out["history"]] == [2]
    assert out["driver"].n_dispatched > mans["ck_t"]["cursor"]
    # a sync run refuses the async checkpoint
    with pytest.raises(SystemExit, match="--aggregation async run"):
        tt.run(tt.parse_args(ASYNC[:-8] + ["--rounds", "4", "--ckpt-dir", str(tmp_path / "ck_t"),
                                           "--resume", "--device", "cpu"]))


@pytest.mark.parametrize("uplink", ["float32", "topk"])
def test_cli_runs_two_updates_and_resume_continues_bitwise(tmp_path, uplink):
    """A run of 3 updates, then its last update run again from the update-1
    checkpoint (as after a kill): the CSV rows agree in every field but the
    wall clock and ``val_ppl``. (``--rounds`` sizes the inner LR schedule, so
    the runs compared share it. The validation stream is not checkpointed, in
    either package: a resumed run evaluates on the stream's first batches.)"""
    args = ASYNC + ["--uplink", uplink, "--device", "cpu", "--rounds", "3"]
    ck = tmp_path / "ck"
    out = tt.run(tt.parse_args(args + ["--ckpt-dir", str(ck), "--log", str(tmp_path / "a.csv")]))
    assert [r["update"] for r in out["history"]] == [0, 1, 2]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_ppl"])
               for r in out["history"])
    shutil.rmtree(ck / "round_000002")  # killed after update 1's checkpoint
    i = args.index("--buffer-size")
    with pytest.raises(SystemExit, match="buffer-size"):
        tt.run(tt.parse_args(args[:i] + ["--buffer-size", "1"] + args[i + 2:]
                             + ["--ckpt-dir", str(ck), "--resume"]))
    tt.run(tt.parse_args(args + ["--ckpt-dir", str(ck), "--resume",
                                 "--log", str(tmp_path / "b.csv")]))
    want, (got,) = _rows(tmp_path / "a.csv")[2], _rows(tmp_path / "b.csv")
    assert sorted(want) == sorted(got)
    for k in want:
        if k not in ("seconds", "val_ppl"):
            assert got[k] == want[k], k


@pytest.mark.parametrize("aggregation", ["sync", "async"])
def test_a_checkpoint_round_is_committed_after_its_client_cursors(tmp_path, monkeypatch,
                                                                   aggregation):
    """The manifest commits a round: when it is written, every client cursor
    of the round is on disk already, so a server killed between the two
    leaves a partial round that ``--resume`` skips (a complete round without
    its cursors would restart every client's stream)."""
    save_server = CheckpointManager.save_server
    committed = []

    def checked_save_server(self, rnd, state, extra=None):
        d = tmp_path / "ck" / f"round_{rnd:06d}"
        missing = [i for i in range(4) if not (d / f"client_{i:04d}.json").exists()]
        assert not missing, (rnd, missing)
        committed.append(rnd)
        return save_server(self, rnd, state, extra)

    monkeypatch.setattr(CheckpointManager, "save_server", checked_save_server)
    args = ASYNC if aggregation == "async" else ASYNC[:ASYNC.index("--aggregation")]
    tt.run(tt.parse_args(args + ["--rounds", "2", "--device", "cpu",
                                 "--ckpt-dir", str(tmp_path / "ck")]))
    assert committed == [0, 1]


@pytest.mark.parametrize("extra,match", [
    pytest.param(["--keep-opt"], "--keep-opt with --aggregation async",
                 id="--keep-opt---keep-opt with --aggregation async"),
    pytest.param(["--cohort-tile", "2"], "applies to --aggregation sync only",
                 id="--cohort-tile-queue A item 3"),
    pytest.param(["--runtime", "sockets", "--aggregation", "sync"],
                 "--runtime sockets requires --aggregation async", id="--runtime-queue A item 6"),
    pytest.param(["--control", "staleness", "--aggregation", "sync"],
                 "--control staleness drives the async buffer knobs",
                 id="--control-queue A item 5"),
    pytest.param(["--robust-agg", "trimmed"], "and --fused-server are mutually exclusive",
                 id="--robust-agg-queue A item 4"),
    pytest.param(["--screen"], "and --fused-server are mutually exclusive",
                 id="--screen-queue A item 4"),
    pytest.param(["--rollback"], "it requires --ckpt-dir", id="--rollback-queue A item 4"),
    pytest.param(["--byzantine-fraction", "0.1", "--aggregation", "sync"],
                 "in-process async attack simulator", id="--byzantine-fraction-queue A item 4"),
    pytest.param(["--byzantine-kind", "nan", "--byzantine-fraction", "0.5",
                  "--aggregation", "sync"], "in-process async attack simulator",
                 id="--byzantine-kind-queue A item 4"),
])
def test_cli_refuses_what_is_not_ported(extra, match):
    """Every flag of the reference is ported (the control and runtime flags
    since queue A items 5 and 6) and refused only where the reference
    refuses it: ``--runtime sockets`` and ``--control staleness`` under
    sync (``test_torch_robust_cli.py``, ``test_torch_control.py`` and
    ``test_torch_runtime.py`` compare the wording)."""
    with pytest.raises(SystemExit, match=match):
        tt.run(tt.parse_args(ASYNC + ["--rounds", "1", "--device", "cpu"] + extra))


def test_cli_async_resume_needs_a_checkpoint_dir_and_an_async_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="needs --ckpt-dir"):
        tt.run(tt.parse_args(ASYNC + ["--rounds", "1", "--device", "cpu", "--resume"]))
    sync = ASYNC[:ASYNC.index("--aggregation")] + ["--device", "cpu",
                                                   "--ckpt-dir", str(tmp_path)]
    tt.run(tt.parse_args(sync + ["--rounds", "1"]))
    with pytest.raises(SystemExit, match="no async aggregator manifest"):
        tt.run(tt.parse_args(ASYNC + ["--rounds", "2", "--device", "cpu", "--resume",
                                      "--ckpt-dir", str(tmp_path)]))
