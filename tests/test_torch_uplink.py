"""The compressed uplink of the port against the reference, on the CPU:

- (c) ``SparseResidualStore`` gather / scatter / stacked / dense round trips
  and ``federated_round_with_uplink`` on a dense store match the reference;
  ``run_clients`` with a stateful codec returns a masked (zero-weight)
  client's residual bitwise unchanged.
- (d) one ``SyncAggregator`` round per fused codec under ``--fused-server``
  on reduced photon-75m in float32 compute agrees with the reference:
  params abs 1e-5 and metrics rel 1e-4 (as the float32 round), with these
  allowances, each stated where it is used —
  top-k: client deltas differ in the last bits between the packages, so an
  entry whose magnitude lies within 1e-5 relative of its client's threshold
  may be kept by one and dropped by the other; such entries are excluded.
  int8: lr times one quantum (the largest client scale of the leaf) per
  params entry, for deltas that sit on a half-quantum. bf16: the reference's rounding noise is fed in, so the
  round tolerance holds.
"""
import dataclasses

import numpy as np
import pytest

from torch_parity import assert_close, assert_metrics_close, jax_to_torch, torch_flat

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.federated as JF  # noqa: E402
import repro_torch.core.federated as TF  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import FederatedConfig as JFed  # noqa: E402
from repro.core import InnerOptConfig as JInner  # noqa: E402
from repro.core import OuterOptConfig as JOuter  # noqa: E402
from repro.core import ParticipationConfig as JPC  # noqa: E402
from repro.core import SyncAggregator as JSync  # noqa: E402
from repro.core.compression import TopKCodec as JTopK  # noqa: E402
from repro.core.compression import get_codec as j_get_codec  # noqa: E402
from repro.data import build_client_streams, round_batches  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import FederatedConfig as TFed  # noqa: E402
from repro_torch.core import InnerOptConfig as TInner  # noqa: E402
from repro_torch.core import OuterOptConfig as TOuter  # noqa: E402
from repro_torch.core import ParticipationConfig as TPC  # noqa: E402
from repro_torch.core import SyncAggregator as TSync  # noqa: E402
from repro_torch.core.compression import TopKCodec as TTopK  # noqa: E402
from repro_torch.core.compression import get_codec as t_get_codec  # noqa: E402
from repro_torch.core.compression import int8_payload_leaves  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_leaves, tree_map  # noqa: E402


def _params(rng):
    return {"w": (rng.standard_normal((8, 4)) * 0.3).astype(np.float32),
            "b": [(rng.standard_normal(4) * 0.1).astype(np.float32)]}


def _jt(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _rows(rng, n, params):
    return [tree_map(lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(np.float32), params)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# (c) the residual store
# ---------------------------------------------------------------------------


def test_sparse_residual_store_round_trips_match_reference():
    rng = np.random.default_rng(0)
    params = _params(rng)
    js = JF.SparseResidualStore(_jt(params))
    ts = TF.SparseResidualStore(jax_to_torch(_jt(params)))
    P = 9
    for ids in ([4, 1], [7, 4, 0]):
        rows = _rows(rng, len(ids), params)
        stacked = tree_map(lambda *xs: np.stack(xs), *rows)
        js.scatter(np.asarray(ids), _jt(stacked))
        ts.scatter(np.asarray(ids), jax_to_torch(_jt(stacked)))
    assert ts.ids() == js.ids() == [0, 1, 4, 7]
    assert len(ts) == len(js) and (3 in ts) == (3 in js) and ts.nbytes == js.nbytes
    sel = np.asarray([3, 7, 1, 8])  # two never-materialized ids gather as zeros
    for got, want in [(ts.gather(sel), js.gather(sel)), (ts.stacked(), js.stacked()),
                      (ts.to_dense(P), js.to_dense(P))]:
        for k, v in torch_flat(jax_to_torch(want)).items():
            np.testing.assert_array_equal(torch_flat(got)[k], v, err_msg=k)
    # the checkpoint lanes rebuild the same store; all-zero dense rows stay unmaterialized
    again = TF.SparseResidualStore.from_stacked(jax_to_torch(_jt(params)), ts.ids(),
                                                ts.stacked())
    dense = TF.SparseResidualStore.from_dense(jax_to_torch(_jt(params)), ts.to_dense(P))
    j_dense = JF.SparseResidualStore.from_dense(_jt(params), js.to_dense(P))
    assert again.ids() == dense.ids() == j_dense.ids() == ts.ids()
    for store in (again, dense):
        for a, b in zip(tree_leaves(store.gather(sel)), tree_leaves(ts.gather(sel))):
            assert torch.equal(a, b)
    empty = TF.SparseResidualStore(jax_to_torch(_jt(params)))
    assert [tuple(x.shape) for x in tree_leaves(empty.stacked())] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(
            JF.SparseResidualStore(_jt(params)).stacked())]
    assert TF.SparseResidualStore.create(t_get_codec("int8"), params) is None


def _tiny_loss_j(p, batch):
    pred = batch["x"] @ p["w"] + p["b"][0]
    loss = jnp.mean(jnp.square(pred - batch["y"]))
    return loss, {"loss": loss}


def _tiny_loss_t(p, batch):
    pred = batch["x"] @ p["w"] + p["b"][0]
    loss = torch.mean(torch.square(pred - batch["y"]))
    return loss, {"loss": loss}


def _tiny_setup(C, tau=2, seed=1):
    rng = np.random.default_rng(seed)
    params = _params(rng)
    batches = {"x": rng.standard_normal((tau, C, 3, 8)).astype(np.float32),
               "y": rng.standard_normal((tau, C, 3, 4)).astype(np.float32)}
    kw = dict(clients_per_round=C, local_steps=tau)
    jfed = JFed(inner=JInner(warmup_steps=1, total_steps=8), outer=JOuter(lr=0.7), **kw)
    tfed = TFed(inner=TInner(warmup_steps=1, total_steps=8), outer=TOuter(lr=0.7), **kw)
    return rng, params, batches, jfed, tfed


def test_run_clients_keeps_a_masked_clients_residual_bitwise():
    C = 3
    rng, params, batches, jfed, tfed = _tiny_setup(C)
    res = tree_map(lambda x: (rng.standard_normal((C,) + x.shape) * 1e-2).astype(np.float32),
                   params)
    w = np.asarray([1.0, 0.0, 2.0], np.float32)
    jstate = JF.init_federated_state(jfed, _jt(params), jax.random.PRNGKey(3))
    tstate = TF.init_federated_state(tfed, jax_to_torch(_jt(params)),
                                     np.asarray(jax.random.PRNGKey(3)))
    codec_j, codec_t = JTopK(0.25), TTopK(0.25)
    j_pay, j_aux = JF.run_clients(_tiny_loss_j, jfed, jstate, _jt(batches),
                                  client_weights=jnp.asarray(w), codec=codec_j,
                                  residuals=_jt(res))
    t_pay, t_aux = TF.run_clients(_tiny_loss_t, tfed, tstate,
                                  {k: torch.from_numpy(v) for k, v in batches.items()},
                                  client_weights=torch.from_numpy(w), codec=codec_t,
                                  residuals=jax_to_torch(_jt(res)))
    for a, b in zip(tree_leaves(t_aux["residuals"]), tree_leaves(jax_to_torch(_jt(res)))):
        assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))  # masked: bitwise
    for k, v in torch_flat(jax_to_torch(j_aux["residuals"])).items():
        assert_close(torch_flat(t_aux["residuals"])[k], v, atol=1e-6, what=k)
    for k, v in torch_flat(jax_to_torch(j_pay)).items():
        assert_close(torch_flat(t_pay)[k], v, atol=1e-6, what=k)
    assert_close(float(t_aux["uplink_residual_norm"]), float(j_aux["uplink_residual_norm"]),
                 rtol=1e-5, what="uplink_residual_norm")


def test_federated_round_with_uplink_dense_store_matches_reference():
    C, P = 2, 5
    rng, params, batches, jfed, tfed = _tiny_setup(C, seed=2)
    store = tree_map(lambda x: (rng.standard_normal((P,) + x.shape) * 1e-2).astype(np.float32),
                     params)
    assert [x.shape for x in tree_leaves(TF.init_uplink_residuals(TTopK(), jax_to_torch(
        _jt(params)), P))] == [x.shape for x in jax.tree_util.tree_leaves(
            JF.init_uplink_residuals(JTopK(), _jt(params), P))]
    sel = np.asarray([3, 1])
    w = np.asarray([2.0, 1.0], np.float32)
    jstate = dict(JF.init_federated_state(jfed, _jt(params), jax.random.PRNGKey(4)),
                  uplink_residuals=_jt(store))
    tstate = dict(TF.init_federated_state(tfed, jax_to_torch(_jt(params)),
                                          np.asarray(jax.random.PRNGKey(4))),
                  uplink_residuals=jax_to_torch(_jt(store)))
    j_new, j_m = JF.federated_round_with_uplink(
        _tiny_loss_j, jfed, JTopK(0.25), jstate, _jt(batches),
        client_weights=jnp.asarray(w), selected=jnp.asarray(sel))
    t_new, t_m = TF.federated_round_with_uplink(
        _tiny_loss_t, tfed, TTopK(0.25), tstate,
        {k: torch.from_numpy(v) for k, v in batches.items()},
        client_weights=torch.from_numpy(w), selected=sel)
    for lane in ("params", "uplink_residuals"):
        for k, v in torch_flat(jax_to_torch(j_new[lane])).items():
            assert_close(torch_flat(t_new[lane])[k], v, atol=1e-6, what=f"{lane}{k}")
    # unselected rows are untouched
    for a, b in zip(tree_leaves(t_new["uplink_residuals"]),
                    tree_leaves(jax_to_torch(_jt(store)))):
        assert torch.equal(a[[0, 2, 4]], b[[0, 2, 4]])
    assert_metrics_close(t_m, j_m, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# (d) one SyncAggregator round per fused codec
# ---------------------------------------------------------------------------

C, P, B, S, TAU, LR, KF = 2, 4, 2, 64, 2, 0.7, 0.05


def _aggregators(scheme, seed=0):
    jcfg = dataclasses.replace(j_get_config("photon-75m").reduced(), compute_dtype="float32")
    tcfg = dataclasses.replace(t_get_config("photon-75m").reduced(), compute_dtype="float32")
    jm, tm = j_build(jcfg), t_build(tcfg)
    params = jm.init(jax.random.PRNGKey(0))
    inner_kw = dict(warmup_steps=1, total_steps=4 * TAU)
    fed_kw = dict(clients_per_round=C, local_steps=TAU)
    jfed = JFed(inner=JInner(**inner_kw), outer=JOuter(name="fedavg", lr=LR), **fed_kw)
    tfed = TFed(inner=TInner(**inner_kw), outer=TOuter(name="fedavg", lr=LR), **fed_kw)
    pkw = dict(population=P, clients_per_round=C, weighting="examples")
    jc, tc = j_get_codec(scheme, KF, fused=True), t_get_codec(scheme, KF, fused=True)
    jagg = JSync(lambda p, b: jm.loss(p, b), jfed, JPC(**pkw), seed=seed, params=params,
                 rng=jax.random.PRNGKey(1), fused_server=True, codec=jc)
    tagg = TSync(tm.loss, tfed, TPC(**pkw), seed=seed, params=jax_to_torch(params),
                 rng=np.asarray(jax.random.PRNGKey(1)), fused_server=True, codec=tc)
    streams = build_client_streams(P, S, jcfg.vocab_size, heterogeneous=False, seed=seed)
    return jagg, tagg, params, streams


def _run(jagg, tagg, streams, rnd=0):
    plan = jagg.plan(rnd)
    tokens = round_batches([streams[i] for i in plan.selected], TAU, B)["tokens"]
    j_m = jagg.run_round({"tokens": jnp.asarray(tokens)}, plan)
    t_m = tagg.run_round({"tokens": torch.from_numpy(tokens)}, tagg.plan(rnd))
    return plan, j_m, t_m


def _ref_cohort_noise(jagg, params):
    """The SR noise the reference's round 0 draws: per client
    ``split(fold_in(rng, round), C)``, then cast_compress's per-leaf draw."""
    per_round = jax.random.fold_in(jagg.state["rng"], jnp.uint32(0))
    leaves = jax.tree_util.tree_leaves(params)
    out = []
    for key in jax.random.split(per_round, C):
        keys = jax.random.split(key, len(leaves))
        out.append([np.asarray(jax.random.randint(k, l.shape, 0, 1 << 16)).astype(np.int32)
                    for k, l in zip(keys, leaves)])
    return [torch.from_numpy(np.stack([o[i] for o in out])) for i in range(len(leaves))]


def test_sync_round_with_fused_bf16_uplink_matches_reference():
    jagg, tagg, params, streams = _aggregators("bf16")
    noise = _ref_cohort_noise(jagg, params)
    tagg.codec.cohort_noise = lambda leaves, rngs: noise
    _, j_m, t_m = _run(jagg, tagg, streams)
    for k, v in torch_flat(jax_to_torch(jagg.state["params"])).items():
        assert_close(torch_flat(tagg.state["params"])[k], v, atol=1e-5, what=k)
    assert set(t_m) == set(j_m)
    assert_metrics_close(t_m, j_m, rtol=1e-4, atol=1e-6)


def test_sync_round_with_fused_int8_uplink_matches_reference():
    jagg, tagg, _, streams = _aggregators("int8")
    payloads = []  # the round's int8 payloads: {q, scale} per leaf, scale (C,)
    encode = tagg.codec.encode_cohort

    def record(*args):
        payloads.append(encode(*args))
        return payloads[-1]

    tagg.codec.encode_cohort = record
    _, j_m, t_m = _run(jagg, tagg, streams)
    # a client delta that lies within its last bits of a half-quantum may
    # round one way here and the other way in the reference: one quantum,
    # scale_c, in that client's decoded entry, so at most Σ_c wn_c·scale_c ≤
    # max_c scale_c in the pseudo-gradient and lr times that in the params,
    # per leaf. The scales are the port's; the reference's differ from them
    # at most in the last bit of a client absmax.
    entries, _ = int8_payload_leaves(payloads[0][0])
    quantum = {k: float(e["scale"].max())
               for (k, _), e in zip(flatten_with_paths(tagg.state["params"]), entries)}
    p0 = torch_flat(jax_to_torch(jax.tree_util.tree_map(jnp.asarray, jagg.state["params"])))
    assert sorted(quantum) == sorted(p0)
    for k, v in p0.items():
        got = torch_flat(tagg.state["params"])[k]
        assert_close(got, v, atol=1e-5 + LR * quantum[k], what=k)
    assert set(t_m) == set(j_m)
    assert_metrics_close(t_m, j_m, rtol=1e-4, atol=1e-6)


def test_sync_round_with_fused_topk_uplink_matches_reference():
    jagg, tagg, _, streams = _aggregators("topk")
    plan, j_m, t_m = _run(jagg, tagg, streams)
    assert tagg.residual_store.ids() == jagg.residual_store.ids() == sorted(plan.selected.tolist())
    flip = None  # per params leaf: entries one package kept and the other dropped
    for cid in plan.selected.tolist():
        r_t = torch_flat(tagg.residual_store.row(cid))
        r_j = torch_flat(jax_to_torch(jagg.residual_store.row(cid)))
        thresh = max(max(float(np.abs(v).max()) for v in r.values()) for r in (r_t, r_j))
        flips = {}
        for k in r_j:
            a, b = r_t[k], r_j[k]
            differ = (a == 0) != (b == 0)
            near = np.abs(np.where(a == 0, b, a)) >= (1 - 1e-5) * thresh
            assert np.all(near[differ]), (cid, k, "a flipped entry is not at the threshold")
            same = ~differ
            assert_close(a[same], b[same], atol=1e-6, what=f"resid {cid}{k}")
            flips[k] = differ
        flip = flips if flip is None else {k: flip[k] | flips[k] for k in flip}
    n_flip = sum(int(f.sum()) for f in flip.values())
    for k, v in torch_flat(jax_to_torch(jagg.state["params"])).items():
        got = torch_flat(tagg.state["params"])[k]
        assert_close(got[~flip[k]], v[~flip[k]], atol=1e-5, what=k)
    assert set(t_m) == set(j_m)
    skip = () if n_flip == 0 else ("pseudo_grad_norm", "client_consensus", "global_model_norm")
    assert_metrics_close(t_m, j_m, rtol=1e-4, atol=1e-6, skip=skip)
    assert_close(t_m["uplink_residual_norm"], float(j_m["uplink_residual_norm"]), rtol=1e-4,
                 what="uplink_residual_norm")
