"""The port's optimizers and one synchronous federated round against the
reference: inner (AdamW/SGD + cosine LR + clipping) and outer (FedAvg/FedMom/
FedAdam) steps at 1e-6; a ``SyncAggregator`` round on reduced photon-75m in
float32 compute, with the plain and the fused server phase, at params abs 1e-5
and metrics rel 1e-4 (float32 sums in another order through τ AdamW steps).
The partial-progress round is held to the reference's actual output."""
import dataclasses

import numpy as np
import pytest

from torch_parity import assert_close, assert_metrics_close, assert_trees_close, jax_to_torch

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.inner_opt as j_inner  # noqa: E402
import repro.core.outer_opt as j_outer  # noqa: E402
import repro_torch.core.inner_opt as t_inner  # noqa: E402
import repro_torch.core.outer_opt as t_outer  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import FederatedConfig as JFed  # noqa: E402
from repro.core import ParticipationConfig as JPC  # noqa: E402
from repro.core import STRAGGLER_PROFILES as J_PROFILES  # noqa: E402
from repro.core import SyncAggregator as JSync  # noqa: E402
from repro.data import build_client_streams, round_batches  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import FederatedConfig as TFed  # noqa: E402
from repro_torch.core import ParticipationConfig as TPC  # noqa: E402
from repro_torch.core import StragglerProfile as TStraggler  # noqa: E402
from repro_torch.core import SyncAggregator as TSync  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _small_tree(rng, scale):
    return {
        "a": (rng.standard_normal((7,)) * scale).astype(np.float32),
        "b": {"c": (rng.standard_normal((16, 8)) * scale).astype(np.float32),
              "d": (rng.standard_normal((33,)) * scale).astype(np.float32)},
    }


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


@pytest.mark.parametrize("step", [0, 1, 2, 5, 50, 99, 100, 101, 5000, 9999, 10000, 20000])
def test_cosine_lr_matches(step):
    cfg_kw = dict(lr_max=3e-4, warmup_steps=100, total_steps=10_000)
    want = float(j_inner.cosine_lr(j_inner.InnerOptConfig(**cfg_kw), jnp.asarray(step)))
    got = t_inner.cosine_lr(t_inner.InnerOptConfig(**cfg_kw), step)
    assert_close(got, want, rtol=1e-6, what=f"lr@{step}")


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_inner_steps_match(name):
    rng = np.random.default_rng(1)
    params = _small_tree(rng, 0.5)
    kw = dict(name=name, lr_max=1e-2, warmup_steps=2, total_steps=10, weight_decay=1e-2)
    jcfg, tcfg = j_inner.InnerOptConfig(**kw), t_inner.InnerOptConfig(**kw)
    jp, jstate = _jtree(params), j_inner.init_inner_state(jcfg, _jtree(params))
    tp = tree_leaves(jax_to_torch(jp))
    tstate = t_inner.init_inner_state(tcfg, tp)
    for step in range(3):
        grads = _small_tree(rng, 2.0 if step == 0 else 0.05)  # step 0 clips
        jp, jstate, jm = j_inner.inner_update(jcfg, jp, _jtree(grads), jstate, jnp.asarray(step))
        tp, tstate, tm = t_inner.inner_update(
            tcfg, tp, tree_leaves(jax_to_torch(_jtree(grads))), tstate, step
        )
        for got, want in zip(tp, jax.tree_util.tree_leaves(jp)):
            assert_close(got.numpy(), np.asarray(want), atol=1e-6, what=f"params@{step}")
        for k in ("lr", "grad_norm", "applied_update_norm"):
            assert_close(float(tm[k]), float(jm[k]), rtol=1e-6, what=k)
        assert tstate["count"] == int(jstate["count"])


@pytest.mark.parametrize("name", ["fedavg", "fedmom", "fedadam"])
def test_outer_steps_match(name):
    rng = np.random.default_rng(2)
    params = _jtree(_small_tree(rng, 0.5))
    jcfg, tcfg = j_outer.OuterOptConfig(name=name, lr=0.7), t_outer.OuterOptConfig(name=name, lr=0.7)
    jstate = j_outer.init_outer_state(jcfg, params)
    tparams = jax_to_torch(params)
    tstate = t_outer.init_outer_state(tcfg, tparams)
    for _ in range(2):
        pg = _jtree(_small_tree(rng, 0.1))
        params, jstate = j_outer.outer_update(jcfg, params, pg, jstate)
        tparams, tstate = t_outer.outer_update(tcfg, tparams, jax_to_torch(pg), tstate)
        assert_trees_close(tparams, params, atol=1e-6)
        for lane in t_outer.OUTER_LANES[name]:
            assert_trees_close(tstate[lane], jstate[lane], atol=1e-6)
        assert tstate["round"] == int(jstate["round"])


# ---------------------------------------------------------------------------
# One SyncAggregator round on reduced photon-75m
# ---------------------------------------------------------------------------


def _round_pair(*, fused, outer, straggler=None, partial=False, tau=2, seed=0,
                rounds=1, clients=2, cohort_tile=None, j_robust=None, t_robust=None,
                **fed_opts):
    """Run ``rounds`` rounds of each package from the same weights, plans and
    batches; ``fed_opts`` go to both FederatedConfigs, ``cohort_tile`` to both
    aggregators, ``j_robust`` / ``t_robust`` to each package's."""
    C, P, B, S = clients, max(4, 2 * clients), 2, 64
    jcfg = dataclasses.replace(j_get_config("photon-75m").reduced(), compute_dtype="float32")
    tcfg = dataclasses.replace(t_get_config("photon-75m").reduced(), compute_dtype="float32")
    jm, tm = j_build(jcfg), t_build(tcfg)
    params = jm.init(jax.random.PRNGKey(0))
    inner_kw = dict(warmup_steps=1, total_steps=4 * tau)
    fed_kw = dict(clients_per_round=C, local_steps=tau, **fed_opts)
    jfed = JFed(inner=j_inner.InnerOptConfig(**inner_kw),
                outer=j_outer.OuterOptConfig(name=outer, lr=0.7), **fed_kw)
    tfed = TFed(inner=t_inner.InnerOptConfig(**inner_kw),
                outer=t_outer.OuterOptConfig(name=outer, lr=0.7), **fed_kw)
    pkw = dict(population=P, clients_per_round=C, weighting="examples")
    jpc = JPC(straggler=straggler or J_PROFILES["none"], **pkw)
    tpc = TPC(straggler=TStraggler(**dataclasses.asdict(straggler or J_PROFILES["none"])),
              **pkw)
    jagg = JSync(lambda p, b: jm.loss(p, b), jfed, jpc, seed=seed, partial_progress=partial,
                 params=params, rng=jax.random.PRNGKey(1), fused_server=fused,
                 cohort_tile=cohort_tile, robust=j_robust)
    tagg = TSync(tm.loss, tfed, tpc, seed=seed, partial_progress=partial,
                 params=jax_to_torch(params), rng=np.asarray(jax.random.PRNGKey(1)),
                 fused_server=fused, cohort_tile=cohort_tile, robust=t_robust)
    streams = build_client_streams(P, S, jcfg.vocab_size, heterogeneous=False, seed=seed)
    for rnd in range(rounds):
        plan = jagg.plan(rnd)
        tokens = round_batches([streams[i] for i in plan.selected], tau, B)["tokens"]
        j_metrics = jagg.run_round({"tokens": jnp.asarray(tokens)}, plan)
        t_metrics = tagg.run_round({"tokens": torch.from_numpy(tokens)}, tagg.plan(rnd))
    return jagg, tagg, j_metrics, t_metrics, plan


def _assert_round_close(jagg, tagg, j_metrics, t_metrics):
    assert_trees_close(tagg.state["params"], jagg.state["params"], atol=1e-5)
    for lane in [k for k in jagg.state["outer"] if k != "round"]:
        assert_trees_close(tagg.state["outer"][lane], jagg.state["outer"][lane], atol=1e-5)
    assert tagg.state["round"] == int(jagg.state["round"])
    assert tagg.state["outer"]["round"] == int(jagg.state["outer"]["round"])
    assert set(t_metrics) == set(j_metrics)
    assert_metrics_close(t_metrics, j_metrics, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fused,outer", [(False, "fedavg"), (True, "fedmom")],
                         ids=["plain-fedavg", "fused-fedmom"])
def test_sync_round_matches_reference(fused, outer):
    _assert_round_close(*_round_pair(fused=fused, outer=outer)[:4])


def test_partial_progress_round_matches_reference():
    """Deadline 0.75 with τ=2: a client of speed in [2/3, 4/3) realizes τ_i=1.
    The seed is picked so that one client is partial and one runs in full;
    the port is held to what the reference actually computes."""
    heavy = dataclasses.replace(J_PROFILES["heavy"], deadline=0.75)
    from repro.core.sampler import plan_round

    pcfg = JPC(population=4, clients_per_round=2, weighting="examples", straggler=heavy,
               partial_progress=True, local_steps=2)
    seed = next(s for s in range(200)
                if sorted(plan_round(pcfg, s, 0).local_steps.tolist()) == [1, 2])
    # FedAvg: a first FedAdam step is ~lr·sign(pg), which no tolerance holds
    # where pg is near 0 (FedAdam is held in the kernel and outer-step tests)
    jagg, tagg, j_metrics, t_metrics, plan = _round_pair(
        fused=True, outer="fedavg", straggler=heavy, partial=True, seed=seed
    )
    assert sorted(plan.local_steps.tolist()) == [1, 2]
    _assert_round_close(jagg, tagg, j_metrics, t_metrics)


def test_sync_round_options_match_reference():
    """Two rounds with the client-side options on at once: inner state kept
    across rounds, FedProx, per-client DP clipping (active: the deltas' norms
    are ~0.25), two micro-batches per step and the legacy bf16 uplink cast."""
    opts = dict(keep_inner_state=True, fedprox_mu=0.01, dp_clip=0.1, grad_accum=2,
                pseudo_grad_dtype="bfloat16")
    jagg, tagg, j_metrics, t_metrics, _ = _round_pair(fused=True, outer="fedavg",
                                                      rounds=2, **opts)
    _assert_round_close(jagg, tagg, j_metrics, t_metrics)
    for lane in ("m", "v"):
        assert_trees_close(tagg.state["inner"][lane], jagg.state["inner"][lane], atol=1e-5)
    np.testing.assert_array_equal(tagg.state["inner"]["count"],
                                  np.asarray(jagg.state["inner"]["count"]))


@pytest.mark.parametrize("fused", [False, True], ids=["per-leaf", "fused"])
def test_dp_noise_has_the_reference_scale(fused):
    """DP noise is drawn by this package's own generator, so only its scale
    (dp_noise·max w/Σw) and the rng lane's advance are compared."""
    from repro_torch.core import apply_aggregate, init_federated_state, prng_key
    from repro_torch.core.federated import split_rng
    from repro_torch.kernels.fedcore import fused_apply_aggregate

    fn = fused_apply_aggregate if fused else apply_aggregate
    c, n = 4, 200_000
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(n, generator=gen), "b": [torch.randn(7, 3, generator=gen)]}
    deltas = {"a": torch.randn(c, n, generator=gen) * 1e-2,
              "b": [torch.randn(c, 7, 3, generator=gen) * 1e-2]}
    w = torch.tensor([1.0, 2.0, 0.0, 1.0])
    clean_fed = TFed(clients_per_round=c, local_steps=1)
    noisy_fed = dataclasses.replace(clean_fed, dp_noise=0.5)
    state = init_federated_state(clean_fed, params, prng_key(3))
    clean, _ = fn(clean_fed, state, deltas, client_weights=w)
    noisy, _ = fn(noisy_fed, state, deltas, client_weights=w)
    diff = (noisy["params"]["a"] - clean["params"]["a"]).numpy()
    assert abs(diff.std() / (0.5 * 2.0 / 4.0) - 1.0) < 0.01  # lr 1: Δθ = −noise
    assert abs(diff.mean()) < 0.01
    np.testing.assert_array_equal(noisy["rng"], split_rng(prng_key(3))[0])
    assert not np.array_equal(noisy["rng"], prng_key(3))


# ---------------------------------------------------------------------------
# Streamed cohorts (cohort tiles), hierarchical means, the centralized step
# ---------------------------------------------------------------------------


def test_tile_rng_keeps_the_round_lane_for_tile_zero():
    from repro.core.federated import TILE_RNG_TAG as J_TAG
    from repro_torch.core.federated import TILE_RNG_TAG, fold_in, tile_rng

    rng = np.asarray(jax.random.PRNGKey(7))
    assert TILE_RNG_TAG == J_TAG
    assert tile_rng(rng, 0) is rng
    lanes = [tile_rng(rng, t) for t in range(1, 5)]
    for t, lane in enumerate(lanes, start=1):
        assert lane.dtype == np.uint32 and lane.shape == (2,)
        np.testing.assert_array_equal(lane, fold_in(rng, TILE_RNG_TAG + t))
    assert len({tuple(x) for x in lanes + [rng]}) == 5


def _quad_t(params, batch):
    loss = torch.mean(torch.square(batch["x"] @ params["w"] + params["b"][0] - batch["y"]))
    return loss, {"loss": loss}


def _quad_setup(c, codec=None, partial=False, tile=None, dp_noise=0.0):
    from repro_torch.core import get_codec

    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32)),
              "b": [torch.from_numpy((rng.standard_normal(4) * 0.1).astype(np.float32))]}
    inner = t_inner.InnerOptConfig(name="sgd", lr_max=0.05, weight_decay=0.0, grad_clip=1e9,
                                   warmup_steps=0, total_steps=100, alpha=1.0)
    fed = TFed(clients_per_round=c, local_steps=3, inner=inner, dp_noise=dp_noise,
               outer=t_outer.OuterOptConfig(name="fedmom", lr=0.7))
    heavy = dataclasses.replace(J_PROFILES["heavy"], deadline=0.75)
    pcfg = TPC(population=2 * c, clients_per_round=c, weighting="examples", dropout_rate=0.2,
               straggler=TStraggler(**dataclasses.asdict(heavy)))
    return TSync(_quad_t, fed, pcfg, seed=1, partial_progress=partial, params=params,
                 rng=np.asarray(jax.random.PRNGKey(2)), cohort_tile=tile,
                 codec=get_codec(codec, 0.25) if codec else None)


def _quad_batches(tau, c, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal((tau, c, 8, 4)).astype(np.float32))
            for k in ("x", "y")}


@pytest.mark.parametrize("codec,partial,dp_noise", [
    (None, False, 0.0), (None, True, 0.01), ("topk", False, 0.0), ("bf16", True, 0.0),
    ("int8", False, 0.01),
], ids=["plain", "partial-dp", "topk", "bf16-partial", "int8-dp"])
def test_one_tile_round_is_bitwise_the_flat_round(codec, partial, dp_noise):
    """C_tile = C: params, outer lanes, rng, residual rows and every metric
    bitwise, round after round (dropout, partial progress, DP noise, codecs)."""
    from repro_torch.tree import params_to_numpy

    flat = _quad_setup(4, codec, partial, dp_noise=dp_noise)
    tiled = _quad_setup(4, codec, partial, tile=4, dp_noise=dp_noise)
    for r in range(3):
        b = _quad_batches(3, 4, seed=30 + r)
        mf = flat.run_round(b, flat.plan(r))
        mt = tiled.run_round(b, tiled.plan(r))
        assert sorted(mf) == sorted(mt)
        for k in mf:
            assert float(mf[k]) == float(mt[k]) or (np.isnan(float(mf[k]))
                                                   and np.isnan(float(mt[k]))), k
        ff, ft = params_to_numpy(flat.checkpoint()[0]), params_to_numpy(tiled.checkpoint()[0])
        assert sorted(ff) == sorted(ft)
        for k in ff:
            np.testing.assert_array_equal(ff[k], ft[k], err_msg=k)
        assert flat.checkpoint()[1] == tiled.checkpoint()[1]


def test_one_tile_round_is_bitwise_the_flat_round_on_reduced_photon():
    jagg, tagg, *_ = _round_pair(fused=False, outer="fedavg")
    _, tiled, *_ = _round_pair(fused=False, outer="fedavg", cohort_tile=2)
    from repro_torch.tree import params_to_numpy

    a, b = params_to_numpy(tagg.state["params"]), params_to_numpy(tiled.state["params"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("robust", [None, "trimmed", "median"])
def test_three_tile_round_with_a_padded_tile_matches_the_reference(robust):
    """C = 5 in tiles of 2: the last tile is one client and one padding slot.
    Params to abs 1e-5 and metrics to rel 1e-4 of the reference's tiled
    round, as the flat round is held (float32 compute on reduced photon).
    Two rounds with the weighted mean, one under a robust rule: an order
    statistic passes one client's float32 noise through unaveraged."""
    from repro.core.robust import RobustAggConfig as JRobust
    from repro_torch.core.robust import RobustAggConfig as TRobust

    kw = {}
    if robust:
        kw = dict(j_robust=JRobust(rule=robust, trim_fraction=0.2),
                  t_robust=TRobust(rule=robust, trim_fraction=0.2))
    jagg, tagg, j_metrics, t_metrics, plan = _round_pair(
        fused=False, outer="fedmom", cohort_tile=2, clients=5, rounds=1 if robust else 2, **kw)
    assert len(plan.selected) == 5
    _assert_round_close(jagg, tagg, j_metrics, t_metrics)


def test_apply_aggregate_partial_of_one_tile_is_apply_aggregate_bitwise():
    from repro_torch.core import apply_aggregate, apply_aggregate_partial, init_federated_state
    from repro_torch.core.federated import _client_norms

    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(50, generator=gen), "b": [torch.randn(3, 4, generator=gen)]}
    deltas = {"a": torch.randn(4, 50, generator=gen) * 1e-2,
              "b": [torch.randn(4, 3, 4, generator=gen) * 1e-2]}
    w = torch.tensor([1.0, 0.0, 2.5, 1.0])
    fed = TFed(clients_per_round=4, local_steps=1, dp_noise=0.1,
               outer=t_outer.OuterOptConfig(name="fedadam", lr=0.1))
    state = init_federated_state(fed, params, np.asarray(jax.random.PRNGKey(5)))
    want, wm = apply_aggregate(fed, state, deltas, client_weights=w)
    dsum = {"a": torch.sum(deltas["a"] * w[:, None], dim=0),
            "b": [torch.sum(deltas["b"][0] * w[:, None, None], dim=0)]}
    got, gm = apply_aggregate_partial(fed, state, dsum, w, _client_norms(deltas))
    from repro_torch.tree import params_to_numpy

    np.testing.assert_equal(params_to_numpy(got), params_to_numpy(want))
    assert {k: float(v) for k, v in gm.items()} == {k: float(v) for k, v in wm.items()}


def test_combine_tile_metrics_matches_the_reference():
    from repro.core.federated import combine_tile_metrics as j_combine
    from repro_torch.core import combine_tile_metrics as t_combine

    rng = np.random.default_rng(9)

    def tile(eff):
        return {"eff_k": np.float32(eff),
                "step_metrics": {k: rng.random(3).astype(np.float32)
                                 for k in ("loss", "grad_norm", "applied_update_norm", "lr")},
                "client_model_norm_mean": np.float32(rng.random()),
                "avg_client_model_norm": np.float32(rng.random()),
                "uplink_residual_norm": np.float32(rng.random())}

    tiles = [tile(2.0), tile(1.0), tile(0.0)]
    as_t = lambda t: tree_map_t(torch.from_numpy, t)  # noqa: E731
    for n in (1, 3):
        want = j_combine([jax.tree_util.tree_map(jnp.asarray, t) for t in tiles[:n]])
        got = t_combine([as_t(t) for t in tiles[:n]])
        assert sorted(got) == sorted(want)
        for k in want:
            assert_close(float(got[k]), float(want[k]), rtol=1e-6, what=k)
    one = as_t(tiles[0])
    assert t_combine([one])["client_model_norm_mean"] is one["client_model_norm_mean"]


def tree_map_t(fn, tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda x: fn(np.asarray(x)), tree)


@pytest.mark.parametrize("c,groups", [(8, 4), (8, 2), (6, 4), (5, 3), (7, 1)])
def test_hierarchical_mean_matches_the_reference(c, groups):
    from repro.core.federated import hierarchical_mean as j_hmean
    from repro_torch.core import hierarchical_mean as t_hmean

    rng = np.random.default_rng(c * 10 + groups)
    d = {"a": rng.standard_normal((c, 6)).astype(np.float32),
         "b": [rng.standard_normal((c, 2, 3)).astype(np.float32)]}
    w = rng.random(c).astype(np.float32)
    w[0] = 0.0
    got = t_hmean(tree_map_t(torch.from_numpy, d), groups, torch.from_numpy(w))
    assert_trees_close(got, j_hmean(_jtree(d), groups, jnp.asarray(w)), rtol=1e-6, atol=1e-7)
    if c % groups == 0:
        got = t_hmean(tree_map_t(torch.from_numpy, d), groups)
        assert_trees_close(got, j_hmean(_jtree(d), groups), rtol=1e-6, atol=1e-7)
    else:
        with pytest.raises(ValueError) as want:
            j_hmean(_jtree(d), groups)
        with pytest.raises(ValueError) as err:
            t_hmean(tree_map_t(torch.from_numpy, d), groups)
        assert str(err.value) == str(want.value)


def test_run_client_tile_refuses_kept_inner_state():
    from repro_torch.core import run_client_tile

    fed = TFed(clients_per_round=2, local_steps=1, keep_inner_state=True)
    with pytest.raises(ValueError, match="keep_inner_state=False"):
        run_client_tile(_quad_t, fed, {}, {}, torch.ones(2))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_centralized_step_matches_the_reference(tmp_path, grad_accum):
    """Two steps at float32 compute: params and AdamW lanes to abs 1e-5,
    metrics to rel 1e-4; the state round-trips through the checkpoint
    format, and the reference loads the port's file."""
    from repro.checkpoint.checkpoint import load_pytree as j_load
    from repro.core import centralized_step as j_step
    from repro.core import init_centralized_state as j_init
    from repro_torch.checkpoint.checkpoint import load_pytree, save_pytree
    from repro_torch.core import centralized_step as t_step
    from repro_torch.core import init_centralized_state as t_init
    from repro_torch.tree import params_to_numpy

    jcfg = dataclasses.replace(j_get_config("photon-75m").reduced(), compute_dtype="float32")
    tcfg = dataclasses.replace(t_get_config("photon-75m").reduced(), compute_dtype="float32")
    jm, tm = j_build(jcfg), t_build(tcfg)
    params = jm.init(jax.random.PRNGKey(0))
    kw = dict(lr_max=1e-3, warmup_steps=1, total_steps=10)
    jin, tin = j_inner.InnerOptConfig(**kw), t_inner.InnerOptConfig(**kw)
    js, ts = j_init(jin, params), t_init(tin, jax_to_torch(params))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 4, 64)).astype(np.int32)
    for step in range(2):
        js, jmet = j_step(lambda p, b: jm.loss(p, b), jin, js, {"tokens": jnp.asarray(toks[step])},
                          grad_accum=grad_accum)
        ts, tmet = t_step(tm.loss, tin, ts, {"tokens": torch.from_numpy(toks[step])},
                          grad_accum=grad_accum)
        assert ts["step"] == int(js["step"]) == step + 1
        assert_trees_close(ts["params"], js["params"], atol=1e-5)
        for lane in ("m", "v"):
            assert_trees_close(ts["inner"][lane], js["inner"][lane], atol=1e-5)
        assert ts["inner"]["count"] == int(js["inner"]["count"])
        assert_metrics_close(tmet, jmet, rtol=1e-4, atol=1e-7)
    path = str(tmp_path / "central")
    save_pytree(path, ts)
    like = t_init(tin, jax_to_torch(params))
    back = load_pytree(path, like)
    assert back["step"] == 2 and back["inner"]["count"] == 2
    np.testing.assert_equal(params_to_numpy(back), params_to_numpy(ts))
    jback = j_load(path, jax.eval_shape(lambda: j_init(jin, params)))
    assert_trees_close(ts, jback)
