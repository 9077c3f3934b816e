"""The port's Byzantine-robust aggregation (``repro_torch.core.robust``)
against the reference's ``repro.core.robust``, on the CPU.

- Selections are bitwise: ``masked_median``, ``screen_cohort``,
  ``sanitize_deltas``, the coordinate median, the trim count, the fold
  buffers and the median fold, on lanes poisoned with NaN, +inf and ×64,
  for n even, odd and 0. The sums (the trimmed mean, the fold totals and
  the trimmed fold) are held to float32 rel 1e-6 + abs 1e-9: torch and XLA
  may add in another order.
- ``RobustState``'s ``snapshot_json`` is the same string after the same
  calls; ``corrupt_tree`` and ``make_byzantine_fn`` are bitwise.
- The robust server phase and the sync drivers under trimmed, median,
  normclip and the screen, with a client whose delta is 64× the others':
  params to abs 1e-6, metrics to rel 1e-5, the screen mask and the
  quarantine table equal.
- The async door with ``screen`` / ``norm_bound`` against the reference's
  ``admit_delta``, and both async drivers with a Byzantine client.

The CLIs are held in ``test_torch_robust_cli.py``.
"""
import json
import math

import numpy as np
import pytest

from torch_parity import assert_close, jax_flat

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.core.robust as JR  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.robust as TR  # noqa: E402
from repro_torch.tree import params_to_numpy, tree_map  # noqa: E402

SUM_TOL = dict(rtol=1e-6, atol=1e-9)


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _eq(got, want, what=""):
    """Bitwise: the same dtype, shape and bits (NaN payloads and signed
    zeros included)."""
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert (got.shape, got.dtype) == (want.shape, want.dtype), (what, got.dtype, want.dtype)
    if got.dtype.kind == "f":
        got, want = got.view(f"u{got.itemsize}"), want.view(f"u{want.itemsize}")
    np.testing.assert_array_equal(got, want, err_msg=what)


def _tree_eq(got, want):
    g, w = params_to_numpy(got), jax_flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        _eq(g[k], w[k], k)


def _tree_close(got, want, **tol):
    g, w = params_to_numpy(got), jax_flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert_close(g[k], w[k], what=k, **tol)


#: (C, poisoned lanes {lane: kind}, weights): n even, odd and 0
COHORTS = {
    "odd-clean": (5, {}, [1.0, 2.0, 1.0, 0.5, 1.0]),
    "even-nan-inf": (6, {1: "nan", 4: "inf"}, [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]),
    "odd-x64-masked": (7, {2: "scale", 5: "nan"}, [1.0, 0.0, 1.0, 1.0, 2.0, 1.0, 1.0]),
    "even-x64": (8, {0: "scale"}, [1.0] * 8),
    "none-valid": (3, {0: "nan"}, [1.0, 0.0, 0.0]),
}


def _cohort(name, seed=0):
    """A (C, ...) delta tree with poisoned lanes, its weights, and the norms."""
    c, poison, w = COHORTS[name]
    rng = np.random.default_rng(seed)
    tree = {"a": (rng.standard_normal((c, 13)) * 1e-2).astype(np.float32),
            "b": [(rng.standard_normal((c, 4, 3)) * 1e-2).astype(np.float32)]}
    for lane, kind in poison.items():
        for x in (tree["a"], tree["b"][0]):
            if kind == "scale":
                x[lane] *= np.float32(64.0)
            else:
                x[lane] = np.nan if kind == "nan" else np.inf
    return tree, np.asarray(w, np.float32)


def _norms(tree):
    return np.array(jax.vmap(J.global_norm)(_j(tree)))


# ---------------------------------------------------------------------------
# order statistics and the screen (bitwise)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(COHORTS))
def test_masked_median_and_screen_are_bitwise_the_references(name):
    tree, w = _cohort(name)
    norms = _norms(tree)
    for mask in (np.isfinite(norms) & (w > 0), np.isfinite(norms), np.zeros_like(w, bool)):
        _eq(TR.masked_median(torch.from_numpy(norms), torch.from_numpy(mask)),
            JR.masked_median(jnp.asarray(norms), jnp.asarray(mask)), "median")
    for z in (6.0, 1.0, 0.5):
        got = TR.screen_cohort(torch.from_numpy(norms), torch.from_numpy(w), z)
        want = JR.screen_cohort(jnp.asarray(norms), jnp.asarray(w), z)
        for g, wt, what in zip(got, want, ("weights", "flagged", "finite")):
            _eq(g, wt, f"{what} z={z}")
    nw, flagged, finite = TR.screen_cohort(torch.from_numpy(norms), torch.from_numpy(w), 6.0)
    healthy = ~flagged.numpy()
    _eq(nw.numpy()[healthy], w[healthy], "healthy lanes keep their weight")
    _tree_eq(TR.sanitize_deltas(_t(tree), finite),
             JR.sanitize_deltas(_j(tree), jnp.asarray(finite.numpy())))


def test_screen_disarms_below_three_valid_lanes():
    norms = np.asarray([1.0, 100.0, np.nan, 1.0], np.float32)
    for w, want_flags in (([1.0, 1.0, 1.0, 0.0], [False, False, True, False]),
                          ([1.0, 1.0, 1.0, 1.0], [False, True, True, False])):
        w = np.asarray(w, np.float32)
        _, flagged, _ = TR.screen_cohort(torch.from_numpy(norms), torch.from_numpy(w), 6.0)
        assert flagged.tolist() == want_flags
        _eq(flagged, JR.screen_cohort(jnp.asarray(norms), jnp.asarray(w), 6.0)[1])


def test_clean_cohort_passes_sanitize_bitwise():
    tree, _ = _cohort("odd-clean")
    got = TR.sanitize_deltas(_t(tree), torch.ones(5, dtype=torch.bool))
    np.testing.assert_equal(params_to_numpy(got), params_to_numpy(_t(tree)))


@pytest.mark.parametrize("trim", [0.0, 0.1, 0.2, 0.25, 0.3, 0.45, 0.49])
def test_trim_count_and_fold_size_are_the_references(trim):
    for n in list(range(0, 24)) + [99, 100, 1000, 12345]:
        got = int(TR._trim_count(trim, torch.tensor(n, dtype=torch.int32)))
        assert got == int(JR._trim_count(trim, jnp.asarray(n, jnp.int32))), (trim, n)
        if n:
            for rule in ("trimmed", "median"):
                assert TR.tile_fold_size(rule, trim, n) == JR.tile_fold_size(rule, trim, n)


# ---------------------------------------------------------------------------
# the flat rules and the robust server phase
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(COHORTS))
def test_flat_rules_match_the_reference(name):
    """The coordinate median is a selection (bitwise); the trimmed mean and
    the norm-clipped mean are sums (SUM_TOL)."""
    tree, w = _cohort(name)
    norms = _norms(tree)
    finite = np.isfinite(norms)
    admit = finite & (w > 0)
    tc = TR.sanitize_deltas(_t(tree), torch.from_numpy(finite))
    jc = JR.sanitize_deltas(_j(tree), jnp.asarray(finite))
    ta, ja = torch.from_numpy(admit), jnp.asarray(admit)
    _tree_eq(TR.median_clients(tc, ta), JR.median_clients(jc, ja))
    for trim in (0.1, 0.2, 0.4):
        _tree_close(TR.trimmed_mean_clients(tc, ta, trim), JR.trimmed_mean_clients(jc, ja, trim),
                    **SUM_TOL)
    tau = np.float32(0.05)
    _eq(TR.normclip_scale(torch.from_numpy(norms), ta, torch.tensor(tau)),
        JR.normclip_scale(jnp.asarray(norms), ja, jnp.asarray(tau)), "normclip scale")


def _fed_pair(c, outer="fedmom"):
    kw = dict(clients_per_round=c, local_steps=1)
    return (J.FederatedConfig(outer=J.OuterOptConfig(name=outer, lr=0.7), **kw),
            T.FederatedConfig(outer=T.OuterOptConfig(name=outer, lr=0.7), **kw))


def _params_like(tree, seed=3):
    rng = np.random.default_rng(seed)
    return tree_map(lambda x: (rng.standard_normal(x.shape[1:]) * 0.1).astype(np.float32), tree)


@pytest.mark.parametrize("rule,screen", [("trimmed", False), ("median", False),
                                         ("normclip", False), ("normclip-abs", False),
                                         ("none", True), ("trimmed", True)])
@pytest.mark.parametrize("name", ["even-nan-inf", "odd-x64-masked", "even-x64"])
def test_robust_server_phase_matches_the_reference(rule, screen, name):
    tree, w = _cohort(name)
    c = w.shape[0]
    clip_norm = 0.05 if rule == "normclip-abs" else 0.0
    kw = dict(rule=rule.split("-")[0], screen=screen, clip_norm=clip_norm, trim_fraction=0.2)
    jfed, tfed = _fed_pair(c)
    jfn = JR.make_robust_apply_fn(jfed, JR.RobustAggConfig(**kw))
    tfn = TR.make_robust_apply_fn(tfed, TR.RobustAggConfig(**kw))
    p = _params_like(tree)
    js = J.init_federated_state(jfed, _j(p), jax.random.PRNGKey(0))
    ts = T.init_federated_state(tfed, _t(p), np.asarray(jax.random.PRNGKey(0)))
    jn, jm = jax.jit(lambda s, d, w: jfn(jfed, s, d, client_weights=w))(js, _j(tree),
                                                                       jnp.asarray(w))
    tn, tm = tfn(tfed, ts, _t(tree), client_weights=torch.from_numpy(w))
    _tree_close(tn["params"], jn["params"], atol=1e-6)
    for lane in [k for k in jn["outer"] if k != "round"]:
        _tree_close(tn["outer"][lane], jn["outer"][lane], atol=1e-6)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        if k == "screen_mask":
            _eq(tm[k], jm[k], k)
        else:
            assert_close(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, what=k)
    assert all(np.isfinite(x).all() for x in params_to_numpy(tn["params"]).values())


def test_robust_config_validates_as_the_reference():
    for kw in (dict(rule="mean"), dict(trim_fraction=0.5), dict(clip_mult=0.0),
               dict(clip_norm=-1.0), dict(screen_z=0.0), dict(screen_warmup=0),
               dict(rollback_window=1), dict(rollback_factor=1.0), dict(quarantine_rounds=0)):
        with pytest.raises(ValueError) as want:
            JR.RobustAggConfig(**kw)
        with pytest.raises(ValueError) as got:
            TR.RobustAggConfig(**kw)
        assert str(got.value) == str(want.value)
    for kw in (dict(), dict(rule="median"), dict(screen=True), dict(rollback=True)):
        j, t = JR.RobustAggConfig(**kw), TR.RobustAggConfig(**kw)
        assert (t.active, t.stateful) == (j.active, j.stateful)
    with pytest.raises(ValueError, match="inactive"):
        TR.make_robust_apply_fn(_fed_pair(2)[1], TR.RobustAggConfig(rollback=True))


# ---------------------------------------------------------------------------
# the tile folds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["trimmed", "median"])
@pytest.mark.parametrize("tiles", [(3, 3, 2), (4, 4), (2, 2, 2, 1)], ids=str)
def test_tile_folds_match_the_reference(rule, tiles):
    """Fold buffers are selections (bitwise, with the ∓inf sentinels), totals
    are sums (SUM_TOL); the median fold is bitwise, the trimmed one SUM_TOL,
    and both agree with the flat rule over the whole cohort."""
    c = sum(tiles)
    rng = np.random.default_rng(c)
    tree = {"a": (rng.standard_normal((c, 9)) * 1e-2).astype(np.float32),
            "b": [(rng.standard_normal((c, 2, 5)) * 1e-2).astype(np.float32)]}
    tree["a"][1] *= 64.0
    tree["b"][0][c - 1] = np.nan
    norms = _norms(tree)
    finite = np.isfinite(norms)
    admit = finite & (np.arange(c) != 2)  # one lane masked out by its weight
    trim = 0.2
    k = TR.tile_fold_size(rule, trim, c)
    params = _params_like(tree)
    tf, jf = TR.tile_fold_init(_t(params), k), JR.tile_fold_init(_j(params), k)
    lo = 0
    for n in tiles:
        sl = slice(lo, lo + n)
        d = tree_map(lambda x: x[sl], tree)
        fin, adm = finite[sl], admit[sl]
        tf = TR.tile_fold_update(tf, TR.sanitize_deltas(_t(d), torch.from_numpy(fin)),
                                 torch.from_numpy(adm))
        jf = JR.tile_fold_update(jf, JR.sanitize_deltas(_j(d), jnp.asarray(fin)),
                                 jnp.asarray(adm))
        lo += n
        _tree_eq(tf["top"], jf["top"])
        _tree_eq(tf["bot"], jf["bot"])
        _tree_close(tf["total"], jf["total"], **SUM_TOL)
        assert tf["count"] == int(jf["count"])
    got, want = TR.tile_fold_finish(tf, rule, trim), JR.tile_fold_finish(jf, rule, trim)
    clean = TR.sanitize_deltas(_t(tree), torch.from_numpy(finite))
    if rule == "median":
        _tree_eq(got, want)
        _tree_eq(got, JR.median_clients(_j(tree_map(lambda x: x.numpy(), clean)),
                                         jnp.asarray(admit)))
    else:
        _tree_close(got, want, **SUM_TOL)
        # the total carries the ×64 lane until the trim subtracts it: ulps of
        # its magnitude (~0.6) remain, hence abs 1e-7 against the flat rule
        flat = TR.trimmed_mean_clients(clean, torch.from_numpy(admit), trim)
        for k_, v in params_to_numpy(flat).items():
            assert_close(params_to_numpy(got)[k_], v, rtol=1e-5, atol=1e-7, what=k_)


def test_empty_fold_finishes_at_zero():
    p = {"a": np.zeros(3, np.float32)}
    for rule in ("trimmed", "median"):
        got = TR.tile_fold_finish(TR.tile_fold_init(_t(p), 2), rule, 0.1)
        want = JR.tile_fold_finish(JR.tile_fold_init(_j(p), 2), rule, 0.1)
        _tree_eq(got, want)
    with pytest.raises(ValueError, match="no tiled fold"):
        TR.tile_fold_size("normclip", 0.1, 4)


# ---------------------------------------------------------------------------
# host state and the attack simulator
# ---------------------------------------------------------------------------


def _drive_state(mod, cfg_kw):
    rs = mod.RobustState(mod.RobustAggConfig(**cfg_kw))
    trace = []
    norms = [1.0, 1.1, 0.9, float("nan"), 1.05, 50.0, float("inf"), 0.95, 1.2, 1.0, 1.3]
    for i, v in enumerate(norms):
        rs.observe_norm(v)
        trace.append(rs.norm_bound())
        trace.append(rs.observe_update(v))
        if i % 3 == 0:
            rs.add_quarantine([i, i + 1], i)
        trace.append([rs.is_quarantined(c, i) for c in range(12)])
        if not trace[-2]:
            rs.mark_good(i)
        else:
            rs.note_rollback()
        rs.note_screen_rejects(i % 2)
    return rs, trace


@pytest.mark.parametrize("cfg_kw", [dict(), dict(screen_warmup=3, rollback_window=2,
                                                 quarantine_rounds=2, screen_z=2.0)])
def test_robust_state_json_is_the_references(cfg_kw):
    (trs, tt_), (jrs, jt_) = _drive_state(TR, cfg_kw), _drive_state(JR, cfg_kw)
    assert tt_ == jt_
    assert trs.snapshot_json() == jrs.snapshot_json()
    again = TR.RobustState(TR.RobustAggConfig(**cfg_kw))
    again.load_state_dict(json.loads(jrs.snapshot_json()))
    assert again.snapshot_json() == jrs.snapshot_json()
    assert TR._median_sorted([]) == JR._median_sorted([]) == 0.0


@pytest.mark.parametrize("kind", ["nan", "inf", "scale", "sign_flip"])
def test_corrupt_tree_and_byzantine_fn_are_bitwise(kind):
    rng = np.random.default_rng(1)
    payload = {"w": {"q": rng.integers(-127, 128, (4, 3)).astype(np.int8),
                     "scale": np.float32(0.01)},
               "b": [(rng.standard_normal(5) * 1e-2).astype(np.float32)]}
    _tree_eq(TR.corrupt_tree(_t(payload), kind), JR.corrupt_tree(_j(payload), kind))
    tfn, jfn = (TR.make_byzantine_fn(0.25, kind, 8), JR.make_byzantine_fn(0.25, kind, 8))
    for cid in range(8):
        _tree_eq(tfn(cid, 0, _t(payload)), jfn(cid, 0, _j(payload)))
    assert TR.make_byzantine_fn(0.0, kind, 8) is None
    with pytest.raises(ValueError, match="byzantine kind"):
        TR.make_byzantine_fn(0.5, "replay", 8)
    with pytest.raises(ValueError, match="cannot apply"):
        TR.corrupt_tree(_t(payload), "replay")
    assert TR.CORRUPT_KINDS == JR.CORRUPT_KINDS and TR.ROBUST_RULES == JR.ROBUST_RULES


# ---------------------------------------------------------------------------
# the sync drivers with a Byzantine client (a quadratic model)
# ---------------------------------------------------------------------------


def _quad_t(params, batch):
    loss = torch.mean(torch.square(batch["x"] @ params["w"] + params["b"][0] - batch["y"]))
    return loss, {"loss": loss}


def _quad_j(params, batch):
    loss = jnp.mean(jnp.square(batch["x"] @ params["w"] + params["b"][0] - batch["y"]))
    return loss, {"loss": loss}


def _quad_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 4)).astype(np.float32),
            "b": [(rng.standard_normal(4) * 0.1).astype(np.float32)]}


def _quad_batches(tau, c, seed, byz=()):
    rng = np.random.default_rng(seed)
    b = {"x": rng.standard_normal((tau, c, 8, 4)).astype(np.float32),
         "y": rng.standard_normal((tau, c, 8, 4)).astype(np.float32)}
    for k in byz:  # a Byzantine client: its targets are 64× the others'
        b["y"][:, k] *= np.float32(64.0)
    return b


def _sync_pair(robust_kw, c=6, tau=2, **agg_kw):
    inner = dict(name="sgd", lr_max=0.05, weight_decay=0.0, grad_clip=1e9, warmup_steps=0,
                 total_steps=100, alpha=1.0)
    pkw = dict(population=8, clients_per_round=c, weighting="examples")
    jfed = J.FederatedConfig(clients_per_round=c, local_steps=tau,
                             inner=J.InnerOptConfig(**inner), outer=J.OuterOptConfig(lr=0.7))
    tfed = T.FederatedConfig(clients_per_round=c, local_steps=tau,
                             inner=T.InnerOptConfig(**inner), outer=T.OuterOptConfig(lr=0.7))
    jr = JR.RobustAggConfig(**robust_kw) if robust_kw is not None else None
    tr = TR.RobustAggConfig(**robust_kw) if robust_kw is not None else None
    p = _quad_params()
    jagg = J.SyncAggregator(_quad_j, jfed, J.ParticipationConfig(**pkw), seed=2, params=_j(p),
                            rng=jax.random.PRNGKey(1), robust=jr, **agg_kw)
    tagg = T.SyncAggregator(_quad_t, tfed, T.ParticipationConfig(**pkw), seed=2, params=_t(p),
                            rng=np.asarray(jax.random.PRNGKey(1)), robust=tr, **agg_kw)
    return jagg, tagg


@pytest.mark.parametrize("robust_kw", [
    dict(rule="trimmed", trim_fraction=0.2), dict(rule="median"),
    dict(rule="normclip"), dict(rule="normclip", clip_norm=0.5),
    dict(screen=True, screen_z=3.0), dict(rule="median", screen=True, quarantine_rounds=1),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_sync_rounds_of_both_drivers_hold_a_byzantine_client(robust_kw):
    """Three rounds from one starting point, slot 1 of each cohort scaled
    ×64: params, metrics, the screen's quarantine table and the manifest."""
    jagg, tagg = _sync_pair(robust_kw)
    for r in range(3):
        plan = jagg.plan(r)
        b = _quad_batches(2, 6, seed=10 + r, byz=(1,))
        jm = jagg.run_round(_j(b), plan)
        tm = tagg.run_round(_t(b), tagg.plan(r))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert_close(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, what=f"{r} {k}")
        _tree_close(tagg.state["params"], jagg.state["params"], atol=1e-5, rtol=1e-5)
        assert tagg.checkpoint()[1] == jagg.checkpoint()[1]
    if robust_kw.get("screen"):
        assert tagg.robust_state.counters["screen_rejects"] > 0
    assert tagg.robust_state.snapshot_json() == jagg.robust_state.snapshot_json()


def test_quarantined_clients_weigh_zero_and_a_stateful_only_defense_touches_nothing():
    jagg, tagg = _sync_pair(dict(rule="median"))
    base_j, base_t = _sync_pair(dict(rule="median"))
    plan = jagg.plan(0)
    b = _quad_batches(2, 6, seed=3)
    base_t.run_round(_t(b), plan)
    tagg.robust_state.add_quarantine([int(plan.selected[0])], 0)
    jagg.robust_state.add_quarantine([int(plan.selected[0])], 0)
    tm = tagg.run_round(_t(b), plan)
    jm = jagg.run_round(_j(b), plan)
    assert float(tm["effective_clients"]) == float(jm["effective_clients"]) == \
        int(plan.mask.sum()) - 1
    _tree_close(tagg.state["params"], jagg.state["params"], atol=1e-6)
    assert float(base_t.robust_state.quarantine == {}) and tagg.robust_state.quarantine
    # a defense that only keeps state (rollback) leaves the round bitwise undefended
    _, plain = _sync_pair(None)
    _, guarded = _sync_pair(dict(rollback=True))
    for agg in (plain, guarded):
        agg.run_round(_t(b), plan)
    np.testing.assert_equal(params_to_numpy(plain.state["params"]),
                            params_to_numpy(guarded.state["params"]))


def test_sync_manifest_round_trips_and_adopt_model_rewinds_only_the_model():
    _, tagg = _sync_pair(dict(rule="trimmed", rollback=True))
    tagg.run_round(_t(_quad_batches(2, 6, seed=1)), tagg.plan(0))
    tagg.robust_state.add_quarantine([3], 0)
    tagg.robust_state.mark_good(0)
    tree, manifest = tagg.checkpoint()
    assert manifest["robust"] == tagg.robust_state.state_dict()
    _, other = _sync_pair(dict(rule="trimmed", rollback=True))
    other.restore(tree, manifest)
    assert other.robust_state.snapshot_json() == tagg.robust_state.snapshot_json()
    _, clean = _sync_pair(dict(rule="trimmed", rollback=True))
    clean.restore(tree, {k: v for k, v in manifest.items() if k != "robust"})
    assert clean.robust_state.snapshot_json() == \
        TR.RobustState(TR.RobustAggConfig(rule="trimmed", rollback=True)).snapshot_json()
    before = {k: tagg.state[k] for k in ("round", "rng")}
    tagg.run_round(_t(_quad_batches(2, 6, seed=2)), tagg.plan(1))
    tagg.adopt_model({"params": tree["params"], "outer": tree["outer"]})
    np.testing.assert_equal(params_to_numpy(tagg.state["params"]),
                            params_to_numpy(tree["params"]))
    assert tagg.state["round"] == before["round"] + 1
    assert not np.array_equal(tagg.state["rng"], before["rng"])


@pytest.mark.parametrize("kw,match", [
    (dict(robust=dict(rule="median"), fused_server=True), "cannot host a robust rule"),
    (dict(robust=dict(screen=True), cohort_tile=2), "cannot compose with --cohort-tile"),
    (dict(robust=dict(rule="normclip"), cohort_tile=2), "use an absolute"),
    (dict(cohort_tile=0), "cohort_tile must be >= 1"),
    (dict(cohort_tile=2, fused_server=True), "tiled partial-sum layout"),
], ids=["fused", "screen-tile", "normclip-tile", "tile-0", "tile-fused"])
def test_sync_aggregator_refuses_as_the_reference(kw, match):
    robust = kw.pop("robust", None)
    errs = []
    for mod, R, loss, tr in ((J, JR, _quad_j, _j), (T, TR, _quad_t, _t)):
        fed = mod.FederatedConfig(clients_per_round=4, local_steps=1)
        pcfg = mod.ParticipationConfig(population=8, clients_per_round=4)
        with pytest.raises(ValueError, match=match) as e:
            mod.SyncAggregator(loss, fed, pcfg, params=tr(_quad_params()),
                               robust=R.RobustAggConfig(**robust) if robust else None, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# the async door and the async drivers
# ---------------------------------------------------------------------------


def _door_pair(m=4):
    kw = dict(clients_per_round=2, local_steps=1)
    jfed, tfed = J.FederatedConfig(**kw), T.FederatedConfig(**kw)
    acfg = dict(buffer_size=m, staleness_alpha=0.0)
    p = _quad_params()
    js = J.init_async_state(jfed, J.AsyncAggConfig(**acfg), _j(p), jax.random.PRNGKey(0))
    ts = T.init_async_state(tfed, T.AsyncAggConfig(**acfg), _t(p),
                            np.asarray(jax.random.PRNGKey(0)))
    return jfed, tfed, J.AsyncAggConfig(**acfg), T.AsyncAggConfig(**acfg), js, ts


def test_screened_door_matches_the_reference():
    """A NaN delta, an inf one, one over the bound and one under it: the
    same admissions, the same ``screened`` flags, norms to rel 1e-6; a
    refusal takes no slot."""
    jfed, tfed, jacfg, tacfg, js, ts = _door_pair()
    rng = np.random.default_rng(4)
    base = tree_map(lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(np.float32),
                    _quad_params())
    arrivals = [(base, np.inf), (tree_map(lambda x: x * np.float32(np.nan), base), np.inf),
                (tree_map(lambda x: x + np.float32(np.inf), base), np.inf),
                (tree_map(lambda x: x * np.float32(64.0), base), 0.5),
                (base, 0.5), (base, None)]
    for d, bound in arrivals:
        js, jm = J.admit_delta(jfed, jacfg, js, _j(d), jnp.asarray(0, jnp.int32),
                               jnp.asarray(1.0), auto_flush=False, screen=True,
                               norm_bound=None if bound is None else jnp.asarray(bound,
                                                                                 jnp.float32))
        ts, tm = T.admit_delta(tfed, tacfg, ts, _t(d), 0, 1.0, auto_flush=False, screen=True,
                               norm_bound=bound)
        for k in ("accepted", "screened", "buf_count"):
            assert tm[k] == float(jm[k]), k
        if math.isfinite(float(jm["delta_norm"])):
            assert_close(tm["delta_norm"], float(jm["delta_norm"]), rtol=1e-6, what="norm")
        else:
            assert repr(tm["delta_norm"]) == repr(float(jm["delta_norm"]))
    assert ts["buf_count"] == 3  # the clean delta three times; the poison took no slot
    _tree_eq(ts["buffer"], js["buffer"])


def _async_pair(robust_kw, byz_kind="nan", fused=False, codec=None):
    inner = dict(name="sgd", lr_max=0.05, weight_decay=0.0, grad_clip=1e9, warmup_steps=0,
                 total_steps=100, alpha=1.0)
    kw = dict(clients_per_round=4, local_steps=2)
    jfed = J.FederatedConfig(inner=J.InnerOptConfig(**inner), **kw)
    tfed = T.FederatedConfig(inner=T.InnerOptConfig(**inner), **kw)
    acfg = dict(buffer_size=2, staleness_alpha=0.5)
    pkw = dict(population=8, clients_per_round=4, dropout_rate=0.1, weighting="examples")
    p = _quad_params()
    mb = lambda tr: (lambda cid: tr(_quad_batches(2, 1, seed=100 + cid)))  # noqa: E731
    jd = J.AsyncFederationDriver(
        _quad_j, jfed, J.AsyncAggConfig(**acfg),
        J.ParticipationConfig(straggler=J.STRAGGLER_PROFILES["heavy"], **pkw), mb(_j),
        seed=3, params=_j(p), rng=jax.random.PRNGKey(1), fused_server=fused,
        robust=JR.RobustAggConfig(**robust_kw), codec=codec and J.get_codec(codec, fused=fused))
    td = T.AsyncFederationDriver(
        _quad_t, tfed, T.AsyncAggConfig(**acfg),
        T.ParticipationConfig(straggler=T.STRAGGLER_PROFILES["heavy"], **pkw), mb(_t),
        seed=3, params=_t(p), rng=np.asarray(jax.random.PRNGKey(1)), fused_server=fused,
        robust=TR.RobustAggConfig(**robust_kw),
        codec=codec and T.get_codec(codec, fused=fused))
    jd.corrupt_fn = JR.make_byzantine_fn(0.25, byz_kind, 8)
    td.corrupt_fn = TR.make_byzantine_fn(0.25, byz_kind, 8)
    return jd, td


@pytest.mark.parametrize("robust_kw,byz", [
    (dict(screen=True, screen_warmup=2), "nan"),
    (dict(screen=True, screen_warmup=2, rule="trimmed", trim_fraction=0.25), "scale"),
    (dict(rule="median"), "inf"),
], ids=["screen-nan", "screen-trimmed-scale", "median-inf"])
def test_async_drivers_hold_a_byzantine_client(robust_kw, byz):
    jd, td = _async_pair(robust_kw, byz)
    jrows, trows = jd.run_updates(5), td.run_updates(5)
    assert (td.n_dispatched, td.sim_time, td.work_completed, td.work_wasted) == \
        (jd.n_dispatched, jd.sim_time, jd.work_completed, jd.work_wasted)
    for t, j in zip(trows, jrows):
        for k in ("sim_time", "admitted_staleness", "buffer_fill", "nonfinite_deltas"):
            assert t[k] == j[k], k
        assert_close(t["pseudo_grad_norm"], j["pseudo_grad_norm"], rtol=1e-5, what="pg_norm")
    _tree_close(td.state["params"], jd.state["params"], atol=1e-5, rtol=1e-5)
    tm, jm = td.checkpoint()[1], jd.checkpoint()[1]
    assert sorted(tm) == sorted(jm)
    tr, jr = tm.pop("robust"), jm.pop("robust")
    assert tm == jm
    for k in ("quarantine", "last_good", "counters"):
        assert tr[k] == jr[k], k
    assert_close(tr["norm_history"], jr["norm_history"], rtol=1e-5, what="norm_history")
    if robust_kw.get("screen"):
        assert tr["counters"]["screen_rejects"] > 0


def test_fused_int8_flush_of_a_nan_scale_plane_is_the_references():
    """``--fused-server --uplink int8`` with NaN attackers and only
    ``--rollback``: the corrupted scale plane decodes to NaN and the flush's
    pseudo-gradient norm is NaN in both packages at the same updates."""
    jd, td = _async_pair(dict(rollback=True), "nan", fused=True, codec="int8")
    jrows, trows = jd.run_updates(5), td.run_updates(5)
    pg = [(math.isnan(t["pseudo_grad_norm"]), math.isnan(j["pseudo_grad_norm"]))
          for t, j in zip(trows, jrows)]
    assert all(a == b for a, b in pg) and any(a for a, _ in pg), pg
    assert [t["nonfinite_deltas"] for t in trows] == [j["nonfinite_deltas"] for j in jrows]


def test_fold_sorts_in_column_blocks_with_the_same_bits(monkeypatch):
    rng = np.random.default_rng(2)
    tree = {"a": (rng.standard_normal((3, 5, 7)) * 1e-2).astype(np.float32)}
    admit = torch.tensor([True, False, True])
    whole = TR.tile_fold_update(TR.tile_fold_init(_t(_params_like(tree)), 2), _t(tree), admit)
    monkeypatch.setattr(TR, "SORT_COLUMNS", 4)  # 35 columns in 9 blocks
    blocks = TR.tile_fold_update(TR.tile_fold_init(_t(_params_like(tree)), 2), _t(tree), admit)
    for lane in ("top", "bot", "total"):
        np.testing.assert_equal(params_to_numpy(blocks[lane]), params_to_numpy(whole[lane]))
