"""The port's closed-loop control (``repro_torch.control``) against the
reference's, on the CPU.

- The fedmetrics window helpers the policies read are bitwise the
  reference's.
- Fed the same metric rows, both packages' policies (through
  ``FederationController``) return the same ``KnobUpdate`` sequence and the
  same ``state_dict`` JSON, byte for byte; the constructors and
  ``load_state_dict`` refuse in the reference's words.
- The aggregators: a static controller is bitwise no controller (rows,
  state, manifest without ``control``); a governed async run killed and
  resumed through its checkpoint is bitwise the uninterrupted run; the
  buffer resize refuses a non-empty buffer; the knob refusals are the
  reference's.
- Both CLIs: a governed async run and a cohort-tuned sync run resumed from a
  shared checkpoint follow the reference's knob trajectory, with the
  timeline fields bitwise and the losses to rel 2e-2 (bf16 compute, as
  ``test_torch_train.py``); controller state crosses over in both
  directions; every ``--control`` refusal has the reference's wording.
"""
import csv
import dataclasses
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one torch thread)
from torch_parity import assert_close  # noqa: E402

import repro.control as JC  # noqa: E402
import repro.metrics.fedmetrics as JM  # noqa: E402
import repro_torch.control as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.metrics.fedmetrics as TM  # noqa: E402
from repro.launch import train as jt  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import train as tt  # noqa: E402
from repro_torch.metrics import participation_metrics  # noqa: E402
from repro_torch.tree import params_to_numpy, tree_map  # noqa: E402

# ---------------------------------------------------------------------------
# the window helpers and the policies, fed the same rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_helpers_are_the_references(seed):
    rng = np.random.default_rng(seed)
    stal = [float(x) for x in rng.integers(0, 12, size=int(rng.integers(0, 20)))]
    rows = [{"effective_k": float(rng.integers(0, 5)),
             "admitted_staleness": [float(x) for x in rng.integers(0, 9, size=3)]}
            for _ in range(int(rng.integers(0, 5)))]
    rows.append({"effective_k": float("nan"), "admitted_staleness": [float("inf"), 2.0]})
    counts = TM.staleness_hist_counts(stal)
    np.testing.assert_array_equal(counts, JM.staleness_hist_counts(stal))
    for q in (0.0, 0.5, 0.9, 1.0):
        assert TM.histogram_quantile(counts, q) == JM.histogram_quantile(counts, q)
    assert TM.window_mean(rows, "effective_k", -1.0) == JM.window_mean(rows, "effective_k", -1.0)
    assert TM.window_concat(rows, "admitted_staleness") == \
        JM.window_concat(rows, "admitted_staleness")
    with pytest.raises(ValueError, match="bucket counts"):
        TM.histogram_quantile([1.0, 2.0], 0.5)


def _async_rows(rng, n):
    return [{"admitted_staleness": [float(x) for x in rng.integers(0, 10, size=int(rng.integers(0, 6)))],
             "buffer_occupancy": float(rng.random()), "sim_time": float(rng.random() * 9),
             "train_loss_mean": float(rng.random()), "ignored": "x"} for _ in range(n)]


def _sync_rows(rng, n, k=4):
    return [{"effective_k": float(rng.integers(0, k + 1)),
             "partial_rescued_work": float(rng.random()),
             "partial_wasted_work": float(rng.random()),
             "train_loss": float(rng.random() * 5)} for _ in range(n)]


POLICIES = [
    ("staleness", dict(staleness_alpha=0.5, buffer_size=2, target=1.0, buffer_max=8), _async_rows),
    ("staleness", dict(staleness_alpha=1.3, buffer_size=4, target=3.0, quantile=0.5, gain=0.3,
                       deadband=0.1, buffer_max=4), _async_rows),
    ("cohort", dict(clients_per_round=4, deadline=1.5, population=10), _sync_rows),
    ("cohort", dict(clients_per_round=6, deadline=4.0, population=8, target=0.95, gain=0.4,
                    k_min=2), _sync_rows),
]


@pytest.mark.parametrize("policy,kw,rows", POLICIES, ids=["gov", "gov-tight", "cohort",
                                                          "cohort-pinned"])
@pytest.mark.parametrize("window,interval", [(4, 1), (2, 3)])
def test_policies_fed_the_same_rows_make_the_same_updates(policy, kw, rows, window, interval):
    ctl = {m: m.build_controller(policy, window=window, interval=interval, **kw)
           for m in (JC, TC)}
    rng = np.random.default_rng(7)
    n_updates = 0
    for row in rows(rng, 40):
        uj, ut = ctl[JC].observe(dict(row)), ctl[TC].observe(dict(row))
        assert (uj is None) == (ut is None)
        if ut is not None:
            n_updates += 1
            assert ut.knob_dict() == uj.knob_dict() and ut.evidence == uj.evidence
            assert ut.changed and uj.changed
        assert json.dumps(ctl[TC].state_dict()) == json.dumps(ctl[JC].state_dict())
        assert ctl[TC].knobs() == ctl[JC].knobs()
    assert n_updates > 0
    # the state crosses over both ways and continues identically
    for src, dst in ((JC, TC), (TC, JC)):
        other = dst.build_controller(policy, window=window, interval=interval, **kw)
        other.load_state_dict(json.loads(json.dumps(ctl[src].state_dict())))
        assert json.dumps(other.state_dict()) == json.dumps(ctl[src].state_dict())


def _message(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("case", [
    lambda m: m.build_controller("chaotic"),
    lambda m: m.StalenessGovernor(quantile=0.0),
    lambda m: m.StalenessGovernor(target=-1.0),
    lambda m: m.CohortTuner(clients_per_round=4, deadline=0.0, population=8),
    lambda m: m.CohortTuner(clients_per_round=4, deadline=1.0, population=8, target=1.5),
    lambda m: m.FederationController(m.StaticPolicy(), window=0),
    lambda m: m.FederationController(m.StaticPolicy(), interval=0),
    lambda m: m.build_controller("staleness").load_state_dict(
        m.build_controller("cohort", clients_per_round=4, deadline=1.0,
                           population=8).state_dict()),
    lambda m: m.StalenessGovernor().load_state_dict({"nope": 1}),
], ids=["unknown", "quantile", "target", "deadline", "cohort-target", "window", "interval",
        "policy-mismatch", "field"])
def test_control_refusals_are_the_references(case):
    assert _message(lambda: case(TC)) == _message(lambda: case(JC))


def test_knob_update_and_registry_are_the_references():
    assert sorted(TC.CONTROL_POLICIES) == sorted(JC.CONTROL_POLICIES)
    assert (TC.ALPHA_STEP, TC.ALPHA_MAX, TC.DEADLINE_STEP) == \
        (JC.ALPHA_STEP, JC.ALPHA_MAX, JC.DEADLINE_STEP)
    assert TC.CONTROL_KEYS == JC.CONTROL_KEYS
    u = TC.KnobUpdate(buffer_size=4, deadline=1.5)
    assert u.changed and u.knob_dict() == {"buffer_size": 4.0, "deadline": 1.5}
    assert not TC.KnobUpdate().changed
    assert TC.build_controller("static") is None
    assert not TC.FederationController(TC.StaticPolicy()).enabled


# ---------------------------------------------------------------------------
# the aggregators (the quadratic model)
# ---------------------------------------------------------------------------

TAU = 3


def _quad(params, batch):
    loss = torch.mean(torch.square(batch["x"] @ params["w"] + params["b"][0] - batch["y"]))
    return loss, {"loss": loss}


def _params():
    rng = np.random.default_rng(0)
    return tree_map(torch.from_numpy, {"w": rng.standard_normal((4, 4)).astype(np.float32),
                                       "b": [(rng.standard_normal(4) * 0.1).astype(np.float32)]})


def _batches(cid, c=1):
    rng = np.random.default_rng(100 + cid)
    return {k: torch.from_numpy(rng.standard_normal((TAU, c, 8, 4)).astype(np.float32))
            for k in ("x", "y")}


def _cfgs(k=4, pop=8):
    sgd = T.InnerOptConfig(name="sgd", lr_max=0.05, weight_decay=0.0, grad_clip=1e9,
                           warmup_steps=0, total_steps=10_000, alpha=1.0)
    fed = T.FederatedConfig(clients_per_round=k, local_steps=TAU, inner=sgd)
    pcfg = T.ParticipationConfig(population=pop, clients_per_round=k, dropout_rate=0.1,
                                 straggler=T.STRAGGLER_PROFILES["heavy"])
    return fed, pcfg


def _async(controller=None, state=None, dispatch=None, codec=None):
    fed, pcfg = _cfgs()
    acfg = T.AsyncAggConfig(buffer_size=2, staleness_alpha=0.5)
    return T.AsyncFederationDriver(_quad, fed, acfg, pcfg, _batches, seed=3, params=_params(),
                                   rng=T.prng_key(0), controller=controller, state=state,
                                   dispatch=dispatch, codec=codec, fused_server=True)


def _governor(target=0.5):
    return TC.FederationController(TC.StalenessGovernor(staleness_alpha=0.5, buffer_size=2,
                                                        target=target, buffer_max=4))


def _assert_checkpoints_equal(a, b):
    (ta, ma), (tb, mb) = a.checkpoint(), b.checkpoint()
    assert ma == mb
    fa, fb = params_to_numpy(ta), params_to_numpy(tb)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_a_static_controller_is_bitwise_no_controller():
    a, b = _async(), _async(TC.FederationController(TC.StaticPolicy()))
    assert a.run_updates(5) == b.run_updates(5)
    _assert_checkpoints_equal(a, b)
    assert "control" not in b.checkpoint()[1]
    fed, pcfg = _cfgs()
    runs = []
    for ctl in (None, TC.FederationController(TC.StaticPolicy())):
        agg = T.SyncAggregator(_quad, fed, pcfg, seed=2, params=_params(), controller=ctl,
                               fused_server=True)
        rows = []
        for r in range(3):
            m = {k: float(v) for k, v in agg.run_round(_batches(0, 4), agg.plan(r)).items()}
            rows.append((m, agg.control_step(m)))
        runs.append((rows, agg))
    assert runs[0][0] == runs[1][0]
    _assert_checkpoints_equal(runs[0][1], runs[1][1])


def test_the_governor_resizes_the_buffer_at_flushes_and_resumes_bitwise(tmp_path):
    drv = _async(_governor())
    rows = drv.run_updates(6)
    fills = [r["buffer_fill"] for r in rows]
    assert fills == [2.0, 1.0, 2.0, 4.0, 4.0, 4.0], fills  # M moved 2 → 1 → 2 → 4
    assert [r.get("knob_buffer_size") for r in rows[:3]] == [1.0, 2.0, 4.0]
    assert drv.acfg.buffer_size == 4 and drv.n_flushes == 6
    # killed after update 2, resumed from its checkpoint: bitwise the rest
    part = _async(_governor())
    head = part.run_updates(3)
    tree, manifest = part.checkpoint()
    ck = CheckpointManager(str(tmp_path))
    ck.save_server(2, tree, extra={"aggregator": manifest})
    ctl = _governor()
    ctl.load_state_dict(manifest["control"])
    fed, pcfg = _cfgs()
    acfg = T.AsyncAggConfig(buffer_size=int(ctl.knobs()["buffer_size"]),
                            staleness_alpha=ctl.knobs()["staleness_alpha"])
    like = T.AsyncBufferAggregator.checkpoint_template(fed, acfg, pcfg, _params())
    state, man = ck.load_server(2, like)
    resumed = T.AsyncFederationDriver(_quad, fed, acfg, pcfg, _batches, seed=3, state=state,
                                      dispatch=man["extra"]["aggregator"], controller=ctl,
                                      fused_server=True)
    tail = resumed.run_updates(3)
    strip = lambda rs: [{k: v for k, v in r.items() if k != "update"} for r in rs]  # noqa: E731
    assert strip(head + tail) == strip(rows)
    _assert_checkpoints_equal(drv, resumed)


def test_the_cohort_tuner_moves_k_between_sync_rounds():
    fed, pcfg = _cfgs(k=4, pop=8)
    pcfg = T.ParticipationConfig(
        population=8, clients_per_round=4, dropout_rate=0.2,
        straggler=dataclasses.replace(T.STRAGGLER_PROFILES["heavy"], deadline=4.0))
    ctl = TC.FederationController(TC.CohortTuner(clients_per_round=4, deadline=4.0,
                                                 population=8, target=0.95))
    agg = T.SyncAggregator(_quad, fed, pcfg, seed=0, params=_params(), controller=ctl,
                           fused_server=True)
    widths = []
    for r in range(4):
        plan = agg.plan(r)
        widths.append(len(plan.selected))
        m = {k: float(v) for k, v in agg.run_round(_batches(0, len(plan.selected)), plan).items()}
        m.update(participation_metrics(plan))
        agg.control_step(m)
    assert widths == [4, 6, 8, 8], widths
    assert agg.fed.clients_per_round == agg.pcfg.clients_per_round == 8
    assert agg.checkpoint()[1]["control"]["state"]["clients_per_round"] == 8


def test_knob_refusals_are_the_references():
    import jax
    import jax.numpy as jnp

    import repro.core as J

    jp = {"w": jnp.zeros((4, 4)), "b": [jnp.zeros(4)]}
    sgd = dict(name="sgd", lr_max=0.05, weight_decay=0.0, grad_clip=1e9, warmup_steps=0,
               total_steps=100, alpha=1.0)
    fed_j = J.FederatedConfig(clients_per_round=2, local_steps=TAU,
                              inner=J.InnerOptConfig(**sgd), keep_inner_state=True)
    fed_t = T.FederatedConfig(clients_per_round=2, local_steps=TAU,
                              inner=T.InnerOptConfig(**sgd), keep_inner_state=True)
    pj = J.ParticipationConfig(population=4, clients_per_round=2)
    pt = T.ParticipationConfig(population=4, clients_per_round=2)
    sj = J.SyncAggregator(lambda p, b: (0.0, {}), fed_j, pj, params=jp,
                          rng=jax.random.PRNGKey(0))
    st = T.SyncAggregator(_quad, fed_t, pt, params=_params())
    for update in (JC.KnobUpdate(buffer_size=2), JC.KnobUpdate(clients_per_round=4)):
        tu = TC.KnobUpdate(**{k: getattr(update, k) for k in ("buffer_size",
                                                                 "clients_per_round")})
        assert _message(lambda: st.apply_knobs(tu)) == _message(lambda: sj.apply_knobs(update))
    drv = _async()
    assert _message(lambda: drv.apply_knobs(TC.KnobUpdate(deadline=1.0)))[1].startswith(
        "async control drives staleness_alpha/buffer_size only")
    while int(drv.state["buf_count"]) == 0:
        drv.step()
    kind, msg = _message(lambda: drv.apply_knobs(TC.KnobUpdate(buffer_size=4)))
    assert kind == "RuntimeError" and "knob updates must land at a flush boundary" in msg


# ---------------------------------------------------------------------------
# both CLIs
# ---------------------------------------------------------------------------

BASE = ["--reduced", "--local-steps", "2", "--clients", "4", "--population", "8",
        "--seq-len", "64", "--fused-server", "--straggler-profile", "heavy",
        "--eval-batches", "1"]
GOVERNED = BASE + ["--aggregation", "async", "--control", "staleness", "--control-target", "0.5"]
COHORT = BASE + ["--control", "cohort", "--deadline", "4", "--dropout-rate", "0.2",
                 "--control-target", "0.95"]
EXACT = {"async": ("buffer_fill", "staleness_mean", "staleness_max", "sim_time",
                   "deltas_admitted", "work_completed", "work_wasted", "knob_buffer_size",
                   "knob_staleness_alpha"),
         "sync": ("effective_k", "selected", "contributors", "knob_clients_per_round",
                  "knob_deadline")}


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _compare(t_rows, j_rows, kind):
    assert len(t_rows) == len(j_rows) > 0
    for t, j in zip(t_rows, j_rows):
        for k in EXACT[kind]:
            assert t.get(k) == j.get(k), (k, t.get(k), j.get(k))
        assert_close(float(t["train_loss"]), float(j["train_loss"]), rtol=2e-2,
                     what="train_loss")


@pytest.mark.parametrize("kind,args,rounds", [("async", GOVERNED, 5), ("sync", COHORT, 4)],
                         ids=["governed-async", "cohort-sync"])
def test_both_clis_follow_the_same_knob_trajectory_from_a_shared_checkpoint(tmp_path, kind,
                                                                            args, rounds):
    ck = tmp_path / "ck"
    jt.run(jt.parse_args(args + ["--rounds", "1", "--ckpt-dir", str(ck)]))
    shutil.copytree(ck, tmp_path / "ck_t")
    jt.run(jt.parse_args(args + ["--rounds", str(rounds), "--ckpt-dir", str(ck), "--resume",
                                 "--log", str(tmp_path / "j.csv")]))
    tt.run(tt.parse_args(args + ["--rounds", str(rounds), "--ckpt-dir", str(tmp_path / "ck_t"),
                                 "--resume", "--log", str(tmp_path / "t.csv"),
                                 "--device", "cpu"]))
    j_rows, t_rows = _rows(tmp_path / "j.csv"), _rows(tmp_path / "t.csv")
    _compare(t_rows, j_rows, kind)
    assert any(r.get("knob_" + ("buffer_size" if kind == "async" else "clients_per_round"))
               for r in t_rows)
    # the port's last checkpoint resumes in the reference with the same controller
    last = f"round_{rounds - 1:06d}"
    with open(tmp_path / "ck_t" / last / "manifest.json") as f:
        t_ctl = json.load(f)["extra"]["aggregator"]["control"]
    with open(ck / last / "manifest.json") as f:
        j_ctl = json.load(f)["extra"]["aggregator"]["control"]
    assert t_ctl["history"] == j_ctl["history"] and t_ctl["state"] == j_ctl["state"]
    jout = jt.run(jt.parse_args(args + ["--rounds", str(rounds + 1), "--ckpt-dir",
                                        str(tmp_path / "ck_t"), "--resume"]))
    assert len(jout["history"]) == 1


def test_a_governed_cli_run_resumes_bitwise_and_static_is_the_default(tmp_path):
    args = GOVERNED + ["--device", "cpu", "--rounds", "5"]
    ck = tmp_path / "ck"
    tt.run(tt.parse_args(args + ["--ckpt-dir", str(ck), "--log", str(tmp_path / "a.csv")]))
    shutil.rmtree(ck / "round_000004")
    shutil.rmtree(ck / "round_000003")
    tt.run(tt.parse_args(args + ["--ckpt-dir", str(ck), "--resume",
                                 "--log", str(tmp_path / "b.csv")]))
    want, got = _rows(tmp_path / "a.csv")[3:], _rows(tmp_path / "b.csv")
    assert len(got) == 2 and got[0]["knob_staleness_alpha"] == "2.0"
    for w, g in zip(want, got):
        for k in w:  # b.csv's header lacks the knob columns its rows never set
            if k not in ("seconds", "val_ppl"):
                assert g.get(k, "") == w[k], k
    # --control static is the uncontrolled run, row for row
    plain = BASE + ["--aggregation", "async", "--device", "cpu", "--rounds", "2"]
    a = tt.run(tt.parse_args(plain))["history"]
    b = tt.run(tt.parse_args(plain + ["--control", "static"]))["history"]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "seconds"} for r in rs]  # noqa: E731
    assert strip(a) == strip(b)


SMALL = ["--reduced", "--rounds", "1", "--local-steps", "2", "--clients", "2",
         "--population", "4", "--seq-len", "64"]


@pytest.mark.parametrize("extra", [
    ["--control", "staleness"],
    ["--control", "cohort", "--aggregation", "async"],
    ["--control", "cohort", "--keep-opt"],
    ["--control", "cohort"],
    ["--control", "cohort", "--straggler-profile", "heavy", "--runtime", "sockets"],
], ids=lambda x: "_".join(a.strip("-") for a in x))
def test_cli_control_refusals_have_the_references_wording(extra):
    msgs = []
    for mod, dev in ((jt, []), (tt, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            mod.run(mod.parse_args(SMALL + extra + dev))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and len(msgs[0]) > 20, msgs


@pytest.mark.parametrize("first,then", [
    (["--control", "staleness"], []),
    ([], ["--control", "staleness"]),
    (["--control", "staleness"], ["--control", "staleness", "--control-gain", "0.3"]),
], ids=["governed-then-static", "static-then-governed", "changed-gain"])
def test_cli_control_resume_refusals_have_the_references_wording(tmp_path, first, then):
    args = SMALL + ["--aggregation", "async", "--straggler-profile", "heavy"]
    ck = tmp_path / "ck"
    jt.run(jt.parse_args(args + first + ["--ckpt-dir", str(ck)]))
    resume = ["--rounds", "2", "--resume"]
    msgs = []
    for mod, dev, d in ((jt, [], "j"), (tt, ["--device", "cpu"], "t")):
        shutil.copytree(ck, tmp_path / d)
        with pytest.raises(SystemExit) as e:
            mod.run(mod.parse_args(args + then + resume + ["--ckpt-dir", str(tmp_path / d)]
                                   + dev))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and len(msgs[0]) > 20, msgs
