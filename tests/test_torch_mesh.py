"""The port's mesh tooling against the reference, on the CPU.

- Specs: the reference's divisibility cases; ``param_pspec`` of every leaf
  of every registered arch at (16, 16), (2, 16, 16) and (4, 4), the logical
  axes key path by key path, ``choose_client_mapping`` and every
  ``decode_cache_pspec`` kind — all equal to the reference's (specs compared
  as tuples, a one-name tuple entry read as the name, as JAX reads it).
- Steps that run: ``remat`` bitwise its plain twin and within the family
  tolerance (``FAMILY_TOL``) of the reference's ``remat=True``; pre-split
  rounds and centralized steps bitwise the reshaped ones; the host-mesh
  train step (float32 and int8 with ``fused_server``), prefill and decode
  of reduced qwen3-1.7b and mamba2-1.3b against the reference's on a
  one-device mesh (at round 0 params abs 1e-5 and metrics rel 1e-4, as
  ``test_torch_federated.py``'s rounds; past the warmup the update of the
  params and of FedMom's lane to 1e-3 of the reference update's norm;
  logits to ``FAMILY_TOL`` of their largest entry).
- ``autobatch``'s estimate exactly the reference's; the op counter exact on
  a matmul, an elementwise op and a view, and within 0.85–1.15× of the
  reference's ``hlo_analyzer`` FLOPs (0.5–2× its bytes) on a reduced qwen3
  loss.
"""
import dataclasses

import numpy as np
import pytest

from torch_parity import (FAMILY_TOL, assert_close, assert_metrics_close, assert_trees_close,
                          family_pair, family_tokens, jax_flat, jax_to_torch, torch_flat,
                          update_rel_err)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as j_cfg  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.common import is_desc  # noqa: E402
from repro.sharding import specs as j_sh  # noqa: E402
from repro_torch.configs import InputShape  # noqa: E402
from repro_torch.configs import get_config as t_cfg  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models.common import param_axes  # noqa: E402
from repro_torch.sharding import specs as t_sh  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_flatten, tree_unflatten  # noqa: E402

GiB16 = 16 * 1024 ** 3
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x4": ((4, 4), ("data", "model"))}


def norm_spec(spec):
    """A spec as a plain tuple: a one-name tuple entry as the name, no
    trailing None."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else (None if e == () else e)
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in out)


def meshes(name, hbm=GiB16):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), Mesh(shape, axes, hbm)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def test_param_pspec_divisibility_rules():
    """The reference's cases (tests/test_sharding_dryrun.py) on the port."""
    P = t_sh.P
    mesh = Mesh((1, 16), ("data", "model"), GiB16)
    assert t_sh.param_pspec(mesh, ("ffn", None), (8192, 64)) == P("model", None)
    assert t_sh.param_pspec(mesh, ("kv_heads", None), (8, 64)) == P(None, None)
    assert t_sh.param_pspec(mesh, (None, "heads", "head_dim"), (512, 56, 128)) == \
        P(None, None, "model")
    assert t_sh.param_pspec(mesh, (None, "kv_heads", "head_dim"), (512, 8, 64)) == \
        P(None, None, "model")
    assert t_sh.param_pspec(mesh, ("layers", "ffn"), (40, 8192)) == P(None, "model")
    assert t_sh.param_pspec(mesh, ("vocab", "ffn"), (4096, 4096)) == P("model", None)


def _paths(tree, prefix=""):
    """The tree with each leaf replaced by its key path string."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths(v, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return prefix


def _leaf_descs(tree, is_leaf=None):
    if is_leaf is None:
        return {p: d for p, d in flatten_with_paths(tree)}
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {jax.tree_util.keystr(p): d for p, d in leaves}


@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_param_axes_and_every_leaf_spec_match_the_reference(arch):
    """``param_axes(model.desc())`` equals the reference's key path by key
    path, and ``param_pspec`` (with the FSDP axes of the hierarchical
    mapping, as ``params_pspecs`` places them) of every leaf equals the
    reference's at (16, 16), (2, 16, 16) and (4, 4)."""
    jd = _leaf_descs(j_build(j_cfg(arch)).desc(), is_desc)
    tdesc = t_build(t_cfg(arch)).desc()
    td = _leaf_descs(tdesc)
    assert sorted(jd) == sorted(td)
    from repro.models.common import param_axes as j_param_axes

    want = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(
        j_param_axes(j_build(j_cfg(arch)).desc()), is_leaf=lambda x: isinstance(x, tuple))[0]}
    got = {}
    t_sh.map_leaves(lambda d, a: got.setdefault(d, a), _paths(tdesc), param_axes(tdesc))
    assert got == want
    for path in jd:
        assert td[path].axes == jd[path].axes and td[path].shape == jd[path].shape, path
    for name in MESHES:
        jm, tm = meshes(name)
        for fsdp in ((), ("data",)):
            for path, d in jd.items():
                want = j_sh.add_fsdp_axes(j_sh.param_pspec(jm, d.axes, d.shape), d.shape, jm,
                                          fsdp, d.axes)
                got = t_sh.add_fsdp_axes(t_sh.param_pspec(tm, d.axes, d.shape), d.shape, tm,
                                         fsdp, d.axes)
                assert norm_spec(got) == norm_spec(want), (name, fsdp, path, got, want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_choose_client_mapping_matches_the_reference(mesh_name):
    for hbm in (GiB16, 80e9, 2 * 1024 ** 3):
        jm, tm = meshes(mesh_name, hbm)
        for n in (10 ** 6, 1.3e9, 3e9, 7e9, 17e9, 33e9, 52e9, 1e11, 1e12):
            want = j_sh.choose_client_mapping(jm, int(n), hbm)
            assert t_sh.choose_client_mapping(tm, int(n)) == want, (hbm, n)
            assert t_sh.choose_client_mapping(tm, int(n), hbm) == want, (hbm, n)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_decode_cache_pspec_matches_the_reference_for_every_kind(mesh_name):
    jm, tm = meshes(mesh_name)
    cases = [("kv", (128, 32768, 8, 128)), ("kv", (1, 524288, 4, 256)), ("kv", (4, 64, 2, 8)),
             ("cross", (128, 1500, 20, 64)), ("cross", (2, 1500, 20, 64)),
             ("conv", (128, 3, 4352)), ("conv", (1, 3, 4352)), ("conv", (64, 3, 100)),
             ("ssd", (128, 64, 64, 128)), ("ssd", (1, 64, 64, 128)), ("ssd", (32, 8, 64, 16)),
             ("ssd", (32, 20, 64, 16))]
    for kind, shape in cases:
        for long_ctx in (False, True):
            want = j_sh.decode_cache_pspec(jm, shape, kind, long_ctx)
            got = t_sh.decode_cache_pspec(tm, shape, kind, long_ctx)
            assert norm_spec(got) == norm_spec(want), (kind, shape, long_ctx, got, want)
    with pytest.raises(ValueError):
        t_sh.decode_cache_pspec(tm, (1, 2), "nope", False)


def test_spec_helpers_match_the_reference():
    for name in MESHES:
        jm, tm = meshes(name)
        assert t_sh.client_axes(tm) == j_sh.client_axes(jm)
        assert t_sh.n_clients(tm) == j_sh.n_clients(jm)
        for nd in (2, 3, 5):
            assert norm_spec(t_sh.train_batch_pspec(tm, nd)) == \
                norm_spec(j_sh.train_batch_pspec(jm, nd))
            assert norm_spec(t_sh.central_batch_pspec(tm, nd)) == \
                norm_spec(j_sh.central_batch_pspec(jm, nd))
        spec = t_sh.P(None, "model")
        assert norm_spec(t_sh.clientize_pspec(tm, spec)) == \
            norm_spec(j_sh.clientize_pspec(jm, j_sh.P(None, "model")))
    assert t_sh.AXIS_RULES == j_sh.AXIS_RULES


def test_params_shardings_are_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    model = t_build(t_cfg("qwen3-1.7b"))
    mesh = make_production_mesh(multi_pod=True, hbm_bytes=GiB16)
    placements = t_sh.params_shardings(mesh, model.axes(), model.shapes())
    specs = t_sh.params_pspecs(mesh, model.axes(), model.shapes())
    assert placements["embed"] == (Replicate(), Replicate(), Shard(0))  # vocab over model
    wq = placements["segments"][0]["pos0"]["mixer"]["wq"]
    assert specs["segments"][0]["pos0"]["mixer"]["wq"] == t_sh.P(None, None, "model", None)
    assert wq == (Replicate(), Replicate(), Shard(2))
    assert t_sh.placements(mesh, t_sh.P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))


def test_meshes_and_shard_hint(monkeypatch):
    """The production meshes carry the data sheet's memory whatever the
    host; the host mesh covers its one device. ``shard_hint`` is left out by
    design (``tests/test_torch_names.py``): on one card it could only be the
    identity. What it refused, a real step over more than one device, the
    federated steps refuse before they lay out a client-stacked tree."""
    import repro_torch.models.common as common
    from repro_torch.launch.mesh import H100_SXM_HBM_BYTES
    from repro_torch.launch.steps import build_train_step

    prod = make_production_mesh()
    assert (prod.size, prod.axis_names, prod.hbm_bytes) == (256, ("data", "model"),
                                                            H100_SXM_HBM_BYTES)
    assert make_production_mesh(multi_pod=True, hbm_bytes=GiB16).shape == \
        {"pod": 2, "data": 16, "model": 16}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # a host with a card
    assert make_production_mesh().hbm_bytes == H100_SXM_HBM_BYTES
    monkeypatch.undo()
    host = make_host_mesh(device="cpu")
    assert (host.size, dict(host.shape), host.device.type) == (1, {"data": 1, "model": 1}, "cpu")
    host.require_one_device()
    with pytest.raises(NotImplementedError, match="spans 256 devices"):
        prod.require_one_device()
    assert not hasattr(common, "shard_hint")
    shape = InputShape("train_4k", 64, 32, "train")
    for kw in ({}, {"cohort_tile": 16}):
        step = build_train_step(t_cfg("photon-75m").reduced(), shape, prod, tau_lowered=1, **kw)
        with pytest.raises(NotImplementedError, match="spans 256 devices"):
            step.fn(*step.args)


# ---------------------------------------------------------------------------
# remat and pre-split micro-batches
# ---------------------------------------------------------------------------


def _loss_and_grads(tm, tp, toks, remat):
    leaves, treedef = tree_flatten(tp)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss, metrics = tm.loss(tree_unflatten(treedef, leaves), {"tokens": torch.from_numpy(toks)},
                            remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        torch_flat(tree_unflatten(treedef, list(grads)))


@pytest.mark.parametrize("arch", ["photon-75m", "qwen3-1.7b", "mamba2-1.3b", "deepseek-moe-16b"])
def test_remat_is_bitwise_its_plain_twin_and_matches_the_reference(arch):
    jm, tm, jp, tp = family_pair(arch)
    toks = family_tokens(jm.cfg, 2, 48, seed=4)
    l0, m0, g0 = _loss_and_grads(tm, tp, toks, remat=False)
    l1, m1, g1 = _loss_and_grads(tm, tp, toks, remat=True)
    assert torch.equal(l0, l1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert sorted(g0) == sorted(g1) and all(np.array_equal(g0[k], g1[k]) for k in g0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=True), has_aux=True))(jp, {"tokens": jnp.asarray(toks)})
    assert_close(float(l1), float(jl), rtol=FAMILY_TOL, what="loss")
    jg = jax_flat(jg)
    g_max = max(float(np.abs(v).max()) for v in jg.values())
    for k in jg:
        assert_close(g1[k], jg[k], atol=FAMILY_TOL * g_max, what=f"grad {k}")


def _photon_round_pieces(grad_accum):
    from repro_torch.core import FederatedConfig, InnerOptConfig, init_federated_state

    cfg = dataclasses.replace(t_cfg("photon-75m").reduced(), compute_dtype="float32")
    model = t_build(cfg)
    fed = FederatedConfig(clients_per_round=2, local_steps=2, grad_accum=grad_accum,
                          inner=InnerOptConfig(lr_max=1e-3, warmup_steps=1, total_steps=10))
    state = init_federated_state(fed, model.init(0, device="cpu"))
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 2, 4, 32)).astype(np.int32)
    return model, fed, state, torch.from_numpy(toks)


def _assert_bitwise(a, b):
    fa, fb = torch_flat(a), torch_flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("grad_accum", [1, 2, 4])
def test_pre_split_round_and_centralized_step_are_bitwise_the_reshaped_ones(grad_accum):
    """``pre_split_micro`` / ``pre_split`` take micro-batch i as row i of a
    leading dim; the reshaped path cuts the batch dim the same way, so both
    run the same micro-batches in the same order: bitwise."""
    from repro_torch.core import (InnerOptConfig, centralized_step, federated_round,
                                  init_centralized_state)

    model, fed, state, toks = _photon_round_pieces(grad_accum)
    split = toks.reshape(toks.shape[:2] + (grad_accum, 4 // grad_accum) + toks.shape[3:])
    flat_state, flat_m = federated_round(model.loss, fed, state, {"tokens": toks})
    pre_state, pre_m = federated_round(model.loss, dataclasses.replace(fed, pre_split_micro=True),
                                       state, {"tokens": split})
    _assert_bitwise(pre_state["params"], flat_state["params"])
    _assert_bitwise(pre_state["outer"], flat_state["outer"])
    assert all(torch.equal(pre_m[k], flat_m[k]) for k in flat_m)

    inner = InnerOptConfig(lr_max=1e-3, warmup_steps=1, total_steps=10)
    cstate = init_centralized_state(inner, state["params"])
    a, am = centralized_step(model.loss, inner, cstate, {"tokens": toks[0, 0]},
                             grad_accum=grad_accum)
    b, bm = centralized_step(model.loss, inner, cstate, {"tokens": split[0, 0]},
                             grad_accum=grad_accum, pre_split=True)
    _assert_bitwise(a, b)
    assert sorted(am) == sorted(bm)
    assert all(torch.equal(torch.as_tensor(am[k]), torch.as_tensor(bm[k])) for k in am)


# ---------------------------------------------------------------------------
# Host-mesh steps against the reference's one-device mesh
# ---------------------------------------------------------------------------


def _pair_cfgs(arch):
    kw = dict(compute_dtype="float32")
    return (dataclasses.replace(j_cfg(arch).reduced(), **kw),
            dataclasses.replace(t_cfg(arch).reduced(), **kw))


def _j_mesh():
    """The reference's host mesh: one CPU device, (data=1, model=1)."""
    from repro.launch.mesh import make_host_mesh as j_host_mesh

    mesh = j_host_mesh()
    assert mesh.size == 1
    return mesh


#: the round the host-mesh train steps start from: past the inner cosine's
#: 100-step warmup at τ = 2, so each local step moves the params by about
#: lr_max (at round 0 the two steps' rates are 0 and 3e-6)
PAST_WARMUP = 100
#: the host-mesh step's update (params and FedMom's lane) against the
#: reference's, relative to the reference update's norm (update_rel_err)
UPDATE_RTOL = 1e-3


@pytest.mark.parametrize("uplink", ["float32", "int8"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_host_mesh_train_step_matches_the_reference(arch, uplink):
    """``build_train_step`` at a global batch of 4, τ = 2, ``fused_server``:
    the port's host mesh against the reference's one-device mesh from the
    reference's init params and the same tokens. At round 0 with a zero
    FedMom lane the new params and lane are held as values (abs 1e-5); from
    round ``PAST_WARMUP`` with a seeded lane, where the step moves them by
    ~1e-3, as updates (``UPDATE_RTOL`` of the reference update's norm)."""
    from repro.configs import InputShape as JShape
    from repro.core import init_federated_state as j_init_state
    from repro.launch.steps import build_train_step as j_build_step
    from repro_torch.launch.steps import build_train_step, materialize

    jcfg, tcfg = _pair_cfgs(arch)
    jstep = j_build_step(jcfg, JShape("train_4k", 64, 4, "train"), _j_mesh(), tau_lowered=2,
                         fused_server=True, uplink=uplink)
    tstep = build_train_step(tcfg, InputShape("train_4k", 64, 4, "train"),
                             make_host_mesh(device="cpu"), tau_lowered=2, fused_server=True,
                             uplink=uplink)
    assert tstep.meta == jstep.meta and tstep.meta["fused_server"]
    assert tstep.arg_kinds == ("fed_state", "batch", "weights")
    jp = j_build(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size,
                        tuple(tstep.args[1]["tokens"].shape)).astype(np.int32)
    assert toks.shape == tuple(jstep.args[1]["tokens"].shape) == (2, 1, 1, 4, 64)
    mom = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 3e-4).astype(np.float32), jp)

    def both(round_, momentum):
        # copies: the reference's call donates its state
        js = j_init_state(_fed_of(jstep), jax.tree_util.tree_map(jnp.copy, jp))
        state, _, w = materialize(tstep, "cpu", seed=0)
        state["params"], state["round"] = jax_to_torch(jp), round_
        js["round"] = jnp.int32(round_)
        if momentum is not None:
            js["outer"]["momentum"] = jax.tree_util.tree_map(jnp.asarray, momentum)
            state["outer"]["momentum"] = jax_to_torch(momentum)
        j_new, j_met = jstep.fn(js, {"tokens": jnp.asarray(toks)}, jnp.ones((1,), jnp.float32))
        t_new, t_met = tstep.fn(state, {"tokens": torch.from_numpy(toks)}, w)
        assert t_new["round"] == int(j_new["round"]) == round_ + 1
        assert_metrics_close(t_met, j_met, rtol=1e-4, atol=1e-6)
        return t_new, j_new

    t_new, j_new = both(0, None)
    assert_trees_close(t_new["params"], j_new["params"], atol=1e-5)
    assert_trees_close(t_new["outer"]["momentum"], j_new["outer"]["momentum"], atol=1e-5)

    t_new, j_new = both(PAST_WARMUP, mom)
    err_p = update_rel_err(torch_flat(t_new["params"]), jax_flat(j_new["params"]), jax_flat(jp))
    err_m = update_rel_err(torch_flat(t_new["outer"]["momentum"]),
                           jax_flat(j_new["outer"]["momentum"]), jax_flat(mom))
    assert err_p <= UPDATE_RTOL and err_m <= UPDATE_RTOL, (err_p, err_m)


def _fed_of(jstep):
    from repro.launch.steps import default_fed_config

    return dataclasses.replace(default_fed_config(1, 2, jstep.meta["grad_accum"]),
                               pre_split_micro=True)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_host_mesh_prefill_and_decode_steps_match_the_reference(arch):
    from repro.configs import InputShape as JShape
    from repro.launch.steps import build_decode_step as j_decode
    from repro.launch.steps import build_prefill_step as j_prefill
    from repro_torch.launch.steps import build_decode_step, build_prefill_step, materialize

    jcfg, tcfg = _pair_cfgs(arch)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                j_build(jcfg).init(jax.random.PRNGKey(1)))
    tp = jax_to_torch(jp)
    tmesh = make_host_mesh(device="cpu")
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)

    jstep = j_prefill(jcfg, JShape("prefill_32k", 32, 2, "prefill"), _j_mesh())
    tstep = build_prefill_step(tcfg, InputShape("prefill_32k", 32, 2, "prefill"), tmesh)
    assert (tstep.name, tstep.meta, tstep.model_flops) == (jstep.name, jstep.meta,
                                                           jstep.model_flops)
    j_logits, _ = jstep.fn(jp, {"tokens": jnp.asarray(toks)})
    t_logits, _ = tstep.fn(tp, {"tokens": torch.from_numpy(toks)})
    j_logits = np.asarray(j_logits, np.float32)
    assert_close(t_logits.float().numpy(), j_logits,
                 atol=FAMILY_TOL * float(np.abs(j_logits).max()), what="prefill logits")

    shape = ("decode_32k", 16, 2, "decode")
    jstep = j_decode(jcfg, JShape(*shape), _j_mesh())
    tstep = build_decode_step(tcfg, InputShape(*shape), tmesh)
    assert (tstep.name, tstep.meta, tstep.model_flops) == (jstep.name, jstep.meta,
                                                           jstep.model_flops)
    _, cache, _, idx = materialize(tstep, "cpu", seed=0)
    assert idx == 15
    jcache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), jstep.args[1])
    tok = toks[:, :1]
    j_logits, _ = jstep.fn(jp, jcache, jnp.asarray(tok), jnp.int32(idx))
    t_logits, _ = tstep.fn(tp, cache, torch.from_numpy(tok), idx)
    j_logits = np.asarray(j_logits, np.float32)
    assert_close(t_logits.float().numpy(), j_logits,
                 atol=FAMILY_TOL * float(np.abs(j_logits).max()), what="decode logits")


def test_materialize_refuses_a_production_plan():
    from repro_torch.launch.steps import build_step, materialize

    step = build_step(t_cfg("mamba2-1.3b"), "long_500k", make_production_mesh())
    with pytest.raises(ValueError, match="production mesh"):
        materialize(step)


# ---------------------------------------------------------------------------
# autobatch and the op counter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_autobatch_matches_the_reference(arch):
    from repro.launch import autobatch as j_ab
    from repro_torch.launch import autobatch as t_ab

    jc, tc = j_cfg(arch), t_cfg(arch)
    assert t_ab.activation_bytes_per_token(tc) == j_ab.activation_bytes_per_token(jc)
    for seq in (2048, 4096, 32768):
        for hbm in (GiB16, 80e9):
            for mp in (1, 16):
                want = j_ab.estimate_micro_batch(jc, seq, hbm_bytes=hbm, model_parallel=mp)
                got = t_ab.estimate_micro_batch(tc, seq, hbm_bytes=hbm, model_parallel=mp)
                assert got == want, (seq, hbm, mp)
    assert t_ab.estimate_micro_batch(tc, 4096, hbm_bytes=GiB16) == \
        j_ab.estimate_micro_batch(jc, 4096)  # the defaults: model_parallel 16


def test_verify_micro_batch_reads_the_measured_peak():
    from repro_torch.launch.autobatch import verify_micro_batch
    from repro_torch.roofline.analysis import Measured

    m = Measured(flops=1.0, bytes=1.0, ops=1, seconds=1.0, peak_memory=70e9,
                 kernels_not_counted={})
    assert verify_micro_batch(m, hbm_bytes=80e9) and not verify_micro_batch(m, hbm_bytes=60e9)
    assert not verify_micro_batch(dataclasses.replace(m, peak_memory=None), hbm_bytes=80e9)


def test_op_counter_is_exact_on_a_matmul_an_elementwise_op_and_a_view():
    from repro_torch.roofline.analysis import OpCounter

    a, b = torch.randn(4, 5), torch.randn(5, 3)
    with OpCounter() as c:
        a @ b
    assert (c.flops, c.bytes, c.ops) == (2 * 4 * 3 * 5, 4 * (20 + 15 + 12), 1)
    with OpCounter() as c:
        a * a
    assert (c.flops, c.bytes, c.ops) == (20, 4 * 3 * 20, 1)
    with OpCounter() as c:
        a.view(20), a.t(), a[1:]
    assert (c.flops, c.bytes, c.ops) == (0, 0, 0)
    with OpCounter() as c:
        a.sum()
    assert (c.flops, c.bytes) == (20, 4 * 21)  # a reduction: its operand's elements
    with OpCounter() as c:
        a.to(torch.bfloat16)
    assert (c.flops, c.bytes) == (0, 4 * 20 + 2 * 20)  # a cast moves data only


def test_op_counter_on_a_reduced_qwen3_loss_is_within_a_band_of_the_hlo_analyzer():
    """FLOPs of the loss's forward and backward, counted op by op, against
    the reference's trip-count-aware HLO count of the same jitted function:
    within 0.85–1.15× (the dots dominate; elementwise conventions differ).
    Bytes within 0.5–2×: eager bytes count every op's boundary, XLA its
    fusions' boundaries, and the two graphs cut the work differently."""
    from repro.roofline.hlo_analyzer import analyze
    from repro_torch.roofline.analysis import OpCounter

    jm, tm, jp, tp = family_pair("qwen3-1.7b")
    toks = family_tokens(jm.cfg, 2, 64, seed=9)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b), has_aux=True))
    hlo = analyze(fn.lower(jp, {"tokens": jnp.asarray(toks)}).compile().as_text())
    with OpCounter() as c:
        _loss_and_grads(tm, tp, toks, remat=False)
    assert 0.85 <= c.flops / hlo.flops <= 1.15, (c.flops, hlo.flops)
    assert 0.5 <= c.bytes / hlo.bytes <= 2.0, (c.bytes, hlo.bytes)


def test_roofline_report_of_a_plan_keeps_unknown_terms_null():
    from repro_torch.roofline import analyze_compiled, model_flops_6nd
    from repro_torch.roofline.analysis import Measured

    r = analyze_compiled("plan", None, 256, model_flops=model_flops_6nd(10, 100))
    d = r.to_dict()
    assert d["model_flops"] == 6000.0
    for k in ("flops_per_device", "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
              "useful_flops_ratio", "peak_memory_per_device"):
        assert d[k] is None, k
    m = Measured(flops=989e12, bytes=3.35e12 * 2, ops=3, seconds=2.5, peak_memory=1e9,
                 kernels_not_counted={"server_apply": 1})
    d = analyze_compiled("run", m, 1, model_flops=494.5e12).to_dict()
    assert (d["t_compute_s"], d["t_memory_s"], d["t_collective_s"]) == (1.0, 2.0, 0.0)
    assert d["bottleneck"] == "memory" and d["useful_flops_ratio"] == 0.5
    assert d["measured"]["kernels_not_counted"] == {"server_apply": 1}
