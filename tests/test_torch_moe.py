"""The mixture-of-experts FFN and the MoE families (deepseek-moe-16b,
llama4-scout-17b-a16e, jamba-v0.1-52b) against the JAX package at reduced
size.

``moe_ffn``'s routing is a selection, so it is held bit for bit: given the
same router probabilities, the port's :func:`route` gives the reference's
expert indices, renormalised gates, positions in expert and kept slots — read
off the reference's own ``moe_ffn`` (its jaxpr, evaluated with the
intermediates as extra outputs), ties and dropped slots included. The two
packages' softmaxes differ in the last bit, so from the same x and router
weights the output and the aux loss are held to f32 tolerances: |Δ| ≤
1e-5·max|ref| (output, gradients against the largest gradient entry) and
1e-5 relative (aux).

The families run as the dense decoders do (``test_torch_decoders.py``):
``Model.loss`` with ``moe_aux``, its gradient, prefill and four decode steps
at f32 compute; the train CLI resumes reference checkpoints of reduced
deepseek-moe-16b and jamba; jamba's ``use_pallas`` prefill goes through the
SSD kernel's plain version on the CPU.
"""
import dataclasses

import numpy as np
import pytest

from torch_parity import (
    assert_close,
    check_family_loss_and_grad,
    check_family_prefill_and_decode,
    cli_resume_round_trip,
    close_to_max,
    family_pair,
    jax_flat,
    torch_flat,
)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.common import init_params as j_init_params  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.tree import (  # noqa: E402
    flatten_with_paths,
    params_from_numpy,
    tree_flatten,
    tree_unflatten,
)

MOE = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "jamba-v0.1-52b"]
TOL = 1e-5


def moe_inputs(arch, B, S, seed, skew=0.0, tie=False):
    """The reduced arch's config (f32 compute), its MoE FFN weights from the
    reference's init, and x (B, S, D) from numpy. ``skew`` raises expert 0's
    router logit by about skew·D/2 on every token (slots drop past capacity);
    ``tie`` makes router columns 1 and 3 copies of 0 and 2 (tied
    probabilities in both packages)."""
    cfg = dataclasses.replace(j_get_config(arch).reduced(), compute_dtype="float32")
    p = {k: np.array(v) for k, v in
         jax_flat(j_init_params(jax.random.PRNGKey(seed), j_moe.moe_ffn_desc(cfg))).items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    router = p["['router']"]
    if skew:
        x += 0.5
        router[:, 0] += skew
    if tie:
        router[:, 1], router[:, 3] = router[:, 0], router[:, 2]
    return cfg, p, x


def reference_routing(cfg, p_flat, x):
    """The reference ``moe_ffn``'s output, aux and routing: its jaxpr run
    with the intermediates as extra outputs — the probabilities (top_k's
    input), expert_idx (top_k's indices), the renormalised gates (the
    division of top_k's values), pos_in_expert (the int32 subtraction of
    the cumsum) and keep (the comparison of that with the capacity)."""
    treedef = jax.tree_util.tree_structure(j_moe.moe_ffn_desc(cfg))
    keys = [jax.tree_util.keystr(path) for path, _ in
            jax.tree_util.tree_flatten_with_path(j_moe.moe_ffn_desc(cfg))[0]]
    p = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(p_flat[k]) for k in keys])
    closed = jax.make_jaxpr(lambda x, p: j_moe.moe_ffn(cfg, p, x))(jnp.asarray(x), p)
    eqns = closed.jaxpr.eqns
    top_k = next(e for e in eqns if e.primitive.name == "top_k")
    gates = next(e for e in eqns if e.primitive.name == "div" and e.invars[0] is top_k.outvars[0])
    pos = next(e for e in eqns if e.primitive.name == "sub"
               and e.outvars[0].aval.dtype == jnp.int32 and e.outvars[0].aval.ndim == 1)
    keep = next(e for e in eqns if e.primitive.name == "lt" and e.invars[0] is pos.outvars[0])
    extra = [top_k.invars[0], top_k.outvars[1], gates.outvars[0], pos.outvars[0],
             keep.outvars[0]]
    jaxpr = closed.jaxpr.replace(outvars=list(closed.jaxpr.outvars) + extra)
    out = jax.core.eval_jaxpr(jaxpr, closed.consts, *jax.tree_util.tree_leaves((x, p)))
    names = ("y", "aux", "probs", "expert_idx", "gates", "pos_in_expert", "keep")
    return {k: np.asarray(v) for k, v in zip(names, out)}


def port_moe(cfg, p_flat, x):
    return t_moe.moe_ffn(cfg, params_from_numpy(p_flat, "cpu"), torch.from_numpy(x))


#: (case, arch, B, S, seed, skew, tie, slots drop): the capacity factor is
#: 1.25 (deepseek-moe, llama4) or 1.0 (jamba); B = 2, S = 1 is a decode step,
#: where the capacity is max(1, int(2·K·cf/E)) = 1
ROUTING_CASES = [
    ("random", "deepseek-moe-16b", 2, 24, 0, 0.0, False, None),
    ("tied probabilities", "deepseek-moe-16b", 2, 24, 1, 0.0, True, None),
    ("tied, top-1", "llama4-scout-17b-a16e", 2, 24, 2, 0.0, True, None),
    ("cf 1.0 drops", "jamba-v0.1-52b", 2, 32, 3, 0.01, False, True),
    ("cf 1.25 drops", "deepseek-moe-16b", 2, 32, 4, 0.01, False, True),
    ("decode, capacity 1", "deepseek-moe-16b", 2, 1, 5, 0.01, False, True),
]


@pytest.mark.parametrize("case,arch,B,S,seed,skew,tie,drops", ROUTING_CASES,
                         ids=[c[0] for c in ROUTING_CASES])
def test_routing_given_the_same_probabilities_is_the_references_bitwise(
        case, arch, B, S, seed, skew, tie, drops):
    cfg, p, x = moe_inputs(arch, B, S, seed, skew, tie)
    ref = reference_routing(cfg, p, x)
    T, K = B * S, cfg.moe_top_k
    capacity = t_moe.capacity_of(cfg, T)
    assert capacity == max(1, int(T * K * cfg.moe_capacity_factor / cfg.n_experts))
    gates, idx, pos, keep = t_moe.route(torch.tensor(ref["probs"]), K, capacity)
    assert np.array_equal(idx.numpy(), ref["expert_idx"].astype(np.int64))
    assert gates.dtype == torch.float32
    assert np.array_equal(gates.numpy().view(np.uint32), ref["gates"].view(np.uint32))
    assert np.array_equal(pos.numpy(), ref["pos_in_expert"].astype(np.int64))
    assert np.array_equal(keep.numpy(), ref["keep"])
    if tie:  # the lower expert index of a tied pair is taken first
        probs = ref["probs"]
        assert np.array_equal(probs[:, 0], probs[:, 1]) and np.array_equal(probs[:, 2], probs[:, 3])
        first = ref["expert_idx"][:, 0]
        assert set(np.unique(first)) <= {0, 2}
    if drops:
        assert not keep.all() and keep.any()
    if S == 1:
        assert capacity == 1


@pytest.mark.parametrize("case,arch,B,S,seed,skew,tie,drops", ROUTING_CASES,
                         ids=[c[0] for c in ROUTING_CASES])
def test_moe_ffn_output_and_aux_match_reference(case, arch, B, S, seed, skew, tie, drops):
    """From the same x and weights (each package's own softmax)."""
    cfg, p, x = moe_inputs(arch, B, S, seed, skew, tie)
    ref = reference_routing(cfg, p, x)
    y, aux = port_moe(cfg, p, x)
    assert y.shape == x.shape and aux.dtype == torch.float32 and aux.ndim == 0
    close_to_max(y, ref["y"], "moe_ffn output")
    assert_close(float(aux), float(ref["aux"]), rtol=TOL, what="aux")


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_gradients_match_reference(arch):
    """d/d(x, weights) of Σ y·r + aux (r a fixed random tensor)."""
    cfg, p, x = moe_inputs(arch, 2, 24, 6, skew=0.01)
    r = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def j_scalar(x_, leaves):
        tree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(j_moe.moe_ffn_desc(cfg)), leaves)
        y, aux = j_moe.moe_ffn(cfg, tree, x_)
        return jnp.sum(y * r) + aux

    order = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(j_moe.moe_ffn_desc(cfg))[0]]
    jgx, jgw = jax.grad(j_scalar, argnums=(0, 1))(
        jnp.asarray(x), [jnp.asarray(p[k]) for k in order])
    jg = {"x": np.asarray(jgx), **{k: np.asarray(g) for k, g in zip(order, jgw)}}

    flat, treedef = tree_flatten(params_from_numpy(p, "cpu"))
    flat = [t.requires_grad_(True) for t in flat]
    tp = tree_unflatten(treedef, flat)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = t_moe.moe_ffn(cfg, tp, tx)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux, [tx] + flat)
    tg = {"x": grads[0].numpy()}
    tg.update({k: g.numpy() for (k, _), g in zip(flatten_with_paths(tp), grads[1:])})
    assert sorted(tg) == sorted(jg)
    g_max = max(float(np.abs(v).max()) for v in jg.values())
    for k in jg:
        assert_close(tg[k], jg[k], atol=TOL * g_max, what=f"grad {k}")


def test_expert_ffn_is_recomputed_in_the_backward_pass(monkeypatch):
    """In training the expert FFN runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``): twice per forward-and-backward, once
    without grad."""
    cfg, p, x = moe_inputs("deepseek-moe-16b", 2, 8, 8)
    calls = []
    real = t_moe._expert_ffn
    monkeypatch.setattr(t_moe, "_expert_ffn", lambda *a: calls.append(1) or real(*a))
    params = params_from_numpy(p, "cpu")
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = t_moe.moe_ffn(cfg, params, tx)
    (y.sum() + aux).backward()
    assert len(calls) == 2 and tx.grad is not None
    calls.clear()
    with torch.no_grad():
        t_moe.moe_ffn(cfg, params, torch.from_numpy(x))
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# The MoE families against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_loss_with_moe_aux_and_gradient_match_reference(arch):
    metrics = check_family_loss_and_grad(arch)
    assert np.isfinite(metrics["moe_aux"]) and metrics["moe_aux"] > 0


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_four_decode_steps_match_reference(arch):
    check_family_prefill_and_decode(arch)


def test_jamba_prefill_under_use_pallas_takes_the_ssd_plain_version_on_the_cpu():
    """Jamba's SSM layer goes through ``ops.ssd`` under ``use_pallas``: on the
    CPU the kernel's plain version (no launch), which agrees with the
    reference's ``use_pallas`` prefill (its Pallas kernel in interpret mode)."""
    from repro_torch.kernels.ssd_scan import kernel as SK

    calls = []
    real = SK.ssd_scan_plain
    SK.ssd_scan_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        before = SK.ssd_scan_fwd.launches
        check_family_prefill_and_decode("jamba-v0.1-52b", n_decode=1, use_pallas=True)
    finally:
        SK.ssd_scan_plain = real
    assert SK.ssd_scan_fwd.launches == before
    n_ssm = sum(k.mixer == "ssm" for k in j_get_config("jamba-v0.1-52b").reduced().layer_kinds())
    assert len(calls) == n_ssm == 1


@pytest.mark.parametrize("arch", MOE)
def test_moe_checkpoints_cross_over_by_the_references_key_paths(arch, tmp_path):
    """Reduced MoE params saved by either package load in the other, leaf for
    leaf: the router, the (E, d, dff) experts and the shared experts."""
    from repro.checkpoint.checkpoint import load_pytree as j_load, save_pytree as j_save
    from repro_torch.checkpoint import load_pytree as t_load, save_pytree as t_save

    jm, tm, jp, _ = family_pair(arch)
    tp = tm.init(7, device="cpu")  # the port's own draws, not the reference's
    keys = torch_flat(tp)
    cfg = tm.cfg
    experts = [k for k, v in keys.items() if k.endswith("['ffn']['w_in']")
               and v.shape[-3:] == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)]
    assert experts and any(k.endswith("['ffn']['router']") for k in keys)
    assert any("['ffn']['shared']" in k for k in keys) == bool(cfg.n_shared_experts)
    t_save(str(tmp_path / "t.npz"), tp)
    back = jax_flat(j_load(str(tmp_path / "t.npz"), jp))
    assert sorted(back) == sorted(keys)
    assert all(np.array_equal(v, keys[k]) for k, v in back.items())
    j_save(str(tmp_path / "j.npz"), jp)
    got, want = torch_flat(t_load(str(tmp_path / "j.npz"), tp)), jax_flat(jp)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b"])
def test_train_cli_resumes_a_reference_moe_checkpoint(arch, tmp_path):
    jr, tr = cli_resume_round_trip(arch, tmp_path)
    assert np.isfinite(float(tr["train_loss"]))
