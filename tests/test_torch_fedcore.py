"""The flat-buffer federation ops of the port against ``repro.kernels.fedcore``:
packing bitwise on the photon tree, the plain server step against the Pallas
``server_apply`` kernel run in interpret mode, and the fused server phase as a
whole against the reference's flat chain. Tolerances: params/lanes abs 1e-6; norms rel 1e-5 (the sums are
reassociated float32)."""
import numpy as np
import pytest

from torch_parity import assert_close, assert_metrics_close, assert_trees_close, jax_to_torch

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import FederatedConfig as JFed  # noqa: E402
from repro.core import OuterOptConfig as JOuter  # noqa: E402
from repro.core import init_federated_state as j_init_state  # noqa: E402
from repro.kernels.fedcore import fused_apply_aggregate as j_fused  # noqa: E402
from repro.kernels.fedcore import kernel as JK  # noqa: E402
from repro.kernels.fedcore import ops as jops  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch.core import FederatedConfig as TFed  # noqa: E402
from repro_torch.core import OuterOptConfig as TOuter  # noqa: E402
from repro_torch.core import init_federated_state as t_init_state  # noqa: E402
from repro_torch.kernels.fedcore import kernel as TK  # noqa: E402
from repro_torch.kernels.fedcore import ops as tops  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

BLOCK = 128


@pytest.fixture(scope="module")
def photon_params():
    return build_model(get_config("photon-75m").reduced()).init(jax.random.PRNGKey(0))


def test_pack_unpack_bitwise_on_photon_tree(photon_params):
    jl = jax.tree_util.tree_leaves(photon_params)
    tl = tree_leaves(jax_to_torch(photon_params))
    for block in (1, 8192):
        jf, jspec = jops.pack_leaves(jl, block)
        tf, tspec = tops.pack_leaves(tl, block)
        assert (jspec.shapes, jspec.n, jspec.n_pad) == (tspec.shapes, tspec.n, tspec.n_pad)
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
        for a, b in zip(tl, tops.unpack_leaves(tf, tspec)):
            assert torch.equal(a, b)
    c = 3
    rng = np.random.default_rng(0)
    stacked = [rng.standard_normal((c,) + tuple(x.shape)).astype(np.float32) for x in jl]
    jf, jspec = jops.pack_client_leaves([jnp.asarray(x) for x in stacked], c, 8192)
    tf, tspec = tops.pack_client_leaves([torch.from_numpy(x) for x in stacked], c, 8192)
    assert jspec.n_pad == tspec.n_pad
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())


def test_dtype_groups_match():
    shapes = [(3,), (2, 2), (5,), (1,)]
    dts = ["float32", "bfloat16", "float32", "bfloat16"]
    jl = [jnp.zeros(s, d) for s, d in zip(shapes, dts)]
    tl = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in zip(shapes, dts)]
    assert [i for _, i in jops.dtype_group_indices(jl)] == [i for _, i in tops.dtype_group_indices(tl)]


def _server_inputs(opt, c, seed):
    rng = np.random.default_rng(seed)
    n, n_pad = 300, 384  # a padded tail, three 128-blocks
    d = np.zeros((c, n_pad), np.float32)
    d[:, :n] = rng.standard_normal((c, n)).astype(np.float32) * 1e-2
    w = np.asarray([1.0, 2.0, 0.0, 0.5][:c] if c > 1 else [1.0], np.float32)
    wn = (w / w.sum()).astype(np.float32)
    p = np.zeros(n_pad, np.float32)
    p[:n] = rng.standard_normal(n).astype(np.float32) * 0.02
    g0 = rng.standard_normal(n_pad).astype(np.float32) * 5e-3
    lanes = {"fedavg": [], "fedmom": [g0], "fedadam": [0.1 * g0, 0.01 * g0 * g0]}[opt]
    noise = np.zeros(n_pad, np.float32)
    noise[:n] = rng.standard_normal(n).astype(np.float32) * 1e-3
    return d, wn, p, [x.astype(np.float32) for x in lanes], noise


@pytest.mark.parametrize("opt", ["fedavg", "fedmom", "fedadam"])
@pytest.mark.parametrize("with_noise", [False, True], ids=["clean", "noise"])
@pytest.mark.parametrize("c", [1, 4])
def test_server_apply_plain_matches_pallas_kernel(opt, with_noise, c):
    d, wn, p, lanes, noise = _server_inputs(opt, c, seed=c)
    hyper = dict(lr={"fedavg": 1.0, "fedmom": 0.7, "fedadam": 0.1}[opt],
                 momentum=0.9, nesterov=True, beta2=0.99, eps=1e-8)
    bias = (1.0 - 0.9 ** 2, 1.0 - 0.99 ** 2) if opt == "fedadam" else None
    j_p, j_lanes, j_pg, j_np, j_dsq = JK.server_apply(
        jnp.asarray(d), jnp.asarray(wn), jnp.asarray(p), [jnp.asarray(x) for x in lanes],
        opt=opt, bias_corr=None if bias is None else tuple(jnp.float32(b) for b in bias),
        noise=jnp.asarray(noise) if with_noise else None, block=BLOCK, interpret=True,
        **hyper,
    )
    t_p, t_lanes = torch.from_numpy(p.copy()), [torch.from_numpy(x.copy()) for x in lanes]
    launches = TK.server_apply.launches
    t_pg, t_np, t_dsq = TK.server_apply(  # a CPU tensor: the plain version, no launch
        torch.from_numpy(d), torch.from_numpy(wn), t_p, t_lanes, opt=opt, bias_corr=bias,
        noise=torch.from_numpy(noise) if with_noise else None, **hyper,
    )
    assert TK.server_apply.launches == launches
    assert_close(t_p.numpy(), np.asarray(j_p), atol=1e-6, what="params")
    for a, b in zip(t_lanes, j_lanes):
        assert_close(a.numpy(), np.asarray(b), atol=1e-6, what="lane")
    assert_close(float(t_pg), float(j_pg[0, 0]), rtol=1e-5, what="pg_sq")
    assert_close(float(t_np), float(j_np[0, 0]), rtol=1e-5, what="newp_sq")
    assert_close(t_dsq.numpy(), np.asarray(j_dsq)[:, 0], rtol=1e-5, what="delta_sq")


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    d = torch.zeros((4, 64))
    wn = torch.full((4,), 0.25)
    p = torch.zeros(64)
    TK._check(d, wn, p, [], "fedavg", None, None)  # well-formed: passes
    bad = [
        (d.double(), wn, p, [], "fedavg", None, None),  # dtype
        (d, wn, torch.zeros(60), [], "fedavg", None, None),  # shape
        (d[:, :62], wn[:4], p[:62], [], "fedavg", None, None),  # Np % 4
        (d.t().contiguous().t(), wn, p, [], "fedavg", None, None),  # not contiguous
        (d, wn, p, [p], "fedavg", None, None),  # lanes count
        (d, wn, p, [p, p], "fedadam", None, None),  # missing bias corrections
        (torch.zeros((33, 64)), torch.zeros(33), p, [], "fedavg", None, None),  # cohort
        (d, wn, p, [], "fedsgd", None, None),  # unknown optimizer
    ]
    for args in bad:
        with pytest.raises(ValueError):
            TK._check(*args)


@pytest.mark.parametrize("opt", ["fedavg", "fedmom", "fedadam"])
def test_fused_apply_aggregate_matches_reference(opt, photon_params):
    c = 4
    rng = np.random.default_rng(7)
    params = photon_params
    draw = lambda x: jnp.asarray(  # noqa: E731
        rng.standard_normal((c,) + x.shape).astype(np.float32) * 1e-3
    )
    deltas0 = jax.tree_util.tree_map(draw, params)
    deltas = jax.tree_util.tree_map(draw, params)
    w = np.asarray([1.0, 2.0, 0.0, 0.5], np.float32)
    jfed = JFed(clients_per_round=c, local_steps=2, outer=JOuter(name=opt, lr=0.7))
    tfed = TFed(clients_per_round=c, local_steps=2, outer=TOuter(name=opt, lr=0.7))
    jstate = j_init_state(jfed, params, jax.random.PRNGKey(5))
    # one step on other deltas first, so the optimizer lanes are non-trivial
    # (the same deltas twice would make FedAdam's step ~ pg/|pg|, ill-conditioned
    # wherever pg is near 0)
    jstate, _ = j_fused(jfed, jstate, deltas0, client_weights=jnp.asarray(w))
    tstate = t_init_state(tfed, jax_to_torch(jstate["params"]), np.asarray(jstate["rng"]))
    tstate["outer"] = jax_to_torch(jstate["outer"])
    tstate["outer"]["round"] = int(jstate["outer"]["round"])
    tstate["round"] = int(jstate["round"])

    # against the reference's flat chain, which the plain version follows op for
    # op (its Pallas kernel is held against above); on FedAdam the reference's
    # two paths differ from each other by ~2e-6 where m, v and pg are all ~1e-6
    j_new, j_metrics = j_fused(jfed, jstate, deltas, client_weights=jnp.asarray(w),
                               use_pallas=False)
    t_new, t_metrics = tops.fused_apply_aggregate(
        tfed, tstate, jax_to_torch(deltas), client_weights=torch.from_numpy(w)
    )
    assert_trees_close(t_new["params"], j_new["params"], atol=1e-6)
    for lane in [k for k in j_new["outer"] if k != "round"]:
        assert_trees_close(t_new["outer"][lane], j_new["outer"][lane], atol=1e-6)
    assert t_new["outer"]["round"] == int(j_new["outer"]["round"])
    assert t_new["round"] == int(j_new["round"])
    # norms rel 1e-5; client_consensus is a cosine near 0 formed by a
    # cancellation, so it is held absolutely at 1e-6 of its unit scale
    assert_metrics_close(t_metrics, j_metrics, rtol=1e-5, atol=1e-6)
