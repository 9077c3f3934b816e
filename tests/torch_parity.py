"""Shared helpers of the PyTorch port's parity tests (``tests/test_torch_*.py``).

Each test builds its inputs with numpy from a seed and feeds the same values to
the JAX package and to ``repro_torch``; JAX trees cross over as
``{keystr: ndarray}`` (the checkpoint's own flattening), so a carried weight
is a key lookup.

Torch runs single-threaded here: on the CPU build these tests run against,
the first multi-threaded ``torch.sqrt`` of a process was seen to compute one
thread's chunk with an approximate square root (relative error ~2e-4), which
no stated tolerance could absorb. One thread computes every element alike.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


def jax_flat(tree):
    """``{keystr: ndarray}`` of a JAX tree (bf16 leaves as float32)."""
    from repro.checkpoint.checkpoint import _flatten_with_paths

    return _flatten_with_paths(tree)


def jax_to_torch(tree, device="cpu"):
    """A JAX tree as the port's nested dict/list of tensors."""
    from repro_torch.tree import params_from_numpy

    return params_from_numpy(jax_flat(tree), device)


def torch_flat(tree):
    from repro_torch.tree import params_to_numpy

    return params_to_numpy(tree)


def assert_close(got, want, *, atol=0.0, rtol=0.0, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    bound = atol + rtol * np.abs(want)
    assert np.all(err <= bound), (
        f"{what}: max abs err {err.max():.3e}, worst excess "
        f"{(err - bound).max():.3e} (atol={atol}, rtol={rtol})"
    )


def assert_trees_close(torch_tree, jax_tree, *, atol=0.0, rtol=0.0):
    """Same key paths, and every leaf within ``atol + rtol·|want|``."""
    got, want = torch_flat(torch_tree), jax_flat(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], atol=atol, rtol=rtol, what=k)


def assert_metrics_close(got: dict, want: dict, *, rtol: float, atol: float = 1e-7,
                         skip=()):
    """Every reference metric is present in ``got`` and agrees to ``rtol``."""
    for k, v in want.items():
        if k in skip:
            continue
        assert k in got, k
        assert_close(float(got[k]), float(v), atol=atol, rtol=rtol, what=k)


def _report() -> None:
    """Print the measured max errors of the model and server-step parity, at
    the sizes ``test_torch_model.py`` and ``test_torch_fedcore.py`` use."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_cfg
    from repro.kernels.fedcore import kernel as JK
    from repro.models import build_model as j_build
    from repro_torch.configs import get_config as t_cfg
    from repro_torch.kernels.fedcore import kernel as TK
    from repro_torch.models import build_model as t_build
    from repro_torch.tree import tree_flatten, tree_unflatten

    for seq, batch, dtype in [(64, 2, "float32"), (512, 1, "float32"), (64, 2, "bfloat16")]:
        jm = j_build(dataclasses.replace(j_cfg("photon-75m").reduced(), compute_dtype=dtype))
        tm = t_build(dataclasses.replace(t_cfg("photon-75m").reduced(), compute_dtype=dtype))
        params = jm.init(jax.random.PRNGKey(0))
        toks = np.random.default_rng(seq).integers(0, 512, (batch, seq)).astype(np.int32)
        (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(params, {"tokens": jnp.asarray(toks)})
        leaves, treedef = tree_flatten(jax_to_torch(params))
        leaves = [x.requires_grad_(True) for x in leaves]
        tl, _ = tm.loss(tree_unflatten(treedef, leaves), {"tokens": torch.from_numpy(toks)})
        tg = torch_flat(tree_unflatten(treedef, list(torch.autograd.grad(tl, leaves))))
        jgf = jax_flat(jg)
        gerr = max(float(np.abs(tg[k] - jgf[k]).max()) for k in jgf)
        gmax = max(float(np.abs(v).max()) for v in jgf.values())
        print(f"model {dtype} S={seq} B={batch}: loss rel err "
              f"{abs(float(tl.detach()) - float(jl)) / abs(float(jl)):.3e}, grad max abs err "
              f"{gerr:.3e} (max |g| {gmax:.3e})")

    rng = np.random.default_rng(4)
    c, n = 4, 384
    d = (rng.standard_normal((c, n)) * 1e-2).astype(np.float32)
    wn = np.asarray([1.0, 2.0, 0.0, 0.5], np.float32) / np.float32(3.5)
    p = (rng.standard_normal(n) * 0.02).astype(np.float32)
    g0 = (rng.standard_normal(n) * 5e-3).astype(np.float32)
    noise = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    for opt, lanes, lr in [("fedavg", [], 1.0), ("fedmom", [g0], 0.7),
                           ("fedadam", [0.1 * g0, 0.01 * g0 * g0], 0.1)]:
        bias = (1.0 - 0.9 ** 2, 1.0 - 0.99 ** 2) if opt == "fedadam" else None
        jp, jlanes, jpg, jnp_, jdsq = JK.server_apply(
            jnp.asarray(d), jnp.asarray(wn), jnp.asarray(p), [jnp.asarray(x) for x in lanes],
            opt=opt, lr=lr, bias_corr=None if bias is None else tuple(map(jnp.float32, bias)),
            noise=jnp.asarray(noise), block=128, interpret=True,
        )
        tp, tlanes = torch.from_numpy(p.copy()), [torch.from_numpy(x.copy()) for x in lanes]
        tpg, tnp, tdsq = TK.server_apply_plain(
            torch.from_numpy(d), torch.from_numpy(wn), tp, tlanes, opt=opt, lr=lr,
            bias_corr=bias, noise=torch.from_numpy(noise),
        )
        lane_err = max([float(np.abs(a.numpy() - np.asarray(b)).max())
                        for a, b in zip(tlanes, jlanes)] or [0.0])
        norms_t = np.asarray([float(tpg), float(tnp), *tdsq.numpy()], np.float64)
        norms_j = np.asarray([float(jpg[0, 0]), float(jnp_[0, 0]), *np.asarray(jdsq)[:, 0]],
                             np.float64)
        print(f"server_apply {opt} C={c} noise: params max abs err "
              f"{float(np.abs(tp.numpy() - np.asarray(jp)).max()):.3e}, lanes {lane_err:.3e}, "
              f"norms max rel err {float(np.max(np.abs(norms_t - norms_j) / norms_j)):.3e}")


if __name__ == "__main__":
    _report()
