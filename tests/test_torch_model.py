"""``repro_torch`` Model.loss and its gradients against
``jax.value_and_grad(repro Model.loss)`` on reduced photon-75m, same weights
and tokens. float32 compute is held tight; the default bf16 compute loosely
(the frameworks round bf16 at different places)."""
import dataclasses

import numpy as np
import pytest

from torch_parity import jax_flat, jax_to_torch, torch_flat

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten, tree_flatten  # noqa: E402


@pytest.mark.parametrize(
    "seq,batch,dtype",
    [(64, 2, "float32"), (512, 1, "float32"), (64, 2, "bfloat16")],
    ids=["f32-s64", "f32-s512-chunked", "bf16-s64"],
)
def test_loss_and_grads_match_reference(seq, batch, dtype):
    jcfg = dataclasses.replace(j_get_config("photon-75m").reduced(), compute_dtype=dtype)
    tcfg = dataclasses.replace(t_get_config("photon-75m").reduced(), compute_dtype=dtype)
    jm, tm = j_build(jcfg), t_build(tcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(seq).integers(0, jcfg.vocab_size, (batch, seq)).astype(np.int32)

    (j_loss, j_metrics), j_grads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, {"tokens": jnp.asarray(tokens)}
    )

    leaves, treedef = tree_flatten(jax_to_torch(params))
    leaves = [x.requires_grad_(True) for x in leaves]
    t_loss, t_metrics = tm.loss(tree_unflatten(treedef, leaves), {"tokens": torch.from_numpy(tokens)})
    t_grads = tree_unflatten(treedef, list(torch.autograd.grad(t_loss, leaves)))

    if dtype == "float32":
        assert abs(float(t_loss.detach()) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
        jg, tg = jax_flat(j_grads), torch_flat(t_grads)
        assert sorted(jg) == sorted(tg)
        gmax = max(1.0, max(float(np.abs(g).max()) for g in jg.values()))
        for k in jg:
            err = float(np.abs(tg[k] - jg[k]).max())
            assert err <= 1e-5 * gmax, (k, err)
        for k in ("ce", "z_loss", "accuracy", "n_tokens"):
            assert abs(float(t_metrics[k]) - float(j_metrics[k])) <= 1e-5 * max(
                1.0, abs(float(j_metrics[k]))), k
    else:
        assert abs(float(t_loss.detach()) - float(j_loss)) <= 2e-2
    assert len(tree_leaves(t_grads)) == len(jax.tree_util.tree_leaves(j_grads))
