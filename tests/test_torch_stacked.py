"""A stacked body's per-layer weights and the backward that fills their stack.

``transformer.layer_views`` gives each layer views of the rows of the stacked
leaves, and the backward writes each layer's gradients into their rows of one
buffer per leaf. Slicing ``x[r]`` per layer gave each layer a
``select_backward``: a zero-filled stack-sized tensor with the layer's
gradient in row r, added into the leaf's gradient. These tests hold the
profiled backward to no such ``select_backward`` and no more than one
``stack`` per stacked leaf, and the loss and every gradient to the per-layer
slicing's, with ``torch.equal`` (which takes -0.0 and +0.0 as equal: the
slicing's ``+ 0.0`` turned a -0.0 gradient element into +0.0, the rows keep
its sign). Reduced configs, each planned as one body repeated twice; jamba at
4 layers repeats a two-layer body of an SSD and an attention-and-MoE layer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten  # noqa: E402

CASES = {
    "photon-75m": {},
    "qwen3-1.7b": {},
    "mamba2-1.3b": {},
    "jamba-v0.1-52b": {"n_layers": 4},
}


def _slice_per_layer(seg_params, n_repeat):
    if n_repeat == 1:
        return [seg_params]
    return [tree_map(lambda x: x[r], seg_params) for r in range(n_repeat)]


def _stacked_leaves(cfg, params):
    segs = transformer.plan_segments(cfg.layer_kinds())
    return [x for s, p in zip(segs, params["segments"]) if s.n_repeat > 1
            for x in tree_flatten(p)[0]]


def _loss_and_grads(model, params, tokens, remat, stack_shapes):
    """Loss, gradients, and in the profiled backward: the ``aten::stack``
    calls of a backward node and the ``select_backward`` calls that fill a
    stack-sized gradient. Such a call writes the layer's gradient through an
    ``aten::select`` of its zeros, whose input has their shape; the layers'
    own slicing (the loss's of the tokens, the SSD conv's of its taps) fills
    smaller ones."""
    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    loss, _ = model.loss(tree_unflatten(treedef, leaves), {"tokens": tokens}, remat=remat)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        grads = torch.autograd.grad(loss, leaves)
    events = list(prof.events())
    n_stack = sum(e.name == "aten::stack" and e.cpu_parent is not None
                  and e.cpu_parent.name.endswith("Backward0") for e in events)
    n_select = sum(e.name == "aten::select" and e.cpu_parent is not None
                   and e.cpu_parent.name == "aten::select_backward"
                   and tuple(e.input_shapes[0]) in stack_shapes for e in events)
    return loss.detach(), grads, n_stack, n_select


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", sorted(CASES))
def test_stacked_backward_selects_no_stack_and_matches_per_layer_slicing(
        arch, remat, monkeypatch):
    cfg = dataclasses.replace(get_config(arch).reduced(), **CASES[arch])
    segs = transformer.plan_segments(cfg.layer_kinds())
    assert any(s.n_repeat == 2 for s in segs), segs
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 32)).astype(np.int64))
    stacked = _stacked_leaves(cfg, params)
    stack_shapes = {tuple(x.shape) for x in stacked}
    assert stacked

    loss, grads, n_stack, n_select = _loss_and_grads(model, params, tokens, remat,
                                                     stack_shapes)
    assert n_select == 0
    assert n_stack <= len(stacked)

    monkeypatch.setattr(transformer, "layer_views", _slice_per_layer)
    loss_s, grads_s, _, n_select_s = _loss_and_grads(model, params, tokens, remat,
                                                     stack_shapes)
    # the per-layer slicing: a zero-filled stack per stacked leaf and layer
    assert n_select_s == 2 * len(stacked)
    assert torch.equal(loss, loss_s)
    assert len(grads) == len(grads_s)
    for g, gs in zip(grads, grads_s):
        assert torch.equal(g, gs)


def test_layer_views_fill_the_rows_of_layers_that_take_no_gradient():
    """Layers whose views the loss does not use (here all but one, in turn)
    get zero rows, as the per-layer slicing gives them; without a gradient
    the views are plain rows of the stack, written in place as decode writes
    its caches."""
    w = torch.randn(3, 4, 2)
    for used in range(3):
        x = w.clone().requires_grad_(True)
        views = transformer.layer_views({"w": x}, 3)
        (g,) = torch.autograd.grad((views[used]["w"] ** 2).sum(), [x])
        want = torch.zeros_like(w)
        want[used] = 2 * w[used]
        assert torch.equal(g, want)
    with torch.no_grad():
        views = transformer.layer_views({"w": w, "cache": {}}, 3)
        views[1]["w"][:, 0] = 7.0
    assert all(torch.equal(v["w"], w[r]) and v["w"].grad_fn is None
               for r, v in enumerate(views))
    assert bool((w[1, :, 0] == 7.0).all())
