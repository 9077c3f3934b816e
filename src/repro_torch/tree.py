"""Nested dict/list trees of tensors: the port's parameter and state container.

A tree is a nest of ``dict``s and ``list``s whose leaves are tensors, numpy
arrays or Python ints. Dicts iterate by sorted key and lists by index, which is
``jax.tree_util.tree_flatten``'s order, and :func:`flatten_with_paths` names
each leaf with the same string ``jax.tree_util.keystr`` gives it
(``['segments'][0]['pos0']['mixer']['wq']``). So a flat packed buffer, an npz
checkpoint key and a carried-over weight are the same thing in both packages.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


class _Leaf:
    """Placeholder marking a leaf position inside a treedef."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "*"


_LEAF = _Leaf()


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` in JAX order; :func:`tree_unflatten` inverts it."""
    leaves: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the treedef has slots")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """``[(keystr, leaf)]`` in flatten order, keystr as ``jax.tree_util.keystr``."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix: str):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, f"{prefix}[{i}]")
        else:
            out.append((prefix, node))

    walk(tree, "")
    return out


_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _parse_path(path: str) -> List[Any]:
    keys, pos = [], 0
    for m in _KEY_RE.finditer(path):
        if m.start() != pos:
            raise ValueError(f"cannot parse tree path {path!r}")
        keys.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(path) or not keys:
        raise ValueError(f"cannot parse tree path {path!r}")
    return keys


def to_numpy(x) -> np.ndarray:
    """A leaf as the numpy array a checkpoint stores: bf16 tensors widen to
    float32 (as the JAX checkpoint writes them) and Python ints are int32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    if isinstance(x, (bool, np.bool_)):
        return np.asarray(x)
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    return np.asarray(x)


def params_to_numpy(tree) -> Dict[str, np.ndarray]:
    """``{keystr: ndarray}``: the same dict ``repro.checkpoint.checkpoint.
    _flatten_with_paths`` builds from the JAX tree."""
    return {path: to_numpy(leaf) for path, leaf in flatten_with_paths(tree)}


def params_from_numpy(flat: Dict[str, np.ndarray], device, dtype=None):
    """Rebuild a tree of tensors on ``device`` from ``{keystr: ndarray}`` (the
    weight carry-across from the JAX package). ``dtype`` casts floating leaves;
    by default each keeps its array's dtype."""
    root: Dict[Any, Any] = {}
    for path, arr in flat.items():
        keys = _parse_path(path)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        t = torch.from_numpy(np.array(arr, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        node[keys[-1]] = t.to(device)
    return _lists_from_int_keys(root)


def _lists_from_int_keys(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists_from_int_keys(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"list indices {sorted(out)} are not contiguous")
        return [out[i] for i in range(len(out))]
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in float32, as ``repro.core.inner_opt.global_norm``."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def clone(tree):
    """Copy every tensor leaf (the aggregator's ownership copy)."""
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)
