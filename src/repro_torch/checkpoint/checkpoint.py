"""Round checkpoints: an ``.npz`` of the state tree plus a JSON manifest per
round — the format of ``repro.checkpoint.checkpoint``, key for key, so a run of
either package resumes the other's checkpoint.

Every blob is written to a same-directory temp file, fsynced and
``os.replace``d into place, the manifest strictly after the state blob: a
round directory is either complete (parseable manifest + blob) or partial,
and ``latest_round()`` only ever selects complete ones.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, params_to_numpy, tree_flatten, tree_unflatten


def _atomic_write(path: str, writer) -> None:
    """Write via temp file + fsync + ``os.replace``: the final path holds the
    complete new content or is untouched."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _atomic_write_json(path: str, obj, **dump_kw) -> None:
    _atomic_write(path, lambda f: f.write(json.dumps(obj, **dump_kw).encode("utf-8")))


def save_pytree(path: str, tree) -> None:
    flat = params_to_numpy(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not path.endswith(".npz"):
        path = path + ".npz"
    _atomic_write(path, lambda f: np.savez(f, **flat))


@dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and device of a template leaf that is not allocated (the
    reference's ``jax.ShapeDtypeStruct``): a checkpoint template describes the
    residual lane of every ever-selected client without holding it."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: Any = "cpu"


def _like_leaf(arr: np.ndarray, like):
    if isinstance(like, (torch.Tensor, TensorSpec)):
        return torch.from_numpy(np.array(arr)).to(dtype=like.dtype, device=like.device)
    if isinstance(like, np.ndarray):
        return np.asarray(arr, dtype=like.dtype)
    if isinstance(like, int):
        return int(arr)
    raise TypeError(f"cannot restore a leaf like {type(like).__name__}")


def load_pytree(path: str, like) -> Any:
    """Restore into the structure of ``like``: each leaf takes the shape-checked
    array under its key path, with the template leaf's kind, dtype and device."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    leaves = []
    for key, leaf in flatten_with_paths(like):
        arr = data[key]
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {shape}")
        leaves.append(_like_leaf(arr, leaf))
    return tree_unflatten(tree_flatten(like)[1], leaves)


class CheckpointManager:
    """Round-granular checkpoint store with a JSON manifest per round."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    def _round_dir(self, rnd: int) -> str:
        return os.path.join(self.dir, f"round_{rnd:06d}")

    def _is_complete(self, rnd: int) -> bool:
        d = self._round_dir(rnd)
        if not os.path.exists(os.path.join(d, "server.npz")):
            return False
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        return True

    def _round_numbers(self):
        out = []
        for n in os.listdir(self.dir):
            if not n.startswith("round_"):
                continue
            try:
                out.append(int(n.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def save_server(self, rnd: int, state, extra: Optional[Dict] = None) -> str:
        d = self._round_dir(rnd)
        os.makedirs(d, exist_ok=True)
        # state blob first, manifest last: the manifest rename is the commit point
        save_pytree(os.path.join(d, "server.npz"), state)
        manifest = {"round": rnd, "extra": extra or {}}
        _atomic_write_json(os.path.join(d, "manifest.json"), manifest, indent=2)
        self._gc()
        return d

    def save_client(self, rnd: int, client_id: int, data_state: Dict) -> None:
        """One client's data cursor. Call it before the round's
        :meth:`save_server`: the manifest commits the round, cursors included."""
        d = self._round_dir(rnd)
        os.makedirs(d, exist_ok=True)
        _atomic_write_json(os.path.join(d, f"client_{client_id:04d}.json"), data_state)

    def latest_round(self) -> Optional[int]:
        rounds = [r for r in self._round_numbers() if self._is_complete(r)]
        return max(rounds) if rounds else None

    def load_manifest(self, rnd: int) -> Dict:
        with open(os.path.join(self._round_dir(rnd), "manifest.json")) as f:
            return json.load(f)

    def load_server(self, rnd: int, like) -> Tuple[Any, Dict]:
        state = load_pytree(os.path.join(self._round_dir(rnd), "server.npz"), like)
        return state, self.load_manifest(rnd)

    def load_client(self, rnd: int, client_id: int) -> Dict:
        with open(os.path.join(self._round_dir(rnd), f"client_{client_id:04d}.json")) as f:
            return json.load(f)

    def _gc(self) -> None:
        """Keep the last ``keep_last`` complete rounds; prune older partial
        rounds (a partial round newer than every complete one may be a save in
        flight and is left alone)."""
        rounds = self._round_numbers()
        complete = [r for r in rounds if self._is_complete(r)]
        if not complete:
            return
        doomed = set(complete[: -self.keep_last])
        newest_complete = complete[-1]
        doomed.update(r for r in rounds if r not in complete and r < newest_complete)
        for rnd in doomed:
            d = self._round_dir(rnd)
            for fn in os.listdir(d):
                os.remove(os.path.join(d, fn))
            os.rmdir(d)
