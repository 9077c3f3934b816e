"""Synchronous federated aggregation as a state machine — the flat path of
``repro.core.aggregator.SyncAggregator``.

The aggregator owns the server state and three policies:

  (a) admission — the ``ParticipationPlan``'s mask (availability → dropout →
      straggler cut, or partial progress: a slow client is admitted with the
      τ_i steps it realized);
  (b) weights — FedAvg data-size weights scaled by τ_i/τ under partial
      progress (:func:`partial_progress_weights`);
  (c) the checkpoint schema — the state tree (params/outer/round/rng) plus a
      ``{"schema", "kind", "round"}`` manifest, key for key the reference's, so
      a checkpoint written by either package resumes in the other.

Codecs, cohort tiles, robust rules and the async buffer are not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.federated import (
    FederatedConfig,
    federated_round,
    init_federated_state,
)
from repro_torch.core.sampler import ParticipationConfig, ParticipationPlan, plan_round
from repro_torch.tree import clone, tree_leaves, tree_map

#: version tag of the checkpoint schema, shared with the reference
AGGREGATOR_SCHEMA_VERSION = 1


def partial_progress_weights(weights, local_steps, tau: int) -> np.ndarray:
    """w_i = n_k,i · τ_i/τ (zero where masked); the plain weights when
    ``local_steps`` is None. With every τ_i = τ the scale is exactly 1.0."""
    w = np.asarray(weights, np.float32)
    if local_steps is None:
        return w
    frac = np.asarray(local_steps, np.float32) / np.float32(tau)
    return (w * frac).astype(np.float32)


class SyncAggregator:
    """Synchronous rounds over a fixed-width cohort (see module docstring).

    ``fused_server=True`` runs the server phase through
    ``kernels.fedcore.fused_apply_aggregate``: on the card, the CUDA
    ``server_apply`` kernel."""

    kind = "sync"

    def __init__(
        self,
        loss_fn: Callable,
        fed: FederatedConfig,
        pcfg: ParticipationConfig,
        *,
        seed: int = 0,
        partial_progress: bool = False,
        params=None,
        rng: Optional[np.ndarray] = None,
        state: Optional[Dict[str, Any]] = None,
        fused_server: bool = False,
    ):
        if partial_progress or pcfg.partial_progress:
            # the aggregator owns the policy: it teaches the participation
            # layer the round's τ so plan_round can derive per-client τ_i
            pcfg = replace(pcfg, partial_progress=True, local_steps=fed.local_steps)
        self.fed = fed
        self.pcfg = pcfg
        self.seed = seed
        self.partial_progress = pcfg.partial_progress
        self._loss_fn = loss_fn
        self._apply_fn = None
        if fused_server:
            from repro_torch.kernels.fedcore import fused_apply_aggregate

            self._apply_fn = fused_apply_aggregate
        if state is None:
            # own a copy: rounds replace the state, and the caller keeps its params
            self.state = init_federated_state(fed, clone(params), rng)
        else:
            self.restore(state, None)

    # --- (a) admission ---------------------------------------------------
    def plan(self, round_idx: int) -> ParticipationPlan:
        """The round's admission decisions — pure in (cfg, seed, r)."""
        return plan_round(self.pcfg, self.seed, round_idx)

    # --- (b) weight policy -----------------------------------------------
    def round_weights(self, plan: ParticipationPlan) -> np.ndarray:
        return partial_progress_weights(plan.weights, plan.local_steps, self.fed.local_steps)

    def tau_steps(self, plan: ParticipationPlan) -> Optional[np.ndarray]:
        """The (K,) step budgets. Masked slots keep the full τ (their output is
        weighted out anyway), as in the reference."""
        if plan.local_steps is None:
            return None
        return np.where(plan.mask, plan.local_steps, self.fed.local_steps).astype(np.int32)

    # --- the round -------------------------------------------------------
    def run_round(self, batches: Dict[str, torch.Tensor], plan: ParticipationPlan
                  ) -> Dict[str, torch.Tensor]:
        """One round under this aggregator's policies; replaces the owned state.

        The server phase builds the new state from fresh buffers (the fused
        kernel writes its results in place over the packed copies it reads)
        and the old state is dropped here — the stand-in for the reference's
        buffer donation: no params-sized output is allocated twice."""
        device = self.device
        w = torch.from_numpy(self.round_weights(plan)).to(device)
        tau = self.tau_steps(plan) if self.partial_progress else None
        self.state, metrics = federated_round(
            self._loss_fn, self.fed, self.state, batches, client_weights=w,
            tau_steps=tau, apply_fn=self._apply_fn,
        )
        return metrics

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.state["params"])[0].device

    # --- (c) checkpoint schema -------------------------------------------
    def checkpoint(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(state_tree, manifest)``; the tree is a host copy, so the next
        round cannot change what the caller saves."""
        manifest = {"schema": AGGREGATOR_SCHEMA_VERSION, "kind": self.kind,
                    "round": int(self.state["round"])}
        return tree_map(_host_copy, self.state), manifest

    def restore(self, state: Dict[str, Any], manifest: Optional[Dict[str, Any]] = None) -> None:
        """Adopt a restored state tree (as :func:`checkpoint.load_pytree`
        returns it, with the template's devices)."""
        if isinstance(manifest, dict):
            self.validate_manifest(manifest, self.kind)
        self.state = clone(state)

    @staticmethod
    def validate_manifest(manifest: Dict[str, Any], kind: str) -> None:
        if not isinstance(manifest, dict) or manifest.get("kind") != kind:
            found = manifest.get("kind") if isinstance(manifest, dict) else manifest
            raise ValueError(f"aggregator manifest kind {found!r} does not match {kind!r}")
        if int(manifest.get("schema", -1)) != AGGREGATOR_SCHEMA_VERSION:
            raise ValueError(
                f"aggregator checkpoint schema {manifest.get('schema')!r} != "
                f"supported version {AGGREGATOR_SCHEMA_VERSION}"
            )

    @classmethod
    def checkpoint_template(cls, fed: FederatedConfig, params_like) -> Dict[str, Any]:
        """A state tree shaped like ``checkpoint()[0]``: the ``like`` argument
        of ``checkpoint.load_pytree``."""
        return init_federated_state(fed, params_like)


def _host_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return x.copy()
    return x
