"""The server-side aggregation seam: ``repro.core.aggregator``'s
``SyncAggregator`` (the flat path), ``AsyncBufferAggregator`` and
``AsyncFederationDriver``.

An aggregator owns the server state and three policies:

  (a) admission — sync: the ``ParticipationPlan``'s mask (availability →
      dropout → straggler cut, or partial progress: a slow client is admitted
      with the τ_i steps it realized); async: the buffer door
      (``core/async_agg.admit_delta``) and the rule that a population client
      holds at most one dispatch slot;
  (b) weights — FedAvg data-size weights scaled by τ_i/τ under partial
      progress (:func:`partial_progress_weights`), then, async, the staleness
      discount at admission;
  (c) the checkpoint schema — ``checkpoint()`` gives ``(state_tree,
      manifest)``, key for key the reference's, so a checkpoint written by
      either package resumes in the other. Sync: params/outer/round/rng plus a
      sparse ``uplink_residuals`` lane for stateful codecs (every ever-selected
      client's row, stacked in sorted-id order), and a ``{"schema", "kind",
      "round"[, "uplink_ids"]}`` manifest. Async: the state with its buffer
      lanes, the residual rows, the K in-flight params snapshots stacked
      ``(K, ...)`` and, with a codec, ``uplink_rng``; the manifest carries the
      dispatch cursor, the simulated clock, the work and byte totals and each
      in-flight slot's ``(finish, index, version)``.

With an uplink ``codec`` the clients' deltas are encoded before the server
decodes them; a stateful codec's error-feedback residuals live in a
:class:`~repro_torch.core.federated.SparseResidualStore` keyed by population
client.

``SyncAggregator(cohort_tile=...)`` streams the cohort through the client
phase in tiles (Σ w·Δ per tile, one divide at the end), so the (C, N) delta
buffer is bounded by the tile. ``robust=`` (``core/robust``) installs a
robust rule or the delta screen at the server phase's ``apply_fn`` seam (a
per-tile order-statistic fold under tiling), keeps the quarantine table and
the divergence guard's state in ``manifest["robust"]``, and screens the async
door.

``tracer`` (``obs/``) records round, dispatch, admission and flush events at
the reference's sites; it only reads host floats the metrics path already
made, so a traced run is bitwise the untraced one. ``controller``
(``control/``) closes the loop: :meth:`Aggregator.control_step` feeds each
round or flush row to it and applies the :class:`~repro_torch.control.
KnobUpdate` it returns at that boundary — the cohort size and deadline
(sync) or the staleness exponent and the buffer size (async), so the fedcore
kernels run at the widths it picks. Its state rides ``manifest["control"]``.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import TensorSpec
from repro_torch.core.async_agg import (
    AsyncAggConfig,
    admission_record,
    admit_delta,
    flush_buffer,
    init_async_state,
)
from repro_torch.core.compression import Codec
from repro_torch.core.federated import (
    FederatedConfig,
    SparseResidualStore,
    _finish_aggregate,
    _weigh_clients,
    apply_aggregate_partial,
    combine_tile_metrics,
    federated_round,
    federated_round_with_uplink,  # noqa: F401  (the reference's public name)
    fold_in,
    init_federated_state,
    run_client_tile,
    run_clients,
    tile_rng,
    trace_attrs,
)
from repro_torch.core.robust import (
    RobustAggConfig,
    RobustState,
    make_robust_apply_fn,
    normclip_scale,
    sanitize_deltas,
    tile_fold_finish,
    tile_fold_init,
    tile_fold_size,
    tile_fold_update,
)
from repro_torch.core.sampler import (
    AsyncTimeline,
    ParticipationConfig,
    ParticipationPlan,
    plan_round,
)
from repro_torch.obs.metrics import observe_staleness
from repro_torch.obs.phases import phase, round_phases
from repro_torch.obs.tracer import NULL_TRACER, get_tracer
from repro_torch.tree import clone, global_norm, tree_leaves, tree_map

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


class Aggregator:
    """Base of the seam: the kind, the schema version, the manifest check and
    the control step."""

    kind = "base"
    #: an optional :class:`repro_torch.control.FederationController`; None (or
    #: a static one) leaves every path bitwise the uncontrolled run
    controller = None

    def checkpoint(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def apply_knobs(self, update) -> None:
        """Apply a :class:`~repro_torch.control.KnobUpdate` at a round or
        flush boundary."""
        raise NotImplementedError

    def control_step(self, row: Dict[str, Any]):
        """Feed one boundary row to the controller and apply what it returns;
        a no-op without an active controller. Returns the applied update or
        None."""
        c = self.controller
        if c is None or not c.enabled:
            return None
        update = c.observe(row)
        if update is None:
            return None
        self.apply_knobs(update)
        self._trace_knob_update(update)
        return update

    def _trace_knob_update(self, update) -> None:
        """The applied update as a ``knob_update`` instant with its evidence,
        and the ``control_*`` gauges."""
        t = self.tracer
        if not t.enabled:
            return
        attrs: Dict[str, Any] = {f"knob_{k}": v for k, v in update.knob_dict().items()}
        attrs.update({f"evidence_{k}": v for k, v in update.evidence.items()})
        t.point("knob_update", parent=getattr(self, "_round_span", None), **attrs)
        t.count("knob_updates")
        for k, v in self.controller.knobs().items():
            t.gauge(f"control_{k}", float(v))

    @staticmethod
    def validate_manifest(manifest: Dict[str, Any], kind: str) -> None:
        """Refuse a manifest of another kind or schema version: restoring it
        would replay a different state machine."""
        if not isinstance(manifest, dict) or manifest.get("kind") != kind:
            found = manifest.get("kind") if isinstance(manifest, dict) else manifest
            raise ValueError(f"aggregator manifest kind {found!r} does not match {kind!r}")
        if int(manifest.get("schema", -1)) != AGGREGATOR_SCHEMA_VERSION:
            raise ValueError(
                f"aggregator checkpoint schema {manifest.get('schema')!r} != "
                f"supported version {AGGREGATOR_SCHEMA_VERSION}"
            )

    def _manifest_header(self) -> Dict[str, Any]:
        return {"schema": AGGREGATOR_SCHEMA_VERSION, "kind": self.kind}


class SyncAggregator(Aggregator):
    """Synchronous rounds over a fixed-width cohort (see module docstring).

    ``fused_server=True`` runs the server phase through
    ``kernels.fedcore.fused_apply_aggregate``: on the card, the CUDA
    ``server_apply`` kernel. ``cohort_tile`` streams the cohort ``C_tile``
    clients at a time; one tile (``C_tile == C``) is bitwise the flat round.
    ``robust`` is a :class:`~repro_torch.core.robust.RobustAggConfig`."""

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
        codec: Optional[Codec] = None,
        cohort_tile: Optional[int] = None,
        robust: Optional[RobustAggConfig] = None,
        tracer=None,
        controller=None,
    ):
        self.tracer = get_tracer(tracer)
        self.controller = controller
        if robust is not None and robust.active and fused_server:
            raise ValueError(
                "--fused-server is a plain weighted-mean flat-buffer pass and "
                "cannot host a robust rule or the delta screen — drop one of "
                "--fused-server / --robust-agg / --screen"
            )
        if robust is not None and cohort_tile is not None:
            if robust.screen:
                raise ValueError(
                    "the median/MAD delta screen needs the whole cohort's "
                    "norms in one pass and cannot compose with --cohort-tile "
                    "(tiles fold before the cohort median exists) — drop "
                    "--screen or --cohort-tile"
                )
            if robust.rule == "normclip" and robust.clip_norm <= 0.0:
                raise ValueError(
                    "adaptive norm-clipping (clip_norm=0) needs the cohort "
                    "median norm before any tile folds — use an absolute "
                    "--clip-norm with --cohort-tile"
                )
        self.robust = robust
        self.robust_state = RobustState(robust) if robust is not None and robust.stateful \
            else None
        if partial_progress or pcfg.partial_progress:
            # the aggregator owns the policy: it teaches the participation
            # layer the round's τ so plan_round can derive per-client τ_i
            pcfg = replace(pcfg, partial_progress=True, local_steps=fed.local_steps)
        self.fed = fed
        self.pcfg = pcfg
        self.seed = seed
        self.partial_progress = pcfg.partial_progress
        self.codec = codec
        if cohort_tile is not None:
            cohort_tile = int(cohort_tile)
            if cohort_tile < 1:
                raise ValueError(f"cohort_tile must be >= 1, got {cohort_tile}")
            if fed.keep_inner_state:
                raise ValueError(
                    "cohort tiling cannot keep per-client inner state across "
                    "rounds (the (K, ...)-shaped inner store is the memory "
                    "term tiling removes) — drop --keep-opt or --cohort-tile"
                )
            if fused_server:
                raise ValueError(
                    "--fused-server consumes the full (C, N) delta buffer with "
                    "pre-normalized weights, not the tiled partial-sum layout "
                    "— drop one of --fused-server / --cohort-tile"
                )
        self.cohort_tile = cohort_tile
        self.residual_store = SparseResidualStore.create(
            codec, params if params is not None else (state or {}).get("params")
        )
        self._loss_fn = loss_fn
        self._apply_fn = None
        if fused_server:
            from repro_torch.kernels.fedcore import fused_apply_aggregate

            self._apply_fn = fused_apply_aggregate
        elif robust is not None and robust.active and cohort_tile is None:
            # the tiled path composes the robust rule as a per-tile fold instead
            self._apply_fn = make_robust_apply_fn(fed, robust)
        if state is None:
            # own a copy: rounds replace the state, and the caller keeps its params
            self.state = init_federated_state(fed, clone(params), rng)
        else:
            self.restore(state, None)

    def apply_knobs(self, update) -> None:
        """Apply a sync update between rounds: the deadline is a planning
        scalar; a new ``clients_per_round`` moves the participation and the
        federated configs together, so the next round (and its fused
        ``server_apply``) runs at that cohort width."""
        if update.staleness_alpha is not None or update.buffer_size is not None:
            raise ValueError(
                "sync aggregator has no async knobs (staleness_alpha/"
                "buffer_size belong to --aggregation async)"
            )
        if update.deadline is not None:
            self.pcfg = replace(
                self.pcfg,
                straggler=replace(self.pcfg.straggler, deadline=float(update.deadline)),
            )
        if update.clients_per_round is not None:
            k = int(update.clients_per_round)
            if self.fed.keep_inner_state:
                raise ValueError(
                    "cohort control cannot resize the keep_inner_state lanes "
                    "(the persisted inner optimizer state is (K, ...)-shaped) "
                    "— drop --keep-opt or use --control static"
                )
            self.pcfg = replace(self.pcfg, clients_per_round=k)
            self.fed = replace(self.fed, clients_per_round=k)

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

        Quarantined clients weigh 0 this round (nothing is touched while the
        table is empty). With the screen, the flagged clients are counted and
        quarantined, and ``screen_mask`` leaves the metrics."""
        t = self.tracer
        rs = self.robust_state
        rid = int(self.state["round"])
        if t.enabled:
            t.begin("round", span_id=f"r{rid}", round=rid,
                    effective_k=float(plan.effective_k), track=0)
        # a flat round's phase spans (obs/phases); a tiled round keeps only its round span
        with round_phases(t if self.cohort_tile is None else NULL_TRACER, f"r{rid}",
                          self.device) as phases:
            w = self.round_weights(plan)
            if rs is not None and rs.quarantine:
                q = np.asarray([rs.is_quarantined(int(c), rid)
                                for c in np.asarray(plan.selected)])
                if q.any():
                    w = np.where(q, np.float32(0.0), w).astype(np.float32)
            if self.cohort_tile is not None:
                metrics = self._run_round_tiled(batches, plan, w)
            else:
                metrics = self._run_round_flat(batches, plan, w)
            metrics = dict(metrics)
            screen_mask = metrics.pop("screen_mask", None)
            if screen_mask is not None and rs is not None:
                with phase("screen"):
                    flagged = np.nonzero(screen_mask.cpu().numpy() > 0)[0]
                if len(flagged):
                    sel = np.asarray(plan.selected)
                    cids = [int(sel[i]) for i in flagged]
                    rs.note_screen_rejects(len(cids))
                    rs.add_quarantine(cids, rid)
                    if t.enabled:
                        for cid in cids:
                            t.point("screen_reject", parent=f"r{rid}", client=cid, round=rid)
                            t.count("screen_rejects")
            if t.enabled:
                with phase("readout"):
                    attrs = trace_attrs(metrics)  # the one device read tracing pays
                rollup = phases.finish() if phases is not None else {}
        if t.enabled:
            t.end(f"r{rid}", **attrs, **rollup)
            t.count("rounds")
            t.gauge("round", rid + 1)
            for k, v in attrs.items():
                t.gauge(k, v)
        return metrics

    def _run_round_flat(self, batches, plan: ParticipationPlan, w: np.ndarray
                        ) -> Dict[str, torch.Tensor]:
        """The cohort-wide round. The server phase builds the new state from
        fresh buffers (the fused kernel writes its results in place over the
        packed copies it reads) and the old state is dropped here — the
        stand-in for the reference's buffer donation."""
        tau = self.tau_steps(plan) if self.partial_progress else None
        stateful = self.residual_store is not None
        with phase("prologue"):
            residuals = self.residual_store.gather(plan.selected) if stateful else None
            client_weights = torch.from_numpy(w).to(self.device)
        self.state, metrics = federated_round(
            self._loss_fn, self.fed, self.state, batches,
            client_weights=client_weights, tau_steps=tau,
            apply_fn=self._apply_fn, codec=self.codec, residuals=residuals,
        )
        if stateful:
            # the cohort's updated rows belong in the population store
            with phase("scatter"):
                self.residual_store.scatter(plan.selected, self.state.pop("uplink_residuals"))
        return metrics

    def _run_round_tiled(self, batches, plan: ParticipationPlan, w: np.ndarray
                         ) -> Dict[str, torch.Tensor]:
        """The streamed round: ⌈C / C_tile⌉ tiles through
        :func:`run_client_tile`, Σ w·Δ summed across tiles and divided once by
        :func:`apply_aggregate_partial`. The last tile pads to the tile width
        with zero-weight slots (a zero batch, a zero residual row, the full
        τ) that never touch the residual store. Each tile's (C_tile, N)
        deltas are freed before the next tile runs. A trimmed or median rule
        folds each tile into order-statistic buffers instead of the sum;
        normclip (absolute threshold) clips each client inside its tile."""
        C, ct = self.fed.clients_per_round, self.cohort_tile
        n_tiles = -(-C // ct)
        device = self.device
        stateful = self.residual_store is not None
        tau_np = (np.asarray(self.tau_steps(plan), np.int32) if self.partial_progress
                  else None)
        w_full = np.zeros(n_tiles * ct, np.float32)
        w_full[:C] = w
        fed_tile = replace(self.fed, clients_per_round=ct)
        core = {"params": self.state["params"], "round": self.state["round"]}
        base_rng = self.state["rng"]
        robust = self.robust
        rule = robust.rule if robust is not None and robust.active else None
        fold = None
        if rule in ("trimmed", "median"):
            k = tile_fold_size(rule, robust.trim_fraction, n_tiles * ct)
            fold = tile_fold_init(self.state["params"], k)
        delta_sum, delta_norms, tile_outs = None, [], []
        sel = np.asarray(plan.selected)
        for t in range(n_tiles):
            lo, hi = t * ct, min((t + 1) * ct, C)
            n_real = hi - lo

            def pad(x, dim=0):
                if n_real == ct:
                    return x
                shape = list(x.shape)
                shape[dim] = ct - n_real
                return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)],
                                 dim=dim)

            b_t = {k: pad(v[:, lo:hi], dim=1) for k, v in batches.items()}
            w_t = torch.from_numpy(w_full[t * ct:(t + 1) * ct].copy()).to(device)
            res_t = (tree_map(pad, self.residual_store.gather(sel[lo:hi])) if stateful
                     else None)
            tau_t = None
            if tau_np is not None:
                # pad slots take the full τ, as masked slots do (tau_steps())
                tau_t = np.concatenate([tau_np[lo:hi], np.full(ct - n_real, self.fed.local_steps,
                                                               np.int32)])
            s_t = dict(core, rng=tile_rng(base_rng, t))
            out = run_client_tile(self._loss_fn, fed_tile, s_t, b_t, w_t, codec=self.codec,
                                  residuals=res_t, tau_steps=tau_t,
                                  return_deltas=rule is not None)
            del b_t, res_t
            if stateful:
                rows = out.pop("residuals")
                self.residual_store.scatter(sel[lo:hi], tree_map(lambda x: x[:n_real], rows))
                del rows
            ds, dn_t = out.pop("delta_sum"), out.pop("delta_norms")
            with torch.no_grad():
                if fold is not None:
                    finite = torch.isfinite(dn_t)
                    deltas = sanitize_deltas(out.pop("deltas"), finite)
                    fold = tile_fold_update(fold, deltas, (w_t > 0) & finite)
                    del deltas
                else:
                    if rule == "normclip":
                        ds = _clip_sum(out.pop("deltas"), dn_t, w_t, robust.clip_norm)
                    if delta_sum is None:
                        delta_sum = ds
                    else:
                        tree_map(lambda a, b: a.add_(b), delta_sum, ds)
            del ds
            delta_norms.append(dn_t)
            tile_outs.append(out)
        dn = torch.cat(delta_norms)
        w_all = torch.from_numpy(w_full).to(device)
        if fold is not None:
            pg = tile_fold_finish(fold, rule, robust.trim_fraction)
            del fold
            self.state, agg_metrics = _finish_aggregate(self.fed, self.state, pg, dn, w_all)
        else:
            self.state, agg_metrics = apply_aggregate_partial(self.fed, self.state, delta_sum,
                                                              w_all, dn)
        return dict(combine_tile_metrics(tile_outs), **agg_metrics)

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.state["params"])[0].device

    # --- (c) checkpoint schema -------------------------------------------
    def checkpoint(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(state_tree, manifest)``; the tree is a host copy, so the next
        round cannot change what the caller saves."""
        manifest = dict(self._manifest_header(), round=int(self.state["round"]))
        tree = tree_map(_host_copy, self.state)
        if self.residual_store is not None:
            # sparse lane: every ever-selected client's row in sorted-id
            # order; the id list rides the manifest so a load template can be
            # sized without reading the npz
            manifest["uplink_ids"] = self.residual_store.ids()
            tree["uplink_residuals"] = tree_map(_host_copy, self.residual_store.stacked())
        if self.controller is not None and self.controller.enabled:
            # absent for static/None: the uncontrolled manifest is unchanged
            manifest["control"] = self.controller.state_dict()
        if self.robust_state is not None:
            # absent when the defense is off: the undefended manifest is unchanged
            manifest["robust"] = self.robust_state.state_dict()
        return tree, manifest

    def adopt_model(self, tree: Dict[str, Any]) -> None:
        """Adopt a rolled-back ``{params, outer}`` subset (divergence
        rollback): the model and outer lanes rewind while ``round`` and
        ``rng`` keep advancing, so a resumed run replays the same rollback."""
        self.state = dict(self.state, params=clone(tree["params"]), outer=clone(tree["outer"]))

    def restore(self, state: Dict[str, Any], manifest: Optional[Dict[str, Any]] = None) -> None:
        """Adopt a restored state tree (as :func:`checkpoint.load_pytree`
        returns it, with the template's devices). An ``uplink_residuals`` lane
        goes to the sparse store: with ``manifest["uplink_ids"]`` it is the
        sparse stacked layout; without, a legacy dense ``(population, ...)``
        lane, whose all-zero rows stay unmaterialized."""
        if isinstance(manifest, dict):
            self.validate_manifest(manifest, self.kind)
        state = dict(state)
        res = state.pop("uplink_residuals", None)
        if res is not None:
            if self.codec is None or not self.codec.stateful:
                raise ValueError(
                    "restored state carries per-client error-feedback residuals but this "
                    "aggregator's codec is not stateful — pass the codec the checkpoint "
                    "was written with"
                )
            ids = manifest.get("uplink_ids") if isinstance(manifest, dict) else None
            leading = tree_leaves(res)[0].shape[0]
            if ids is not None:
                if len(ids) != leading:
                    raise ValueError(f"uplink_residuals lane has {leading} rows but the "
                                     f"manifest lists {len(ids)} uplink_ids")
                self.residual_store = SparseResidualStore.from_stacked(state["params"], ids, res)
            elif leading == self.pcfg.population:
                self.residual_store = SparseResidualStore.from_dense(state["params"], res)
            else:
                raise ValueError(
                    f"uplink_residuals lane has leading dim {leading}, which matches neither "
                    f"the manifest's uplink_ids (absent) nor the dense "
                    f"(population={self.pcfg.population}, ...) layout"
                )
        if self.robust_state is not None and isinstance(manifest, dict) and "robust" in manifest:
            # a manifest without the key restores a clean slate
            self.robust_state.load_state_dict(manifest["robust"])
        self.state = clone(state)

    @classmethod
    def checkpoint_template(cls, fed: FederatedConfig, pcfg: ParticipationConfig, params_like,
                            codec: Optional[Codec] = None, uplink_ids=None) -> Dict[str, Any]:
        """A state tree shaped like ``checkpoint()[0]``: the ``like`` argument
        of ``checkpoint.load_pytree``. ``uplink_ids`` (the manifest's id list)
        sizes the residual lane; ``None`` means the legacy dense ``(P, ...)``
        layout. The lane's leaves are :class:`~repro_torch.checkpoint.
        TensorSpec`s: a template never allocates the store it describes."""
        state = init_federated_state(fed, params_like)
        if codec is not None and codec.stateful:
            n = pcfg.population if uplink_ids is None else len(uplink_ids)
            state["uplink_residuals"] = tree_map(
                lambda p: TensorSpec((n,) + tuple(p.shape), torch.float32, p.device),
                params_like,
            )
        return state


def _clip_sum(deltas, norms: torch.Tensor, w: torch.Tensor, clip_norm: float):
    """A tile's Σ w_k s_k Δ_k with each client clipped at the absolute
    ``clip_norm`` (normclip under tiling); non-finite lanes are zeroed first."""
    finite = torch.isfinite(norms)
    scale = normclip_scale(norms, (w > 0) & finite,
                           torch.tensor(float(clip_norm), dtype=torch.float32,
                                        device=norms.device))
    clean = sanitize_deltas(deltas, finite)
    return tree_map(lambda x: torch.sum(_weigh_clients(x, w.float() * scale), dim=0), clean)


def _host_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return x.copy()
    return x


def _host_tree(tree):
    return tree_map(_host_copy, tree)


#: the fedcore kernels the async path launches with ``fused_server`` and a
#: fused codec, by ``--uplink``, each with the counter of
#: :class:`AsyncBufferAggregator` its launch count equals: ``server_apply``
#: once per non-empty flush, the encode kernel once per client phase,
#: ``int8_dequant`` once per admission (decoded at the buffer door)
ASYNC_KERNEL_COUNTERS = {
    "float32": {"server_apply": "n_flushes"},
    "topk": {"server_apply": "n_flushes", "topk_mask_ef": "n_client_phases"},
    "bf16": {"server_apply": "n_flushes", "sr_bf16": "n_client_phases"},
    "int8": {"server_apply": "n_flushes", "int8_quant": "n_client_phases",
             "int8_dequant": "n_admissions"},
}


class AsyncBufferAggregator(Aggregator):
    """Asynchronous (FedBuff-style) buffered aggregation as a state machine.

      (a) admission — :meth:`admit`, the buffer door of
          ``core/async_agg.admit_delta``, and :meth:`_dispatch`: a population
          client holds at most one slot at a time.
      (b) weights — :meth:`event_weight` credits a completion τ_i/τ under
          partial progress; the staleness discount is applied at admission.
      (c) checkpoint — :meth:`checkpoint` (see the module docstring). The
          timeline is pure in ``(cfg, seed, n)``, so restoring the state, the
          residual rows, the in-flight snapshots and the manifest replays the
          run bitwise.

    The in-flight slots hold their params snapshot by reference: nothing in
    this package writes a params tensor in place (a flush builds new params,
    the client phase trains a copy), so a snapshot keeps the version it was
    dispatched with. The event loop is :class:`AsyncFederationDriver`.

    With ``robust``: a robust rule guards each flush (its screen is off there:
    the screen runs at the door, :meth:`admit`, against
    :meth:`RobustState.norm_bound`), and ``corrupt_fn`` (the attack
    simulator, ``core/robust.make_byzantine_fn``) corrupts an upload between
    the client phase and the door."""

    kind = "async"

    def __init__(
        self,
        fed: FederatedConfig,
        acfg: AsyncAggConfig,
        pcfg: ParticipationConfig,
        *,
        seed: int = 0,
        params=None,
        rng: Optional[np.ndarray] = None,
        state: Optional[Dict[str, Any]] = None,
        codec: Optional[Codec] = None,
        dispatch: Optional[Dict[str, Any]] = None,
        fused_server: bool = False,
        robust: Optional[RobustAggConfig] = None,
        tracer=None,
        controller=None,
    ):
        self.fed = fed
        self.acfg = acfg
        self.pcfg = pcfg
        self.codec = codec
        self.seed = seed
        self.fused_server = fused_server
        self.tracer = get_tracer(tracer)
        self.controller = controller
        if robust is not None and robust.active and fused_server:
            raise ValueError(
                "--fused-server is a plain weighted-mean flat-buffer pass and "
                "cannot host a robust rule or the delta screen — drop one of "
                "--fused-server / --robust-agg / --screen"
            )
        self.robust = robust
        self.robust_state = RobustState(robust) if robust is not None and robust.stateful \
            else None
        self._screen = robust is not None and robust.screen
        #: an optional ``(client_id, dispatch_index, upload) -> upload`` hook run
        #: before the door: the Byzantine-client simulator; None on honest runs
        self.corrupt_fn = None
        if pcfg.partial_progress and pcfg.local_steps != fed.local_steps:
            raise ValueError(
                "pcfg.local_steps must equal fed.local_steps under partial "
                f"progress (got {pcfg.local_steps} vs {fed.local_steps})"
            )
        self._apply_fn = None
        if fused_server:
            from repro_torch.kernels.fedcore import fused_apply_aggregate

            self._apply_fn = fused_apply_aggregate
        elif robust is not None and robust.rule != "none":
            # the buffer holds admitted deltas only, but may still hold poison
            # from before the screen's warmup: the rule's sanitize absorbs it
            self._apply_fn = make_robust_apply_fn(fed, replace(robust, screen=False))
        state = init_async_state(fed, acfg, params, rng) if state is None else dict(state)
        inflight = state.pop("inflight_params", None)
        uplink_rng = state.pop("uplink_rng", None)
        restored_res = state.pop("uplink_residuals", None)
        self.state = state
        stateful = codec is not None and codec.stateful
        if restored_res is not None and not stateful:
            raise ValueError(
                "restored state carries per-client error-feedback residuals but the "
                "codec is not stateful — pass the codec the checkpoint was written with"
            )
        self.residuals: Optional[SparseResidualStore] = None
        if stateful:
            params_like = self.state["params"]
            if restored_res is None:
                self.residuals = SparseResidualStore(params_like)
            else:
                ids = dispatch.get("uplink_ids") if isinstance(dispatch, dict) else None
                leading = tree_leaves(restored_res)[0].shape[0]
                if ids is not None:
                    self.residuals = SparseResidualStore.from_stacked(params_like, ids,
                                                                      restored_res)
                elif leading == pcfg.population:
                    self.residuals = SparseResidualStore.from_dense(params_like, restored_res)
                else:
                    raise ValueError(
                        f"uplink_residuals lane has leading dim {leading}, which matches "
                        f"neither the manifest's uplink_ids (absent) nor the dense "
                        f"(population={pcfg.population}, ...) layout"
                    )
        self._bytes_per_upload = (
            float(codec.nbytes(self.state["params"])) if codec is not None
            else 4.0 * sum(x.numel() for x in tree_leaves(self.state["params"]))
        )
        # the run's codec key: derived once from the rng lane, restored verbatim
        self._uplink_rng = None
        if codec is not None:
            self._uplink_rng = (np.asarray(uplink_rng, np.uint32) if uplink_rng is not None
                                else fold_in(self.state["rng"], 0x55504C4B))
        self.uplink_bytes_total = 0.0  # bytes uploaded, refused uploads included
        self.timeline = AsyncTimeline(pcfg, seed)
        self.sim_time = 0.0
        self.work_completed = 0.0  # simulated client time that reached the buffer
        self.work_wasted = 0.0  # dropout / refused client time
        self.n_dispatched = 0  # the dispatch cursor
        self._heap: List[Tuple[float, int, Any, Any, int]] = []
        self._busy: set = set()  # population ids holding a slot
        self._losses: List[float] = []  # client train losses since the last flush
        self._staleness: List[float] = []  # admitted staleness since the last flush
        self._res_norms: List[float] = []  # error-feedback residual norms since then
        # this process's counts (not checkpointed): what the kernels' launch
        # counts are held against on the card
        self.n_flushes = 0  # non-empty flushes (one server_apply each when fused)
        self.n_admissions = 0  # uploads that reached the door (one decode each)
        self.n_client_phases = 0  # client phases run (one codec encode each)
        # the server's round span: dispatch spans of version v parent into
        # "u{v}"; _trace_flush rotates it when a flush bumps the version
        self._round_span = f"u{int(self.state['round'])}" if self.tracer.enabled else None
        if self.tracer.enabled:
            self.tracer.begin("round", span_id=self._round_span,
                              round=int(self.state["round"]), track=0)
        if dispatch is not None:
            if self.robust_state is not None and "robust" in dispatch:
                # a manifest without the key restores a clean slate
                self.robust_state.load_state_dict(dispatch["robust"])
            self._restore_dispatch(dispatch, inflight)
        else:
            for _ in range(pcfg.clients_per_round):
                self._dispatch()

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.state["params"])[0].device

    def apply_knobs(self, update) -> None:
        """Apply an async update at a flush boundary: ``staleness_alpha``
        changes the door's discount; ``buffer_size`` reallocates the buffer
        lanes at the new M, which is sound only while the buffer is empty
        (every flush drains it, and :meth:`control_step` runs in
        :meth:`_flush_row`). The fused flush packs the lanes afresh at each
        call, so its next ``server_apply`` runs at the new width. The dispatch
        timeline is pure in ``(pcfg, seed)`` and neither knob touches it."""
        if update.clients_per_round is not None or update.deadline is not None:
            raise ValueError(
                "async control drives staleness_alpha/buffer_size only: the "
                "dispatch timeline is pure in (participation config, seed) "
                "and cannot change mid-run (cohort/deadline are sync knobs)"
            )
        acfg = self.acfg
        if update.staleness_alpha is not None:
            acfg = replace(acfg, staleness_alpha=float(update.staleness_alpha))
        if update.buffer_size is not None and int(update.buffer_size) != acfg.buffer_size:
            if int(self.state["buf_count"]) != 0:
                raise RuntimeError(
                    f"buffer resize with {int(self.state['buf_count'])} "
                    f"buffered deltas — knob updates must land at a flush "
                    f"boundary (the buffer drains at every flush)"
                )
            m = int(update.buffer_size)
            acfg = replace(acfg, buffer_size=m)
            self.state = dict(
                self.state,
                buffer=tree_map(lambda p: torch.zeros((m,) + tuple(p.shape), dtype=torch.float32,
                                                      device=p.device), self.state["params"]),
                buf_weights=torch.zeros((m,), dtype=torch.float32),
                buf_staleness=torch.zeros((m,), dtype=torch.float32),
            )
        self.acfg = acfg
        self._notify_knobs(update)

    def _notify_knobs(self, update) -> None:
        """Fired after an update is applied; the socket runtime's driver
        passes it on to its backend."""

    # --- dispatch --------------------------------------------------------
    def _dispatch(self) -> None:
        # skip timeline entries whose client is in flight: at refill at most
        # K−1 clients are busy and each wave names K distinct clients, so a
        # free one comes within two waves
        for _ in range(64 * self.timeline.cfg.clients_per_round):
            ev = self.timeline.dispatch(self.n_dispatched)
            self.n_dispatched += 1
            if ev.client not in self._busy:
                break
        else:  # pragma: no cover — unreachable by the argument above
            raise RuntimeError("async dispatch starved: every client busy")
        self._busy.add(ev.client)
        snapshot = self.state["params"] if ev.completes else None
        version = int(self.state["round"])
        heapq.heappush(self._heap, (self.sim_time + ev.duration, ev.index, ev, snapshot, version))
        self._on_dispatch(ev, snapshot, version)
        self._trace_dispatch(ev, version)

    def _on_dispatch(self, ev, snapshot, version: int) -> None:
        """Fired once per dispatched slot, restored slots included: the
        socket runtime hands the slot's assignment to its backend here."""

    # --- telemetry (reads host values only) ------------------------------
    def _trace_dispatch(self, ev, version: int) -> None:
        """Open the dispatch span ``d{index}`` under the round span of its
        snapshot's version, on the client's display track."""
        if not self.tracer.enabled:
            return
        self.tracer.begin(
            "dispatch", span_id=f"d{ev.index}", parent=f"u{version}",
            index=ev.index, client=int(ev.client), version=version,
            completes=bool(ev.completes), track=1 + int(ev.client),
        )
        self.tracer.count("dispatches")

    def _trace_complete(self, ev, outcome: str, staleness=None) -> None:
        """Close a dispatch span with its terminal outcome."""
        if not self.tracer.enabled:
            return
        attrs: Dict[str, Any] = {"outcome": outcome}
        if staleness is not None:
            attrs["staleness"] = float(staleness)
        self.tracer.end(f"d{ev.index}", **attrs)
        self.tracer.count(f"outcome_{outcome}")

    def _trace_admit(self, ev, metrics) -> Dict[str, Any]:
        """One admission's instant, counters and histogram; returns its host
        record (``{}`` untraced)."""
        if not self.tracer.enabled:
            return {}
        rec = admission_record(metrics)
        self.tracer.point("admit", parent=f"d{ev.index}", index=ev.index,
                          client=int(ev.client), **rec)
        if rec["accepted"]:
            self.tracer.count("admits")
            observe_staleness(self.tracer, rec["staleness"])
        else:
            self.tracer.count("admit_rejects")
        self.tracer.gauge("buffer_occupancy", rec.get("buf_count", 0.0) / self.acfg.buffer_size)
        return rec

    def _pop_completion(self):
        finish, _, ev, snapshot, version = heapq.heappop(self._heap)
        self.sim_time = max(self.sim_time, finish)
        self._busy.discard(ev.client)
        return ev, snapshot, version

    def dispatch_key(self, index: int) -> np.ndarray:
        """The codec key of dispatch ``index``: a function of the run's
        ``uplink_rng`` and the index alone, so a resumed run draws the same
        noise. This package's rule (:func:`fold_in`), not JAX's bits."""
        return fold_in(self._uplink_rng, index)

    # --- per-client error-feedback rows ----------------------------------
    @staticmethod
    def _res_gather(store: SparseResidualStore, cid):
        """One client's row as a ``(1, ...)`` tree (zeros before its first upload)."""
        return tree_map(lambda r: r[None], store.row(int(cid)))

    @staticmethod
    def _res_scatter(store: SparseResidualStore, cid, new) -> None:
        """Write a client's updated ``(1, ...)`` row back (a copy)."""
        store.scatter([int(cid)], new)

    # --- (a)/(b) admission and weights -----------------------------------
    def event_weight(self, ev) -> float:
        """A completion's pre-discount weight: the plan's, times τ_i/τ under
        partial progress."""
        if self.pcfg.partial_progress and ev.local_steps:
            return float(ev.weight) * ev.local_steps / self.pcfg.local_steps
        return float(ev.weight)

    def admit(self, delta, version: int, weight: float) -> Dict[str, Any]:
        """Admit one upload (a codec payload is decoded at the door) tagged
        with the version it was computed against; a refusal takes no slot.
        With the screen, the door also refuses a non-finite delta and one over
        the adaptive norm bound."""
        self.n_admissions += 1
        kw: Dict[str, Any] = {}
        if self._screen:
            kw = dict(screen=True, norm_bound=(self.robust_state.norm_bound()
                                               if self.robust_state is not None
                                               else float("inf")))
        self.state, m = admit_delta(self.fed, self.acfg, self.state, delta, version, weight,
                                    auto_flush=False, codec=self.codec, **kw)
        return m

    def _note_admission(self, ev, m) -> None:
        """The defense's bookkeeping of one admission: every finite norm seen
        at the door feeds the adaptive bound; a screened refusal is counted,
        and only a non-finite one quarantines its sender (a norm-bound miss
        is weak evidence, and a round-indexed quarantine of honest clients
        would stall the run)."""
        rs = self.robust_state
        if rs is None or "delta_norm" not in m:
            return
        norm = float(m["delta_norm"])
        finite = math.isfinite(norm)
        if finite:
            rs.observe_norm(norm)
        if float(m["accepted"]) <= 0 and float(m.get("screened", 0.0)) > 0:
            rs.note_screen_rejects()
            if not finite:
                rs.add_quarantine([int(ev.client)], int(self.state["round"]))
            if self.tracer.enabled:
                self.tracer.point("screen_reject", parent=f"d{ev.index}", index=ev.index,
                                  client=int(ev.client), norm=norm if finite else -1.0)
                self.tracer.count("screen_rejects")

    def flush(self) -> Dict[str, Any]:
        """One outer update from the buffer; bumps the version unless empty."""
        self.n_flushes += int(self.state["buf_count"]) > 0
        self.state, m = flush_buffer(self.fed, self.acfg, self.state, apply_fn=self._apply_fn)
        return m

    def should_flush(self) -> bool:
        return int(self.state["buf_count"]) >= self.acfg.buffer_size

    def _flush_row(self, flush_metrics, deadline: bool = False) -> Dict[str, Any]:
        row: Dict[str, Any] = {k: float(v) for k, v in flush_metrics.items()}
        row["sim_time"] = self.sim_time
        row["train_loss_mean"] = (
            float(torch.tensor(self._losses, dtype=torch.float32).mean()) if self._losses
            else 0.0
        )
        row["admitted_staleness"] = list(self._staleness)
        row["uplink_bytes_total"] = self.uplink_bytes_total
        if self.residuals is not None:
            row["uplink_residual_norm"] = (
                sum(self._res_norms) / len(self._res_norms) if self._res_norms else 0.0
            )
        self._losses, self._staleness, self._res_norms = [], [], []
        self._trace_flush(row, deadline)
        # the flush boundary is the async control point: the buffer just
        # drained, so a resize is safe; applied knobs echo into the row
        update = self.control_step(row)
        if update is not None:
            for k, v in update.knob_dict().items():
                row[f"knob_{k}"] = v
        return row

    def _trace_flush(self, row: Dict[str, Any], deadline: bool) -> None:
        """A flush instant; the round span rotates when the flush bumped the
        version (an empty deadline flush does not)."""
        t = self.tracer
        if not t.enabled:
            return
        new_round = int(self.state["round"])
        attrs = {"round": new_round, "deadline": deadline, "sim_time": row["sim_time"],
                 "train_loss": row["train_loss_mean"]}
        for k in ("buffer_fill", "staleness_mean", "staleness_max"):
            if k in row:
                attrs[k] = row[k]
        t.point("flush", parent=self._round_span, **attrs)
        t.count("deadline_flushes" if deadline else "flushes")
        if f"u{new_round}" != self._round_span:
            t.end(self._round_span, **{k: v for k, v in attrs.items() if k != "round"})
            self._round_span = f"u{new_round}"
            t.begin("round", span_id=self._round_span, round=new_round, track=0)
        t.gauge("round", new_round)
        t.gauge("sim_time", row["sim_time"])
        t.gauge("train_loss", row["train_loss_mean"])
        t.gauge("uplink_bytes_total", row["uplink_bytes_total"])
        if "buffer_fill" in row:
            t.gauge("last_flush_fill", row["buffer_fill"])

    def finalize_trace(self) -> None:
        """Close the K in-flight dispatch spans (``inflight_at_exit``) and the
        round span at the end of a run, so the report's check can tell a
        clean exit from a leak."""
        if not self.tracer.enabled:
            return
        for _, _, ev, _, _ in sorted(self._heap, key=lambda e: (e[0], e[1])):
            self._trace_complete(ev, "inflight_at_exit")
        self.tracer.end(self._round_span)

    def force_flush(self) -> Optional[Dict[str, Any]]:
        """A last outer update from a partly filled buffer (end of a run); a
        row shaped as the driver's flush rows, or None when it is empty."""
        if int(self.state["buf_count"]) == 0:
            return None
        return self._flush_row(self.flush())

    # --- (c) checkpoint ---------------------------------------------------
    def checkpoint_state(self) -> Dict[str, Any]:
        """Server state and the per-client error-feedback store as one tree
        with a fixed structure (the legacy dense schema, kept for buffer-only
        round trips): the residual lane is the dense ``(P, ...)`` expansion
        of the sparse store; :meth:`checkpoint` writes the sparse lane. A host
        copy, as :meth:`checkpoint`'s tree: the next admission writes the
        buffer lanes in place."""
        tree = _host_tree(self.state)
        if self.residuals is not None:
            tree["uplink_residuals"] = _host_tree(self.residuals.to_dense(self.pcfg.population))
        return tree

    def checkpoint(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(state_tree, manifest)``. The tree is a host copy of every lane —
        the next admission writes the buffer, its weights and the residual
        rows in place — with the sparse residual lane, ``inflight_params``
        (the K slots' snapshots stacked in sorted ``(finish, index)`` order)
        and, with a codec, ``uplink_rng``."""
        entries = sorted(self._heap, key=lambda e: (e[0], e[1]))
        tree = _host_tree(self.state)
        if self.residuals is not None:
            tree["uplink_residuals"] = _host_tree(self.residuals.stacked())
        snaps = [snap if snap is not None else self.state["params"]  # filler: never read
                 for _, _, _, snap, _ in entries]
        tree["inflight_params"] = tree_map(
            lambda *xs: torch.stack([x.detach().cpu() for x in xs]), *snaps)
        if self._uplink_rng is not None:
            tree["uplink_rng"] = self._uplink_rng.copy()
        manifest = dict(
            self._manifest_header(),
            cursor=int(self.n_dispatched),
            sim_time=float(self.sim_time),
            work_completed=float(self.work_completed),
            work_wasted=float(self.work_wasted),
            uplink_bytes_total=float(self.uplink_bytes_total),
            slots=[{"finish": float(finish), "index": int(index), "version": int(ver)}
                   for finish, index, _, _, ver in entries],
        )
        if self.residuals is not None:
            manifest["uplink_ids"] = self.residuals.ids()
        if self.controller is not None and self.controller.enabled:
            manifest["control"] = self.controller.state_dict()
        if self.robust_state is not None:
            manifest["robust"] = self.robust_state.state_dict()
        return tree, manifest

    def adopt_model(self, tree: Dict[str, Any]) -> None:
        """Adopt a rolled-back ``{params, outer}`` subset and drain the buffer:
        its deltas were admitted into the poisoned trajectory. ``round``,
        ``rng`` and the dispatch machinery keep advancing; in-flight
        snapshots keep the params they were dispatched with."""
        m = self.acfg.buffer_size
        params = clone(tree["params"])
        self.state = dict(
            self.state, params=params, outer=clone(tree["outer"]),
            buffer=tree_map(lambda p: torch.zeros((m,) + tuple(p.shape), dtype=torch.float32,
                                                  device=p.device), params),
            buf_weights=torch.zeros((m,), dtype=torch.float32),
            buf_staleness=torch.zeros((m,), dtype=torch.float32),
            buf_count=0,
        )

    def _restore_dispatch(self, manifest: Dict[str, Any], inflight) -> None:
        self.validate_manifest(manifest, self.kind)
        slots = manifest["slots"]
        K = self.pcfg.clients_per_round
        if len(slots) != K:
            raise ValueError(
                f"dispatch manifest has {len(slots)} in-flight slots but this configuration "
                f"runs {K} — resume with the checkpoint's clients_per_round"
            )
        if inflight is None:
            raise ValueError(
                "dispatch manifest given but the state tree carries no 'inflight_params' — "
                "load through the aggregator's checkpoint_template"
            )
        self.n_dispatched = int(manifest["cursor"])
        self.sim_time = float(manifest["sim_time"])
        self.work_completed = float(manifest["work_completed"])
        self.work_wasted = float(manifest["work_wasted"])
        self.uplink_bytes_total = float(manifest["uplink_bytes_total"])
        for pos, slot in enumerate(slots):
            ev = self.timeline.dispatch(int(slot["index"]))  # pure in (cfg, seed, index)
            snapshot = tree_map(lambda x, p=pos: x[p], inflight) if ev.completes else None
            heapq.heappush(self._heap, (float(slot["finish"]), ev.index, ev, snapshot,
                                        int(slot["version"])))
            self._busy.add(ev.client)
            self._on_dispatch(ev, snapshot, int(slot["version"]))
            self._trace_dispatch(ev, int(slot["version"]))

    @classmethod
    def checkpoint_template(cls, fed: FederatedConfig, acfg: AsyncAggConfig,
                            pcfg: ParticipationConfig, params_like, codec: Optional[Codec] = None,
                            uplink_ids=None) -> Dict[str, Any]:
        """A state tree shaped like ``checkpoint()[0]``, the ``like`` argument
        of ``checkpoint.load_pytree``. The buffer, residual and in-flight lanes
        are :class:`~repro_torch.checkpoint.TensorSpec`s on the params'
        device: a template never allocates them. ``uplink_ids`` sizes the
        residual lane (``None``: the dense ``(P, ...)`` layout)."""
        state = init_federated_state(replace(fed, keep_inner_state=False), params_like)
        spec = lambda lead, dtype: (lambda p: TensorSpec(  # noqa: E731
            (lead,) + tuple(p.shape), dtype or p.dtype, p.device))
        state["buffer"] = tree_map(spec(acfg.buffer_size, torch.float32), params_like)
        state["buf_weights"] = torch.zeros((acfg.buffer_size,), dtype=torch.float32)
        state["buf_staleness"] = torch.zeros((acfg.buffer_size,), dtype=torch.float32)
        state["buf_count"] = 0
        if codec is not None and codec.stateful:
            n = pcfg.population if uplink_ids is None else len(uplink_ids)
            state["uplink_residuals"] = tree_map(spec(n, torch.float32), params_like)
        state["inflight_params"] = tree_map(spec(pcfg.clients_per_round, None), params_like)
        if codec is not None:
            state["uplink_rng"] = np.zeros((2,), np.uint32)
        return state


class AsyncFederationDriver(AsyncBufferAggregator):
    """The event loop of the simulated asynchronous federation (Photon §5.3)
    over :class:`AsyncBufferAggregator`: it owns the data and compute plane
    only — the client phase (``run_clients`` at C = 1 on each dispatch's
    params snapshot) and the per-update rows.

    ``make_batches(client_id)`` returns the client's batches, leaves
    ``(τ, 1, ...)``. Under partial progress the completion's τ_i is the
    client phase's step budget and its weight is scaled by τ_i/τ."""

    def __init__(
        self,
        loss_fn: Callable,
        fed: FederatedConfig,
        acfg: AsyncAggConfig,
        pcfg: ParticipationConfig,
        make_batches: Callable[[int], Dict[str, torch.Tensor]],
        *,
        seed: int = 0,
        params=None,
        rng: Optional[np.ndarray] = None,
        state: Optional[Dict[str, Any]] = None,
        codec: Optional[Codec] = None,
        dispatch: Optional[Dict[str, Any]] = None,
        fused_server: bool = False,
        robust: Optional[RobustAggConfig] = None,
        tracer=None,
        controller=None,
    ):
        super().__init__(fed, acfg, pcfg, seed=seed, params=params, rng=rng, state=state,
                         codec=codec, dispatch=dispatch, fused_server=fused_server,
                         robust=robust, tracer=tracer, controller=controller)
        self.make_batches = make_batches
        self._loss_fn = loss_fn
        self._fed1 = replace(fed, clients_per_round=1, keep_inner_state=False)

    def step(self) -> Optional[Dict[str, Any]]:
        """Advance the timeline by one completion and dispatch a replacement;
        the flush row when this completion's admission filled the buffer."""
        ev, snapshot, version = self._pop_completion()
        row = None
        rs = self.robust_state
        if ev.completes and rs is not None and rs.is_quarantined(int(ev.client),
                                                                 int(self.state["round"])):
            # a quarantined client never runs its phase: its time is wasted
            self.work_wasted += ev.duration
            self._trace_complete(ev, "quarantined")
            self._dispatch()
            return None
        if ev.completes:
            # the client consumed its data either way. A refusal for staleness
            # is certain at pop time (no flush can intervene), so its compute is
            # skipped — unless an error-feedback codec must advance the residual
            staleness = int(self.state["round"]) - version
            rejected = 0 < self.acfg.max_staleness < staleness
            batches = self.make_batches(ev.client)
            if rejected and self.residuals is None:
                self.work_wasted += ev.duration
                self._trace_complete(ev, "rejected_stale", staleness=staleness)
            else:
                st: Dict[str, Any] = {"params": snapshot, "round": version}
                kw: Dict[str, Any] = {}
                if self.codec is not None:
                    st["rng"] = self.dispatch_key(ev.index)
                if self.pcfg.partial_progress:
                    kw["tau_steps"] = np.asarray([ev.local_steps or self.fed.local_steps],
                                                 np.int32)
                if self.residuals is not None:
                    kw["residuals"] = self._res_gather(self.residuals, ev.client)
                self.n_client_phases += 1
                deltas, aux = run_clients(self._loss_fn, self._fed1, st, batches,
                                          codec=self.codec, **kw)
                if self.residuals is not None:
                    # the residual is the client's, whatever the door decides
                    self._res_scatter(self.residuals, ev.client, aux["residuals"])
                    self._res_norms.append(float(global_norm(aux["residuals"])))
                delta = tree_map(lambda d: d[0], deltas)
                if self.corrupt_fn is not None:
                    # the Byzantine simulator corrupts the upload (the codec
                    # payload, with a codec) before the door
                    delta = self.corrupt_fn(int(ev.client), int(ev.index), delta)
                self.uplink_bytes_total += self._bytes_per_upload
                m = self.admit(delta, version, self.event_weight(ev))
                self._note_admission(ev, m)
                rec = self._trace_admit(ev, m)
                if m["accepted"] > 0:
                    self.work_completed += ev.duration
                    self._staleness.append(float(m["staleness"]))
                    self._losses.append(float(aux["step_metrics"]["loss"][-1]))
                    self._trace_complete(ev, "admitted", staleness=rec.get("staleness"))
                else:  # refused at the door: kept out of the flush row
                    self.work_wasted += ev.duration
                    self._trace_complete(ev, "rejected", staleness=rec.get("staleness"))
            if self.should_flush():
                row = self._flush_row(self.flush())
        else:
            self.work_wasted += ev.duration
            self._trace_complete(ev, "no_show")
        self._dispatch()
        return row

    def run_updates(self, n_updates: int,
                    on_update: Optional[Callable[[int, Dict[str, Any]], None]] = None,
                    max_events: Optional[int] = None) -> List[Dict[str, Any]]:
        """Run the event loop until ``n_updates`` outer updates have applied.
        Raises when the event budget (default 1000 per update) runs out first:
        a silently short history would corrupt any time-to-loss comparison."""
        history: List[Dict[str, Any]] = []
        budget = max_events if max_events is not None else 1000 * max(1, n_updates)
        while len(history) < n_updates and budget > 0:
            budget -= 1
            row = self.step()
            if row is not None:
                row["update"] = len(history)
                history.append(row)
                if on_update is not None:
                    on_update(len(history) - 1, row)
        if len(history) < n_updates:
            raise RuntimeError(
                f"async event budget exhausted after {len(history)}/{n_updates} outer "
                f"updates (the buffer admits too rarely: a mostly offline population, zero "
                f"weights, or max_staleness refusing everything) — raise max_events or "
                f"loosen the configuration"
            )
        return history
