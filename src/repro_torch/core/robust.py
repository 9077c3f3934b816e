"""Byzantine-robust aggregation: the delta screen, the robust rules, the tiled
folds, divergence rollback and the attack simulator — the counterpart of
``repro.core.robust``.

  =======================  ====================================================
  defense layer            where it plugs in
  =======================  ====================================================
  delta screen             the (C,) weight vector of the sync round
                           (:func:`screen_cohort`: non-finite and median/MAD
                           norm-outlier clients weigh 0); the async door takes
                           the same test (``admit_delta(screen=...)``)
  robust aggregation rule  the ``apply_fn`` seam of the server phase
                           (:func:`make_robust_apply_fn`: trimmed mean,
                           coordinate median or norm-clipped mean in front of
                           ``_finish_aggregate``)
  tiled composition        per-tile order-statistic folds
                           (:func:`tile_fold_init` / ``update`` / ``finish``):
                           top-k and bottom-k buffers and a running sum across
                           cohort tiles, exact without the (C, N) matrix
  divergence rollback      :class:`RobustState`, host-side and checkpointed in
                           ``manifest['robust']``; the train loop rolls back
                           through ``CheckpointManager``
  =======================  ====================================================

Selections (sorts, ranks, masks) are the reference's exactly: a median takes
the mean of ranks ``(n−1)//2`` and ``n//2`` of a sort with ±inf sentinels
(``torch.median`` would return the lower one), and the trim count multiplies
in float32. The cardinal trap, as in the reference: a zero weight does not
neutralize a non-finite delta (0·NaN = NaN), so a flagged lane's values are
rewritten by :func:`sanitize_deltas` before any sum touches them.
"""
from __future__ import annotations

import json
import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Tuple

import torch

from repro_torch.core.federated import (
    FederatedConfig,
    _client_norms,
    _finish_aggregate,
    _weigh_clients,
    _weighted_mean_clients,
)
from repro_torch.tree import global_norm  # noqa: F401  (the reference module's public name)
from repro_torch.tree import tree_leaves, tree_map

#: the ``--robust-agg`` choices — 'none' is the plain weighted mean
ROBUST_RULES = ("none", "trimmed", "median", "normclip")

#: payload corruption kinds of the attack simulator ('replay' is transport-level)
CORRUPT_KINDS = ("nan", "inf", "scale", "sign_flip", "replay")


@dataclass(frozen=True)
class RobustAggConfig:
    """Knobs of the defense (the ``--robust-*`` flags). All off by default.
    ``clip_norm == 0`` selects the adaptive normclip threshold (median
    admitted norm × ``clip_mult``); a positive value is an absolute threshold,
    the only normclip mode that composes with cohort tiling."""

    rule: str = "none"  # none | trimmed | median | normclip
    trim_fraction: float = 0.1  # trimmed: fraction trimmed from EACH tail
    clip_mult: float = 3.0  # normclip adaptive: τ = median(norms) · clip_mult
    clip_norm: float = 0.0  # normclip absolute τ (0 → adaptive)
    screen: bool = False  # median/MAD norm screen + non-finite rejection
    screen_z: float = 6.0  # robust z-score flag threshold
    screen_warmup: int = 8  # async: admitted norms before the bound engages
    rollback: bool = False  # divergence guard + checkpoint rollback
    rollback_window: int = 8  # guard window (accepted pg-norm history)
    rollback_factor: float = 4.0  # trigger: pg_norm > window median × factor
    quarantine_rounds: int = 4  # rounds an offending client id sits out

    def __post_init__(self):
        if self.rule not in ROBUST_RULES:
            raise ValueError(f"rule must be one of {ROBUST_RULES}, got {self.rule!r}")
        if not 0.0 <= self.trim_fraction < 0.5:
            raise ValueError(f"trim_fraction must be in [0, 0.5), got {self.trim_fraction}")
        if self.clip_mult <= 0.0:
            raise ValueError(f"clip_mult must be > 0, got {self.clip_mult}")
        if self.clip_norm < 0.0:
            raise ValueError(f"clip_norm must be >= 0, got {self.clip_norm}")
        if self.screen_z <= 0.0:
            raise ValueError(f"screen_z must be > 0, got {self.screen_z}")
        if self.screen_warmup < 1:
            raise ValueError(f"screen_warmup must be >= 1, got {self.screen_warmup}")
        if self.rollback_window < 2:
            raise ValueError(f"rollback_window must be >= 2, got {self.rollback_window}")
        if self.rollback_factor <= 1.0:
            raise ValueError(f"rollback_factor must be > 1, got {self.rollback_factor}")
        if self.quarantine_rounds < 1:
            raise ValueError(f"quarantine_rounds must be >= 1, got {self.quarantine_rounds}")

    @property
    def active(self) -> bool:
        """True when the aggregation math itself changes (apply_fn installed)."""
        return self.rule != "none" or self.screen

    @property
    def stateful(self) -> bool:
        """True when host-side defense state must ride the manifest."""
        return self.active or self.rollback


# ---------------------------------------------------------------------------
# Order statistics under a mask
# ---------------------------------------------------------------------------


def _lanes(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) mask shaped to broadcast over a (C, ...) leaf."""
    return mask.reshape((-1,) + (1,) * (x.ndim - 1))


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``x[mask]``: invalid lanes sort to +inf and the two middle
    ranks of the n valid lanes are averaged. n == 0 gives 0."""
    n = int(torch.sum(mask.to(torch.int32)))
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    s = torch.sort(torch.where(mask, x.float(), _f32(math.inf, x))).values
    return 0.5 * (s[max((n - 1) // 2, 0)] + s[max(n // 2, 0)])


def screen_cohort(
    delta_norms: torch.Tensor,  # (C,) per-client delta norms (may hold NaN/inf)
    weights: torch.Tensor,  # (C,) aggregation weights (0 = already masked out)
    z: float,  # robust z-score threshold
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The delta screen: non-finite rejection and the median/MAD norm-outlier
    test |x − med| / (1.4826·MAD) > z over the valid lanes, disarmed below 3
    valid lanes. Returns ``(new_weights, flagged, finite)``; a healthy lane
    keeps its weight bitwise. Callers must also :func:`sanitize_deltas` the
    non-finite lanes."""
    finite = torch.isfinite(delta_norms)
    valid = finite & (weights > 0)
    med = masked_median(delta_norms, valid)
    zero = torch.zeros_like(delta_norms)
    dev = torch.where(valid, torch.abs(delta_norms - med), zero)
    mad = masked_median(dev, valid)
    sigma = torch.maximum(1.4826 * mad, _f32(1e-12, mad))
    n_valid = int(torch.sum(valid.to(torch.int32)))
    outlier = valid & (dev / sigma > _f32(z, dev)) & (n_valid >= 3)
    flagged = (~finite) | outlier
    new_w = torch.where(flagged, torch.zeros_like(weights), weights)
    return new_w, flagged, finite


def sanitize_deltas(deltas, finite: torch.Tensor):
    """Zero every element of each non-finite client lane (0·NaN = NaN: a zero
    weight does not take a poisoned lane out of a sum). An all-finite cohort
    passes through as it is (the same tensors, no copy)."""
    if bool(finite.all()):
        return deltas
    return tree_map(lambda x: torch.where(_lanes(finite, x), x, torch.zeros_like(x)), deltas)


# ---------------------------------------------------------------------------
# Robust aggregation rules — flat (C, ...) cohort
# ---------------------------------------------------------------------------
#
# The trimmed mean and the coordinate median run UNWEIGHTED over the admitted
# lanes (the weight is the admission mask, w > 0): an attacker that inflates
# its own weight would defeat a weighted order statistic. Norm clipping keeps
# the weighted mean and bounds each client's influence.


def _trim_count(trim_fraction: float, n: torch.Tensor) -> torch.Tensor:
    """k_eff = min(⌊trim·n⌋, (n−1)//2), the product taken in float32."""
    n = torch.as_tensor(n, dtype=torch.int32)
    k = (torch.tensor(trim_fraction, dtype=torch.float32) * n.float()).to(torch.int32)
    return torch.clamp(k, 0, max((int(n) - 1) // 2, 0))


def trimmed_mean_clients(deltas, admit: torch.Tensor, trim_fraction: float):
    """Coordinate-wise trimmed mean over the admitted lanes: per coordinate,
    drop the k_eff smallest and the k_eff largest admitted values and average
    the rest. Admitted lanes must be finite, so the +inf sentinels of masked
    lanes sort last unambiguously."""
    c = admit.shape[0]
    n = int(torch.sum(admit.to(torch.int32)))
    k_eff = int(_trim_count(trim_fraction, n))

    def tm(x):
        s = torch.sort(torch.where(_lanes(admit, x), x, _f32(math.inf, x).to(x.dtype)),
                       dim=0).values
        rank = torch.arange(c, device=x.device).reshape((-1,) + (1,) * (x.ndim - 1))
        sel = (rank >= k_eff) & (rank < n - k_eff)
        kept = torch.sum(torch.where(sel, s, torch.zeros((), dtype=s.dtype, device=s.device)),
                         dim=0)
        return kept / torch.tensor(max(n - 2 * k_eff, 1), dtype=x.dtype, device=x.device)

    return tree_map(tm, deltas)


def median_clients(deltas, admit: torch.Tensor):
    """Coordinate-wise median over the admitted lanes (an even n averages the
    two middle ranks, as :func:`masked_median`). Zero where none is admitted."""
    n = int(torch.sum(admit.to(torch.int32)))
    lo_rank, hi_rank = max((n - 1) // 2, 0), max(n // 2, 0)

    def med(x):
        if n == 0:
            return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
        s = torch.sort(torch.where(_lanes(admit, x), x, _f32(math.inf, x).to(x.dtype)),
                       dim=0).values
        return (0.5 * (s[lo_rank] + s[hi_rank])).to(x.dtype)

    return tree_map(med, deltas)


def normclip_scale(
    delta_norms: torch.Tensor,  # (C,) — may hold NaN/inf (those lanes scale 0)
    admit: torch.Tensor,  # (C,) bool
    tau: torch.Tensor,  # () clip threshold
) -> torch.Tensor:
    """Per-client clip factor s_k = min(1, τ/‖Δ_k‖); a lane not admitted gets 0."""
    one = torch.ones_like(delta_norms)
    safe = torch.maximum(torch.where(torch.isfinite(delta_norms), delta_norms, one),
                         _f32(1e-12, delta_norms))
    return torch.where(admit, torch.minimum(one, tau / safe), torch.zeros_like(delta_norms))


def make_robust_apply_fn(fed: FederatedConfig, cfg: RobustAggConfig):
    """A server phase with ``apply_aggregate``'s signature and contract, for
    the same ``apply_fn`` seam as ``fused_apply_aggregate`` (the two exclude
    each other). Decode → screen (optional) → sanitize the non-finite lanes →
    the robust estimator (the plain weighted mean for ``rule='none'`` with
    the screen) → ``_finish_aggregate``. With the screen the metrics carry a
    (C,) ``screen_mask``, which ``SyncAggregator`` pops for quarantine."""
    if not cfg.active:
        raise ValueError("make_robust_apply_fn called with an inactive config")

    @torch.no_grad()
    def robust_apply(fed_, state, deltas, client_weights=None, codec=None):
        if codec is not None:
            deltas = codec.decode_cohort(deltas)
        c = tree_leaves(deltas)[0].shape[0]
        device = tree_leaves(deltas)[0].device
        w = (client_weights.float() if client_weights is not None
             else torch.ones((c,), dtype=torch.float32, device=device))
        raw_norms = _client_norms(deltas)
        finite = torch.isfinite(raw_norms)
        extra = {}
        if cfg.screen:
            w, flagged, finite = screen_cohort(raw_norms, w, cfg.screen_z)
            extra["screen_mask"] = flagged.float()
            extra["screened_clients"] = torch.sum(flagged.float())
        deltas = sanitize_deltas(deltas, finite)
        admit = (w > 0) & finite

        if cfg.rule == "trimmed":
            pseudo_grad = trimmed_mean_clients(deltas, admit, cfg.trim_fraction)
        elif cfg.rule == "median":
            pseudo_grad = median_clients(deltas, admit)
        elif cfg.rule == "normclip":
            if cfg.clip_norm > 0.0:
                tau = _f32(cfg.clip_norm, raw_norms)
            else:
                tau = masked_median(raw_norms, admit) * cfg.clip_mult
            scale = normclip_scale(raw_norms, admit, tau)
            pseudo_grad = _weighted_mean_clients(
                tree_map(lambda x: _weigh_clients(x, scale), deltas), w)
        else:  # 'none' with the screen: the weighted mean over the screened weights
            pseudo_grad = _weighted_mean_clients(deltas, w)

        # the raw (unsanitized) norms feed the metrics, which count the
        # poisoned lanes as nonfinite_deltas
        new_state, metrics = _finish_aggregate(fed, state, pseudo_grad, raw_norms, w)
        return new_state, dict(metrics, **extra)

    return robust_apply


# ---------------------------------------------------------------------------
# Tiled composition — exact trimming and median across cohort tiles
# ---------------------------------------------------------------------------
#
# A coordinate's trimmed mean is recoverable from (running total, top-k
# buffer, bottom-k buffer, admitted count) as long as k bounds the trim
# count: total − Σ(top k_eff) − Σ(bottom k_eff), over n − 2k_eff. The median
# is ranks (n−1)//2 and n//2 of the bottom buffer with k = C//2 + 1. Memory is
# O(k·N) instead of O(C·N).

#: columns sorted at a time by :func:`tile_fold_update`: the sort's values and
#: int64 indices of a (k + C_tile, N_leaf) block would otherwise be several
#: times the fold itself at full width
SORT_COLUMNS = 1 << 22


def tile_fold_size(rule: str, trim_fraction: float, c_total: int) -> int:
    """The fold's buffer depth k (Python arithmetic, as the reference's)."""
    if rule == "trimmed":
        return max(1, int(trim_fraction * c_total))
    if rule == "median":
        return c_total // 2 + 1
    raise ValueError(f"no tiled fold for rule {rule!r}")


def tile_fold_init(params_like, k: int) -> Dict[str, Any]:
    """An empty fold: ∓inf sentinel buffers, zero totals, zero count."""
    full = lambda v: (lambda p: torch.full((k,) + tuple(p.shape), v,  # noqa: E731
                                           dtype=torch.float32, device=p.device))
    return {
        "top": tree_map(full(-math.inf), params_like),
        "bot": tree_map(full(math.inf), params_like),
        "total": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params_like),
        "count": 0,
    }


@torch.no_grad()
def tile_fold_update(fold: Dict[str, Any], deltas, admit: torch.Tensor) -> Dict[str, Any]:
    """Fold one tile's decoded deltas in: masked lanes enter as ∓inf (they
    never displace a real value), each buffer re-sorts along the lane axis of
    the (k + C_tile, ...) concatenation and keeps k, the totals and the
    admitted count accumulate."""
    k = tree_leaves(fold["top"])[0].shape[0]

    def upd(buf, d, fill, keep_top):
        # each column sorts on its own, so a block of columns at a time gives
        # the same values with a bounded transient
        out = torch.empty_like(buf)
        b2, d2, o2 = buf.reshape(k, -1), d.reshape(d.shape[0], -1), out.reshape(k, -1)
        m, f = admit.reshape(-1, 1), _f32(fill, d)
        for a in range(0, b2.shape[1], SORT_COLUMNS):
            cols = slice(a, a + SORT_COLUMNS)
            cat = torch.cat([b2[:, cols], torch.where(m, d2[:, cols], f)], dim=0)
            s = torch.sort(cat, dim=0).values
            o2[:, cols] = s[-k:] if keep_top else s[:k]
        return out

    return {
        "top": tree_map(lambda t, d: upd(t, d, -math.inf, True), fold["top"], deltas),
        "bot": tree_map(lambda b, d: upd(b, d, math.inf, False), fold["bot"], deltas),
        "total": tree_map(lambda t, d: t + torch.sum(
            torch.where(_lanes(admit, d), d, torch.zeros((), dtype=d.dtype, device=d.device)),
            dim=0), fold["total"], deltas),
        "count": fold["count"] + int(torch.sum(admit.to(torch.int32))),
    }


@torch.no_grad()
def tile_fold_finish(fold: Dict[str, Any], rule: str, trim_fraction: float):
    """The robust pseudo-gradient from the folded moments. Trimmed:
    (total − Σ largest k_eff − Σ smallest k_eff) / (n − 2k_eff); median:
    ranks (n−1)//2 and n//2 of the ascending bottom buffer. Equal to the flat
    rules within float tolerance, not bitwise: the running total sums in tile
    order, the flat rule in lane order."""
    n = int(fold["count"])
    k = tree_leaves(fold["top"])[0].shape[0]

    if rule == "trimmed":
        k_eff = min(int(_trim_count(trim_fraction, n)), k)

        def fin(top, bot, total):
            rank = torch.arange(k, device=total.device).reshape((-1,) + (1,) * total.ndim)
            zero = torch.zeros((), dtype=total.dtype, device=total.device)
            top_sum = torch.sum(torch.where(rank >= k - k_eff, top, zero), dim=0)
            bot_sum = torch.sum(torch.where(rank < k_eff, bot, zero), dim=0)
            kept = total - top_sum - bot_sum
            return kept / torch.tensor(max(n - 2 * k_eff, 1), dtype=total.dtype,
                                       device=total.device)

        return tree_map(fin, fold["top"], fold["bot"], fold["total"])

    if rule == "median":
        lo_rank, hi_rank = max((n - 1) // 2, 0), max(n // 2, 0)

        def fin_med(bot):
            if n == 0:
                return torch.zeros(bot.shape[1:], dtype=bot.dtype, device=bot.device)
            return 0.5 * (bot[lo_rank] + bot[hi_rank])

        return tree_map(fin_med, fold["bot"])

    raise ValueError(f"no tiled fold for rule {rule!r}")


# ---------------------------------------------------------------------------
# Byzantine client simulator — deterministic payload corruption
# ---------------------------------------------------------------------------


def corrupt_tree(tree, kind: str, scale: float = 64.0):
    """One payload corruption of a delta or payload tree, on float leaves only:
    integer codec planes (int8 ``q``, top-k indices) are left alone, so the
    payload still decodes. 'replay' is transport-level and has no tree form."""
    def is_float(x):
        return isinstance(x, torch.Tensor) and x.is_floating_point()

    if kind == "nan":
        fn = lambda x: torch.full_like(x, math.nan) if is_float(x) else x  # noqa: E731
    elif kind == "inf":
        fn = lambda x: torch.full_like(x, math.inf) if is_float(x) else x  # noqa: E731
    elif kind == "scale":
        fn = lambda x: (x * torch.tensor(scale, dtype=x.dtype, device=x.device)  # noqa: E731
                        if is_float(x) else x)
    elif kind == "sign_flip":
        fn = lambda x: -x if is_float(x) else x  # noqa: E731
    else:
        raise ValueError(f"corrupt_tree cannot apply kind {kind!r}")
    return tree_map(fn, tree)


def make_byzantine_fn(fraction: float, kind: str, population: int):
    """The deterministic Byzantine cohort: population ids below
    ``int(fraction · P)`` corrupt every delta they push. Returns None for
    fraction 0, else a ``(client_id, dispatch_index, delta) -> delta``
    callable (``AsyncFederationDriver.corrupt_fn``)."""
    if fraction <= 0.0:
        return None
    if kind not in CORRUPT_KINDS or kind == "replay":
        raise ValueError(f"byzantine kind must be one of {CORRUPT_KINDS[:-1]}, got {kind!r}")
    bad = int(fraction * population)

    def corrupt(client_id: int, index: int, delta):
        if int(client_id) >= bad:
            return delta
        return corrupt_tree(delta, kind)

    return corrupt


# ---------------------------------------------------------------------------
# Host-side defense state — quarantine, norm history, divergence guard
# ---------------------------------------------------------------------------


class RobustState:
    """The checkpointable host half of the defense (pure Python, as the
    reference's, so the same calls give the same :meth:`snapshot_json`):

    - ``quarantine``: population client id → release round;
    - ``norm_history``: trailing admitted delta norms, the async door's
      adaptive bound once ``screen_warmup`` of them exist;
    - ``guard_window``: trailing accepted pseudo-gradient norms; the guard
      trips on a non-finite norm or one above the full window's median ×
      ``rollback_factor`` (a tripping value is not appended);
    - ``last_good``: the newest round whose checkpoint the guard blessed."""

    def __init__(self, cfg: RobustAggConfig):
        self.cfg = cfg
        self.quarantine: Dict[int, int] = {}
        self.norm_history: deque = deque(maxlen=max(4 * cfg.screen_warmup, 32))
        self.guard_window: deque = deque(maxlen=cfg.rollback_window)
        self.last_good: int = -1
        self.counters: Dict[str, int] = {"screen_rejects": 0, "quarantines": 0, "rollbacks": 0}

    # -- quarantine -------------------------------------------------------
    def is_quarantined(self, client_id: int, rnd: int) -> bool:
        """True while ``rnd`` is before the client's release round (an expired
        entry is dropped when queried)."""
        release = self.quarantine.get(int(client_id))
        if release is None:
            return False
        if rnd >= release:
            del self.quarantine[int(client_id)]
            return False
        return True

    def add_quarantine(self, client_ids: Iterable[int], rnd: int) -> None:
        for cid in client_ids:
            self.quarantine[int(cid)] = max(self.quarantine.get(int(cid), 0),
                                            rnd + self.cfg.quarantine_rounds)
            self.counters["quarantines"] += 1

    # -- async admission norm screen --------------------------------------
    def observe_norm(self, norm: float) -> None:
        v = float(norm)
        if v == v and abs(v) != float("inf"):  # finite only
            self.norm_history.append(v)

    def norm_bound(self) -> float:
        """median + z·1.4826·MAD of the trailing admitted norms, floored at 2×
        the median (and 1e-9); +inf until ``screen_warmup`` samples exist."""
        if len(self.norm_history) < self.cfg.screen_warmup:
            return float("inf")
        vals = sorted(self.norm_history)
        med = _median_sorted(vals)
        mad = _median_sorted(sorted(abs(v - med) for v in vals))
        return max(med + self.cfg.screen_z * 1.4826 * mad, 2.0 * med, 1e-9)

    # -- divergence guard -------------------------------------------------
    def observe_update(self, pg_norm: float) -> bool:
        """Feed one aggregation's pseudo-gradient norm; True when the guard
        trips (the caller rolls back to ``last_good``)."""
        v = float(pg_norm)
        if v != v or abs(v) == float("inf"):
            return True
        if (len(self.guard_window) == self.cfg.rollback_window
                and v > _median_sorted(sorted(self.guard_window)) * self.cfg.rollback_factor):
            return True
        self.guard_window.append(v)
        return False

    def mark_good(self, rnd: int) -> None:
        self.last_good = max(self.last_good, int(rnd))

    def note_rollback(self) -> None:
        self.counters["rollbacks"] += 1

    def note_screen_rejects(self, n: int = 1) -> None:
        self.counters["screen_rejects"] += int(n)

    # -- checkpoint round-trip -------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "quarantine": {str(k): int(v) for k, v in self.quarantine.items()},
            "norm_history": [float(v) for v in self.norm_history],
            "guard_window": [float(v) for v in self.guard_window],
            "last_good": int(self.last_good),
            "counters": dict(self.counters),
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.quarantine = {int(k): int(v) for k, v in d.get("quarantine", {}).items()}
        self.norm_history = deque(d.get("norm_history", []), maxlen=self.norm_history.maxlen)
        self.guard_window = deque(d.get("guard_window", []), maxlen=self.guard_window.maxlen)
        self.last_good = int(d.get("last_good", -1))
        self.counters.update({k: int(v) for k, v in d.get("counters", {}).items()})

    def snapshot_json(self) -> str:
        """Canonical JSON (sorted keys), for bitwise-resume comparisons."""
        return json.dumps(self.state_dict(), sort_keys=True)


def _median_sorted(vals) -> float:
    vals = list(vals)
    n = len(vals)
    if n == 0:
        return 0.0
    return 0.5 * (vals[(n - 1) // 2] + vals[n // 2])
