"""Client participation subsystem (Algorithm 1, L.4 + paper §7 robustness claims).

The paper argues federated pre-training is robust to *partial participation* and to
*statistical and hardware heterogeneity*. This module provides the machinery behind
those claims as a set of pure, seeded functions — every quantity for round ``r`` is a
function of ``(seed, r, config)`` alone, never of execution history, so runs are
exactly resumable and round ``r`` samples identically whether or not rounds
``0..r-1`` were ever executed (paper §6.1 "reproducible sampling").

Layers, composed by :func:`plan_round`:

  1. **Availability models** — who *could* participate this round:
     ``uniform`` (everyone), ``dirichlet`` (skewed per-client popularity, a fixed
     Dirichlet draw — some publishers show up far more often than others), and
     ``markov`` (per-client on/off chains — clients leave and rejoin the federation
     in correlated streaks, Photon's volunteer-compute regime).
  2. **Cohort selection** — K-of-P sampling among the available clients; slots left
     over when fewer than K are available are padded with masked (zero-weight)
     clients so the jitted round always sees a fixed client axis.
  3. **Mid-round dropout** — each selected client independently fails with
     ``dropout_rate`` probability (process crash, network partition).
  4. **Straggler simulation** — persistent per-client speed multipliers (hardware
     heterogeneity); with a round deadline, clients whose simulated wall-clock
     exceeds it are masked out of the aggregate.
  5. **Aggregation weights** — FedAvg data-size weighting from per-client example
     counts (or uniform), zeroed for every masked slot.

The resulting :class:`ParticipationPlan` feeds ``federated_round`` as a weight
vector: dropped/straggling clients contribute zero-weight deltas to the aggregate,
so the effective cohort K_eff ≤ K varies per round.

The async aggregator replays the same plans as a dispatch timeline
(:class:`AsyncTimeline`): dispatch ``n`` is slot ``n % K`` of wave ``n // K``.

Numpy only, copied from ``repro.core.sampler`` (whose package imports JAX): a
plan for ``(cfg, seed, round)`` and a dispatch for ``(cfg, seed, n)`` are
bitwise the reference's (tested).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import numpy as np

# Fixed integer tags decorrelate the per-purpose random streams under one user seed.
# Every tagged stream is seeded as (seed, TAG, index): the tag always sits in the
# same position and the entropy length (3) differs from the untagged legacy
# ``sample_round`` sequence (seed, round_idx), so no two streams can collide.
_TAG_SELECT = 0x5EED0001
_TAG_DATA = 0x5EED0002
_TAG_POPULARITY = 0x5EED0003
_TAG_MARKOV = 0x5EED0004
_TAG_DROPOUT = 0x5EED0005
_TAG_SPEED = 0x5EED0006
_TAG_PAD = 0x5EED0007


def _rng(seed: int, tag: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, tag, index]))


# ---------------------------------------------------------------------------
# Cohort sampling (the seed repo's API, extended with popularity weights)
# ---------------------------------------------------------------------------


def sample_round(
    seed: int,
    round_idx: int,
    population: int,
    k: int,
    probs: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Deterministic K-of-P sample for a given round, optionally popularity-weighted."""
    if k > population:
        raise ValueError(f"cannot sample {k} of {population}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, round_idx]))
    return np.sort(rng.choice(population, size=k, replace=False, p=probs))


def participation_counts(
    seed: int,
    n_rounds: int,
    population: int,
    k: int,
    probs: Optional[np.ndarray] = None,
) -> np.ndarray:
    counts = np.zeros(population, np.int64)
    for r in range(n_rounds):
        counts[sample_round(seed, r, population, k, probs)] += 1
    return counts


# ---------------------------------------------------------------------------
# Statistical heterogeneity: data sizes and popularity
# ---------------------------------------------------------------------------


def client_example_counts(
    seed: int, population: int, median: int = 2048, log_sigma: float = 0.6
) -> np.ndarray:
    """Per-client dataset sizes (log-normal around ``median``) — the n_k of the
    FedAvg weighted average. Fixed for the run: a client's corpus does not change
    between rounds."""
    rng = _rng(seed, _TAG_DATA)
    counts = median * rng.lognormal(0.0, log_sigma, population)
    return np.maximum(1, counts).astype(np.int64)


def dirichlet_popularity(seed: int, population: int, alpha: float = 0.3) -> np.ndarray:
    """A fixed Dirichlet(α) draw over the population: per-round selection
    probabilities. Small α → heavy skew (a few clients dominate participation, the
    long-tail publishers of Fig 1); α → ∞ recovers uniform sampling."""
    rng = _rng(seed, _TAG_POPULARITY)
    p = rng.dirichlet(np.full(population, alpha, np.float64))
    p = p + 1e-9  # keep every client reachable for without-replacement draws
    return p / p.sum()


# ---------------------------------------------------------------------------
# Availability: Markov on/off chains
# ---------------------------------------------------------------------------


def markov_availability(
    seed: int,
    round_idx: int,
    population: int,
    p_drop: float = 0.2,
    p_join: float = 0.5,
) -> np.ndarray:
    """Boolean availability of every client at round ``round_idx`` under independent
    per-client two-state Markov chains (on --p_drop--> off, off --p_join--> on),
    started from the stationary distribution.

    Pure in ``(seed, round_idx)``: the chain is replayed from round 0 with per-round
    seeded innovations, so the answer for round r never depends on which rounds were
    actually executed (exact-resume requirement). O(r·P) vectorized — negligible next
    to a training round.
    """
    stationary_on = p_join / max(p_join + p_drop, 1e-12)
    state = _rng(seed, _TAG_MARKOV, 0).random(population) < stationary_on
    for r in range(1, round_idx + 1):
        u = _rng(seed, _TAG_MARKOV, r).random(population)
        state = np.where(state, u >= p_drop, u < p_join)
    return state


# ---------------------------------------------------------------------------
# Hardware heterogeneity: stragglers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StragglerProfile:
    """Persistent per-client speed heterogeneity plus an optional round deadline.

    Speeds are log-normal multipliers (1.0 = median hardware); a client's simulated
    round time is 1/speed in units of the median client's round. With ``deadline``
    > 0, clients whose time exceeds it are masked out of the aggregate (the
    synchronous-round straggler cut of Photon §5.3)."""

    name: str = "none"
    speed_log_sigma: float = 0.0
    deadline: float = 0.0  # in median-round units; 0 = wait for everyone


STRAGGLER_PROFILES: Dict[str, StragglerProfile] = {
    "none": StragglerProfile("none", 0.0, 0.0),
    "mild": StragglerProfile("mild", 0.35, 2.0),
    "heavy": StragglerProfile("heavy", 0.8, 1.5),
}


def client_speeds(seed: int, population: int, log_sigma: float) -> np.ndarray:
    """Fixed per-client relative speed multipliers (hardware doesn't change per round)."""
    if log_sigma <= 0.0:
        return np.ones(population, np.float64)
    rng = _rng(seed, _TAG_SPEED)
    return rng.lognormal(0.0, log_sigma, population)


# ---------------------------------------------------------------------------
# The participation plan: one round's elastic cohort
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParticipationConfig:
    population: int
    clients_per_round: int  # K — the fixed client-axis width of the jitted round
    model: str = "uniform"  # uniform | dirichlet | markov
    dirichlet_alpha: float = 0.3
    markov_p_drop: float = 0.2  # on → off per round
    markov_p_join: float = 0.5  # off → on per round
    dropout_rate: float = 0.0  # seeded mid-round client failure probability
    straggler: StragglerProfile = field(
        default_factory=lambda: STRAGGLER_PROFILES["none"]
    )
    weighting: str = "uniform"  # uniform | examples (FedAvg data-size weights)
    examples_median: int = 2048
    examples_log_sigma: float = 0.6
    # Straggler PARTIAL PROGRESS (FedProx/FedNova tradition, ROADMAP item 1):
    # instead of cutting a client that misses the deadline, credit the τ_i =
    # min(τ, ⌊τ·speed_i·deadline⌋) local steps it actually finished. The plan
    # then carries per-slot realized step counts (``ParticipationPlan.local_steps``)
    # and the aggregator's weight policy scales each delta by τ_i/τ
    # (``core/aggregator.partial_progress_weights``).
    partial_progress: bool = False
    local_steps: int = 0  # τ — required (> 0) when partial_progress is on

    def __post_init__(self):
        if self.model not in ("uniform", "dirichlet", "markov"):
            raise ValueError(f"unknown availability model {self.model!r}")
        if self.weighting not in ("uniform", "examples"):
            raise ValueError(f"unknown weighting {self.weighting!r}")
        if self.clients_per_round > self.population:
            raise ValueError(
                f"cannot sample {self.clients_per_round} of {self.population}"
            )
        if self.partial_progress and self.local_steps < 1:
            raise ValueError(
                "partial_progress needs the round's τ (local_steps > 0) to derive "
                "per-client realized step counts"
            )


@dataclass(frozen=True)
class ParticipationPlan:
    """One round's resolved cohort. ``selected`` always has length K (the jitted
    round's client axis); ``mask``/``weights`` carry the elasticity."""

    selected: np.ndarray  # (K,) int64 — distinct client ids bound to the client axis
    mask: np.ndarray  # (K,) bool — contributes to the aggregate
    weights: np.ndarray  # (K,) float32 — aggregation weights, 0 where masked
    speeds: np.ndarray  # (K,) float64 — relative hardware speed of each slot
    unavailable: np.ndarray  # (K,) bool — padded slots the availability model ruled out
    dropped: np.ndarray  # (K,) bool — mid-round dropout casualties
    stragglers: np.ndarray  # (K,) bool — missed the round deadline
    round_time: float  # simulated wall-clock, median-client-round units
    times: np.ndarray = None  # (K,) float64 — UNCAPPED per-slot completion time
    # (τ local steps at 1/speed, median-client-round units). The sync round caps
    # this at the deadline and discards the tail; the async aggregator replays it
    # as an event timeline, so slow clients land in later buffers instead.
    local_steps: np.ndarray = None  # (K,) int64 — realized per-slot step counts
    # τ_i under partial progress (None when partial_progress is off): the τ-mask
    # input of the jitted round. 0 where masked; τ for full-speed clients.

    @property
    def effective_k(self) -> int:
        return int(self.mask.sum())

    @property
    def n_dropped(self) -> int:
        return int(self.dropped.sum())

    @property
    def n_stragglers(self) -> int:
        return int(self.stragglers.sum())


def plan_round(cfg: ParticipationConfig, seed: int, round_idx: int) -> ParticipationPlan:
    """Resolve one round's participation: availability → cohort → dropout →
    straggler cut → weights. Pure in ``(cfg, seed, round_idx)``.

    At least one client always survives (the fastest of the round's starters): a
    fully-empty aggregate would make the round's weighted mean ill-defined, and a
    real aggregator would simply rerun such a round.
    """
    P, K = cfg.population, cfg.clients_per_round

    # 1. availability model → candidate pool (+ optional popularity weights)
    probs = None
    if cfg.model == "dirichlet":
        probs = dirichlet_popularity(seed, P, cfg.dirichlet_alpha)
        available = np.ones(P, bool)
    elif cfg.model == "markov":
        available = markov_availability(
            seed, round_idx, P, cfg.markov_p_drop, cfg.markov_p_join
        )
    else:
        available = np.ones(P, bool)

    # 2. cohort selection: K distinct ids; prefer available clients, pad the rest
    #    with masked unavailable ones so the client axis stays K-wide.
    avail_ids = np.flatnonzero(available)
    if len(avail_ids) == P and probs is None:
        selected = sample_round(seed, round_idx, P, K)  # legacy-identical cohorts
        mask = np.ones(K, bool)
    elif len(avail_ids) >= K:
        if probs is not None:
            selected = sample_round(seed, round_idx, P, K, probs)
        else:
            rng = _rng(seed, _TAG_SELECT, round_idx)
            selected = np.sort(rng.choice(avail_ids, size=K, replace=False))
        mask = np.ones(K, bool)
    else:
        off_ids = np.flatnonzero(~available)
        n_pad = K - len(avail_ids)
        pad = _rng(seed, _TAG_PAD, round_idx).choice(off_ids, size=n_pad, replace=False)
        order = np.argsort(np.concatenate([avail_ids, pad]))
        selected = np.concatenate([avail_ids, pad])[order]
        mask = np.concatenate([np.ones(len(avail_ids), bool), np.zeros(n_pad, bool)])[
            order
        ]
    unavailable = ~mask

    # 3. seeded mid-round dropout
    u = _rng(seed, _TAG_DROPOUT, round_idx).random(K)
    dropped = mask & (u < cfg.dropout_rate)
    mask = mask & ~dropped

    # 4. straggler handling: per-client wall-clock = 1/speed (median units).
    #    Deadline-cut (legacy): clients past the deadline are masked out.
    #    Partial progress: a slow client is credited the τ_i = min(τ,
    #    ⌊τ·speed_i·deadline⌋) local steps it realized by the deadline; only a
    #    client too slow to finish even ONE step is still cut.
    deadline = cfg.straggler.deadline
    speeds = client_speeds(seed, P, cfg.straggler.speed_log_sigma)[selected]
    times = 1.0 / speeds
    started = mask.copy()
    stragglers = np.zeros(K, bool)
    local_steps = None
    if cfg.partial_progress:
        tau = cfg.local_steps
        if deadline > 0.0:
            tau_i = np.minimum(tau, np.floor(tau * speeds * deadline)).astype(np.int64)
        else:  # no deadline: everyone runs to full τ
            tau_i = np.full(K, tau, np.int64)
        stragglers = mask & (tau_i < 1)
        mask = mask & ~stragglers
        local_steps = np.where(mask, tau_i, 0)
    elif deadline > 0.0:
        stragglers = mask & (times > deadline)
        mask = mask & ~stragglers
    if started.any():
        capped = times if deadline <= 0 else np.minimum(times, deadline)
        if local_steps is not None and cfg.local_steps > 0:
            # a partial client uploads as soon as its τ_i-th step lands
            capped = np.where(mask, (local_steps / cfg.local_steps) * times, capped)
        round_time = float(capped[started].max())
    else:
        round_time = 0.0

    # 5. never let the aggregate go empty: resurrect the fastest starter
    if not mask.any():
        idx = int(np.argmax(np.where(started, speeds, -np.inf))) if started.any() else 0
        mask[idx] = True
        dropped[idx] = False
        stragglers[idx] = False
        unavailable[idx] = False
        if local_steps is not None:
            # restore the rescued client's real realized budget (its row was
            # zeroed with the rest of the masked slots), floored at one step
            local_steps[idx] = max(1, int(tau_i[idx]))

    # 6. aggregation weights (FedAvg n_k weighting or uniform), zeroed where
    #    masked. Deliberately NOT scaled by τ_i/τ here: the fractional-progress
    #    weight policy is owned by the Aggregator seam
    #    (core/aggregator.partial_progress_weights), which composes it for both
    #    the sync round and async admission.
    if cfg.weighting == "examples":
        n_k = client_example_counts(
            seed, P, cfg.examples_median, cfg.examples_log_sigma
        )[selected].astype(np.float32)
    else:
        n_k = np.ones(K, np.float32)
    weights = n_k * mask.astype(np.float32)

    return ParticipationPlan(
        selected=selected.astype(np.int64),
        mask=mask,
        weights=weights,
        speeds=speeds,
        unavailable=unavailable,
        dropped=dropped,
        stragglers=stragglers,
        round_time=round_time,
        times=times,
        local_steps=local_steps,
    )


# ---------------------------------------------------------------------------
# Asynchronous dispatch schedule (FedBuff-style aggregation, core/async_agg.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DispatchEvent:
    """One simulated client dispatch resolved by :class:`AsyncTimeline`."""

    index: int  # global dispatch counter n
    wave: int  # participation wave (= plan_round index) this slot came from
    slot: int  # slot within the wave's cohort
    client: int  # population client id
    weight: float  # pre-discount FedAvg weight (n_k or 1); τ_i/τ scaling is the aggregator's
    duration: float  # simulated busy time, median-client-round units
    completes: bool  # False: never produced a delta (unavailable / dropped out)
    local_steps: int = 0  # realized τ_i under partial progress (0 = full τ)


class AsyncTimeline:
    """Deterministic dispatch schedule for the async aggregator.

    The server keeps ``K = clients_per_round`` client slots busy; dispatch
    ``n`` is slot ``n % K`` of ``plan_round(cfg, seed, n // K)``, so it is a
    function of ``(cfg, seed, n)`` alone and a resumed run replays the same
    timeline. The sync round's deadline is stripped: a slow client finishes
    late (its uncapped ``plan.times``) instead of being cut. An unavailable
    slot costs :attr:`CONNECT_COST`, a dropped one half its client's time.

    With ``cfg.partial_progress`` the deadline stays as a per-dispatch budget:
    the client trains τ_i = min(τ, ⌊τ·speed·deadline⌋) steps and uploads
    after (τ_i/τ)·time; a client too slow for one step holds its slot until
    the budget expires and produces nothing.
    """

    CONNECT_COST = 0.05  # failed-dispatch probe, median-client-round units

    def __init__(self, cfg: ParticipationConfig, seed: int):
        if cfg.partial_progress:
            self.cfg = cfg  # plan_round turns the deadline into τ_i budgets
        else:
            self.cfg = replace(cfg, straggler=replace(cfg.straggler, deadline=0.0))
        self.seed = seed
        self._plan_cache: Dict[int, ParticipationPlan] = {}

    def plan(self, wave: int) -> ParticipationPlan:
        if wave not in self._plan_cache:
            if len(self._plan_cache) > 4:  # slots free in order: old waves are dead
                self._plan_cache.clear()
            self._plan_cache[wave] = plan_round(self.cfg, self.seed, wave)
        return self._plan_cache[wave]

    def dispatch(self, n: int) -> DispatchEvent:
        wave, slot = divmod(n, self.cfg.clients_per_round)
        plan = self.plan(wave)
        client = int(plan.selected[slot])
        if plan.unavailable[slot]:
            return DispatchEvent(n, wave, slot, client, 0.0, self.CONNECT_COST, False)
        if plan.dropped[slot]:
            # fails mid-run: holds the slot for half its time, then frees it empty
            return DispatchEvent(n, wave, slot, client, 0.0, 0.5 * float(plan.times[slot]),
                                 False)
        if plan.local_steps is not None:  # partial progress: the deadline is a budget
            tau_i = int(plan.local_steps[slot])
            if tau_i < 1:
                return DispatchEvent(n, wave, slot, client, 0.0,
                                     float(self.cfg.straggler.deadline), False, 0)
            duration = float(plan.times[slot]) * tau_i / self.cfg.local_steps
            return DispatchEvent(n, wave, slot, client, float(plan.weights[slot]), duration,
                                 True, tau_i)
        return DispatchEvent(n, wave, slot, client, float(plan.weights[slot]),
                             float(plan.times[slot]), True)
