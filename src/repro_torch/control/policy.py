"""Closed-loop aggregation control policies (ROADMAP "Adaptive aggregation
control"; Photon's deployment-side control plane, arXiv 2411.02908 §5).

The paper's resilience claims hold *when the server-side knobs match the
observed system*: a buffer sized for a calm population thrashes under heavy
stragglers, a deadline tuned for homogeneous hardware wastes every slow
client's round. This module turns the telemetry the obs layer already exports
(staleness histograms, effective-K, rescued/wasted partial work) back into
knob settings, behind one seam:

    ControlPolicy.observe(metrics_window) -> Optional[KnobUpdate]

A policy is a small pure-host state machine: it sees a bounded window of the
aggregator's per-update metric rows and either returns a :class:`KnobUpdate`
(the new knob values plus the evidence that triggered them) or ``None``.
Everything is stdlib+numpy, JSON-serializable (``state_dict`` /
``load_state_dict`` round-trip exactly — controller state rides the existing
checkpoint manifest), and deterministic: the same metric history always
produces the same knob trajectory, which is what makes a governed run
kill/``--resume`` bitwise.

Knob changes are QUANTIZED to bucketed grids (the reference's rule, which
bounds its recompiles; here it bounds the distinct widths the fedcore kernels
see): ``staleness_alpha`` snaps to a 1/16 grid in [0, 2], ``buffer_size``
moves along powers of two, cohort size moves in steps of 2. The aggregators
only ever apply updates at round/flush boundaries, so a knob change is a
host-side rebuild, never a change inside a step.

Policies:

* :class:`StaticPolicy` — the identity: observes nothing, changes nothing.
  ``--control static`` (and the flag omitted) is bitwise the uncontrolled run.
* :class:`StalenessGovernor` (async) — drives ``staleness_alpha`` and
  ``buffer_size`` toward a target admitted-staleness quantile read off the
  cumulative histogram. Staleness is measured in server rounds, so a large
  buffer (rare flushes) *lowers* the observed quantile: below-target staleness
  means headroom — shrink the buffer (more frequent outer updates) and relax
  the discount; above-target means the buffer absorbs ancient work — raise α
  and grow the buffer so each flush averages more, fresher mass.
* :class:`CohortTuner` (sync) — adjusts the straggler deadline and
  ``clients_per_round`` from the realized effective-K fraction and the
  partial-progress rescued/wasted-work monitors: too few contributors →
  loosen the deadline (then widen the cohort once the deadline saturates);
  over-provisioned rounds → tighten the deadline (then shrink the cohort).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.metrics.fedmetrics import (
    histogram_quantile,
    staleness_hist_counts,
    window_concat,
    window_mean,
)

#: grid step for the staleness-discount exponent: 1/16 is exactly
#: representable in binary, so quantized values round-trip JSON/float exactly
ALPHA_STEP = 0.0625
ALPHA_MAX = 2.0
#: grid step for the deadline knob (median-client-round units)
DEADLINE_STEP = 0.0625


def _snap(value: float, step: float) -> float:
    """Quantize onto the bucketed grid that bounds recompile churn."""
    return round(float(value) / step) * step


def _pow2_toward(current: int, up: bool, lo: int, hi: int) -> int:
    """Next power-of-two buffer size in the given direction, clipped."""
    nxt = current * 2 if up else max(1, current // 2)
    return max(lo, min(hi, nxt))


@dataclass(frozen=True)
class KnobUpdate:
    """One applied (or to-apply) knob change plus its triggering evidence.

    Only the knobs a policy actually moved are set; ``None`` means "leave this
    knob alone". ``evidence`` carries the observed metrics that justified the
    move — it rides the obs event and the benchmark JSON verbatim, so every
    knob change in a trace is auditable."""

    staleness_alpha: Optional[float] = None
    buffer_size: Optional[int] = None
    clients_per_round: Optional[int] = None
    deadline: Optional[float] = None
    evidence: Dict[str, float] = field(default_factory=dict)

    @property
    def changed(self) -> bool:
        return any(
            v is not None
            for v in (
                self.staleness_alpha,
                self.buffer_size,
                self.clients_per_round,
                self.deadline,
            )
        )

    def knob_dict(self) -> Dict[str, float]:
        """The set knobs as a flat float dict (event attrs / CSV columns)."""
        out: Dict[str, float] = {}
        for k in ("staleness_alpha", "buffer_size", "clients_per_round", "deadline"):
            v = getattr(self, k)
            if v is not None:
                out[k] = float(v)
        return out


class ControlPolicy:
    """The policy seam: a deterministic, JSON-serializable knob state machine.

    ``observe`` sees the controller's metrics window (newest row last) and
    returns a :class:`KnobUpdate` when the policy moves a knob, else ``None``.
    ``knobs()`` reports the policy's CURRENT knob values — after a resume this
    is what the trainer rebuilds the aggregator configuration from."""

    name = "base"

    def observe(self, window: List[Dict[str, Any]]) -> Optional[KnobUpdate]:
        raise NotImplementedError

    def knobs(self) -> Dict[str, float]:
        return {}

    def state_dict(self) -> Dict[str, Any]:
        """JSON-able policy state; floats round-trip exactly through the
        checkpoint manifest's JSON reprs."""
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k, v in state.items():
            if not hasattr(self, k):
                raise ValueError(f"{self.name} policy has no state field {k!r}")
            setattr(self, k, v)


class StaticPolicy(ControlPolicy):
    """The identity policy: never observes, never updates — ``--control
    static`` is bitwise the uncontrolled run (asserted in tests)."""

    name = "static"

    def observe(self, window: List[Dict[str, Any]]) -> Optional[KnobUpdate]:
        return None


class StalenessGovernor(ControlPolicy):
    """Async knob governor: hold the admitted-staleness quantile at a target.

    Control law (proportional, on the bucket-edge quantile ``q_obs`` from
    :func:`histogram_quantile`):

        error = q_obs - target
        |error| <= deadband        -> no update
        error > deadband  (stale)  -> alpha += gain * error (stronger discount)
                                      buffer *= 2 (fresher mass per flush)
        error < -deadband (fresh)  -> alpha += gain * error (relax discount)
                                      buffer /= 2 (flush more often)

    α is clipped to [0, ALPHA_MAX] and snapped to the 1/16 grid; the buffer
    moves on powers of two in [buffer_min, buffer_max]. Because staleness is
    counted in server rounds, shrinking the buffer RAISES future staleness
    (more version bumps per unit time) — the loop converges on the target from
    either side instead of ratcheting. A below-target reading is headroom: the
    operator tolerates staler deltas than the system produces, so the governor
    trades that slack for update frequency (the adaptive-control benchmark's
    win condition)."""

    name = "staleness"

    def __init__(
        self,
        *,
        staleness_alpha: float = 0.5,
        buffer_size: int = 4,
        target: float = 1.0,
        quantile: float = 0.9,
        gain: float = 0.5,
        deadband: float = 0.25,
        buffer_min: int = 1,
        buffer_max: Optional[int] = None,
    ):
        if not 0.0 < quantile <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {quantile}")
        if target < 0.0:
            raise ValueError(f"target staleness must be >= 0, got {target}")
        self.staleness_alpha = _snap(min(max(staleness_alpha, 0.0), ALPHA_MAX), ALPHA_STEP)
        self.buffer_size = int(buffer_size)
        self.target = float(target)
        self.quantile = float(quantile)
        self.gain = float(gain)
        self.deadband = float(deadband)
        self.buffer_min = int(buffer_min)
        self.buffer_max = int(buffer_max if buffer_max is not None else buffer_size)

    def knobs(self) -> Dict[str, float]:
        return {
            "staleness_alpha": float(self.staleness_alpha),
            "buffer_size": float(self.buffer_size),
        }

    def observe(self, window: List[Dict[str, Any]]) -> Optional[KnobUpdate]:
        staleness = window_concat(window, "admitted_staleness")
        if not staleness:
            return None
        counts = staleness_hist_counts(staleness)
        q_obs = histogram_quantile(counts, self.quantile)
        error = q_obs - self.target
        evidence = {
            "staleness_quantile": float(q_obs),
            "quantile": self.quantile,
            "target": self.target,
            "error": float(error),
            "n_admitted": float(len(staleness)),
            "buffer_occupancy": window_mean(window, "buffer_occupancy", 1.0),
        }
        if abs(error) <= self.deadband:
            return None
        alpha = _snap(
            min(max(self.staleness_alpha + self.gain * error, 0.0), ALPHA_MAX),
            ALPHA_STEP,
        )
        buffer = _pow2_toward(
            self.buffer_size, up=error > 0, lo=self.buffer_min, hi=self.buffer_max
        )
        update = KnobUpdate(
            staleness_alpha=alpha if alpha != self.staleness_alpha else None,
            buffer_size=buffer if buffer != self.buffer_size else None,
            evidence=evidence,
        )
        if not update.changed:
            return None  # both knobs pinned at their bounds
        self.staleness_alpha = alpha
        self.buffer_size = buffer
        return update


class CohortTuner(ControlPolicy):
    """Sync knob tuner: hold the realized effective-K fraction at a target.

    Reads the per-round ``effective_k`` (contributors after availability,
    dropout and the straggler rule) plus the partial-progress rescued/wasted
    monitors, and compares ``effective_k / clients_per_round`` to ``target``:

        fraction < target - deadband (starved rounds)
            -> deadline *= (1 + gain): give stragglers more time;
               once the deadline saturates at ``deadline_max``, widen the
               cohort by ``k_step`` instead (more candidates per round)
        fraction > target + deadband (over-provisioned rounds)
            -> deadline *= (1 - gain): stop paying for slack;
               once the deadline saturates at ``deadline_min``, shrink the
               cohort

    The deadline snaps to a 1/16 grid (a host-side scalar — free to change);
    ``clients_per_round`` moves in even steps within [k_min, population] and
    is the one sync knob that changes the round's cohort width (a bucketed
    shape, a handful per run)."""

    name = "cohort"

    def __init__(
        self,
        *,
        clients_per_round: int,
        deadline: float,
        population: int,
        target: float = 0.9,
        gain: float = 0.25,
        deadband: float = 0.05,
        deadline_min: float = 0.25,
        deadline_max: float = 4.0,
        k_min: int = 2,
        k_step: int = 2,
    ):
        if deadline <= 0.0:
            raise ValueError(
                "cohort control needs a finite straggler deadline to tune "
                f"(got {deadline}) — pick a straggler profile or --deadline"
            )
        if not 0.0 < target <= 1.0:
            raise ValueError(f"target effective-K fraction must be in (0, 1], got {target}")
        self.clients_per_round = int(clients_per_round)
        self.deadline = _snap(deadline, DEADLINE_STEP)
        self.population = int(population)
        self.target = float(target)
        self.gain = float(gain)
        self.deadband = float(deadband)
        self.deadline_min = float(deadline_min)
        self.deadline_max = float(deadline_max)
        self.k_min = int(k_min)
        self.k_step = int(k_step)

    def knobs(self) -> Dict[str, float]:
        return {
            "clients_per_round": float(self.clients_per_round),
            "deadline": float(self.deadline),
        }

    def observe(self, window: List[Dict[str, Any]]) -> Optional[KnobUpdate]:
        eff_k = window_mean(window, "effective_k", default=-1.0)
        if eff_k < 0.0:
            return None  # window carries no participation rows yet
        fraction = eff_k / float(self.clients_per_round)
        error = fraction - self.target
        evidence = {
            "effective_k_mean": float(eff_k),
            "effective_k_fraction": float(fraction),
            "target": self.target,
            "error": float(error),
            "rescued_work": window_mean(window, "partial_rescued_work", 0.0),
            "wasted_work": window_mean(window, "partial_wasted_work", 0.0),
        }
        if abs(error) <= self.deadband:
            return None
        starved = error < 0.0
        factor = (1.0 + self.gain) if starved else (1.0 - self.gain)
        deadline = _snap(
            min(max(self.deadline * factor, self.deadline_min), self.deadline_max),
            DEADLINE_STEP,
        )
        k = self.clients_per_round
        if deadline == self.deadline:
            # deadline pinned at its bound: move the cohort-size knob instead
            k = k + self.k_step if starved else k - self.k_step
            k = max(self.k_min, min(self.population, k))
        update = KnobUpdate(
            deadline=deadline if deadline != self.deadline else None,
            clients_per_round=k if k != self.clients_per_round else None,
            evidence=evidence,
        )
        if not update.changed:
            return None  # every knob pinned at its bounds
        self.deadline = deadline
        self.clients_per_round = k
        return update


#: registry behind ``--control {static,staleness,cohort}``
CONTROL_POLICIES = {
    StaticPolicy.name: StaticPolicy,
    StalenessGovernor.name: StalenessGovernor,
    CohortTuner.name: CohortTuner,
}
