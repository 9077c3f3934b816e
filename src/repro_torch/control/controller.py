"""The :class:`FederationController`: windowed metric intake for a policy.

The controller is the piece the aggregators actually hold: it filters each
round/flush metrics row down to the control-relevant keys, maintains a bounded
window of recent rows, invokes its :class:`~repro_torch.control.policy.ControlPolicy`
every ``interval`` observations, and records every applied update in a history
(the audit trail the adaptive-control benchmark serializes). Its full state —
window, counters, history, the policy's knob state — is one JSON-able dict
(``state_dict``), persisted under the ``"control"`` key of the aggregator's
checkpoint manifest so a killed governed run resumes bitwise: the restored
controller has seen exactly the rows the original saw, so every future knob
decision replays identically.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.control.policy import (
    CONTROL_POLICIES,
    ControlPolicy,
    KnobUpdate,
    StaticPolicy,
)

#: the metric keys a policy may consume — rows are filtered to these so the
#: checkpointed window stays small and JSON-clean (floats and float lists only)
CONTROL_KEYS = (
    "admitted_staleness",
    "buffer_fill",
    "buffer_occupancy",
    "staleness_mean",
    "staleness_max",
    "sim_time",
    "effective_k",
    "round_time_sim",
    "partial_tau_mean",
    "partial_rescued_work",
    "partial_wasted_work",
    "train_loss",
    "train_loss_mean",
)


def _filter_row(row: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in CONTROL_KEYS:
        v = row.get(k)
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            out[k] = [float(x) for x in v]
        else:
            out[k] = float(v)
    return out


class FederationController:
    """Window + cadence + audit trail around one :class:`ControlPolicy`."""

    def __init__(self, policy: ControlPolicy, *, window: int = 4, interval: int = 1):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.policy = policy
        self.window = int(window)
        self.interval = int(interval)
        self.rows: List[Dict[str, Any]] = []
        self.seen = 0  # observations ever fed in (drives the cadence)
        self.n_updates = 0  # KnobUpdates actually applied
        self.history: List[Dict[str, Any]] = []  # audit trail of every update

    @property
    def enabled(self) -> bool:
        """A static controller is indistinguishable from no controller: the
        aggregators skip ``observe`` entirely, preserving bitwise identity."""
        return self.policy.name != StaticPolicy.name

    def knobs(self) -> Dict[str, float]:
        return self.policy.knobs()

    def observe(self, row: Dict[str, Any]) -> Optional[KnobUpdate]:
        """Feed one metrics row; returns the policy's update when the cadence
        fires and the policy moves a knob."""
        if not self.enabled:
            return None
        self.rows.append(_filter_row(row))
        del self.rows[: -self.window]
        self.seen += 1
        if self.seen % self.interval != 0:
            return None
        update = self.policy.observe(list(self.rows))
        if update is None:
            return None
        self.n_updates += 1
        self.history.append(
            {
                "observation": self.seen,
                "knobs": update.knob_dict(),
                "evidence": dict(update.evidence),
            }
        )
        return update

    # --- resume round-trip (rides the checkpoint manifest) -----------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "policy": self.policy.name,
            "window": self.window,
            "interval": self.interval,
            "rows": [dict(r) for r in self.rows],
            "seen": self.seen,
            "n_updates": self.n_updates,
            "history": [dict(h) for h in self.history],
            "state": self.policy.state_dict(),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("policy") != self.policy.name:
            raise ValueError(
                f"checkpointed controller ran --control {state.get('policy')!r} "
                f"but this run asked for --control {self.policy.name!r} — the "
                f"knob trajectory would diverge from the original run"
            )
        self.window = int(state["window"])
        self.interval = int(state["interval"])
        self.rows = [dict(r) for r in state["rows"]]
        self.seen = int(state["seen"])
        self.n_updates = int(state["n_updates"])
        self.history = [dict(h) for h in state["history"]]
        self.policy.load_state_dict(state["state"])


def build_controller(
    policy: str, *, window: int = 4, interval: int = 1, **policy_kwargs
) -> Optional[FederationController]:
    """``--control`` factory. Returns ``None`` for ``static``: no controller
    object at all, so the default path carries zero new state (checkpoints stay
    byte-identical to the uncontrolled schema)."""
    if policy not in CONTROL_POLICIES:
        raise ValueError(
            f"unknown control policy {policy!r}; choose from "
            f"{sorted(CONTROL_POLICIES)}"
        )
    if policy == StaticPolicy.name:
        return None
    return FederationController(
        CONTROL_POLICIES[policy](**policy_kwargs), window=window, interval=interval
    )
