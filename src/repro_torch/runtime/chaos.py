"""Fault injection for the cross-process runtime (the ``--chaos`` flags).

Every outbound message on either end rolls one seeded die and suffers at most
one of: process KILL (``os._exit`` — the hard crash the lease/redispatch and
checkpoint-resume machinery must absorb), message DROP (the frame is never
sent; the peer recovers via its own timeout + retry), or DELAY (the send is
held for ``delay_s`` — exercises lease expiry and the deadline flush without
killing anyone).

Payload corruption (``--chaos-corrupt``) is a separate die rolled per worker
*push*: the delta pytree itself is poisoned before it leaves the worker —
NaN/Inf fill, large-scale amplification, sign flip, or a replay of the
previous push. Unlike drop/kill, a corrupted payload arrives as a perfectly
well-formed frame (the CRC passes — corruption happened before framing), so
the only line of defense is the server's delta screen / robust aggregation.

The generator is seeded per ``(seed, role)`` so a chaos run is reproducible
per process and the server's dice are independent of each worker's.
"""
from __future__ import annotations

import copy
import os
import random
import sys
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from repro_torch.core.robust import CORRUPT_KINDS, corrupt_tree


@dataclass(frozen=True)
class ChaosConfig:
    drop: float = 0.0  # P(outbound message silently dropped)
    delay: float = 0.0  # P(outbound message held for delay_s)
    kill: float = 0.0  # P(process exits hard before sending)
    delay_s: float = 0.2
    corrupt: float = 0.0  # P(worker push payload poisoned before send)
    corrupt_kinds: Tuple[str, ...] = CORRUPT_KINDS
    seed: int = 0

    def __post_init__(self):
        for name in ("drop", "delay", "kill", "corrupt"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"chaos {name} probability {p} outside [0, 1]")
        if not self.corrupt_kinds:
            raise ValueError("chaos corrupt_kinds must not be empty")
        for k in self.corrupt_kinds:
            if k not in CORRUPT_KINDS:
                raise ValueError(
                    f"unknown corrupt kind {k!r} (choose from {CORRUPT_KINDS})"
                )

    @property
    def active(self) -> bool:
        return (self.drop + self.delay + self.kill + self.corrupt) > 0.0


KILL_EXIT_CODE = 137  # what SIGKILL would report — supervisors respawn on it


class ChaosMonkey:
    """One die roll per outbound message; at most one fault fires.

    When a tracer is attached, every injected fault lands in the event log as
    a ``fault`` instant — the audit the report CLI cross-checks against. For a
    *kill* the tracer is flushed to disk BEFORE ``os._exit`` (which skips all
    atexit/buffer teardown), so the fault that explains a half-open span
    always survives the crash it causes.
    """

    def __init__(self, cfg: ChaosConfig, role: str, tracer=None):
        self.cfg = cfg
        self.role = role
        self.tracer = tracer
        self._rng = random.Random(f"{cfg.seed}:{role}")
        self._corrupt_rng = random.Random(f"{cfg.seed}:{role}:corrupt")
        self._last_payload: Optional[Any] = None

    def _fault(self, kind: str, **attrs) -> None:
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.point("fault", kind=kind, role=self.role, **attrs)
            self.tracer.count(f"chaos_{kind}")
            if kind == "kill":
                self.tracer.flush()

    def on_payload(self, tree: Any, index: int) -> Tuple[Any, Optional[str]]:
        """Roll the corruption die for one outbound push payload. Returns the
        (possibly poisoned) tree and the corruption kind, or ``None`` when the
        payload goes out clean. ``replay`` resends the previous clean payload
        (valid-looking but stale — the staleness/duplicate machinery's
        problem, not the screen's); with no prior push it degrades to a sign
        flip so the configured probability always injects *something*. The
        fault instant carries the push ``index`` so the report audit can tie
        each injected corruption to its admission outcome."""
        if self.cfg.corrupt <= 0.0:
            return tree, None
        roll = self._corrupt_rng.random()
        prev, self._last_payload = self._last_payload, copy.deepcopy(tree)
        if roll >= self.cfg.corrupt:
            return tree, None
        kind = self._corrupt_rng.choice(self.cfg.corrupt_kinds)
        if kind == "replay":
            if prev is None:
                kind = "sign_flip"
                tree = corrupt_tree(tree, kind)
            else:
                tree = prev
        else:
            tree = corrupt_tree(tree, kind)
        self._fault(f"corrupt_{kind}", index=int(index))
        return tree, kind

    def on_send(self) -> bool:
        """Roll before a send. Returns True when the message must be DROPPED.
        May not return at all (kill)."""
        if not self.cfg.active:
            return False
        r = self._rng.random()
        if r < self.cfg.kill:
            print(f"[chaos:{self.role}] killed before send", file=sys.stderr, flush=True)
            self._fault("kill")
            os._exit(KILL_EXIT_CODE)
        r -= self.cfg.kill
        if r < self.cfg.drop:
            self._fault("drop")
            return True
        r -= self.cfg.drop
        if r < self.cfg.delay:
            import time

            self._fault("delay")
            time.sleep(self.cfg.delay_s)
        return False
