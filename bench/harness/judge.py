"""The comparison that decides ``correct``: the program's readings of its
first rounds against the plain reference's readings of the same rounds.

- ``loss_gap``: the widest relative gap of a round's mean training loss;
- ``pg_gap``: the worst parameter's gap between the two norms of the first
  round's pseudo-gradient;
- ``change_gap``: the worst parameter's gap between the two norms of the
  change in the weights after the last round followed. Parameters whose
  reference pseudo-gradient is under a thousandth of the median parameter's
  are left out: their change is round-off (none is, in the two configurations).

A parameter's gap is |program's norm - reference's norm| divided by the
reference's norm of that parameter or of the median parameter, whichever is
larger.

- ``pg_dist``: ‖program's first pseudo-gradient − reference's‖ ÷ ‖reference's‖
  over all parameters at once, element by element, where the cell compares it.
  Under AdamW each element's step is its first moment over the root of its
  second, so round-off in the gradients moves each element but hardly a
  parameter's norm; this distance sees the elements.

``grad_norm_gap`` (the last local step's gradient norm, the cohort's mean) is
read beside them. A number is compared only where the cell sets a limit.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Tuple

import torch

#: a parameter whose reference pseudo-gradient is below this share of the
#: median parameter's is left out of ``change_gap``
ROUNDOFF_SHARE = 1e-3


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[set] = None) -> Tuple[float, str]:
    med = statistics.median(ref.values())
    worst, which = 0.0, ""
    for n, r in ref.items():
        if keep is not None and n not in keep:
            continue
        gap = abs(prog[n] - r) / max(r, med)
        if not math.isfinite(gap):
            return math.inf, n
        if gap >= worst:
            worst, which = gap, n
    return worst, which


def numbers(prog: dict, ref: dict) -> Dict[str, Tuple[float, str]]:
    """Each compared number, with a word on where it was worst."""
    out = {}
    rel = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    rel = [g if math.isfinite(g) else math.inf for g in rel]
    out["loss_gap"] = (max(rel), f"round {rel.index(max(rel))}")
    out["pg_gap"] = worst_leaf(prog["pg_norms"], ref["pg_norms"])
    med = statistics.median(ref["pg_norms"].values())
    keep = {n for n, v in ref["pg_norms"].items() if v >= ROUNDOFF_SHARE * med}
    out["change_gap"] = worst_leaf(prog["change_norms"], ref["change_norms"], keep)
    if "pg" in prog and "pg" in ref:
        diff = sum(float(torch.sum((prog["pg"][n] - x) ** 2)) for n, x in ref["pg"].items())
        total = sum(float(torch.sum(x ** 2)) for x in ref["pg"].values())
        out["pg_dist"] = (math.sqrt(diff / total) if total > 0 else math.inf, "all parameters")
    gn = [abs(p - r) / abs(r) for p, r in zip(prog["client_grad_norm"], ref["client_grad_norm"])]
    gn = [g if math.isfinite(g) else math.inf for g in gn]
    out["grad_norm_gap"] = (max(gn), f"round {gn.index(max(gn))}")
    return out


def judge(nums: Dict[str, Tuple[float, str]], limits: Dict[str, float]) -> Tuple[bool, list]:
    """``(every compared number within its limit, [[name, value, limit], ...])``."""
    rows = [[k, nums[k][0], limits[k]] for k in sorted(limits)]
    return all(v <= lim for _, v, lim in rows), rows
