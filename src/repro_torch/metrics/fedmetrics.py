"""Federated training monitors, the counterpart of ``repro.metrics.fedmetrics``:
perplexity, held-out evaluation, the elastic-participation monitors
(effective cohort, weight entropy), the per-round participation,
partial-progress and uplink-cost rows, the async buffer's staleness summary
and simulated speedup, the control loop's window statistics, the logits'
L2 probe and the CSV logger."""
from __future__ import annotations

import csv
import io
import math
import os
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves


def perplexity(loss_ce: float) -> float:
    return float(math.exp(min(30.0, loss_ce)))


def effective_clients(weights) -> int:
    """K_eff: clients with nonzero aggregation weight this round."""
    return int(np.count_nonzero(np.asarray(weights)))


def weight_entropy(weights) -> float:
    """Shannon entropy (nats) of the normalized aggregation weights, in
    float64: log(K) for a balanced round, falling as few clients dominate.
    The round's own in-device monitor is ``aggregation_metrics``'."""
    w = np.asarray(weights, np.float64)
    w = w[w > 0]
    if w.size == 0:
        return 0.0
    p = w / w.sum()
    return float(-(p * np.log(p)).sum())


def participation_metrics(plan) -> Dict[str, float]:
    """A ``ParticipationPlan`` as logging-row fields (no ``weight_entropy``:
    the round reports that one itself)."""
    return {
        "effective_k": float(plan.effective_k),
        "straggler_count": float(plan.n_stragglers),
        "dropout_count": float(plan.n_dropped),
        "unavailable_count": float(np.asarray(plan.unavailable).sum()),
        "round_time_sim": float(plan.round_time),
    }


def partial_progress_metrics(plan, tau: int) -> Dict[str, float]:
    """How much of the requested τ the cohort realized, and the compute the
    deadline cut would have thrown away (see the reference for each field)."""
    mask = np.asarray(plan.mask)
    speeds_all = np.asarray(plan.speeds, np.float64)
    if plan.local_steps is None:
        cut = np.asarray(plan.stragglers)
        return {
            "partial_tau_mean": 1.0 if mask.any() else 0.0,
            "partial_full_fraction": 1.0 if mask.any() else 0.0,
            "partial_rescued_clients": 0.0,
            "partial_rescued_work": 0.0,
            "partial_wasted_work": float(
                np.minimum(1.0, plan.round_time * speeds_all[cut]).sum()
            ),
        }
    ls = np.asarray(plan.local_steps, np.float64)
    frac = ls[mask] / float(tau)
    rescued = mask & (ls < tau)
    cut = np.asarray(plan.stragglers)
    wasted = float(np.minimum(1.0, plan.round_time * speeds_all[cut]).sum())
    return {
        "partial_tau_mean": float(frac.mean()) if mask.any() else 0.0,
        "partial_full_fraction": float((ls[mask] >= tau).mean()) if mask.any() else 0.0,
        "partial_rescued_clients": float(rescued.sum()),
        "partial_rescued_work": float((ls[rescued] / float(tau)).sum()),
        "partial_wasted_work": wasted,
    }


def uplink_round_metrics(
    scheme: str, params_like, n_uploads: float, topk_fraction: float = 0.05, codec=None,
) -> Dict[str, float]:
    """Per-round uplink cost row: bytes one client sends under ``scheme``, bytes
    the round's ``n_uploads`` uploads cost, and the compression ratio against
    the float32 uplink. Pass the run's ``codec`` when there is one: the fused
    top-k prices ONE global kept-entry budget, not per-leaf budgets, and the
    logged bytes follow what that codec ships."""
    from repro_torch.core.compression import uplink_bytes

    per_client = (float(codec.nbytes(params_like)) if codec is not None
                  else uplink_bytes(params_like, scheme, topk_fraction))
    f32 = uplink_bytes(params_like, "float32")
    return {
        "uplink_bytes_per_client": float(per_client),
        "uplink_bytes_round": float(per_client) * float(n_uploads),
        "uplink_compression_ratio": float(f32) / max(float(per_client), 1e-12),
    }


# histogram bucket edges of delta staleness (server rounds); the last is open
_STALENESS_BUCKETS = ((0, 0), (1, 1), (2, 3), (4, 7), (8, None))


def staleness_stats(staleness: Iterable[float]) -> Dict[str, float]:
    """Mean, max and histogram (``staleness_hist_*``: 0, 1, 2–3, 4–7, 8+) of
    the admitted deltas' ages in one async update."""
    s = np.asarray(list(staleness), np.float64)
    out = {
        "staleness_mean": float(s.mean()) if s.size else 0.0,
        "staleness_max": float(s.max()) if s.size else 0.0,
    }
    for lo, hi in _STALENESS_BUCKETS:
        if hi is None:
            out[f"staleness_hist_{lo}p"] = float((s >= lo).sum())
        elif lo == hi:
            out[f"staleness_hist_{lo}"] = float(((s >= lo) & (s <= hi)).sum())
        else:
            out[f"staleness_hist_{lo}_{hi}"] = float(((s >= lo) & (s <= hi)).sum())
    return out


def staleness_hist_counts(staleness: Iterable[float]) -> np.ndarray:
    """Per-bucket counts of admitted staleness, in ``staleness_stats``' buckets."""
    s = np.asarray(list(staleness), np.float64)
    counts = []
    for lo, hi in _STALENESS_BUCKETS:
        if hi is None:
            counts.append(float((s >= lo).sum()))
        else:
            counts.append(float(((s >= lo) & (s <= hi)).sum()))
    return np.asarray(counts, np.float64)


def histogram_quantile(counts, q: float) -> float:
    """Conservative quantile off the cumulative staleness histogram: the upper
    edge of the first bucket whose cumulative count reaches ``q * total``
    (the open last bucket reports its lower edge; empty is 0.0), so the
    result is one of the bucket edges {0, 1, 3, 7, 8}."""
    c = np.asarray(counts, np.float64)
    if c.shape[0] != len(_STALENESS_BUCKETS):
        raise ValueError(
            f"expected {len(_STALENESS_BUCKETS)} bucket counts, got {c.shape[0]}"
        )
    total = float(c.sum())
    if total <= 0.0:
        return 0.0
    rank = float(q) * total
    cum = 0.0
    for (lo, hi), n in zip(_STALENESS_BUCKETS, c):
        cum += float(n)
        if cum >= rank:
            return float(hi if hi is not None else lo)
    return float(_STALENESS_BUCKETS[-1][0])  # pragma: no cover — q > 1 guard


def window_mean(rows, key: str, default: float = 0.0) -> float:
    """Mean of ``row[key]`` over the window's rows that carry it, non-finite
    values skipped; ``default`` when none does."""
    vals = [
        float(r[key]) for r in rows
        if r.get(key) is not None and math.isfinite(float(r[key]))
    ]
    if not vals:
        return float(default)
    return float(sum(vals) / len(vals))


def window_concat(rows, key: str) -> List[float]:
    """The window's per-row list metrics (``admitted_staleness``) concatenated,
    non-finite elements dropped."""
    out: List[float] = []
    for r in rows:
        v = r.get(key)
        if v:
            out.extend(float(x) for x in v if math.isfinite(float(x)))
    return out


def wallclock_speedup(sync_time: float, async_time: float) -> float:
    """How much longer the deadline-masking sync schedule takes to aggregate
    as many deltas as the async one did (> 1.0: async wins), simulated time."""
    return float(sync_time) / max(float(async_time), 1e-12)


@torch.no_grad()
def evaluate_perplexity(model, params, stream, batches: int = 4, batch_size: int = 4,
                        device=None) -> float:
    """Held-out perplexity on a validation stream (server-side evaluation,
    §4.2), on ``device`` (default: where the params are)."""
    if device is None:
        device = next(iter(tree_leaves(params))).device
    total, n = 0.0, 0
    for _ in range(batches):
        tokens = torch.from_numpy(stream.next_batch(batch_size)).to(device)
        total += float(model.loss(params, {"tokens": tokens})[1]["ce"])
        n += 1
    return perplexity(total / n)


@torch.no_grad()
def activation_l2_probe(model, params, batch) -> float:
    """RMS of the output logits — the divergence leading indicator the paper
    tracks (Fig 5)."""
    logits, _, _ = model.forward(params, batch)
    return float(torch.sqrt(torch.mean(torch.square(logits.float()))))


class MetricLogger:
    """Append-only CSV logger, one row per round. A row that brings new keys
    widens the header with an atomic whole-file rewrite; earlier rows pad the
    new columns with ``""``."""

    def __init__(self, path: str, fieldnames: Optional[List[str]] = None):
        self.path = path
        self.fieldnames = list(fieldnames) if fieldnames else None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._initialized = os.path.exists(path)
        if self._initialized:
            with open(self.path, newline="") as f:
                existing = next(csv.reader(f), None)
            if existing:
                merged = list(existing)
                merged += [c for c in (self.fieldnames or []) if c not in merged]
                self.fieldnames = merged

    def _grow_schema(self, new_keys: List[str]) -> None:
        from repro_torch.checkpoint.checkpoint import _atomic_write

        old_rows = self.read() if self._initialized else []
        self.fieldnames = list(self.fieldnames or []) + list(new_keys)
        buf = io.StringIO(newline="")
        w = csv.DictWriter(buf, fieldnames=self.fieldnames, extrasaction="raise", restval="")
        w.writeheader()
        for r in old_rows:
            w.writerow(r)
        _atomic_write(self.path, lambda f: f.write(buf.getvalue().encode("utf-8")))
        self._initialized = True

    def log(self, row: Dict) -> None:
        row = {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
               for k, v in row.items()}
        if self.fieldnames is None:
            self.fieldnames = list(row.keys())
        new_keys = [k for k in row if k not in self.fieldnames]
        if new_keys and self._initialized:
            self._grow_schema(new_keys)
        elif new_keys:
            self.fieldnames += new_keys
        write_header = not self._initialized
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.fieldnames, extrasaction="raise", restval="")
            if write_header:
                w.writeheader()
            w.writerow(row)
        self._initialized = True

    def read(self) -> List[Dict]:
        with open(self.path) as f:
            return list(csv.DictReader(f))
