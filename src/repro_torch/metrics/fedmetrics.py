"""Federated training monitors, the ported part of ``repro.metrics.fedmetrics``:
perplexity, held-out evaluation, the per-round participation and
partial-progress rows, the float32 uplink cost row and the CSV logger."""
from __future__ import annotations

import csv
import io
import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves


def perplexity(loss_ce: float) -> float:
    return float(math.exp(min(30.0, loss_ce)))


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


def uplink_round_metrics(params_like, n_uploads: float) -> Dict[str, float]:
    """Per-round uplink cost of the float32 uplink (the only one ported): four
    bytes per parameter per upload, compression ratio 1."""
    per_client = 4.0 * sum(x.numel() for x in tree_leaves(params_like))
    return {
        "uplink_bytes_per_client": per_client,
        "uplink_bytes_round": per_client * float(n_uploads),
        "uplink_compression_ratio": 1.0,
    }


@torch.no_grad()
def evaluate_perplexity(model, params, stream, batches: int = 4, batch_size: int = 4,
                        device="cpu") -> float:
    """Held-out perplexity on a validation stream (server-side evaluation, §4.2)."""
    total, n = 0.0, 0
    for _ in range(batches):
        tokens = torch.from_numpy(stream.next_batch(batch_size)).to(device)
        total += float(model.loss(params, {"tokens": tokens})[1]["ce"])
        n += 1
    return perplexity(total / n)


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
