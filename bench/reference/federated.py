"""Plain synchronous federated rounds (Photon, Algorithm 1) in float32.

Each round: every cohort client starts from the global weights, takes τ
local AdamW steps (global-norm clipping, a cosine schedule with linear
warm-up, decoupled weight decay, the mean loss over its batch), and uploads
Δ_c = θ − θ_c, int8-quantised per tensor when the uplink says so. The server
takes the mean of the Δ_c and applies FedAvg or FedMom (with or without
Nesterov). Gradients come from autograd over the family's reference model
(``families/<family>.py``).

:func:`run` follows the first rounds of a run and returns what the benchmark
compares: each round's loss, each parameter's norm of the first round's
pseudo-gradient and of the change in the weights after the last round.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from reference import layout
from reference.model import mm_fp32


def cosine_lr(inner: dict, step: int) -> float:
    """Linear warm-up to ``lr_max`` over ``warmup_steps``, then a cosine down
    to ``alpha·lr_max`` at ``total_steps``."""
    lr_max, warm, total = inner["lr_max"], inner["warmup_steps"], inner["total_steps"]
    if step < warm:
        return lr_max * step / max(1, warm)
    prog = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    lr_min = inner["alpha"] * lr_max
    return lr_min + 0.5 * (lr_max - lr_min) * (1.0 + math.cos(math.pi * prog))


def int8_roundtrip(d: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8: scale = max(absmax, 1e-12)/127, values
    rounded half to even and clipped to ±127, then scaled back."""
    scale = torch.clamp(torch.amax(torch.abs(d)), min=1e-12) / 127.0
    return torch.clamp(torch.round(d / scale), -127, 127) * scale


def leaf_norm(x: torch.Tensor) -> float:
    """Euclidean norm, accumulated in float32 without a copy (its rounding,
    ~1e-6 of the norm, is far under every gap compared)."""
    return float(torch.linalg.vector_norm(x))


def value_and_grad(cfg: dict, theta: Dict[str, torch.Tensor], tokens: torch.Tensor, mm,
                   grads: Dict[str, torch.Tensor]) -> float:
    """Mean loss of ``tokens`` (b, S), one sequence per backward pass (the
    float32 activations of one 2048-token photon-1.3b sequence take ~15 GB);
    the mean gradient is written into ``grads``. Every sequence has S - 1
    labels, so the mean of the sequences' losses is the batch's. Each layer
    of a stacked parameter (``layout.Leaf.stacked``) is its own autograd leaf,
    so no layer's backward touches the others."""
    loss_fn, stacks = layout.family(cfg).loss, layout.stacked(cfg)
    n_seq = tokens.shape[0]
    for g in grads.values():
        g.zero_()
    total = 0.0
    for i in range(n_seq):
        w, flat = {}, []
        for name, t in theta.items():
            if name in stacks:
                w[name] = [t[l].detach().requires_grad_(True) for l in range(t.shape[0])]
                flat += [(name, l, x) for l, x in enumerate(w[name])]
            else:
                w[name] = t.detach().requires_grad_(True)
                flat.append((name, None, w[name]))
        loss, _ = loss_fn(cfg, w, tokens[i:i + 1].long(), mm)
        gs = torch.autograd.grad(loss, [x for _, _, x in flat])
        with torch.no_grad():
            for (name, l, _), g in zip(flat, gs):
                (grads[name] if l is None else grads[name][l]).add_(g, alpha=1.0 / n_seq)
        total += float(loss.detach()) / n_seq
        del w, flat, gs, loss
    return total


@torch.no_grad()
def adamw_step(inner: dict, theta, grads, m, v, count: int, lr: float) -> float:
    """Clip the gradients to global norm ``grad_clip``, then one AdamW step
    in place. Returns the norm before clipping."""
    gn = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
    scale = min(1.0, inner["grad_clip"] / (gn + 1e-9))
    b1, b2 = inner["beta1"], inner["beta2"]
    c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    for name, p in theta.items():
        g = grads[name].mul_(scale)
        m[name].mul_(b1).add_(g, alpha=1.0 - b1)
        v[name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        step = (m[name] / c1) / (torch.sqrt(v[name] / c2) + inner["eps"])
        p.sub_(step.add_(p, alpha=inner["weight_decay"]), alpha=lr)
    return gn


def run(cfg: dict, traffic: dict, theta: Dict[str, torch.Tensor], rounds: List[torch.Tensor],
        theta0_leaf: Callable[[str], torch.Tensor], mm=mm_fp32, keep_pg: bool = False) -> dict:
    """Follow ``len(rounds)`` rounds from ``theta`` (owned and updated in
    place); ``rounds[r]`` holds round r's tokens (τ, C, B, S). ``theta0_leaf``
    gives a parameter's starting value again, for the change after the last
    round; ``keep_pg`` keeps the first round's pseudo-gradient in host memory.
    TF32 is off: every float32 product is a float32 product."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(cfg, traffic, theta, rounds, theta0_leaf, mm, keep_pg)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _run(cfg, traffic, theta, rounds, theta0_leaf, mm, keep_pg) -> dict:
    inner, outer = traffic["inner"], traffic["outer"]
    tau, C = traffic["local_steps"], traffic["clients_per_round"]
    mom = ({n: torch.zeros_like(p) for n, p in theta.items()}
           if outer["name"] == "fedmom" else None)
    out = {"loss": [], "client_grad_norm": []}
    for r, tokens in enumerate(rounds):
        pg = {n: torch.zeros_like(p) for n, p in theta.items()}
        losses, last_gn = [], []
        for c in range(C):
            th = {n: p.clone() for n, p in theta.items()}
            m = {n: torch.zeros_like(p) for n, p in theta.items()}
            v = {n: torch.zeros_like(p) for n, p in theta.items()}
            grads = {n: torch.zeros_like(p) for n, p in theta.items()}
            for t in range(tau):
                losses.append(value_and_grad(cfg, th, tokens[t, c], mm, grads))
                gn = adamw_step(inner, th, grads, m, v, t + 1, cosine_lr(inner, r * tau + t))
            last_gn.append(gn)
            del m, v, grads
            with torch.no_grad():
                for n, p in theta.items():
                    d = p - th[n]
                    if traffic["uplink"] == "int8":
                        d = int8_roundtrip(d)
                    pg[n].add_(d, alpha=1.0 / C)
            del th
        with torch.no_grad():
            if r == 0:
                out["pg_norms"] = {n: leaf_norm(x) for n, x in pg.items()}
                if keep_pg:
                    out["pg"] = {n: x.cpu() for n, x in pg.items()}
            for n, p in theta.items():
                if mom is None:  # fedavg
                    p.sub_(pg[n], alpha=outer["lr"])
                else:  # fedmom
                    mom[n].mul_(outer["momentum"]).add_(pg[n])
                    upd = mom[n] * outer["momentum"] + pg[n] if outer["nesterov"] else mom[n]
                    p.sub_(upd, alpha=outer["lr"])
        del pg
        out["loss"].append(sum(losses) / len(losses))
        out["client_grad_norm"].append(sum(last_gn) / len(last_gn))
    with torch.no_grad():
        out["change_norms"] = {n: leaf_norm(p - theta0_leaf(n)) for n, p in theta.items()}
    return out
