"""Mixture-of-Experts FFN, the counterpart of ``repro.models.moe``: shared +
routed experts, top-k routing with capacity, scatter-based dispatch into
(E, capacity, D) expert buffers, and the Switch-style load-balance auxiliary
loss. Also the dense FFN (SwiGLU or a plain activation).

Routing is a selection, so it is the reference's bit for bit given the same
router probabilities: top-k through a stable descending sort (ties toward the
lower expert index, the order ``lax.top_k`` documents; ``torch.topk``
documents none), and each slot's position in its expert by a cumsum over the
token-then-k slot order, as :func:`route` computes it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ParamDesc, activation_fn


def dense_ffn_desc(cfg, d_ff: int, n_copies: int = 1) -> dict:
    d = cfg.d_model
    dff = d_ff * n_copies
    out_scale = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    if cfg.activation == "silu":  # SwiGLU
        return {
            "w_in": ParamDesc((d, dff), (None, "ffn"), "normal"),
            "w_gate": ParamDesc((d, dff), (None, "ffn"), "normal"),
            "w_out": ParamDesc((dff, d), ("ffn", None), "normal", out_scale),
        }
    return {
        "w_in": ParamDesc((d, dff), (None, "ffn"), "normal"),
        "w_out": ParamDesc((dff, d), ("ffn", None), "normal", out_scale),
    }


def dense_ffn(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = activation_fn(cfg.activation)
    h = torch.einsum("...d,df->...f", x, p["w_in"].to(x.dtype))
    if "w_gate" in p:
        g = torch.einsum("...d,df->...f", x, p["w_gate"].to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    return torch.einsum("...f,fd->...d", h, p["w_out"].to(x.dtype))


def moe_ffn_desc(cfg) -> dict:
    d = cfg.d_model
    e = cfg.n_experts
    dff = cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": ParamDesc((d, e), (None, None), "normal"),
        "w_in": ParamDesc((e, d, dff), ("experts", None, None), "normal"),
        "w_gate": ParamDesc((e, d, dff), ("experts", None, None), "normal"),
        "w_out": ParamDesc((e, dff, d), ("experts", None, None), "normal",
                           0.02 / max(1, 2 * cfg.n_layers) ** 0.5),
    }
    if cfg.n_shared_experts:
        p["shared"] = dense_ffn_desc(cfg, dff, cfg.n_shared_experts)
    return p


def capacity_of(cfg, n_tokens: int, capacity_factor: float = None) -> int:
    """Slots per expert: ``max(1, int(T·K·cf/E))``; at decode (T = B) that is
    often 1, and routes past it drop, as in the reference."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    return max(1, int(n_tokens * cfg.moe_top_k * capacity_factor / cfg.n_experts))


def route(probs: torch.Tensor, k: int, capacity: int):
    """Top-k routing of (T, E) router probabilities. Returns ``(gate_vals
    (T, K) renormalised, expert_idx (T, K) int64, pos_in_expert (T·K,)
    int64, keep (T·K,) bool)``; slots are ordered token first, then k."""
    n_experts = probs.shape[-1]
    expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    gate_vals = torch.gather(probs, -1, expert_idx)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)  # renorm (deepseek)
    oh = F.one_hot(expert_idx.reshape(-1), n_experts)  # (T*K, E)
    # the running count of each expert's slots, scanned along a contiguous
    # (E, T*K) copy: a scan over the slot axis in place (T*K rows of E)
    # took 4.7 ms a layer at deepseek-moe-16b's prefill on the H100
    count = torch.cumsum(oh.t().contiguous(), dim=1).t()
    pos_in_expert = (count * oh).sum(-1) - 1
    return gate_vals, expert_idx, pos_in_expert, pos_in_expert < capacity


def _expert_ffn(act, buf, w_in, w_gate, w_out):
    h_in = torch.einsum("ecd,edf->ecf", buf, w_in)
    h_gate = torch.einsum("ecd,edf->ecf", buf, w_gate)
    return torch.einsum("ecf,efd->ecd", act(h_gate) * h_in, w_out)


def moe_ffn(
    cfg, p: dict, x: torch.Tensor, capacity_factor: float = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux load-balance loss scalar f32)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, D)

    logits = torch.einsum("td,de->te", xt.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    capacity = capacity_of(cfg, T, capacity_factor)
    gate_vals, expert_idx, pos_in_expert, keep = route(probs, K, capacity)

    # Load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    tokens_per_expert = F.one_hot(expert_idx, E).float().sum((0, 1)) / (T * K)  # f_e
    aux = E * torch.sum(tokens_per_expert * probs.mean(0))

    # Scatter the kept slots into (E, capacity, D) expert buffers. A dropped
    # slot adds x·0 at position 0 (exactly 0 there unless x is not finite,
    # as in the reference).
    flat_idx = expert_idx.reshape(T * K)
    safe_pos = torch.where(keep, pos_in_expert, torch.zeros_like(pos_in_expert))
    token_of_slot = torch.arange(T, device=x.device).repeat_interleave(K)
    contrib = torch.where(keep, gate_vals.reshape(T * K), torch.zeros((), device=x.device))
    src = xt[token_of_slot] * keep[:, None].to(x.dtype)
    buf = torch.zeros((E, capacity, D), dtype=x.dtype, device=x.device).index_put(
        (flat_idx, safe_pos), src, accumulate=True)

    # each (E, d, dff) weight cast once per call; in training the expert FFN
    # is recomputed in the backward pass (its (E, cap, dff) hiddens are the
    # widest buffers of fine-grained MoE layers), as the reference's
    # jax.checkpoint does
    weights = (p["w_in"].to(x.dtype), p["w_gate"].to(x.dtype), p["w_out"].to(x.dtype))
    act = activation_fn(cfg.activation)
    if torch.is_grad_enabled():
        out_buf = checkpoint(_expert_ffn, act, buf, *weights, use_reentrant=False)
    else:
        out_buf = _expert_ffn(act, buf, *weights)

    # Combine: gather each slot's expert output, weight by gate, sum over K.
    slot_out = out_buf[flat_idx, safe_pos] * contrib[:, None].to(x.dtype)
    yt = slot_out.reshape(T, K, D).sum(1)

    if cfg.n_shared_experts:
        yt = yt + dense_ffn(cfg, p["shared"], xt)

    return yt.reshape(B, S, D), aux.float()
