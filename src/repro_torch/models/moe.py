"""The dense FFN of ``repro.models.moe`` (SwiGLU or a plain activation). The
routed mixture-of-experts FFN waits for the MoE families (ROADMAP.md)."""
from __future__ import annotations

import torch

from repro_torch.models.common import ParamDesc, activation_fn


def dense_ffn_desc(cfg, d_ff: int, n_copies: int = 1) -> dict:
    d = cfg.d_model
    dff = d_ff * n_copies
    out_scale = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    if cfg.activation == "silu":  # SwiGLU
        return {
            "w_in": ParamDesc((d, dff), "normal"),
            "w_gate": ParamDesc((d, dff), "normal"),
            "w_out": ParamDesc((dff, d), "normal", out_scale),
        }
    return {
        "w_in": ParamDesc((d, dff), "normal"),
        "w_out": ParamDesc((dff, d), "normal", out_scale),
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
