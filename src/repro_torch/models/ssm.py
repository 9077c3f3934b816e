"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060], the
counterpart of ``repro.models.ssm``.

Chunked SSD: an intra-chunk quadratic term plus an inter-chunk linear state
recurrence, O(S·chunk) work and an O(1)-memory decode step. ``ssd_chunked``
is the plain torch path; under ``use_pallas`` the prefill goes through the
CUDA chunk-scan kernel (``repro_torch.kernels.ssd_scan``) instead, as the
reference sends it to its Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.common import ParamDesc, rmsnorm


def ssm_desc(cfg) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    g, ds, nh = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_n_heads
    conv_dim = di + 2 * g * ds
    return {
        "in_proj": ParamDesc((d, 2 * di + 2 * g * ds + nh), (None, "ffn"), "normal"),
        "conv_w": ParamDesc((cfg.ssm_conv_width, conv_dim), (None, "ffn"), "normal", 0.2),
        "conv_b": ParamDesc((conv_dim,), ("ffn",), "zeros"),
        "A_log": ParamDesc((nh,), ("ssm_heads",), "ssm_a"),
        "dt_bias": ParamDesc((nh,), ("ssm_heads",), "ssm_dt"),
        "D_skip": ParamDesc((nh,), ("ssm_heads",), "ones"),
        "norm_scale": ParamDesc((di,), ("ffn",), "ones"),
        "out_proj": ParamDesc((di, d), ("ffn", None), "normal",
                              0.02 / max(1, 2 * cfg.n_layers) ** 0.5),
    }


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence) at the end."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))


def ssd_chunked(
    x: torch.Tensor,  # (B, S, nh, hd)
    dt: torch.Tensor,  # (B, S, nh) — post-softplus
    A: torch.Tensor,  # (nh,) negative
    Bm: torch.Tensor,  # (B, S, G, ds)
    Cm: torch.Tensor,  # (B, S, G, ds)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, nh, hd, ds)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,nh,hd), final_state (B,nh,hd,ds))."""
    B, S, nh, hd = x.shape
    G, ds = Bm.shape[2], Bm.shape[3]
    if S % chunk:  # pad with dt=0 (identity dynamics, zero input contribution)
        pad = chunk - S % chunk
        y, final_state = ssd_chunked(
            _pad_seq(x, pad), _pad_seq(dt, pad), A, _pad_seq(Bm, pad), _pad_seq(Cm, pad),
            chunk, initial_state,
        )
        return y[:, :S], final_state
    nc = S // chunk
    rep = nh // G

    xc = x.reshape(B, nc, chunk, nh, hd)
    dtc = dt.reshape(B, nc, chunk, nh).float()
    Bc = Bm.reshape(B, nc, chunk, G, ds).repeat_interleave(rep, dim=3)  # (B,nc,l,nh,ds)
    Cc = Cm.reshape(B, nc, chunk, G, ds).repeat_interleave(rep, dim=3)

    dA = dtc * A.float()  # (B,nc,l,nh) negative
    dA_cum = torch.cumsum(dA, dim=2)  # inclusive cumulative within chunk
    dA_total = dA_cum[:, :, -1]  # (B,nc,nh)

    # ---- intra-chunk (quadratic within chunk, causal, decay-weighted) ----
    # L[i,j] = exp(dA_cum[i] - dA_cum[j]) for j <= i  (decay from j+1..i).
    # The mask goes in before the exponential: above the diagonal the decay
    # is positive and can overflow to inf, and an inf there turns the
    # gradient of a where() taken after exp into 0·inf = NaN (the reference
    # takes it after; the forward values are the same either way)
    decay = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (B,nc,i,j,nh)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(causal[None, None, :, :, None], decay, -torch.inf))
    scores = torch.einsum("bclhn,bcshn->bclsh", Cc.float(), Bc.float())
    M = scores * L  # (B,nc,i,j,nh)
    dx = xc.float() * dtc[..., None]  # dt-weighted inputs
    y_intra = torch.einsum("bclsh,bcshd->bclhd", M, dx)

    # ---- chunk states: S_c = sum_j exp(dA_total - dA_cum[j]) B_j (dt_j x_j)^T ----
    state_decay = torch.exp(dA_total[:, :, None, :] - dA_cum)  # (B,nc,l,nh)
    states = torch.einsum(
        "bclhn,bclhd,bclh->bchdn", Bc.float(), dx, state_decay
    )  # (B,nc,nh,hd,ds)

    # ---- inter-chunk recurrence over chunks ----
    chunk_decay = torch.exp(dA_total)  # (B,nc,nh)
    carry = (initial_state.float() if initial_state is not None
             else torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(carry)  # state *before* this chunk
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,nh,hd,ds)

    # ---- inter-chunk contribution: y_inter[i] = exp(dA_cum[i]) C_i · state_prev ----
    in_decay = torch.exp(dA_cum)  # (B,nc,l,nh)
    y_inter = torch.einsum(
        "bclhn,bchdn,bclh->bclhd", Cc.float(), prev_states, in_decay
    )

    y = (y_intra + y_inter).reshape(B, S, nh, hd)
    return y.to(x.dtype), carry


def ssd_recurrent_step(
    x: torch.Tensor,  # (B, nh, hd)
    dt: torch.Tensor,  # (B, nh)
    A: torch.Tensor,  # (nh,)
    Bm: torch.Tensor,  # (B, G, ds)
    Cm: torch.Tensor,  # (B, G, ds)
    state: torch.Tensor,  # (B, nh, hd, ds) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode update. Returns (y (B,nh,hd), new_state)."""
    nh = x.shape[1]
    rep = nh // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).float()  # (B,nh,ds)
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())  # (B,nh)
    dx = x.float() * dtf[..., None]  # (B,nh,hd)
    new_state = state * dA[..., None, None] + torch.einsum("bhd,bhn->bhdn", dx, Bh)
    y = torch.einsum("bhdn,bhn->bhd", new_state, Ch)
    return y.to(x.dtype), new_state


def causal_conv1d(
    xbc: torch.Tensor,  # (B, S, C)
    w: torch.Tensor,  # (W, C)
    b: torch.Tensor,  # (C,)
    conv_state: Optional[torch.Tensor] = None,  # (B, W-1, C) history
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv; returns (y, new_conv_state = last W-1 inputs)."""
    W = w.shape[0]
    if conv_state is None:
        hist = torch.zeros((xbc.shape[0], W - 1, xbc.shape[2]), dtype=xbc.dtype,
                           device=xbc.device)
    else:
        hist = conv_state.to(xbc.dtype)
    xp = torch.cat([hist, xbc], dim=1)  # (B, S+W-1, C)
    y = sum(xp[:, i : i + xbc.shape[1]] * w[i].to(xbc.dtype) for i in range(W))
    y = y + b.to(xbc.dtype)
    # a copy, as the reference's slice is: a view would keep all of xp alive
    # in every layer's cache (B·(S+W-1)·C per layer at prefill)
    new_state = xp[:, -(W - 1):].clone() if W > 1 else torch.zeros_like(hist)
    return y, new_state


def ssm_block(
    cfg,
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    cache: Optional[dict] = None,  # {'conv': (B,W-1,conv_dim), 'ssd': (B,nh,hd,ds)}
    decode: bool = False,
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    B, S, D = x.shape
    di, g, ds, nh, hd = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim

    zxbcdt = torch.einsum("bsd,dk->bsk", x, p["in_proj"].to(x.dtype))
    z, xBC, dt_raw = torch.split(zxbcdt, [di, di + 2 * g * ds, nh], dim=-1)

    conv_state = cache.get("conv") if cache else None
    xBC, new_conv_state = causal_conv1d(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)

    x_ssm, Bm, Cm = torch.split(xBC, [di, g * ds, g * ds], dim=-1)
    x_ssm = x_ssm.reshape(B, S, nh, hd)
    Bm = Bm.reshape(B, S, g, ds)
    Cm = Cm.reshape(B, S, g, ds)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if decode:
        assert S == 1
        ssd_state = (cache["ssd"] if cache
                     else torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=x.device))
        y1, new_state = ssd_recurrent_step(
            x_ssm[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], ssd_state
        )
        y = y1[:, None]
    else:
        init = cache.get("ssd") if cache else None
        if use_pallas:
            from repro_torch.kernels.ssd_scan import ops as ssd_ops

            y, new_state = ssd_ops.ssd(x_ssm, dt, A, Bm, Cm, cfg.ssm_chunk, init)
        else:
            y, new_state = ssd_chunked(x_ssm, dt, A, Bm, Cm, cfg.ssm_chunk, init)

    y = y + x_ssm * p["D_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rmsnorm(y * F.silu(z), p["norm_scale"])
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"].to(x.dtype))

    new_cache = None
    if cache is not None or decode:
        new_cache = {"conv": new_conv_state, "ssd": new_state}
    return out, new_cache


def empty_ssm_cache(cfg, batch: int, device="cuda") -> dict:
    """Zero conv and SSD states for ``batch`` sequences on ``device`` (the
    card unless the caller asks for the CPU, or ``meta`` for shapes only)."""
    device = resolve_device(device)
    di, g, ds, nh, hd = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim
    conv_dim = di + 2 * g * ds
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=torch.bfloat16,
                            device=device),
        "ssd": torch.zeros((batch, nh, hd, ds), dtype=torch.float32, device=device),
    }
