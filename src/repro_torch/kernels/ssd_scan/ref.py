"""Oracles of the SSD chunk scan, as ``repro/kernels/ssd_scan/ref.py``: the
model's chunked SSD and a token-by-token recurrence, the ground-truth
semantics (model layout (B, S, nh, hd))."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.ssm import ssd_chunked


def ssd_naive(
    x: torch.Tensor,  # (B, S, nh, hd)
    dt: torch.Tensor,  # (B, S, nh)
    A: torch.Tensor,  # (nh,)
    Bm: torch.Tensor,  # (B, S, G, ds)
    Cm: torch.Tensor,  # (B, S, G, ds)
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token linear recurrence. Returns (y (B,S,nh,hd), final state)."""
    B, S, nh, hd = x.shape
    rep = nh // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2).float()
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    dtf = dt.float()
    a = A.float()
    state = (initial_state.float() if initial_state is not None
             else torch.zeros((B, nh, hd, Bm.shape[3]), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * a)
        dx = x[:, t].float() * dtf[:, t, :, None]
        state = state * dA[..., None, None] + torch.einsum("bhd,bhn->bhdn", dx, Bh[:, t])
        ys.append(torch.einsum("bhdn,bhn->bhd", state, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


ssd_ref = ssd_chunked  # chunked oracle (held against ssd_naive in the tests)
