"""The SSD chunk scan in model layout (B, S, nh, hd), the counterpart of
``repro/kernels/ssd_scan/ops.py``: pads S to a chunk multiple (dt = 0 there:
identity dynamics, no input), starts from a zero state when none is given,
casts dt, A and the state to f32 and moves the head axis ahead of S for the
kernel."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd


def ssd(
    x: torch.Tensor,  # (B, S, nh, hd)
    dt: torch.Tensor,  # (B, S, nh) — post-softplus
    A: torch.Tensor,  # (nh,) negative
    Bm: torch.Tensor,  # (B, S, G, ds)
    Cm: torch.Tensor,  # (B, S, G, ds)
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,  # (B, nh, hd, ds)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (B, S, nh, hd), final_state (B, nh, hd, ds) f32)``."""
    B, S, nh, hd = x.shape
    ds = Bm.shape[3]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    if initial_state is None:
        initial_state = torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=x.device)
    y, final = ssd_scan_fwd(
        x.movedim(1, 2).contiguous(),
        dt.float().movedim(1, 2).contiguous(),
        A.float().contiguous(),
        Bm.movedim(1, 2).contiguous(),
        Cm.movedim(1, 2).contiguous(),
        initial_state.float().contiguous(),
        chunk=chunk,
    )
    y = y.movedim(1, 2)
    if pad:
        y = y[:, :S]
    return y, final
