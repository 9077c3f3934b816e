"""Flash attention in model layout (B, S, H, hd): ``flash_attention``, the
counterpart of ``repro/kernels/flash_attention/ops.py``, and
``flash_attention_alibi``, the causal ALiBi training pair as an autograd
function (the reference has none: it trains ALiBi models on plain einsums).
The reference copies q, k and v to
(B, H, S, hd) and picks Pallas block sizes that divide S; here the kernel
reads the model's tensors in place through their strides (the views below
copy nothing), tiles by 64 and masks the ragged tail itself, and writes o in
(B, S, H, hd) memory, so the result comes back contiguous."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (
    _ALIGN,
    flash_attention_alibi_bwd,
    flash_attention_alibi_fwd,
    flash_attention_fwd,
)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, hd) — model layout
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    if window is not None and not isinstance(window, int):
        raise TypeError("kernel path needs a static window")
    out = flash_attention_fwd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, q_offset=q_offset,
    )
    return out.transpose(1, 2)


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels can read it through its strides (the hd
    axis contiguous, every other stride nonzero and 16-byte aligned), else a
    contiguous copy."""
    size = t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % _ALIGN == 0
          and all(st > 0 and st * size % _ALIGN == 0
                  for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))
    return t if ok else t.contiguous()


class FlashAlibiAttention(torch.autograd.Function):
    """Causal ALiBi self-attention on the flash kernel pair, in model layout:
    one forward launch, two backward launches. It saves q, k, v, o, o's
    rounding residual and the per-row log-sum-exp: nothing of size S². On the
    CPU both directions run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, slopes):
        q, k, v = _readable(q), _readable(k), _readable(v)
        o, o_lo, lse = flash_attention_alibi_fwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), slopes)
        out = o.transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, o_lo, lse, slopes)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, o_lo, lse, slopes = ctx.saved_tensors
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        dq, dk, dv = flash_attention_alibi_bwd(
            t(q), t(k), t(v), t(out), o_lo, lse, t(_readable(dout)), slopes)
        return t(dq), t(dk), t(dv), None


def flash_attention_alibi(
    q: torch.Tensor,  # (B, S, Hq, hd) — model layout
    k: torch.Tensor,  # (B, S, Hkv, hd)
    v: torch.Tensor,
    slopes: torch.Tensor,  # (Hq,) float32 on q's device
) -> torch.Tensor:
    """Causal ALiBi self-attention, differentiable: (B, S, Hq, hd) in q's dtype."""
    return FlashAlibiAttention.apply(q, k, v, slopes)
