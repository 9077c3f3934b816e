"""The plain reference models' shared parts, in float32.

Written from the published descriptions in plain torch operations, with no
kernel, cache or batching of the measured program. Each family's model is its
own module, ``families/<family>.py`` (found by :func:`reference.layout.family`),
built from the parts here: the norms, ALiBi's slopes, the SSD scan of Mamba-2
in the paper's minimal chunked form (arXiv:2405.21060, Listing 1) and the
loss of a tied head, which is next-token cross-entropy over every position
but the last, plus ``z_loss`` times the mean squared log-sum-exp.

Every matrix product goes through ``mm`` (``a @ b`` with broadcasting), so
the same code runs in float32 (:func:`mm_fp32`), as the control that must
fail the comparison with both operands of every product rounded to fp8
(:func:`mm_fp8`), and, as the witness of what bfloat16 products alone do to
the compared numbers, with every product in bfloat16 (:func:`mm_bf16`).
``w`` maps a parameter's name to its tensor, or for a stacked parameter to
the list of its per-layer tensors.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F8_FWD, F8_BWD = torch.float8_e4m3fn, torch.float8_e5m2


def mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one per-tensor scale (its absmax onto
    the format's largest value), returned in float32."""
    top = torch.finfo(dtype).max
    s = torch.clamp(torch.amax(torch.abs(x.detach())), min=1e-30) / top
    return (x / s).to(dtype).float() * s


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with e4m3 operands forward and an e5m2 output gradient
    backward, accumulated in float32: fp8 training's products."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, F8_FWD), _fp8(b, F8_FWD)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, F8_BWD)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        if qb.ndim == 2:  # a (..., k) @ b (k, n): sum over a's leading dims
            gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = torch.matmul(qa.transpose(-1, -2), qg)
        return ga, gb


def mm_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in bfloat16, forward and backward, returned in float32: the
    products of the configurations' compute type over float32 weights."""
    return torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16)).float()


def _layernorm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def _rmsnorm(x, scale, eps):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def alibi_slopes(n_heads: int) -> list:
    """ALiBi's head slopes: the geometric series 2^(-8/n) for n a power of
    two, interleaved from the next power of two otherwise."""
    def pow2(n):
        start = 2.0 ** (-8.0 / n)
        return [start ** (i + 1) for i in range(n)]

    if n_heads & (n_heads - 1) == 0:
        return pow2(n_heads)
    near = 1 << (n_heads.bit_length() - 1)
    return pow2(near) + pow2(2 * near)[0::2][: n_heads - near]


def _lm_loss(cfg, w, h, tokens, mm):
    """Cross-entropy of the tied head over positions 0..S-2, plus the z-loss."""
    logits = mm(h[:, :-1], w["embed"][: cfg["vocab_size"]].T)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tokens[:, 1:, None])[..., 0]
    ce = (lse - ll).mean()
    return ce + cfg["z_loss"] * (lse * lse).mean(), ce


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) -> (..., T, T): sum of x over (j, i] below the diagonal,
    -inf above it."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return seg.masked_fill(~keep, -math.inf)


def ssd(X, A, B, C, block: int):
    """The SSD scan in its minimal chunked form (arXiv:2405.21060, Listing 1):
    y_t = sum_{s<=t} C_t . B_s exp(sum_{r in (s, t]} A_r) X_s.
    X (b, S, h, p), A (b, S, h), B and C (b, S, h, n); S a multiple of ``block``."""
    b, S, h, pdim = X.shape
    c = S // block
    X, B, C = (t.reshape(b, c, block, *t.shape[2:]) for t in (X, B, C))
    A = A.reshape(b, c, block, h).permute(0, 3, 1, 2)  # (b, h, c, l)
    A_cum = torch.cumsum(A, dim=-1)
    L = torch.exp(_segsum(A))  # (b, h, c, l, s)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, L, X)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(_segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states, torch.exp(A_cum))
    return (y_diag + y_off).reshape(b, S, h, pdim)


SSD_BLOCK = 128
