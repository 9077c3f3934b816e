"""The flash attention kernel's plain version (``flash_attention_plain``, what
the wrapper runs on a CPU tensor), its model-layout wrapper and its oracle,
against the JAX package's Pallas kernel in interpret mode and its
``attention_ref``, on the same numpy inputs.

Tolerances: float32 |Δ| ≤ 1e-5·max|ref| (the Pallas kernel folds each row's
keys in blocks with an online softmax, the plain version in one pass: f32
sums in other orders); bfloat16 |Δ| ≤ 2⁻⁷·|ref| + 1e-5·max|ref| (one bf16
ulp: both sides round an f32 result whose last bits may differ). Against
``attention_ref`` only rows that see at least one key are compared: a row
that sees none is 0 in both kernels and the mean of v in the oracle.
"""
import numpy as np
import pytest

from torch_parity import assert_close

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import kernel as j_kernel  # noqa: E402
from repro.kernels.flash_attention import ops as j_ops  # noqa: E402
from repro.kernels.flash_attention import ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as t_ref  # noqa: E402

#: (B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset)
CASES = [
    (1, 2, 2, 64, 64, 64, True, None, 0),
    (2, 4, 2, 100, 100, 64, False, None, 0),  # grp 2, a ragged length (no 8-divisor)
    (1, 8, 2, 48, 80, 64, True, None, 32),  # grp 4, Sq < Sk, q_offset = Sk - Sq
    (1, 4, 4, 96, 96, 128, True, 24, 0),  # sliding window, hd 128
    (2, 4, 1, 40, 72, 64, False, 16, 20),  # window without causality, grp 4
    (1, 2, 1, 36, 36, 64, True, 8, 0),  # grp 2, window, ragged
]
IDS = ["causal", "grp2-ragged", "grp4-offset", "window-hd128", "window-noncausal", "grp2-window"]


def inputs(B, Hq, Hkv, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, hd)).astype(np.float32)
    return q, k, v


def seen_rows(Sq, Sk, causal, window, q_offset):
    """(Sq,) bool: the query rows that see at least one key."""
    qp = q_offset + np.arange(Sq)[:, None]
    kp = np.arange(Sk)[None, :]
    seen = np.ones((Sq, Sk), bool)
    if causal:
        seen &= kp <= qp
    if window is not None:
        seen &= qp - kp < window
    return seen.any(axis=1)


def pallas(q, k, v, causal, window, q_offset, dtype):
    Sq, Sk = q.shape[2], k.shape[2]
    j = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out = j_kernel.flash_attention_fwd(
        *j, causal=causal, window=window, q_offset=q_offset,
        block_q=j_ops._pick_block(Sq), block_k=j_ops._pick_block(Sk), interpret=True,
    )
    return np.asarray(out.astype(jnp.float32))


def to_torch(arrays, dtype):
    return [torch.from_numpy(x).to(dtype) for x in arrays]


def within(got, want, dtype, what):
    scale = float(np.abs(want).max())
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    assert_close(got, want, atol=1e-5 * scale, rtol=rtol, what=what)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_version_matches_the_pallas_kernel(case, dtype):
    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset = case
    q, k, v = inputs(B, Hq, Hkv, Sq, Sk, hd, seed=Sq + Sk)
    want = pallas(q, k, v, causal, window, q_offset,
                  jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    before = t_kernel.flash_attention_fwd.launches
    got = t_kernel.flash_attention_fwd(*to_torch((q, k, v), dtype), causal=causal,
                                       window=window, q_offset=q_offset)
    assert t_kernel.flash_attention_fwd.launches == before  # a CPU tensor launches nothing
    assert got.dtype == dtype and tuple(got.shape) == (B, Hq, Sq, hd)
    within(got.float().numpy(), want, dtype, "plain vs Pallas interpret")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_version_and_oracle_match_the_reference_oracle(case):
    """float32: the port's plain version against the reference's
    ``attention_ref`` on the rows that see a key, and the port's
    ``attention_ref`` against the reference's on every row."""
    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset = case
    q, k, v = inputs(B, Hq, Hkv, Sq, Sk, hd, seed=Sq * Sk)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = np.asarray(j_ref.attention_ref(*(jnp.asarray(x) for x in (q, k, v)), **kw))
    tq, tk, tv = to_torch((q, k, v), torch.float32)
    within(t_ref.attention_ref(tq, tk, tv, **kw).numpy(), want, torch.float32, "oracle")
    rows = seen_rows(Sq, Sk, causal, window, q_offset)
    got = t_kernel.flash_attention_plain(tq, tk, tv, **kw).numpy()
    within(got[:, :, rows], want[:, :, rows], torch.float32, "plain vs oracle")


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, -8), (False, 8, 0)],
                         ids=["before-first-key", "window-past-last-key"])
def test_a_row_that_sees_no_key_is_zero_as_in_the_pallas_kernel(causal, window, q_offset):
    """Rows with no key in sight: the Pallas kernel divides a zero sum by
    max(l, 1e-30) and gives 0; so does the port's kernel function. The
    oracle's softmax over all -1e30 scores gives the mean of v instead."""
    Sq, Sk = 32, 24
    q, k, v = inputs(1, 2, 1, Sq, Sk, 64, seed=9)
    rows = seen_rows(Sq, Sk, causal, window, q_offset)
    assert 0 < rows.sum() < Sq
    want = pallas(q, k, v, causal, window, q_offset, jnp.float32)
    got = t_kernel.flash_attention_fwd(*to_torch((q, k, v), torch.float32), causal=causal,
                                       window=window, q_offset=q_offset).numpy()
    assert np.all(want[:, :, ~rows] == 0.0) and np.all(got[:, :, ~rows] == 0.0)
    within(got, want, torch.float32, "plain vs Pallas interpret")
    oracle = t_ref.attention_ref(*to_torch((q, k, v), torch.float32), causal=causal,
                                 window=window, q_offset=q_offset).numpy()
    mean_v = np.repeat(v.mean(axis=2, keepdims=True), 2, axis=1)  # grp 2
    assert_close(oracle[:, :, ~rows], np.broadcast_to(mean_v, oracle.shape)[:, :, ~rows],
                 atol=1e-6, what="oracle on an unseen row")


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 16)],
                         ids=["noncausal", "causal", "window"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_model_layout_wrapper_matches_the_reference_ops(causal, window, dtype):
    """``ops.flash_attention`` on (B, S, H, hd) against the reference's
    ``ops.flash_attention`` (interpret mode), at whisper's reduced encoder
    shape (16 frames, 4 query heads on 2 kv heads) and at a ragged 100."""
    for S in (16, 100):
        rng = np.random.default_rng(S)
        q = rng.standard_normal((2, S, 4, 64)).astype(np.float32)
        k = rng.standard_normal((2, S, 2, 64)).astype(np.float32)
        v = rng.standard_normal((2, S, 2, 64)).astype(np.float32)
        jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        want = j_ops.flash_attention(*(jnp.asarray(x, jd) for x in (q, k, v)), causal=causal,
                                     window=window, interpret=True)
        got = t_ops.flash_attention(*to_torch((q, k, v), dtype), causal=causal, window=window)
        assert tuple(got.shape) == (2, S, 4, 64) and got.dtype == dtype
        within(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype, f"S={S}")


def test_model_layout_wrapper_refuses_a_window_that_is_not_static():
    """A window that is not None or an int raises TypeError in both wrappers
    (the reference's jit needs a hashable one to get that far: 4.0)."""
    q = np.zeros((1, 8, 2, 64), np.float32)
    with pytest.raises(TypeError, match="static window"):
        j_ops.flash_attention(*(jnp.asarray(q),) * 3, window=4.0, interpret=True)
    for window in (4.0, torch.tensor(4)):
        with pytest.raises(TypeError, match="static window"):
            t_ops.flash_attention(*(torch.from_numpy(q),) * 3, window=window)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Checked on every device, so the CPU path has the kernel's domain; a
    device that is neither cpu nor cuda raises rather than falling back."""
    q, k, v = to_torch(inputs(1, 4, 2, 16, 16, 64, seed=0), torch.float32)
    fa = t_kernel.flash_attention_fwd
    bad = [
        lambda: fa(q[..., :32].contiguous(), k[..., :32].contiguous(),
                   v[..., :32].contiguous()),  # hd 32
        lambda: fa(q.half(), k.half(), v.half()),  # dtype
        lambda: fa(q, k.bfloat16(), v),  # mixed dtypes
        lambda: fa(q, k[:, :1], v),  # k and v shapes differ
        lambda: fa(q[:, :3], k, v),  # Hq % Hkv
        lambda: fa(q.transpose(2, 3).contiguous().transpose(2, 3), k, v),  # not contiguous
        lambda: fa(q, k, v, window=1 << 40),  # beyond int32
        lambda: fa(q.to("meta"), k.to("meta"), v.to("meta")),  # neither cpu nor cuda
    ]
    before = fa.launches
    for fn in bad:
        with pytest.raises(ValueError):
            fn()
    assert fa.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wrapper_takes_model_layout_views(dtype):
    """The kernel reads (B, S, H, hd) tensors in place: their (B, H, S, hd)
    views pass the checks and give what contiguous copies give."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 100, h, 64)).astype(np.float32))
               .to(dtype).transpose(1, 2) for h in (4, 2, 2))
    assert not q.is_contiguous()
    got = t_kernel.flash_attention_fwd(q, k, v, causal=True, window=30)
    want = t_kernel.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                        causal=True, window=30)
    assert torch.equal(got, want)
    assert tuple(t_kernel._strides(q)) == (100 * 4 * 64, 64, 4 * 64)


def test_wrapper_refuses_rows_that_are_not_16_byte_aligned():
    """TMA reads rows at 16-byte-aligned addresses: rows 68 bf16 apart (136
    bytes) or a view 8 bytes into its storage are refused; rows 68 f32 apart
    (272 bytes) are taken."""
    fa = t_kernel.flash_attention_fwd
    f32 = torch.zeros((1, 32, 2, 68))[..., :64].transpose(1, 2)
    assert fa(f32, f32, f32).shape == (1, 2, 32, 64)
    bf = torch.zeros((1, 32, 2, 68)).bfloat16()
    for view in (bf[..., :64].transpose(1, 2),
                 bf.view(-1)[4:4 + 32 * 2 * 64].view(1, 32, 2, 64).transpose(1, 2)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa(view, view, view)


def emulate_tensor_core_kernel(q, k, v, causal, window, q_offset, split=True):
    """The bf16 kernel's arithmetic in f32 torch on the CPU: key tiles of 64,
    S = q·kᵀ from bf16 values (exact products, f32 sums), scaled after the
    product by scale·log2(e), exp2 of one fused multiply-add, the online
    softmax with m in log2 units, and P·V from p split into hi = bf16(p) and
    lo = bf16(p - hi) (``split=False``: p rounded to bf16 once)."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    k, v = (t.float().repeat_interleave(Hq // Hkv, dim=1) for t in (k, v))
    q = q.float()
    c = np.float32(t_kernel.sm_scale(hd)) * np.float32(1.4426950408889634)
    qp = q_offset + torch.arange(Sq)[:, None]
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, hd))
    for k0 in range(0, Sk, 64):
        kt, vt = k[:, :, k0:k0 + 64], v[:, :, k0:k0 + 64]
        s = q @ kt.transpose(-1, -2)
        kp = k0 + torch.arange(kt.shape[2])[None, :]
        seen = torch.ones_like(kp <= qp)
        if causal:
            seen &= kp <= qp
        if window is not None:
            seen &= qp - kp < window
        s = torch.where(seen, s, torch.full_like(s, -float("inf")))
        n = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        a = torch.exp2(m - n)
        p = torch.exp2((s.double() * float(c) - n.double()).float())  # one rounding, as fmaf
        l = l * a + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float() if split else torch.zeros_like(p)
        acc = acc * a + hi @ vt + lo @ vt
        m = n
    return (acc / torch.clamp(l, min=1e-30)).bfloat16()


@pytest.mark.parametrize("case", [
    (1, 4, 4, 300, 300, 64, False, None, 0),  # whisper's encoder layer, reduced; ragged
    (1, 4, 2, 200, 200, 128, True, None, 0),  # hd 128 (1/sqrt(128) is no bf16 value), GQA
    (2, 4, 1, 150, 260, 64, True, 70, 110),  # window, q_offset, grp 4
], ids=["encoder-reduced", "hd128-causal", "window-offset"])
def test_tensor_core_numerics_hold_the_tolerance(case):
    """The bf16 kernel's rounding, emulated, stays within the held tolerance
    of the plain version (|Δ| ≤ 2⁻⁷·|y| + 1e-5·max|y|); rounding p to bf16
    once, as a single bf16 P·V would, does not."""
    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset = case
    q, k, v = to_torch(inputs(B, Hq, Hkv, Sq, Sk, hd, seed=Sq + hd), torch.bfloat16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = t_kernel.flash_attention_plain(q, k, v, **kw).float().numpy()
    got = emulate_tensor_core_kernel(q, k, v, **kw).float().numpy()
    within(got, want, torch.bfloat16, "hi/lo P emulation vs plain")
    once = emulate_tensor_core_kernel(q, k, v, **kw, split=False).float().numpy()
    with pytest.raises(AssertionError):
        within(once, want, torch.bfloat16, "bf16 P emulation vs plain")


# ---------------------------------------------------------------------------
# The causal ALiBi training pair: its float32 oracle, its plain versions, the
# autograd function and the route to it
# ---------------------------------------------------------------------------

from types import SimpleNamespace  # noqa: E402

from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models.common import alibi_slopes  # noqa: E402

#: (S, Hq, Hkv, hd): photon-1.3b's layer at 2048 and 512, a ragged tail, H 16
#: and 4, hd 128 and 64, one GQA case
ALIBI_CASES = [
    (2048, 16, 16, 128),
    (512, 16, 16, 128),
    (100, 16, 16, 128),
    (512, 4, 4, 64),
    (100, 4, 4, 64),
    (100, 4, 2, 64),
]
ALIBI_IDS = ["s2048-h16-hd128", "s512-h16-hd128", "s100-h16-hd128", "s512-h4-hd64",
             "s100-h4-hd64", "s100-gqa2-hd64"]


def alibi_inputs(S, Hq, Hkv, hd, seed):
    """q, k, v in model layout (B 1, S, H, hd), float32, needing grads; dO; slopes."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, h, hd)).astype(np.float32))
               .requires_grad_(True) for h in (Hq, Hkv, Hkv))
    dout = torch.from_numpy(rng.standard_normal((1, S, Hq, hd)).astype(np.float32))
    return q, k, v, dout, alibi_slopes(Hq)


def f32_close(got, want, what):
    """float32 rounding: sums over up to S keys in other orders."""
    want = want.detach()
    assert_close(got.detach().numpy(), want.numpy(), atol=1e-5 * float(want.abs().max()),
                 what=what)


def grads(out, dout, xs):
    return torch.autograd.grad(out, xs, dout)


@pytest.mark.parametrize("case", ALIBI_CASES, ids=ALIBI_IDS)
def test_alibi_oracle_matches_sdpa_chunked_forward_and_backward(case):
    """The training kernels' float32 oracle, forward and autograd backward,
    equals the plain core the model ran before (``sdpa_chunked`` with the
    slopes) to float32 rounding."""
    S, Hq, Hkv, hd = case
    q, k, v, dout, slopes = alibi_inputs(S, Hq, Hkv, hd, seed=S + Hq + hd)
    pos = torch.arange(S)
    want = t_attn.sdpa_chunked(q, k, v, q_pos=pos, k_pos=pos, causal=True, window=None,
                               k_len=None, slopes=slopes)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    o, lse = t_ref.attention_alibi_ref(t(q), t(k), t(v), slopes)
    f32_close(t(o), want, "oracle vs sdpa_chunked: o")
    assert lse.shape == (1, Hq, S) and bool(torch.isfinite(lse).all())
    for name, g, g0 in zip("qkv", grads(t(o), dout, (q, k, v)), grads(want, dout, (q, k, v))):
        f32_close(g, g0, f"oracle vs sdpa_chunked: d{name}")


@pytest.mark.parametrize("case", ALIBI_CASES[2:], ids=ALIBI_IDS[2:])
def test_alibi_function_on_the_cpu_matches_the_oracle(case):
    """``flash_attention_alibi`` on CPU tensors runs the kernels' plain
    versions both ways (the backward recomputes P from the saved lse, D =
    rowsum(dO * O), dS = P (dP - D)) and launches nothing: its output, lse and
    gradients equal the oracle's to float32 rounding."""
    S, Hq, Hkv, hd = case
    q, k, v, dout, slopes = alibi_inputs(S, Hq, Hkv, hd, seed=S * hd + Hkv)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    before = (t_kernel.flash_attention_alibi_fwd.launches,
              t_kernel.flash_attention_alibi_bwd.launches)
    got = t_ops.flash_attention_alibi(q, k, v, slopes)
    o, lse = t_ref.attention_alibi_ref(t(q), t(k), t(v), slopes)
    f32_close(got, t(o), "function vs oracle: o")
    _, o_lo, lse_plain = t_kernel.flash_attention_alibi_plain(t(q), t(k), t(v), slopes)
    assert not o_lo.any()  # float32 inputs: o is the float32 result itself
    assert lse_plain.shape == (1, Hq, t_kernel.lse_len(S))
    f32_close(lse_plain[..., :S], lse, "plain vs oracle: lse")
    assert not lse_plain[..., S:].any()
    for name, g, g0 in zip("qkv", grads(got, dout, (q, k, v)), grads(t(o), dout, (q, k, v))):
        f32_close(g, g0, f"function vs oracle: d{name}")
    assert (t_kernel.flash_attention_alibi_fwd.launches,
            t_kernel.flash_attention_alibi_bwd.launches) == before


def test_alibi_wrappers_refuse_what_the_kernels_do_not_take():
    q, k, v, dout, slopes = alibi_inputs(64, 4, 2, 64, seed=0)
    t = lambda x: x.detach().transpose(1, 2)  # noqa: E731
    q, k, v = t(q), t(k), t(v)
    bad = [
        lambda: t_kernel.flash_attention_alibi_fwd(q, k[:, :, :32], v[:, :, :32], slopes),  # Sk
        lambda: t_kernel.flash_attention_alibi_fwd(q, k, v, slopes[:2]),  # slopes' shape
        lambda: t_kernel.flash_attention_alibi_fwd(q, k, v, slopes.double()),  # slopes' dtype
        lambda: t_kernel.flash_attention_alibi_fwd(q[..., :32], k[..., :32], v[..., :32],
                                                   slopes),  # hd 32
    ]
    o, o_lo, lse = t_kernel.flash_attention_alibi_fwd(q, k, v, slopes)
    bad += [
        lambda: t_kernel.flash_attention_alibi_bwd(q, k, v, o, o_lo, lse[..., :32], o, slopes),
        lambda: t_kernel.flash_attention_alibi_bwd(q, k, v, o, o_lo, lse, o[:, :2], slopes),
        lambda: t_kernel.flash_attention_alibi_bwd(
            q, k, v, o, o_lo.transpose(1, 2).contiguous().transpose(1, 2), lse, o,
            slopes),  # o_lo not in o's strides
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()


_PHOTON = SimpleNamespace(pos_embedding="alibi")
_SENTINEL = torch.tensor(t_attn.WINDOW_SENTINEL, dtype=torch.int32)  # a layer's 0-d window


def _call(device="cuda", dtype=torch.bfloat16, hd=128, **kw):
    """One attention call's observables: photon-1.3b's bf16 training call on
    the card, with the fields of ``kw`` changed."""
    q = SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(1, 2048, 16, hd))
    args = dict(causal=True, window=_SENTINEL, cache=None, kv_source=None, k_len=None)
    args.update(kw)
    return q, args


ROUTE_CASES = {
    "photon-train": (_PHOTON, _call(), True),
    "window-none": (_PHOTON, _call(window=None), True),
    "window-int-sentinel": (_PHOTON, _call(window=t_attn.WINDOW_SENTINEL), True),
    "hd64": (_PHOTON, _call(hd=64), True),
    "cpu": (_PHOTON, _call(device="cpu"), False),
    "f32": (_PHOTON, _call(dtype=torch.float32), False),
    "rope": (SimpleNamespace(pos_embedding="rope"), _call(), False),
    "learned": (SimpleNamespace(pos_embedding="learned"), _call(), False),
    "prefill-cache": (_PHOTON, _call(cache={}), False),
    "decode": (_PHOTON, _call(cache={"k": None, "v": None}, k_len=2049), False),
    "cross-attention": (_PHOTON, _call(causal=False, kv_source=object()), False),
    "not-causal": (_PHOTON, _call(causal=False), False),
    "real-window": (_PHOTON, _call(window=torch.tensor(512, dtype=torch.int32)), False),
    "window-int": (_PHOTON, _call(window=512), False),
    "window-on-a-device": (_PHOTON, _call(window=torch.empty((), dtype=torch.int32,
                                                             device="meta")), False),
    "hd96": (_PHOTON, _call(hd=96), False),
}


@pytest.mark.parametrize("cfg,call,want", ROUTE_CASES.values(), ids=ROUTE_CASES.keys())
def test_flash_train_route_takes_only_photons_bf16_training_call_on_the_card(cfg, call, want):
    q, args = call
    assert t_attn.flash_train_route(cfg, q, **args) is want
