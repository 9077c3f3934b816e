"""The flash decode kernel's plain version (``flash_decode_plain``, what the
wrapper runs on a CPU tensor), its model-layout wrapper and its oracle,
against the JAX package's Pallas kernel in interpret mode and its
``decode_attention_ref``, on the same numpy inputs.

Tolerances, tighter than ``tests/test_kernels.py``'s ``TOL`` (2e-5 f32, 3e-2
bf16): float32 |Δ| ≤ 1e-5·max|ref| (the Pallas kernel folds a row's keys in
kv blocks with an online softmax, the plain version in one pass: f32 sums in
other orders; measured ≤ 3e-7 relative); bfloat16 |Δ| ≤ 2⁻⁷·|ref| +
1e-5·max|ref| (one bf16 ulp: both sides round an f32 result whose last bits
may differ). Against ``decode_attention_ref`` only rows that see at least one
key are compared: a row that sees none is 0 in both kernels and the mean of v
in the oracle.
"""
import numpy as np
import pytest

from torch_parity import assert_close

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode import ops as j_ops  # noqa: E402
from repro.kernels.flash_decode import ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_decode import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash_decode import ops as t_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as t_ref  # noqa: E402

#: (B, Hq, Hkv, S, hd, kv_len per row, window)
CASES = [
    (3, 4, 4, 100, 64, (100, 37, 0), None),  # grp 1, ragged kv_len, an empty row, S = 100
    (2, 4, 2, 200, 128, (200, 150), 64),  # grp 2, window, hd 128
    (2, 8, 2, 96, 32, (96, 10), 50),  # grp 4, hd 32, kv_len < window
    (2, 4, 1, 72, 256, (72, 1), None),  # grp 4, hd 256, one key
    (2, 6, 2, 333, 64, (333, 300), 1),  # grp 3, window 1: the last key only
    pytest.param((2, 4, 2, 600, 128, (600, 517), 256), marks=pytest.mark.slow),  # S > 512
    pytest.param((1, 8, 8, 1024, 32, (1000,), None), marks=pytest.mark.slow),
]
IDS = ["grp1-ragged-empty", "grp2-window-hd128", "grp4-hd32-short", "grp4-hd256-one-key",
       "grp3-window1", "S600", "S1024"]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def inputs(B, Hq, Hkv, S, hd, seed):
    """q (B, 1, Hq, hd) and the caches (B, S, Hkv, hd): model layout."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    return q, k, v


def seen_rows(S, kv_len, window):
    """(B,) bool: the batch rows that see at least one key."""
    kl = np.asarray(kv_len)[:, None]
    pos = np.arange(S)[None]
    seen = pos < kl
    if window is not None:
        seen &= pos > kl - 1 - window
    return seen.any(axis=1)


def pallas(q, k, v, kv_len, window, dtype):
    out = j_ops.flash_decode(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                             jnp.asarray(kv_len, jnp.int32), window=window, interpret=True)
    return np.asarray(out.astype(jnp.float32))[:, 0]


def kernel_layout(q, k, v, dtype):
    """(B, Hq, hd) and (B, Hkv, S, hd) torch tensors, contiguous."""
    return (torch.from_numpy(q[:, 0]).to(dtype),
            torch.from_numpy(np.ascontiguousarray(k.transpose(0, 2, 1, 3))).to(dtype),
            torch.from_numpy(np.ascontiguousarray(v.transpose(0, 2, 1, 3))).to(dtype))


def within(got, want, dtype, what):
    scale = float(np.abs(want).max())
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    assert_close(got, want, atol=1e-5 * scale, rtol=rtol, what=what)


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_version_matches_the_pallas_kernel(case, dtype):
    B, Hq, Hkv, S, hd, kv_len, window = case
    td, jd = dtype
    q, k, v = inputs(B, Hq, Hkv, S, hd, seed=S + hd)
    want = pallas(q, k, v, kv_len, window, jd)
    before = t_kernel.flash_decode_fwd.launches
    got = t_kernel.flash_decode_fwd(*kernel_layout(q, k, v, td),
                                    torch.tensor(kv_len, dtype=torch.int32), window=window)
    assert t_kernel.flash_decode_fwd.launches == before  # a CPU tensor launches nothing
    assert got.dtype == td and tuple(got.shape) == (B, Hq, hd)
    within(got.float().numpy(), want, td, "plain vs Pallas interpret")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_version_and_oracle_match_the_reference_oracle(case):
    """float32: the port's plain version against the reference's
    ``decode_attention_ref`` on the rows that see a key, and the port's
    ``decode_attention_ref`` against the reference's on every row."""
    B, Hq, Hkv, S, hd, kv_len, window = case
    q, k, v = inputs(B, Hq, Hkv, S, hd, seed=S * hd)
    tq, tk, tv = kernel_layout(q, k, v, torch.float32)
    want = np.asarray(j_ref.decode_attention_ref(
        *(jnp.asarray(t.numpy()) for t in (tq, tk, tv)), jnp.asarray(kv_len, jnp.int32),
        window=window))
    kl = torch.tensor(kv_len, dtype=torch.int32)
    within(t_ref.decode_attention_ref(tq, tk, tv, kl, window=window).numpy(), want,
           torch.float32, "oracle")
    rows = seen_rows(S, kv_len, window)
    got = t_kernel.flash_decode_plain(tq, tk, tv, kl, window=window).numpy()
    within(got[rows], want[rows], torch.float32, "plain vs oracle")


@pytest.mark.parametrize("kv_len,window", [((0, 40), None), ((40, 40), 0), ((-3, 7), 4)],
                         ids=["kv_len-0", "window-0", "negative-kv_len"])
def test_a_row_that_sees_no_key_is_zero_as_in_the_pallas_kernel(kv_len, window):
    """Rows with no key in sight: the Pallas kernel divides a zero sum by
    max(l, 1e-30) and gives 0; so does the port's kernel function. The
    oracle's softmax over all -1e30 scores gives the mean of v instead."""
    q, k, v = inputs(2, 4, 2, 40, 64, seed=11)
    rows = seen_rows(40, kv_len, window)
    assert 0 <= rows.sum() < 2
    want = pallas(q, k, v, kv_len, window, jnp.float32)
    tq, tk, tv = kernel_layout(q, k, v, torch.float32)
    kl = torch.tensor(kv_len, dtype=torch.int32)
    got = t_kernel.flash_decode_fwd(tq, tk, tv, kl, window=window).numpy()
    assert np.all(want[~rows] == 0.0) and np.all(got[~rows] == 0.0)
    within(got, want, torch.float32, "plain vs Pallas interpret")
    oracle = t_ref.decode_attention_ref(tq, tk, tv, kl, window=window).numpy()
    mean_v = np.repeat(v.mean(axis=1), 2, axis=1)  # (B, Hq, hd), grp 2
    assert_close(oracle[~rows], mean_v[~rows], atol=1e-6, what="oracle on an unseen row")


@pytest.mark.parametrize("kv_len", [77, (77, 128)], ids=["scalar", "per-row"])
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_model_layout_wrapper_matches_the_reference_ops(kv_len, window, dtype):
    """``ops.flash_decode`` on (B, 1, Hq, hd) and (B, S, Hkv, hd) against the
    reference's ``ops.flash_decode`` (interpret mode): a scalar kv_len is
    broadcast to every row, and the caches are read in place."""
    td, jd = dtype
    q, k, v = inputs(2, 8, 4, 128, 64, seed=5)
    want = j_ops.flash_decode(*(jnp.asarray(x, jd) for x in (q, k, v)),
                              jnp.asarray(kv_len, jnp.int32), window=window, interpret=True)
    got = t_ops.flash_decode(*(torch.from_numpy(x).to(td) for x in (q, k, v)), kv_len,
                             window=window)
    assert tuple(got.shape) == (2, 1, 8, 64) and got.dtype == td
    within(got.float().numpy(), np.asarray(want.astype(jnp.float32)), td, "ops")


def test_model_layout_wrapper_refuses_a_window_that_is_not_static():
    """A window that is not None or an int raises TypeError (the reference's
    jit takes the window as a static argument)."""
    q, k, v = (torch.from_numpy(x) for x in inputs(1, 2, 2, 16, 64, seed=0))
    for window in (4.0, torch.tensor(4)):
        with pytest.raises(TypeError, match="static window"):
            t_ops.flash_decode(q, k, v, 16, window=window)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Checked on every device, so the CPU path has the kernel's domain; a
    device that is neither cpu nor cuda raises rather than falling back."""
    q, k, v = kernel_layout(*inputs(2, 4, 2, 16, 64, seed=0), torch.float32)
    kl = torch.tensor([16, 8], dtype=torch.int32)
    fd = t_kernel.flash_decode_fwd
    bad = [
        lambda: fd(q[..., :48].contiguous(), k[..., :48].contiguous(),
                   v[..., :48].contiguous(), kl),  # hd 48
        lambda: fd(q.half(), k.half(), v.half(), kl),  # dtype
        lambda: fd(q, k.bfloat16(), v, kl),  # mixed dtypes
        lambda: fd(q, k[:, :1], v, kl),  # k and v shapes differ
        lambda: fd(q[:, :3].contiguous(), k, v, kl),  # Hq % Hkv
        lambda: fd(q, k, v, kl.long()),  # kv_len dtype
        lambda: fd(q, k, v, kl[:1]),  # kv_len shape
        lambda: fd(q, k.transpose(2, 3), v, kl),  # hd not the unit-stride axis
        lambda: fd(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, kl),  # q strided
        lambda: fd(q, k, v, kl, window=1 << 40),  # beyond int32
        lambda: fd(q.to("meta"), k.to("meta"), v.to("meta"), kl.to("meta")),  # neither device
    ]
    before = fd.launches
    for fn in bad:
        with pytest.raises(ValueError):
            fn()
    assert fd.launches == before


def test_split_count_fills_the_card_and_follows_the_window():
    """``n_splits``: one split once the (b, kv head) blocks fill 132 SMs 8
    times over; otherwise as many as fill them, but none under 64 keys of the
    longest a row can see."""
    ns = t_kernel.n_splits
    assert ns(128, 16, 8, 32768, None, 132) == 2  # qwen3-1.7b decode_32k: 1,024 blocks
    assert ns(1, 8, 4, 524288, None, 132) == 264  # gemma3-4b long_500k global layer
    assert ns(1, 8, 4, 524288, 1024, 132) == 16  # its local layers: a 1024-key window
    assert ns(2, 4, 2, 100, None, 132) == 2  # a short cache
    assert ns(1, 16, 2, 64, 0, 132) == 1  # an empty window
    assert ns(4096, 8, 8, 4096, None, 132) == 1
