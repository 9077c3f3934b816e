"""The RMSNorm kernel's plain version (``rmsnorm_plain``, what the wrapper runs
on a CPU tensor), its any-leading-dims wrapper and its oracle, against the
JAX package's Pallas kernel in interpret mode and its ``rmsnorm_ref``, on the
same numpy inputs.

Tolerances, tighter than ``tests/test_kernels.py``'s ``TOL`` (2e-5 f32, 3e-2
bf16): float32 |Δ| ≤ 2e-6·|ref| elementwise (the two sum the squares in other
orders; r and the two products then round alike: measured ≤ 4.1e-7); bfloat16
|Δ| ≤ one bf16 ulp of ref (both sides round f32 values that may differ in the
last bits).
"""
import numpy as np
import pytest

from torch_parity import assert_close

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm import ops as j_ops  # noqa: E402
from repro.kernels.rmsnorm import ref as j_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as t_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as t_ref  # noqa: E402

SHAPES = [(4, 32), (2, 8, 128), (3, 5, 7, 1000), (2, 2048), (3, 5, 7, 32), (1, 128)]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    return x, s


def bf16_ulp(y):
    """One bf16 ulp at |y|: 2^(e - 8) where |y| = m·2^e, m in [0.5, 1)."""
    _, e = np.frexp(np.abs(y).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def within(got, want, dtype, what):
    if dtype == torch.float32:
        assert_close(got, want, rtol=2e-6, what=what)
    else:
        err = np.abs(got - want)
        assert np.all(err <= bf16_ulp(want)), (what, float(err.max()))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_version_matches_the_pallas_kernel(shape, dtype):
    """``ops.rmsnorm`` on a CPU tensor (the plain version) against the
    reference's ``ops.rmsnorm`` in interpret mode."""
    td, jd = dtype
    x, s = inputs(shape, seed=sum(shape))
    want = np.asarray(j_ops.rmsnorm(jnp.asarray(x, jd), jnp.asarray(s), interpret=True)
                      .astype(jnp.float32))
    before = t_kernel.rmsnorm_fwd.launches
    got = t_ops.rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(s))
    assert t_kernel.rmsnorm_fwd.launches == before  # a CPU tensor launches nothing
    assert got.dtype == td and tuple(got.shape) == shape
    within(got.float().numpy(), want, td, "plain vs Pallas interpret")


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_version_and_oracle_match_the_reference_oracle(eps, dtype):
    """The port's plain version and its ``rmsnorm_ref`` against the
    reference's ``rmsnorm_ref``, rows of small and large scale included."""
    td, jd = dtype
    x, s = inputs((6, 256), seed=7)
    x[0] *= 1e-3
    x[1] *= 1e3
    want = np.asarray(j_ref.rmsnorm_ref(jnp.asarray(x, jd), jnp.asarray(s), eps)
                      .astype(jnp.float32))
    tx, ts = torch.from_numpy(x).to(td), torch.from_numpy(s)
    within(t_ref.rmsnorm_ref(tx, ts, eps).float().numpy(), want, td, "oracle")
    within(t_kernel.rmsnorm_plain(tx, ts, eps=eps).float().numpy(), want, td, "plain vs oracle")


def test_wrapper_takes_a_bf16_scale_and_any_leading_dims():
    x, s = inputs((2, 3, 4, 64), seed=3)
    tx = torch.from_numpy(x)
    got = t_ops.rmsnorm(tx, torch.from_numpy(s).bfloat16())
    want = t_kernel.rmsnorm_plain(tx.reshape(-1, 64), torch.from_numpy(s).bfloat16())
    assert torch.equal(got, want.reshape(2, 3, 4, 64))
    # a non-contiguous input is flattened by ops, as the reference's reshape does
    got_t = t_ops.rmsnorm(tx.transpose(0, 1), torch.from_numpy(s))
    assert torch.equal(got_t, t_ops.rmsnorm(tx.transpose(0, 1).contiguous(), torch.from_numpy(s)))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Checked on every device, so the CPU path has the kernel's domain; a
    device that is neither cpu nor cuda raises rather than falling back."""
    x, s = (torch.from_numpy(a) for a in inputs((4, 64), seed=0))
    fwd = t_kernel.rmsnorm_fwd
    bad = [
        lambda: fwd(x.half(), s),  # dtype
        lambda: fwd(x, s.int()),  # scale dtype
        lambda: fwd(x, s[:32]),  # scale shape
        lambda: fwd(x[None], s),  # x not 2-d
        lambda: fwd(x.t().contiguous().t(), s),  # not contiguous
        lambda: fwd(x[:0], s),  # no rows
        lambda: fwd(x.to("meta"), s.to("meta")),  # neither cpu nor cuda
    ]
    before = fwd.launches
    for fn in bad:
        with pytest.raises(ValueError):
            fn()
    assert fwd.launches == before
