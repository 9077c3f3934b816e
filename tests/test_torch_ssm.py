"""``repro_torch.models.ssm`` and the SSD chunk scan's plain version against the
JAX package on the same inputs (made with numpy from a seed).

Tolerances. f32 paths sum in other orders than XLA's CPU (einsum blocking,
cumsum, the chunk recurrence): |Δ| ≤ 1e-5·max|ref| over the tensor (measured
5.3e-7 for ``ssd_chunked`` at S = 100, G = 2: ``python tests/torch_parity.py``). bf16 outputs: both sides compute in f32 and round to bf16, so an
element may land one bf16 ulp apart: |Δ| ≤ 2⁻⁷·|ref| + 1e-5·max|ref|. The
whole ``ssm_block`` passes three f32 products of width 256–1088 (each ~6e-7
relative apart between the packages) and a per-row RMS norm, which lifts a
small row's error to the scale of the largest: 1e-4·max|ref| (measured 2.15e-5).
"""
import dataclasses

import numpy as np
import pytest

from torch_parity import assert_close, jax_to_torch

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels.ssd_scan import ops as j_ops  # noqa: E402
from repro.kernels.ssd_scan import ref as j_ref  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models.common import init_params as j_init_params  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as t_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as t_ref  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def close(got, want, *, bf16=False, tol=1e-5, what=""):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max()) or 1.0
    assert_close(got, want, atol=tol * scale, rtol=2.0 ** -7 if bf16 else 0.0, what=what)


def ssd_inputs(B, S, nh, hd, G, ds, seed, init=True):
    """Model-layout inputs: dt post-softplus, A = -exp(.), optional state."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, nh)))).astype(np.float32)
    A = (-np.exp(0.5 * r.standard_normal(nh))).astype(np.float32)
    Bm = r.standard_normal((B, S, G, ds)).astype(np.float32)
    Cm = r.standard_normal((B, S, G, ds)).astype(np.float32)
    s0 = (0.5 * r.standard_normal((B, nh, hd, ds))).astype(np.float32) if init else None
    return x, dt, A, Bm, Cm, s0


def both(arrays, bf16_idx=()):
    """The same arrays for JAX and torch; ``bf16_idx`` are cast to bf16 (RNE
    on both sides, so the bits agree)."""
    j, t = [], []
    for i, a in enumerate(arrays):
        if a is None:
            j.append(None)
            t.append(None)
        elif i in bf16_idx:
            j.append(jnp.asarray(a, jnp.bfloat16))
            t.append(torch.from_numpy(a).to(torch.bfloat16))
        else:
            j.append(jnp.asarray(a))
            t.append(torch.from_numpy(a))
    return j, t


@pytest.mark.parametrize("with_history", [False, True], ids=["fresh", "history"])
def test_causal_conv1d_matches_reference(with_history):
    r = np.random.default_rng(1)
    xbc = r.standard_normal((2, 9, 12)).astype(np.float32)
    w = r.standard_normal((4, 12)).astype(np.float32)
    b = r.standard_normal(12).astype(np.float32)
    hist = r.standard_normal((2, 3, 12)).astype(np.float32) if with_history else None
    (jx, jw, jb, jh), (tx, tw, tb, th) = both([xbc, w, b, hist])
    jy, js = j_ssm.causal_conv1d(jx, jw, jb, jh)
    ty, ts = t_ssm.causal_conv1d(tx, tw, tb, th)
    close(ty, jy, what="y")
    assert np.array_equal(ts.numpy(), np.asarray(js))  # the last W-1 inputs, copied


def test_ssd_recurrent_step_matches_reference():
    x, dt, A, Bm, Cm, s0 = ssd_inputs(2, 1, 4, 8, 2, 6, seed=2)
    (jx, jdt, jA, jB, jC, js), (tx, tdt, tA, tB, tC, ts) = both([x[:, 0], dt[:, 0], A, Bm[:, 0],
                                                                 Cm[:, 0], s0])
    jy, jn = j_ssm.ssd_recurrent_step(jx, jdt, jA, jB, jC, js)
    ty, tn = t_ssm.ssd_recurrent_step(tx, tdt, tA, tB, tC, ts)
    close(ty, jy, what="y")
    close(tn, jn, what="state")


@pytest.mark.parametrize(
    "B,S,nh,hd,G,ds,chunk,init",
    [(2, 64, 4, 32, 1, 16, 16, False), (1, 100, 4, 32, 2, 16, 32, True),
     (2, 48, 6, 8, 3, 8, 16, True)],
    ids=["g1", "ragged-g2-init", "g3-init"],
)
def test_ssd_chunked_matches_reference(B, S, nh, hd, G, ds, chunk, init):
    arrays = ssd_inputs(B, S, nh, hd, G, ds, seed=S, init=init)
    (jx, jdt, jA, jB, jC, js), (tx, tdt, tA, tB, tC, ts) = both(arrays)
    jy, jf = j_ssm.ssd_chunked(jx, jdt, jA, jB, jC, chunk, js)
    ty, tf = t_ssm.ssd_chunked(tx, tdt, tA, tB, tC, chunk, ts)
    assert ty.shape == (B, S, nh, hd) and tf.dtype == torch.float32
    close(ty, jy, what="y")
    close(tf, jf, what="final state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,nh,hd,G,ds,chunk",
    [(1, 64, 2, 32, 1, 16, 16), (1, 100, 2, 32, 1, 16, 32), (2, 64, 4, 16, 2, 8, 16)],
    ids=["even", "ragged", "groups"],
)
def test_ssd_scan_plain_matches_pallas_interpret_and_naive(B, S, nh, hd, G, ds, chunk, dtype):
    """``ops.ssd`` on the CPU (the kernel's plain version) against the
    reference's ``ssd`` with its Pallas kernel in interpret mode, and both
    against the token-by-token recurrence."""
    arrays = ssd_inputs(B, S, nh, hd, G, ds, seed=7 + S)
    bf16 = dtype == "bfloat16"
    (jx, jdt, jA, jB, jC, js), (tx, tdt, tA, tB, tC, ts) = both(
        arrays, bf16_idx=(0, 3, 4) if bf16 else ())
    jy, jf = j_ops.ssd(jx, jdt, jA, jB, jC, chunk=chunk, initial_state=js, interpret=True)
    ty, tf = t_ops.ssd(tx, tdt, tA, tB, tC, chunk, ts)
    assert ty.dtype == tx.dtype and ty.shape == (B, S, nh, hd)
    close(ty, jy, bf16=bf16, what="y vs Pallas interpret")
    close(tf, jf, what="state vs Pallas interpret")
    ny, nf = t_ref.ssd_naive(tx, tdt, tA, tB, tC, ts)
    jny, jnf = j_ref.ssd_naive(jx, jdt, jA, jB, jC, js)
    close(ny, jny, bf16=bf16, what="naive y")
    close(nf, jnf, what="naive state")
    close(ty, ny, bf16=bf16, what="y vs naive")
    close(tf, nf, what="state vs naive")


def test_ssd_continuation_through_initial_state():
    """ssd(x[:64]) then ssd(x[64:], initial_state=...) equals ssd(x), in both
    packages, and the port's halves equal the reference's."""
    arrays = ssd_inputs(1, 128, 2, 32, 1, 16, seed=3, init=False)
    (jx, jdt, jA, jB, jC, _), (tx, tdt, tA, tB, tC, _) = both(arrays)
    ty, tf = t_ops.ssd(tx, tdt, tA, tB, tC, 32)
    ty1, tf1 = t_ops.ssd(tx[:, :64], tdt[:, :64], tA, tB[:, :64], tC[:, :64], 32)
    ty2, tf2 = t_ops.ssd(tx[:, 64:], tdt[:, 64:], tA, tB[:, 64:], tC[:, 64:], 32, tf1)
    jy2, jf2 = j_ops.ssd(jx[:, 64:], jdt[:, 64:], jA, jB[:, 64:], jC[:, 64:], chunk=32,
                         initial_state=j_ops.ssd(jx[:, :64], jdt[:, :64], jA, jB[:, :64],
                                                 jC[:, :64], chunk=32, interpret=True)[1],
                         interpret=True)
    close(ty2, ty[:, 64:], what="second half vs whole")
    close(tf2, tf, what="state vs whole")
    close(ty2, jy2, what="second half vs reference")
    close(tf2, jf2, what="state vs reference")


def test_ssd_scan_wrapper_checks_on_the_cpu():
    """The CPU path checks the kernel layout too, and counts no launch."""
    arrays = ssd_inputs(1, 32, 2, 8, 1, 4, seed=0)
    _, (tx, tdt, tA, tB, tC, ts) = both(arrays)
    m = lambda t: t.movedim(1, 2).contiguous()  # noqa: E731
    before = t_kernel.ssd_scan_fwd.launches
    y, s = t_kernel.ssd_scan_fwd(m(tx), m(tdt), tA, m(tB), m(tC), ts, chunk=16)
    assert y.shape == (1, 2, 32, 8) and s.shape == (1, 2, 8, 4)
    with pytest.raises(ValueError):
        t_kernel.ssd_scan_fwd(m(tx), m(tdt), tA, m(tB), m(tC), ts, chunk=12)  # S % chunk
    with pytest.raises(ValueError):
        t_kernel.ssd_scan_fwd(m(tx), m(tdt).double(), tA, m(tB), m(tC), ts, chunk=16)
    with pytest.raises(ValueError):
        t_kernel.ssd_scan_fwd(m(tx), m(tdt), tA, m(tB).bfloat16(), m(tC), ts, chunk=16)
    with pytest.raises(ValueError):
        t_kernel.ssd_scan_fwd(tx.movedim(1, 2), m(tdt), tA, m(tB), m(tC), ts, chunk=16)
    assert t_kernel.ssd_scan_fwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_scan_with_no_steps_returns_the_initial_state(dtype):
    """S = 0: y is empty and the final state is init, bit for bit (the CUDA
    routes copy init over as well; tests/test_torch_gpu.py)."""
    _, (tx, tdt, tA, tB, tC, ts) = both(ssd_inputs(2, 0, 4, 64, 2, 128, seed=1))
    m = lambda t: t.movedim(1, 2).contiguous()  # noqa: E731
    y, s = t_kernel.ssd_scan_fwd(m(tx).to(dtype), m(tdt), tA, m(tB).to(dtype), m(tC).to(dtype),
                                 ts, chunk=64)
    assert y.shape == (2, 4, 0, 64) and y.dtype == dtype and torch.equal(s, ts)


def _bf16_terms(v, n):
    """v as n bf16 terms, each the bf16 rounding of what the earlier ones
    leave (hi, then lo, ...), in f32."""
    out = []
    for _ in range(n):
        out.append(v.bfloat16().float())
        v = v - out[-1]
    return out


def emulate_tensor_core_scan(x, dt, A, Bm, Cm, init, chunk=64, terms=(2, 2, 3)):
    """The bf16 tensor-core kernel's arithmetic in f32 torch on the CPU,
    kernel layout: C·Bᵀ of exact bf16 values with f32 sums; per chunk the
    cumsum of dt·A in order, M' = (C·Bᵀ·L)·dt_j with L = 2^((cumᵢ − cumⱼ)·log2 e)
    (the product rounded to f32, as the kernel's); y = exp(cum)·(C·Sᵀ) + M'·x
    with S in ``terms[0]`` bf16 terms and M' in ``terms[1]``; S ← exp(total)·S
    + (x·dt·w)ᵀ·B with x·dt·w in ``terms[2]``; y rounded to bf16."""
    ts, tm, tb = terms
    B, nh, S, hd = x.shape
    rep = nh // Bm.shape[1]
    Bh, Ch = (t.repeat_interleave(rep, 1).float() for t in (Bm, Cm))
    xf, st, ys = x.float(), init.float().clone(), []
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    for c0 in range(0, S, chunk):
        xc, dtc = xf[:, :, c0:c0 + chunk], dt[:, :, c0:c0 + chunk].float()
        bc, cc = Bh[:, :, c0:c0 + chunk], Ch[:, :, c0:c0 + chunk]
        cum, run = torch.empty_like(dtc), torch.zeros_like(dtc[..., 0])
        for l in range(chunk):
            run = run + dtc[..., l] * A[None, :]
            cum[..., l] = run
        total = cum[..., -1:]
        L = torch.exp2((cum[..., :, None] - cum[..., None, :]) * np.float32(1.4426950408889634))
        M = torch.where(tri, ((cc @ bc.transpose(-1, -2)) * L) * dtc[..., None, :],
                        torch.zeros(()))
        y = sum(cc @ t.transpose(-1, -2) for t in _bf16_terms(st, ts)) * torch.exp(cum)[..., None]
        for t in _bf16_terms(M, tm):
            y = y + t @ xc
        ys.append(y.bfloat16())
        operand = xc * (dtc * torch.exp(total - cum))[..., None]
        st = torch.exp(total)[..., None] * st
        for t in _bf16_terms(operand, tb):
            st = st + t.transpose(-1, -2) @ bc
    return torch.cat(ys, 2), st


def _tc_units(got, want):
    """(y, state) errors in units of the held tolerances: y |Δ| ≤ 2⁻⁷·|y| +
    1e-5·max|y| (one bf16 ulp), state |Δ| ≤ 1e-5·max|S|."""
    (y, s), (y0, s0) = got, want
    y, y0 = y.float(), y0.float()
    y_units = float(((y - y0).abs() / (2.0 ** -7 * y0.abs() + 1e-5 * y0.abs().max())).max())
    return y_units, float((s - s0).abs().max() / (1e-5 * s0.abs().max()))


@pytest.mark.parametrize("B,S,nh,hd,G,ds", [(1, 512, 4, 64, 1, 128), (2, 192, 4, 128, 2, 64)],
                         ids=["mamba2-layer-reduced", "hd128-g2-ds64"])
def test_tensor_core_numerics_hold_the_tolerance(B, S, nh, hd, G, ds):
    """The bf16 tensor-core kernel's rounding, emulated, stays within the
    held tolerances of the plain version (y one bf16 ulp, state
    1e-5·max|S|) with S and M' in two bf16 terms and the state update's
    x·dt·w in three; one term for every f32 operand breaks them."""
    g = torch.Generator().manual_seed(S + hd)
    rnd = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    x = rnd(B, nh, S, hd).bfloat16()
    dt = torch.nn.functional.softplus(rnd(B, nh, S) - 1.0)
    A = -torch.exp(0.5 * rnd(nh))
    Bm, Cm = rnd(B, G, S, ds).bfloat16(), rnd(B, G, S, ds).bfloat16()
    init = 0.1 * rnd(B, nh, hd, ds)
    assert t_kernel.tensor_core_route(x.dtype, hd, ds, 64)
    want = t_kernel.ssd_scan_plain(x, dt, A, Bm, Cm, init, chunk=64)
    y_units, s_units = _tc_units(emulate_tensor_core_scan(x, dt, A, Bm, Cm, init), want)
    assert y_units <= 1.0 and s_units <= 1.0, (y_units, s_units)
    y_units, s_units = _tc_units(emulate_tensor_core_scan(x, dt, A, Bm, Cm, init,
                                                          terms=(1, 1, 1)), want)
    assert y_units > 1.0 and s_units > 1.0, (y_units, s_units)


def test_tensor_core_route_takes_bf16_at_chunk_64_and_the_widths_it_holds():
    """The route is chosen from dtype and shape before any launch: bf16,
    chunk 64, hd and ds each 64 or 128; f32 and every other shape take the
    CUDA-core kernel (mamba2-1.3b: hd 64, ds 128)."""
    route = t_kernel.tensor_core_route
    assert route(torch.bfloat16, 64, 128, 64) and route(torch.bfloat16, 128, 64, 64)
    assert not route(torch.float32, 64, 128, 64)
    assert not route(torch.bfloat16, 64, 128, 32)
    assert not route(torch.bfloat16, 32, 128, 64) and not route(torch.bfloat16, 64, 256, 64)


def _block_params(cfg_name="mamba2-1.3b"):
    """One SSM layer's params drawn by the reference, at reduced size."""
    jcfg = dataclasses.replace(j_get_config(cfg_name).reduced(), compute_dtype="float32")
    tcfg = dataclasses.replace(t_get_config(cfg_name).reduced(), compute_dtype="float32")
    p = j_init_params(jax.random.PRNGKey(5), j_ssm.ssm_desc(jcfg))
    # in_proj at 0.02 leaves the SSD inputs near zero; widen it so the scan matters
    p = dict(p, in_proj=p["in_proj"] * 25.0)
    return jcfg, tcfg, p, jax_to_torch(p)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["chunked", "pallas"])
def test_ssm_block_prefill_and_decode_match_reference(use_pallas):
    jcfg, tcfg, jp, tp = _block_params()
    r = np.random.default_rng(11)
    x = r.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)  # ragged: 40 % 16
    x1 = r.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)

    jy, jc = j_ssm.ssm_block(jcfg, jp, jnp.asarray(x), cache={}, use_pallas=use_pallas)
    ty, tc = t_ssm.ssm_block(tcfg, tp, torch.from_numpy(x), cache={}, use_pallas=use_pallas)
    close(ty, jy, tol=1e-4, what="prefill out")
    assert sorted(tc) == sorted(jc) == ["conv", "ssd"]
    assert tc["ssd"].dtype == torch.float32
    close(tc["conv"], jc["conv"], what="conv cache")
    close(tc["ssd"], jc["ssd"], what="ssd cache")

    # decode one token from the prefill cache (conv history as the serve path keeps it: bf16)
    jcache = {"conv": jc["conv"].astype(jnp.bfloat16), "ssd": jc["ssd"]}
    tcache = {"conv": tc["conv"].to(torch.bfloat16), "ssd": tc["ssd"]}
    jy1, jc1 = j_ssm.ssm_block(jcfg, jp, jnp.asarray(x1), cache=jcache, decode=True)
    ty1, tc1 = t_ssm.ssm_block(tcfg, tp, torch.from_numpy(x1), cache=tcache, decode=True)
    close(ty1, jy1, tol=1e-4, what="decode out")
    close(tc1["conv"], jc1["conv"], what="decode conv")
    close(tc1["ssd"], jc1["ssd"], what="decode ssd")

    # train mode returns no cache in either package
    assert t_ssm.ssm_block(tcfg, tp, torch.from_numpy(x))[1] is None
    assert j_ssm.ssm_block(jcfg, jp, jnp.asarray(x))[1] is None


def test_empty_ssm_cache_dtypes_and_shapes():
    jcfg, tcfg = j_get_config("mamba2-1.3b").reduced(), t_get_config("mamba2-1.3b").reduced()
    jc, tc = j_ssm.empty_ssm_cache(jcfg, 3), t_ssm.empty_ssm_cache(tcfg, 3, device="cpu")
    for k in ("conv", "ssd"):
        assert tuple(tc[k].shape) == jc[k].shape
    assert tc["conv"].dtype == torch.bfloat16 and tc["ssd"].dtype == torch.float32
    assert jc["conv"].dtype == jnp.bfloat16 and jc["ssd"].dtype == jnp.float32


def test_ssm_inits_draw_the_reference_distributions():
    """The port draws ``ssm_a``/``ssm_dt`` from its own generator; the ranges
    are the reference's: A_log = log U[1, 16], softplus(dt_bias) ∈ [1e-3, 1e-1]."""
    from repro_torch.models.common import ParamDesc, init_params

    p = init_params(0, {"a": ParamDesc((4096,), (None,), "ssm_a"),
                        "d": ParamDesc((4096,), (None,), "ssm_dt")}, device="cpu")
    a, dt = torch.exp(p["a"]), torch.nn.functional.softplus(p["d"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert 7.0 < float(a.mean()) < 10.0  # E[U[1, 16]] = 8.5
    assert 0.04 < float(dt.mean()) < 0.06  # E[U[1e-3, 1e-1]] = 0.0505


def test_ssd_chunked_gradient_stays_finite_where_the_decay_overflows():
    """With fast decay (dt·|A| = 16 a step over a 16-token chunk) the decay
    above the diagonal reaches 240 and exp overflows to inf. The port masks
    before the exponential: its loss equals the reference's (the forward
    values do not depend on where the mask goes) and every gradient is
    finite, where the reference, which masks after, gives NaN ones."""
    import jax
    import jax.numpy as jnp

    from torch_parity import (FAMILY_TOL, assert_close, family_pair, family_tokens, jax_flat,
                              jax_to_torch)
    from repro_torch.tree import tree_flatten, tree_unflatten

    jm, tm, jp, _ = family_pair("mamba2-1.3b")
    assert jm.cfg.ssm_chunk == 16

    def fast(path, x):
        name = jax.tree_util.keystr(path)
        if name.endswith("['A_log']"):
            return jnp.full_like(x, np.log(16.0))
        if name.endswith("['dt_bias']"):
            return jnp.full_like(x, np.log(np.expm1(1.0)))  # softplus = 1
        return x

    jp = jax.tree_util.tree_map_with_path(fast, jp)
    toks = family_tokens(jm.cfg, 2, 48, seed=3)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, {"tokens": jnp.asarray(toks)})
    assert not all(np.isfinite(v).all() for v in jax_flat(jg).values())
    leaves, treedef = tree_flatten(jax_to_torch(jp))
    leaves = [x.requires_grad_(True) for x in leaves]
    tl, _ = tm.loss(tree_unflatten(treedef, leaves), {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(tl, leaves)
    assert_close(float(tl.detach()), float(jl), rtol=FAMILY_TOL, what="loss")
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert max(float(g.abs().max()) for g in grads) > 0
