"""Shared helpers of the PyTorch port's parity tests (``tests/test_torch_*.py``).

Run as a script, it prints the measured model, server-step and serving parity
errors (``python tests/torch_parity.py``), or compares one client's fused top-k
encode at photon-75m's full width in both packages
(``python tests/torch_parity.py --topk-full-width``, about 4 GiB of host memory).

Each test builds its inputs with numpy from a seed and feeds the same values to
the JAX package and to ``repro_torch``; JAX trees cross over as
``{keystr: ndarray}`` (the checkpoint's own flattening), so a carried weight
is a key lookup.

Torch runs single-threaded here: on the CPU build these tests run against,
the first multi-threaded ``torch.sqrt`` of a process was seen to compute one
thread's chunk with an approximate square root (relative error ~2e-4), which
no stated tolerance could absorb. One thread computes every element alike.
"""
from __future__ import annotations

import csv

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


def jax_flat(tree):
    """``{keystr: ndarray}`` of a JAX tree (bf16 leaves as float32)."""
    from repro.checkpoint.checkpoint import _flatten_with_paths

    return _flatten_with_paths(tree)


def jax_to_torch(tree, device="cpu"):
    """A JAX tree as the port's nested dict/list of tensors."""
    from repro_torch.tree import params_from_numpy

    return params_from_numpy(jax_flat(tree), device)


def torch_flat(tree):
    from repro_torch.tree import params_to_numpy

    return params_to_numpy(tree)


def assert_close(got, want, *, atol=0.0, rtol=0.0, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    bound = atol + rtol * np.abs(want)
    assert np.all(err <= bound), (
        f"{what}: max abs err {err.max():.3e}, worst excess "
        f"{(err - bound).max():.3e} (atol={atol}, rtol={rtol})"
    )


def assert_trees_close(torch_tree, jax_tree, *, atol=0.0, rtol=0.0):
    """Same key paths, and every leaf within ``atol + rtol·|want|``."""
    got, want = torch_flat(torch_tree), jax_flat(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], atol=atol, rtol=rtol, what=k)


def update_rel_err(got: dict, want: dict, start: dict) -> float:
    """How far the update ``got − start`` is from ``want − start`` (flat
    ``{key: ndarray}`` trees): the global L2 norm of the difference over that
    of ``want − start``. It reads the update, not the values it moved, so an
    update that moves nothing, or moves the wrong way, is off by 1 or more."""
    assert sorted(got) == sorted(want) == sorted(start)
    num = den = 0.0
    for k in want:
        w = np.asarray(want[k], np.float64)
        num += float(np.sum((np.asarray(got[k], np.float64) - w) ** 2))
        den += float(np.sum((w - np.asarray(start[k], np.float64)) ** 2))
    assert den > 0.0, "the reference update is zero"
    return float(np.sqrt(num / den))


def assert_metrics_close(got: dict, want: dict, *, rtol: float, atol: float = 1e-7,
                         skip=()):
    """Every reference metric is present in ``got`` and agrees to ``rtol``."""
    for k, v in want.items():
        if k in skip:
            continue
        assert k in got, k
        assert_close(float(got[k]), float(v), atol=atol, rtol=rtol, what=k)


def j_merge(dst, src):
    """The reference ``generate``'s cache merge (a closure there)."""
    import jax
    import jax.numpy as jnp

    def leaf(d, s):
        s = s.astype(d.dtype)
        if d.shape == s.shape:
            return s
        return jnp.pad(s, [(0, a - b) for a, b in zip(d.shape, s.shape)])
    return jax.tree_util.tree_map(leaf, dst, src)


# ---------------------------------------------------------------------------
# Model families at reduced size: loss, gradient, prefill and decode steps
# ---------------------------------------------------------------------------

#: |Δ| ≤ FAMILY_TOL·max|ref| over each tensor (logits, cache leaves, a
#: gradient against the largest gradient entry of the tree), and loss and
#: moe_aux to FAMILY_TOL relative, all at compute_dtype="float32": the
#: packages take the same f32 products of width ≤ 512 in other orders
#: (~6e-7 relative each), and per-row norms lift a small row's error to the
#: largest row's scale
FAMILY_TOL = 1e-5


def family_pair(arch, **overrides):
    """Reference and port models of the reduced arch at f32 compute, with
    the reference's weights in both."""
    import dataclasses

    import jax

    from repro.configs import get_config as j_cfg
    from repro.models import build_model as j_build
    from repro_torch.configs import get_config as t_cfg
    from repro_torch.models import build_model as t_build

    kw = dict(compute_dtype="float32", **overrides)
    jm = j_build(dataclasses.replace(j_cfg(arch).reduced(), **kw))
    tm = t_build(dataclasses.replace(t_cfg(arch).reduced(), **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, jax_to_torch(jp)


def family_tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def close_to_max(got, want, what="", rtol=0.0):
    """|got - want| ≤ FAMILY_TOL·max|want| + rtol·|want| over the tensor."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert_close(got, want, atol=FAMILY_TOL * (float(np.abs(want).max()) or 1.0), rtol=rtol,
                 what=what)


def check_family_loss_and_grad(arch, B=2, S=48, seed=1) -> dict:
    """``Model.loss`` and its gradient in both packages on the same tokens;
    returns the port's metrics."""
    import jax
    import jax.numpy as jnp

    from repro_torch.tree import tree_flatten, tree_unflatten

    jm, tm, jp, tp = family_pair(arch)
    toks = family_tokens(jm.cfg, B, S, seed)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks)})
    leaves, treedef = tree_flatten(tp)
    leaves = [x.requires_grad_(True) for x in leaves]
    tl, tmet = tm.loss(tree_unflatten(treedef, leaves), {"tokens": torch.from_numpy(toks)})
    tg = torch_flat(tree_unflatten(treedef, list(torch.autograd.grad(tl, leaves))))
    assert sorted(tmet) == sorted(jmet), (sorted(tmet), sorted(jmet))
    for k in ("loss", "ce", "moe_aux"):
        if k in jmet:
            assert_close(float(tmet[k].detach()), float(jmet[k]), rtol=FAMILY_TOL, what=k)
    jg = jax_flat(jg)
    assert sorted(tg) == sorted(jg)
    g_max = max(float(np.abs(v).max()) for v in jg.values())
    for k in jg:
        assert_close(tg[k], jg[k], atol=FAMILY_TOL * g_max, what=f"grad {k}")
    return {k: float(v.detach()) for k, v in tmet.items()}


def check_family_prefill_and_decode(arch, B=2, S=40, n_decode=4, seed=2,
                                    use_pallas=False, **overrides):
    """Prefill logits and caches from the same tokens, then ``n_decode``
    decode steps fed the reference's greedy tokens. Each step starts both
    packages from the reference's cache (grown to S + n_decode), leaf for
    leaf in its dtype: a bf16 entry the two computed within FAMILY_TOL may
    round to neighbouring bf16 values, which would otherwise move every later
    step. Every step's logits and new cache are held."""
    import jax
    import jax.numpy as jnp

    jm, tm, jp, tp = family_pair(arch, **overrides)
    toks = family_tokens(jm.cfg, B, S, seed)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, use_pallas=use_pallas))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, use_pallas=use_pallas)
    assert tuple(tl.shape) == jl.shape == (B, 1, jm.cfg.vocab_size)
    close_to_max(tl, jl, "prefill logits")
    jf, tf = jax_flat(jc), torch_flat(tc)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        close_to_max(tf[k], jf[k], f"prefill cache {k}")

    max_len = S + n_decode
    jc = j_merge(jm.init_cache(B, max_len), jc)
    j_step = jax.jit(lambda p, c, t, i: jm.decode_step(p, c, t, i))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(n_decode):
        tc = carried_cache(jc)
        jl, jc = j_step(jp, jc, jnp.asarray(tok), jnp.int32(S + i))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), S + i)
        close_to_max(tl, jl, f"decode step {i} logits")
        bf16 = bf16_paths(jc)
        jf, tf = jax_flat(jc), torch_flat(tc)
        assert sorted(tf) == sorted(jf)
        for k in jf:  # the entries written this step round to bf16 (2⁻⁷·|x|)
            close_to_max(tf[k], jf[k], f"decode step {i} cache {k}",
                         rtol=2.0 ** -7 if k in bf16 else 0.0)
        tok = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]


def bf16_paths(jax_tree) -> set:
    import jax
    import jax.numpy as jnp

    return {jax.tree_util.keystr(p) for p, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]
            if leaf.dtype == jnp.bfloat16}


def carried_cache(jax_cache):
    """A reference cache as the port's tree, each leaf in its reference dtype."""
    from repro_torch.tree import flatten_with_paths, params_from_numpy, tree_flatten, tree_unflatten

    bf16 = bf16_paths(jax_cache)
    tree = params_from_numpy(jax_flat(jax_cache), "cpu")
    leaves = [t.to(torch.bfloat16) if k in bf16 else t for k, t in flatten_with_paths(tree)]
    return tree_unflatten(tree_flatten(tree)[1], leaves)


#: the train CLIs' flags in the checkpoint round trips (default bf16 compute,
#: so rows agree loosely: train_loss rel 2e-2, val_ppl rel 5e-2)
CLI_COMMON = ["--reduced", "--local-steps", "2", "--clients", "2", "--population", "4",
              "--seq-len", "64", "--fused-server"]


def csv_rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def cli_resume_round_trip(arch, tmp_path):
    """The reference writes round 0; each CLI resumes a copy for round 1 and
    their rows agree; the port's round-1 checkpoint has the reference's keys,
    shapes and dtypes, and the reference CLI resumes it for round 2."""
    import shutil

    from repro.checkpoint import load_pytree
    from repro.launch import train as jt
    from repro_torch.launch import train as tt

    args = CLI_COMMON + ["--arch", arch]
    ck = tmp_path / "ck"
    jt.run(jt.parse_args(args + ["--rounds", "1", "--ckpt-dir", str(ck)]))
    shutil.copytree(ck, tmp_path / "ck_j")
    shutil.copytree(ck, tmp_path / "ck_t")
    j_out = jt.run(jt.parse_args(args + ["--rounds", "2", "--ckpt-dir", str(tmp_path / "ck_j"),
                                         "--resume", "--log", str(tmp_path / "j.csv")]))
    tt.run(tt.parse_args(args + ["--rounds", "2", "--ckpt-dir", str(tmp_path / "ck_t"),
                                 "--resume", "--log", str(tmp_path / "t.csv"),
                                 "--device", "cpu"]))
    (jr,), (tr,) = csv_rows(tmp_path / "j.csv"), csv_rows(tmp_path / "t.csv")
    assert float(jr["round"]) == float(tr["round"]) == 1.0
    for k in ("selected", "contributors", "effective_k", "uplink_bytes_per_client"):
        assert jr[k] == tr[k], k
    assert_close(float(tr["train_loss"]), float(jr["train_loss"]), rtol=2e-2, what="train_loss")
    assert_close(float(tr["val_ppl"]), float(jr["val_ppl"]), rtol=5e-2, what="val_ppl")
    t_npz = tmp_path / "ck_t" / "round_000001" / "server.npz"
    j_npz = tmp_path / "ck_j" / "round_000001" / "server.npz"
    with np.load(t_npz) as t, np.load(j_npz) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    load_pytree(str(t_npz), j_out["state"])
    back = jt.run(jt.parse_args(args + ["--rounds", "3", "--ckpt-dir", str(tmp_path / "ck_t"),
                                        "--resume"]))
    assert [int(r["round"]) for r in back["history"]] == [2]
    assert np.isfinite(back["history"][0]["train_loss"])
    return jr, tr


def _report() -> None:
    """Print the measured max errors of the model and server-step parity, at
    the sizes ``test_torch_model.py`` and ``test_torch_fedcore.py`` use."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_cfg
    from repro.kernels.fedcore import kernel as JK
    from repro.models import build_model as j_build
    from repro_torch.configs import get_config as t_cfg
    from repro_torch.kernels.fedcore import kernel as TK
    from repro_torch.models import build_model as t_build
    from repro_torch.tree import tree_flatten, tree_unflatten

    for seq, batch, dtype in [(64, 2, "float32"), (512, 1, "float32"), (64, 2, "bfloat16")]:
        jm = j_build(dataclasses.replace(j_cfg("photon-75m").reduced(), compute_dtype=dtype))
        tm = t_build(dataclasses.replace(t_cfg("photon-75m").reduced(), compute_dtype=dtype))
        params = jm.init(jax.random.PRNGKey(0))
        toks = np.random.default_rng(seq).integers(0, 512, (batch, seq)).astype(np.int32)
        (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(params, {"tokens": jnp.asarray(toks)})
        leaves, treedef = tree_flatten(jax_to_torch(params))
        leaves = [x.requires_grad_(True) for x in leaves]
        tl, _ = tm.loss(tree_unflatten(treedef, leaves), {"tokens": torch.from_numpy(toks)})
        tg = torch_flat(tree_unflatten(treedef, list(torch.autograd.grad(tl, leaves))))
        jgf = jax_flat(jg)
        gerr = max(float(np.abs(tg[k] - jgf[k]).max()) for k in jgf)
        gmax = max(float(np.abs(v).max()) for v in jgf.values())
        print(f"model {dtype} S={seq} B={batch}: loss rel err "
              f"{abs(float(tl.detach()) - float(jl)) / abs(float(jl)):.3e}, grad max abs err "
              f"{gerr:.3e} (max |g| {gmax:.3e})")

    rng = np.random.default_rng(4)
    c, n = 4, 384
    d = (rng.standard_normal((c, n)) * 1e-2).astype(np.float32)
    wn = np.asarray([1.0, 2.0, 0.0, 0.5], np.float32) / np.float32(3.5)
    p = (rng.standard_normal(n) * 0.02).astype(np.float32)
    g0 = (rng.standard_normal(n) * 5e-3).astype(np.float32)
    noise = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    for opt, lanes, lr in [("fedavg", [], 1.0), ("fedmom", [g0], 0.7),
                           ("fedadam", [0.1 * g0, 0.01 * g0 * g0], 0.1)]:
        bias = (1.0 - 0.9 ** 2, 1.0 - 0.99 ** 2) if opt == "fedadam" else None
        jp, jlanes, jpg, jnp_, jdsq = JK.server_apply(
            jnp.asarray(d), jnp.asarray(wn), jnp.asarray(p), [jnp.asarray(x) for x in lanes],
            opt=opt, lr=lr, bias_corr=None if bias is None else tuple(map(jnp.float32, bias)),
            noise=jnp.asarray(noise), block=128, interpret=True,
        )
        tp, tlanes = torch.from_numpy(p.copy()), [torch.from_numpy(x.copy()) for x in lanes]
        tpg, tnp, tdsq = TK.server_apply_plain(
            torch.from_numpy(d), torch.from_numpy(wn), tp, tlanes, opt=opt, lr=lr,
            bias_corr=bias, noise=torch.from_numpy(noise),
        )
        lane_err = max([float(np.abs(a.numpy() - np.asarray(b)).max())
                        for a, b in zip(tlanes, jlanes)] or [0.0])
        norms_t = np.asarray([float(tpg), float(tnp), *tdsq.numpy()], np.float64)
        norms_j = np.asarray([float(jpg[0, 0]), float(jnp_[0, 0]), *np.asarray(jdsq)[:, 0]],
                             np.float64)
        print(f"server_apply {opt} C={c} noise: params max abs err "
              f"{float(np.abs(tp.numpy() - np.asarray(jp)).max()):.3e}, lanes {lane_err:.3e}, "
              f"norms max rel err {float(np.max(np.abs(norms_t - norms_j) / norms_j)):.3e}")


def _report_serving() -> None:
    """Print the measured serving parity errors, relative to max|ref|, at the
    inputs ``test_torch_ssm.py``, ``test_torch_serve.py``,
    ``test_torch_whisper.py`` and ``test_torch_flash_attention.py`` use."""
    import sys
    from pathlib import Path

    import jax.numpy as jnp

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_serve as SV
    import test_torch_ssm as SM
    from repro.kernels.ssd_scan import ops as j_ops
    from repro.models import ssm as j_ssm
    from repro_torch.kernels.ssd_scan import ops as t_ops
    from repro_torch.models import ssm as t_ssm

    def rel(got, want):
        got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        want = np.asarray(want, np.float32)
        return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))

    arrays = SM.ssd_inputs(1, 100, 4, 32, 2, 16, seed=100)
    (jx, jdt, jA, jB, jC, js), (tx, tdt, tA, tB, tC, ts) = SM.both(arrays)
    jy, jf = j_ssm.ssd_chunked(jx, jdt, jA, jB, jC, 32, js)
    ty, tf = t_ssm.ssd_chunked(tx, tdt, tA, tB, tC, 32, ts)
    print(f"ssd_chunked S=100 G=2: y {rel(ty, jy):.2e}, state {rel(tf, jf):.2e}")
    jy, jf = j_ops.ssd(jx, jdt, jA, jB, jC, chunk=32, initial_state=js, interpret=True)
    ty, tf = t_ops.ssd(tx, tdt, tA, tB, tC, 32, ts)
    print(f"ssd plain vs Pallas interpret S=100 G=2: y {rel(ty, jy):.2e}, state {rel(tf, jf):.2e}")
    jcfg, tcfg, jp, tp = SM._block_params()
    x = np.random.default_rng(11).standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    jo, jc = j_ssm.ssm_block(jcfg, jp, jnp.asarray(x), cache={})
    to, tc = t_ssm.ssm_block(tcfg, tp, torch.from_numpy(x), cache={})
    print(f"ssm_block prefill: out {rel(to, jo):.2e}, ssd cache {rel(tc['ssd'], jc['ssd']):.2e}")
    for arch in SV.ARCHS + ["whisper-large-v3"]:
        jm, tm, jp, tp = SV.pair(arch)
        toks = SV.prompt(jm.cfg, 2, 40, seed=40)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
        if jm.cfg.enc_dec:
            aud = np.random.default_rng(40).standard_normal(
                (2, jm.cfg.n_audio_frames, jm.cfg.d_model)).astype(np.float32)
            jb["audio_embed"], tb["audio_embed"] = jnp.asarray(aud), torch.from_numpy(aud)
        jl, jc = jm.prefill(jp, jb)
        tl, tc = tm.prefill(tp, tb)
        jf, tf = jax_flat(jc), torch_flat(tc)
        print(f"{arch} reduced prefill: logits {rel(tl, jl):.2e}, worst cache leaf "
              f"{max(rel(tf[k], jf[k]) for k in jf):.2e}")

    from repro.kernels.flash_attention import ops as j_fa
    from repro_torch.kernels.flash_attention import ops as t_fa

    for causal, window in ((False, None), (True, None), (True, 16)):
        rng = np.random.default_rng(100)
        q, k, v = (rng.standard_normal((2, 100, h, 64)).astype(np.float32) for h in (4, 2, 2))
        want = j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, window=window, interpret=True)
        got = t_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   causal=causal, window=window)
        print(f"flash attention plain vs Pallas interpret S=100 grp 2 causal={causal} "
              f"window={window}: {rel(got, want):.2e}")


def _topk_full_width(k_fraction: float = 0.05, seed: int = 0) -> None:
    """One client's ``--fused-server`` top-k encode at photon-75m's full
    width (74,100,992 entries, one global budget) in both packages, on the
    same delta and residual, compared bit for bit, with where each package's
    budget went, leaf by leaf. Only the codec runs at full width, not the
    model: the delta is drawn with numpy from ``seed`` with a scale per leaf
    (10⁻⁴ to 10⁻², log-uniform), most embedding rows exactly zero (the
    tokens a client's round never saw), and half of every leaf on a grid of
    1/64 of its scale, which makes ties at the threshold. The reference runs
    its plain chain (bitwise its Pallas kernel, ``tests/test_torch_codecs.py``)."""
    import resource
    import time

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_cfg
    from repro.kernels.fedcore import FusedTopKCodec as JFusedTopK
    from repro.models import build_model as j_build
    from repro_torch.kernels.fedcore import FusedTopKCodec as TFusedTopK
    from repro_torch.tree import params_from_numpy

    cfg = j_cfg("photon-75m")
    shapes = jax.eval_shape(j_build(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(shape, key):
        scale = np.float32(10.0 ** rng.uniform(-4, -2))
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        flat = x.reshape(-1)
        half = flat.size // 2
        flat[:half] = np.round(flat[:half] / scale * 64) * (scale / 64)
        if key == "['embed']":  # rows of tokens outside a round's B·S·τ = 4096 draws
            seen = np.zeros(shape[0], bool)
            seen[rng.integers(0, shape[0], 4096)] = True
            x[~seen] = 0.0
        return x

    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    keys = [jax.tree_util.keystr(path) for path, _ in leaves]
    delta = {k: draw(l.shape, k) for k, (_, l) in zip(keys, leaves)}
    resid = {k: 0.5 * draw(l.shape, k) for k, (_, l) in zip(keys, leaves)}
    n = sum(x.size for x in delta.values())
    k = max(1, int(n * k_fraction))
    print(f"photon-75m full width: {n:,} entries in {len(keys)} leaves, "
          f"k = {k:,} ({k_fraction})")

    treedef = jax.tree_util.tree_structure(shapes)
    j_tree = lambda d: jax.tree_util.tree_unflatten(treedef, [jnp.asarray(d[k]) for k in keys])  # noqa: E731
    t0 = time.perf_counter()
    jp, jr = JFusedTopK(k_fraction=k_fraction, use_pallas=False).encode(j_tree(delta),
                                                                        j_tree(resid))
    jp, jr = jax_flat(jp), jax_flat(jr)
    t1 = time.perf_counter()
    tp, tr = TFusedTopK(k_fraction=k_fraction).encode(params_from_numpy(delta, "cpu"),
                                                      params_from_numpy(resid, "cpu"))
    tp, tr = torch_flat(tp), torch_flat(tr)
    t2 = time.perf_counter()
    differ = sum(int(np.count_nonzero(tp[key].view(np.uint32) != jp[key].view(np.uint32))
                     + np.count_nonzero(tr[key].view(np.uint32) != jr[key].view(np.uint32)))
                 for key in keys)
    kept_t = {key: int(np.count_nonzero(tp[key])) for key in keys}
    kept_j = {key: int(np.count_nonzero(jp[key])) for key in keys}
    thresh = min(float(np.abs(v[v != 0]).min()) for v in tp.values() if np.any(v))
    print(f"entries whose bits differ (payload + residual): {differ}; kept "
          f"{sum(kept_t.values()):,} (reference {sum(kept_j.values()):,}), threshold "
          f"{thresh:.9e}; reference {t1 - t0:.1f} s, port {t2 - t1:.1f} s on this host's "
          f"CPU; peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
    for key in keys:
        print(f"  {key}: {delta[key].size:,} entries, kept {kept_t[key]:,} "
              f"({kept_t[key] / delta[key].size:.4%}), reference {kept_j[key]:,}")
    assert differ == 0 and kept_t == kept_j


if __name__ == "__main__":
    import sys

    if "--topk-full-width" in sys.argv[1:]:
        _topk_full_width()
    else:
        _report()
        _report_serving()
