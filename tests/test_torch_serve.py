"""The port's serving path — ``Model.forward/prefill/decode_step``, the caches
and ``launch/serve.generate`` — against the JAX package at reduced
mamba2-1.3b and photon-75m (whisper-large-v3: ``test_torch_whisper.py``),
same weights (carried across by key path) and same tokens.

Tolerances, all at ``compute_dtype="float32"``: logits and cache leaves
|Δ| ≤ 1e-5·max|ref| over the tensor — each layer passes f32 products of width
up to 1088 that the two packages sum in other orders (~6e-7 relative each),
and per-row norms lift a small row's error to the largest row's scale
(measured ≤ 8.6e-7 at prefill: ``python tests/torch_parity.py``). Greedy
tokens: equal.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from torch_parity import assert_close, j_merge, jax_flat, torch_flat
from torch_parity import family_pair as pair, family_tokens as prompt

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as t_ssd_kernel  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import attention as t_attention  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.tree import flatten_with_paths, params_from_numpy  # noqa: E402

ARCHS = ["mamba2-1.3b", "photon-75m"]
TOL = 1e-5


def close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert_close(got, want, atol=TOL * (float(np.abs(want).max()) or 1.0), what=what)


def caches_close(t_cache, j_cache):
    got, want = torch_flat(t_cache), jax_flat(j_cache)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], what=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    jm, tm, jp, tp = pair(arch)
    toks = prompt(jm.cfg, 2, 40)  # 40: a ragged tail for mamba2's 16-chunks
    jl, jaux, jc = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, taux, tc = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert jc is None and tc is None and float(taux) == float(jaux) == 0.0
    close(tl, jl, "train logits")
    (jloss, jmet), (tloss, tmet) = jm.loss(jp, {"tokens": jnp.asarray(toks)}), \
        tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    assert_close(float(tloss), float(jloss), rtol=1e-5, what="loss")
    assert_close(float(tmet["accuracy"]), float(jmet["accuracy"]), atol=1e-6, what="accuracy")


@pytest.mark.parametrize("arch,S", [("mamba2-1.3b", 40), ("photon-75m", 40),
                                    ("photon-75m", 512)],
                         ids=["mamba2", "photon", "photon-chunked"])
def test_prefill_matches_reference(arch, S):
    jm, tm, jp, tp = pair(arch)
    toks = prompt(jm.cfg, 2 if S < 512 else 1, S, seed=S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(tl.shape) == jl.shape == (toks.shape[0], 1, jm.cfg.vocab_size)
    close(tl, jl, "last-position logits")
    caches_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_from_a_carried_cache_matches_reference(arch):
    """The reference's prefill cache, grown to max_len and carried across,
    gives the same next logits and cache in both packages."""
    jm, tm, jp, tp = pair(arch)
    toks = prompt(jm.cfg, 2, 24, seed=3)
    B, S0, max_len = 2, 24, 30
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    jc = j_merge(jm.init_cache(B, max_len), jc)
    # bf16 leaves cross as f32 (exactly); the port's merge casts them back
    tc = t_serve.merge(tm.init_cache(B, max_len, device="cpu"), params_from_numpy(jax_flat(jc), "cpu"))
    assert [t.dtype for _, t in flatten_with_paths(tc)] == \
        [t.dtype for _, t in flatten_with_paths(tm.init_cache(B, max_len, device="cpu"))]
    tok = prompt(jm.cfg, B, 1, seed=4)
    jl, jn = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(S0))
    tl, tn = tm.decode_step(tp, tc, torch.from_numpy(tok), S0)
    close(tl, jl, "decode logits")
    caches_close(tn, jn)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_token_for_token(arch):
    jm, tm, jp, tp = pair(arch)
    toks = prompt(jm.cfg, 2, 20, seed=5)
    j_out = np.asarray(j_serve.generate(jm, jp, jnp.asarray(toks), 8))
    t_out = t_serve.generate(tm, tp, torch.from_numpy(toks), 8).numpy()
    assert t_out.dtype == np.int32 and t_out.shape == (2, 28)
    assert np.array_equal(t_out, j_out), (t_out[:, 20:], j_out[:, 20:])


def test_prefill_use_pallas_on_the_cpu_matches_the_plain_path():
    """Under use_pallas the SSM layers take ``ops.ssd`` (the kernel's plain
    version on the CPU, no launch); it agrees with ``ssd_chunked`` and with the
    reference's Pallas prefill in interpret mode."""
    jm, tm, jp, tp = pair("mamba2-1.3b")
    toks = prompt(jm.cfg, 2, 40, seed=6)
    before = t_ssd_kernel.ssd_scan_fwd.launches
    tl_k, tc_k = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, use_pallas=True)
    tl_p, tc_p = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert t_ssd_kernel.ssd_scan_fwd.launches == before
    close(tl_k, tl_p.numpy(), "use_pallas vs plain logits")
    for (k, a), (_, b) in zip(flatten_with_paths(tc_k), flatten_with_paths(tc_p)):
        close(a, b.numpy(), k)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, use_pallas=True)
    close(tl_k, jl, "use_pallas vs reference use_pallas")
    caches_close(tc_k, jc)
    out = t_serve.generate(tm, tp, torch.from_numpy(toks), 4, use_pallas=True)
    assert np.array_equal(out.numpy(), t_serve.generate(tm, tp, torch.from_numpy(toks), 4).numpy())


def test_use_pallas_raises_only_where_the_reference_takes_flash_attention(monkeypatch):
    """Where each package calls flash attention under ``use_pallas`` (the
    port's kernel is ported, so nothing raises any more; the name is kept).
    The reference sends self-attention without ALiBi to its Pallas flash
    kernel when the window is None or an int, and so does the port: a direct
    ``attention(window=None)`` call reaches each package's ``flash_attention``
    once, with the same output. Through a decoder a layer's window is an entry
    of the window array (a jnp scalar in the reference, a 0-d tensor in the
    port), so a rope photon prefill calls it in neither package. Whisper's
    encoder calls ``attention`` with no window: the port calls the kernel once
    per encoder layer (2), the reference once for its scanned body."""
    import repro.kernels.flash_attention.ops as j_fa
    import repro_torch.kernels.flash_attention.ops as t_fa
    from repro.models import attention as j_attention

    calls = {"reference": 0, "port": 0}

    def counted(name, real):
        def fn(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return fn

    monkeypatch.setattr(j_fa, "flash_attention", counted("reference", j_fa.flash_attention))
    monkeypatch.setattr(t_fa, "flash_attention", counted("port", t_fa.flash_attention))
    jm, tm, jp, tp = pair("photon-75m", pos_embedding="rope")
    layer = lambda p: p["segments"][0]["pos0"]["mixer"]  # noqa: E731
    x = np.random.default_rng(7).standard_normal((1, 16, jm.cfg.d_model)).astype(np.float32)
    j_layer = jax.tree_util.tree_map(lambda a: a[0], layer(jp))
    jy, _ = j_attention.attention(jm.cfg, j_layer, jnp.asarray(x), positions=jnp.arange(16),
                                  window=None, use_pallas=True)
    t_layer = {k: v[0] for k, v in layer(tp).items()}
    ty, _ = t_attention.attention(tm.cfg, t_layer, torch.from_numpy(x),
                                  positions=torch.arange(16), window=None, use_pallas=True)
    assert calls == {"reference": 1, "port": 1}
    close(ty, jy, "direct flash attention call")

    calls.update(reference=0, port=0)
    toks = prompt(jm.cfg, 1, 16, seed=8)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, use_pallas=True)
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, use_pallas=True)
    assert calls == {"reference": 0, "port": 0}
    close(tl, jl, "rope prefill under use_pallas")

    jm, tm, jp, tp = pair("whisper-large-v3")
    toks = prompt(jm.cfg, 1, 16, seed=9)
    aud = np.random.default_rng(9).standard_normal(
        (1, jm.cfg.n_audio_frames, jm.cfg.d_model)).astype(np.float32)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks), "audio_embed": jnp.asarray(aud)},
                       use_pallas=True)
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                            "audio_embed": torch.from_numpy(aud)}, use_pallas=True)
    assert calls == {"reference": 1, "port": tm.cfg.n_encoder_layers} and \
        tm.cfg.n_encoder_layers == 2
    close(tl, jl, "whisper prefill under use_pallas")


@pytest.mark.parametrize("arch,calls", [("qwen3-1.7b", 0), ("gemma3-4b", 0), ("photon-75m", 0),
                                        ("mamba2-1.3b", 0), ("whisper-large-v3", 1)])
def test_reference_prefill_reaches_flash_attention_only_through_whisper(arch, calls,
                                                                        monkeypatch):
    """Where the reference's ``use_pallas`` prefill calls its flash kernel:
    decoder layers get their window from the window array and take ``sdpa``;
    only whisper's encoder calls ``attention`` with no window. This decides
    which slice ports ``flash_attention_fwd`` (ROADMAP.md queue A)."""
    import repro.kernels.flash_attention.ops as j_fa

    seen = []
    real = j_fa.flash_attention
    monkeypatch.setattr(j_fa, "flash_attention",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    cfg = j_get_config(arch).reduced()
    jm = j_build(cfg)
    batch = {"tokens": jnp.asarray(prompt(cfg, 1, 16))}
    if cfg.enc_dec:
        batch["audio_embed"] = jnp.zeros((1, cfg.n_audio_frames, cfg.d_model))
    jm.prefill(jm.init(jax.random.PRNGKey(0)), batch, use_pallas=True)
    assert len(seen) == calls


def test_mamba2_full_width_params_carry_across_by_key_path():
    """mamba2-1.3b at full width: one segment of 48 stacked SSM layers whose
    key paths and shapes are the reference's, leaf for leaf (shapes only,
    nothing is materialized)."""
    jm = j_build(j_get_config("mamba2-1.3b"))
    tm = t_build(t_get_config("mamba2-1.3b"))
    abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    j_shapes = {jax.tree_util.keystr(p): tuple(l.shape)
                for p, l in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    t_shapes = {k: tuple(v.shape) for k, v in flatten_with_paths(tm.init(0, device="meta"))}
    assert t_shapes == j_shapes
    assert t_shapes["['segments'][0]['pos0']['mixer']['in_proj']"] == (48, 2048, 8512)
    # the leaves hold 1,344,052,224 params; the analytic param_count() says 1,343,630,336
    assert sum(int(np.prod(s)) for s in t_shapes.values()) == 1_344_052_224


def test_mamba2_checkpoints_cross_over(tmp_path):
    """Reduced mamba2-1.3b params saved by either package load in the other,
    leaf for leaf (the stacked SSM segment and the ssm_a/ssm_dt leaves)."""
    from repro.checkpoint.checkpoint import load_pytree as j_load, save_pytree as j_save
    from repro_torch.checkpoint import load_pytree as t_load, save_pytree as t_save

    jm, tm, jp, _ = pair("mamba2-1.3b")
    tp = tm.init(7, device="cpu")  # the port's own draws, not the reference's
    t_save(str(tmp_path / "t.npz"), tp)
    back = j_load(str(tmp_path / "t.npz"), jp)
    for k, v in jax_flat(back).items():
        assert np.array_equal(v, torch_flat(tp)[k]), k
    j_save(str(tmp_path / "j.npz"), jp)
    got, want = torch_flat(t_load(str(tmp_path / "j.npz"), tp)), jax_flat(jp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("helper", ["tree_flatten", "tree_map", "tree_stack",
                                    "flatten_with_paths", "int8_payload_leaves"])
def test_tree_walks_release_their_leaves_without_the_garbage_collector(helper):
    """A tree walk leaves no reference cycle behind: once its result is
    dropped, the leaves it saw are freed at once, not when the cyclic garbage
    collector next runs (on the card that held a prefill's per-layer caches,
    1.1 GB at full-width whisper, past the end of the call)."""
    import gc
    import weakref

    from repro_torch import tree as T
    from repro_torch.core.compression import int8_payload_leaves

    calls = {
        "tree_flatten": lambda t: T.tree_flatten({"a": [t, 1]}),
        "tree_map": lambda t: T.tree_map(lambda x: x, {"a": [t]}),
        "tree_stack": lambda t: T.tree_stack([{"a": t}, {"a": t}]),
        "flatten_with_paths": lambda t: T.flatten_with_paths({"a": [t]}),
        "int8_payload_leaves": lambda t: int8_payload_leaves({"a": {"q": t, "scale": t}}),
    }
    gc.disable()
    try:
        t = torch.ones(3)
        ref = weakref.ref(t)
        out = calls[helper](t)
        del out, t
        assert ref() is None
    finally:
        gc.enable()


def test_prefill_releases_per_layer_caches_without_the_garbage_collector(monkeypatch):
    """After a prefill only the stacked cache holds the per-layer k/v it was
    built from: nothing waits for the garbage collector."""
    import gc
    import weakref

    jm, tm, _, tp = pair("whisper-large-v3")
    refs = []
    real = t_attention.attention

    def spy(*a, **k):
        y, c = real(*a, **k)
        if c:
            refs.extend([weakref.ref(c["k"]), weakref.ref(c["v"])])
        return y, c

    monkeypatch.setattr(t_attention, "attention", spy)
    toks = prompt(jm.cfg, 1, 12, seed=10)
    aud = np.zeros((1, jm.cfg.n_audio_frames, jm.cfg.d_model), np.float32)
    gc.disable()
    try:
        _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                   "audio_embed": torch.from_numpy(aud)})
        assert len(refs) == 2 * 2 * jm.cfg.n_layers  # self and cross k/v per layer
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        t_serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4", "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("generated (2, 12) in ")
    assert lines[1].startswith("sample: [") and len(eval(lines[1][len("sample: "):])) == 4
    assert lines[2] == "device: cpu"


def test_serve_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--arch", "mamba2-1.3b", "--reduced"])
