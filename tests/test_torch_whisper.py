"""whisper-large-v3 serving in the port — the audio encoder, learned decoder
positions, cross-attention and its cache, ``generate(audio_embed=)`` — against
the JAX package at the reduced config (2 encoder + 2 decoder layers, 16 audio
frames, 4 query heads on 2 kv heads, d 256), same weights (carried across by
key path), same tokens and same audio frame embeddings (numpy, from a seed).

Tolerances, all at ``compute_dtype="float32"``: encoder output, logits and
cache leaves |Δ| ≤ 1e-5·max|ref| over the tensor — the packages sum f32
products of width up to 512 in other orders, and LayerNorm lifts a small
row's error to the largest row's scale (measured 5.2e-7 on the logits and
≤ 5.9e-7 on the cache leaves at prefill: ``python tests/torch_parity.py``).
Greedy tokens: equal.
"""
import dataclasses
import io
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from torch_parity import jax_flat, torch_flat

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import transformer as j_transformer  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_fa_kernel  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import transformer as t_transformer  # noqa: E402
from repro_torch.tree import flatten_with_paths, params_from_numpy  # noqa: E402
from test_torch_serve import caches_close, close, j_merge, pair, prompt  # noqa: E402

ARCH = "whisper-large-v3"


def audio(cfg, B, seed=0):
    """(B, n_audio_frames, d_model) frame embeddings, float32."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


def batches(toks, aud):
    return ({"tokens": jnp.asarray(toks), "audio_embed": jnp.asarray(aud)},
            {"tokens": torch.from_numpy(toks), "audio_embed": torch.from_numpy(aud)})


def test_whisper_config_is_the_reference_config():
    j, t = j_get_config(ARCH), t_get_config(ARCH)
    for cj, ct in ((j, t), (j.reduced(), t.reduced())):
        assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
        assert cj.param_count() == ct.param_count()
        for kinds in ("layer_kinds", "encoder_layer_kinds"):
            assert [dataclasses.asdict(k) for k in getattr(cj, kinds)()] == \
                [dataclasses.asdict(k) for k in getattr(ct, kinds)()]
    r = t.reduced()
    assert (r.n_layers, r.n_encoder_layers, r.n_audio_frames, r.n_heads, r.n_kv_heads) == \
        (2, 2, 16, 4, 2)


def test_reduced_params_carry_across_by_key_path():
    """The port's own tree has the reference's key paths and shapes leaf for
    leaf — the encoder's stacked segment, ``pos_embed``, each decoder layer's
    ``cross_attn`` (no qk-norm) and ``norm_cross`` — and a carried tree is
    the reference's values."""
    jm, tm, jp, tp = pair(ARCH)
    own = {k: tuple(v.shape) for k, v in flatten_with_paths(tm.init(0, device="cpu"))}
    assert own == {k: v.shape for k, v in jax_flat(jp).items()}
    for key in ("['pos_embed']", "['encoder']['audio_pos']",
                "['encoder']['segments'][0]['pos0']['mixer']['wq']",
                "['encoder']['final_norm']['bias']",
                "['segments'][0]['pos0']['cross_attn']['wk']",
                "['segments'][0]['pos0']['norm_cross']['scale']"):
        assert key in own, key
    assert own["['encoder']['segments'][0]['pos0']['mixer']['wk']"] == (2, 256, 2, 64)
    assert own["['pos_embed']"] == (32_768, 256)
    got, want = torch_flat(tp), jax_flat(jp)
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "use_pallas"])
def test_encode_matches_reference(use_pallas):
    """``_encode`` in both packages; under use_pallas the reference runs its
    Pallas flash kernel in interpret mode and the port the kernel's plain
    version (a CPU tensor)."""
    jm, tm, jp, tp = pair(ARCH)
    aud = audio(jm.cfg, 2, seed=1)
    want = j_transformer._encode(jm.cfg, jp["encoder"], jnp.asarray(aud), use_pallas)
    got = t_transformer._encode(tm.cfg, tp["encoder"], torch.from_numpy(aud), use_pallas)
    assert tuple(got.shape) == want.shape == (2, 16, 256)
    close(got, want, "encoder output")


def test_forward_train_and_loss_match_reference():
    jm, tm, jp, tp = pair(ARCH)
    jb, tb = batches(prompt(jm.cfg, 2, 24, seed=2), audio(jm.cfg, 2, seed=2))
    jl, _, jc = jm.forward(jp, jb)
    tl, _, tc = tm.forward(tp, tb)
    assert jc is None and tc is None
    close(tl, jl, "train logits")
    (jloss, jmet), (tloss, tmet) = jm.loss(jp, jb), tm.loss(tp, tb)
    close(tloss, jloss, "loss")
    close(tmet["accuracy"], jmet["accuracy"], "accuracy")


def test_prefill_matches_reference():
    """Last-position logits, and every cache leaf: the decoder's self-attention
    k/v and the cross-attention k/v of the encoder output, (2, B, 16, 2, 64)."""
    jm, tm, jp, tp = pair(ARCH)
    jb, tb = batches(prompt(jm.cfg, 2, 20, seed=3), audio(jm.cfg, 2, seed=3))
    jl, jc = jm.prefill(jp, jb)
    tl, tc = tm.prefill(tp, tb)
    assert tuple(tl.shape) == jl.shape == (2, 1, jm.cfg.vocab_size)
    close(tl, jl, "last-position logits")
    assert tuple(tc[0]["pos0"]["cross"]["k"].shape) == (2, 2, 16, 2, 64)
    caches_close(tc, jc)


def test_init_cache_matches_reference_layout():
    jm, tm, _, _ = pair(ARCH)
    want = {k: v.shape for k, v in jax_flat(jm.init_cache(2, 30)).items()}
    got = {k: tuple(v.shape) for k, v in flatten_with_paths(tm.init_cache(2, 30, device="cpu"))}
    assert got == want
    assert got["[0]['pos0']['cross']['v']"] == (2, 2, 16, 2, 64)


def test_decode_step_from_a_carried_cache_matches_reference():
    """The reference's prefill cache, grown to max_len (the cross cache keeps
    its shape) and carried across, gives the same next logits and cache: the
    learned position at ``cache_index`` and the cached cross-attention."""
    jm, tm, jp, tp = pair(ARCH)
    B, S0, max_len = 2, 12, 16
    jb, _ = batches(prompt(jm.cfg, B, S0, seed=4), audio(jm.cfg, B, seed=4))
    _, jc = jm.prefill(jp, jb)
    jc = j_merge(jm.init_cache(B, max_len), jc)
    tc = t_serve.merge(tm.init_cache(B, max_len, device="cpu"), params_from_numpy(jax_flat(jc), "cpu"))
    tok = prompt(jm.cfg, B, 1, seed=5)
    jl, jn = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(S0))
    tl, tn = tm.decode_step(tp, tc, torch.from_numpy(tok), S0)
    close(tl, jl, "decode logits")
    caches_close(tn, jn)


def test_generate_matches_reference_token_for_token():
    jm, tm, jp, tp = pair(ARCH)
    toks, aud = prompt(jm.cfg, 2, 20, seed=6), audio(jm.cfg, 2, seed=6)
    j_out = np.asarray(j_serve.generate(jm, jp, jnp.asarray(toks), 8,
                                        audio_embed=jnp.asarray(aud)))
    t_out = t_serve.generate(tm, tp, torch.from_numpy(toks), 8,
                             audio_embed=torch.from_numpy(aud)).numpy()
    assert t_out.dtype == np.int32 and t_out.shape == (2, 28)
    assert np.array_equal(t_out, j_out), (t_out[:, 20:], j_out[:, 20:])


def test_prefill_use_pallas_on_the_cpu_matches_the_plain_path():
    """Under use_pallas the encoder's self-attention takes ``ops.flash_attention``
    (the kernel's plain version on a CPU tensor, no launch); it agrees with the
    plain path and with the reference's use_pallas prefill (Pallas interpret)."""
    jm, tm, jp, tp = pair(ARCH)
    jb, tb = batches(prompt(jm.cfg, 2, 20, seed=7), audio(jm.cfg, 2, seed=7))
    before = t_fa_kernel.flash_attention_fwd.launches
    tl_k, tc_k = tm.prefill(tp, tb, use_pallas=True)
    tl_p, tc_p = tm.prefill(tp, tb)
    assert t_fa_kernel.flash_attention_fwd.launches == before
    close(tl_k, tl_p.numpy(), "use_pallas vs plain logits")
    for (k, a), (_, b) in zip(flatten_with_paths(tc_k), flatten_with_paths(tc_p)):
        close(a, b.numpy(), k)
    jl, jc = jm.prefill(jp, jb, use_pallas=True)
    close(tl_k, jl, "use_pallas vs reference use_pallas")
    caches_close(tc_k, jc)
    out = t_serve.generate(tm, tp, tb["tokens"], 4, audio_embed=tb["audio_embed"],
                           use_pallas=True)
    assert np.array_equal(out.numpy(), t_serve.generate(
        tm, tp, tb["tokens"], 4, audio_embed=tb["audio_embed"]).numpy())


def test_full_width_params_carry_across_by_key_path():
    """whisper-large-v3 at full width, from shapes only (nothing is
    materialized): the reference's key paths and shapes leaf for leaf, 32
    stacked encoder and 32 stacked decoder layers."""
    jm, tm = j_build(j_get_config(ARCH)), t_build(t_get_config(ARCH))
    abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    j_shapes = {jax.tree_util.keystr(p): tuple(l.shape)
                for p, l in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    t_shapes = {k: tuple(v.shape) for k, v in flatten_with_paths(tm.init(0, device="meta"))}
    assert t_shapes == j_shapes
    assert t_shapes["['encoder']['segments'][0]['pos0']['mixer']['wq']"] == (32, 1280, 20, 64)
    assert t_shapes["['segments'][0]['pos0']['cross_attn']['wo']"] == (32, 20, 64, 1280)
    assert t_shapes["['encoder']['audio_pos']"] == (1500, 1280)
    # the leaves hold 1,578,803,200 params; the analytic param_count() says 1,576,544,000
    assert sum(int(np.prod(s)) for s in t_shapes.values()) == 1_578_803_200
    assert tm.cfg.param_count() == jm.cfg.param_count() == 1_576_544_000


def test_whisper_checkpoints_cross_over(tmp_path):
    """Reduced whisper params saved by either package load in the other, leaf
    for leaf (the encoder subtree, ``pos_embed``, the cross-attention)."""
    from repro.checkpoint.checkpoint import load_pytree as j_load, save_pytree as j_save
    from repro_torch.checkpoint import load_pytree as t_load, save_pytree as t_save

    jm, tm, jp, _ = pair(ARCH)
    tp = tm.init(7, device="cpu")  # the port's own draws, not the reference's
    t_save(str(tmp_path / "t.npz"), tp)
    back = jax_flat(j_load(str(tmp_path / "t.npz"), jp))
    assert all(np.array_equal(v, torch_flat(tp)[k]) for k, v in back.items())
    j_save(str(tmp_path / "j.npz"), jp)
    got, want = torch_flat(t_load(str(tmp_path / "j.npz"), tp)), jax_flat(jp)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_serve_cli_runs_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        t_serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4", "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("generated (2, 12) in ")
    assert lines[1].startswith("sample: [") and len(eval(lines[1][len("sample: "):])) == 4
    assert lines[2] == "device: cpu"


def test_serve_clis_hand_generate_the_same_prompt_and_audio(monkeypatch):
    """Both CLIs draw the prompt and then the audio frames from one
    ``RandomState(seed)``, so they serve the same inputs."""
    seen = {}

    def capture(name):
        def fake_generate(model, params, prompt_tokens, max_new, *, audio_embed=None, **_):
            seen[name] = (np.asarray(prompt_tokens), np.asarray(audio_embed, np.float32))
            B, S0 = prompt_tokens.shape
            out = np.zeros((B, S0 + max_new), np.int32)
            return torch.from_numpy(out) if name == "port" else jnp.asarray(out)
        return fake_generate

    argv = ["--arch", ARCH, "--reduced", "--batch", "3", "--prompt-len", "5", "--gen", "2",
            "--seed", "11"]
    monkeypatch.setattr(j_serve, "generate", capture("reference"))
    monkeypatch.setattr(t_serve, "generate", capture("port"))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with redirect_stdout(io.StringIO()):
        j_serve.main()
        t_serve.main(argv + ["--device", "cpu"])
    (jp, ja), (tp, ta) = seen["reference"], seen["port"]
    assert np.array_equal(jp, tp) and jp.shape == (3, 5)
    assert np.array_equal(ja, ta) and ja.shape == (3, 16, 256)
