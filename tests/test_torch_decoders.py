"""The dense RoPE/GQA decoders (granite-3-2b, qwen3-1.7b, gemma3-4b,
deepseek-coder-33b, chameleon-34b) against the JAX package at reduced size,
and the config registry of every architecture.

Every family case runs at ``compute_dtype="float32"`` with the reference's
weights carried across by key path and the same numpy tokens:
``Model.loss`` and its gradient, prefill logits and caches, and four decode
steps, each held to ``torch_parity.FAMILY_TOL`` (|Δ| ≤ 1e-5·max|ref| per
tensor, loss to 1e-5 relative). The train CLI resumes a reference-written
checkpoint of reduced gemma3-4b (default bf16 compute, so the rows agree
loosely: train_loss rel 2e-2, val_ppl rel 5e-2, as in
``test_torch_train.py``); the serve CLI runs every new arch.
"""
import dataclasses
import io
from contextlib import redirect_stdout

import pytest

from torch_parity import (
    check_family_loss_and_grad,
    check_family_prefill_and_decode,
    cli_resume_round_trip,
)

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

DENSE = ["granite-3-2b", "qwen3-1.7b", "gemma3-4b", "deepseek-coder-33b", "chameleon-34b"]
MOE = ["deepseek-moe-16b", "llama4-scout-17b-a16e", "jamba-v0.1-52b"]
ALL = sorted(j_configs.list_configs())


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def test_every_reference_arch_is_registered_in_the_port():
    assert t_configs.list_configs() == ALL
    assert t_configs.ASSIGNED_ARCHS == j_configs.ASSIGNED_ARCHS
    assert set(t_configs.ASSIGNED_ARCHS) <= set(ALL)


def test_input_shapes_equal_the_references():
    assert {k: dataclasses.asdict(v) for k, v in t_configs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_configs.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_new_config_is_the_references_field_for_field(arch):
    t, j = t_configs.get_config(arch), j_configs.get_config(arch)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert [dataclasses.asdict(k) for k in t.layer_kinds()] == \
        [dataclasses.asdict(k) for k in j.layer_kinds()]


@pytest.mark.parametrize("arch", ALL)
def test_shapes_and_param_counts_equal_the_references(arch):
    t, j = t_configs.get_config(arch), j_configs.get_config(arch)
    for shape in j_configs.INPUT_SHAPES:
        assert t.supports_shape(shape) == j.supports_shape(shape), shape
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_get_config_refuses_an_unknown_arch_as_the_reference_does():
    with pytest.raises(KeyError, match="unknown arch 'nope'"):
        t_configs.get_config("nope")
    with pytest.raises(KeyError, match="unknown arch 'nope'"):
        j_configs.get_config("nope")


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_full_width_params_carry_across_by_key_path(arch):
    """At published widths the port's tree has the reference's key paths and
    shapes leaf for leaf (shapes only, nothing is materialized)."""
    jm = j_build(j_configs.get_config(arch))
    tm = t_build(t_configs.get_config(arch))
    abstract = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    j_shapes = {jax.tree_util.keystr(p): tuple(leaf.shape)
                for p, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    t_shapes = {k: tuple(v.shape) for k, v in flatten_with_paths(tm.init(0, device="meta"))}
    assert t_shapes == j_shapes


# ---------------------------------------------------------------------------
# The dense decoders against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradient_match_reference(arch):
    metrics = check_family_loss_and_grad(arch)
    assert "moe_aux" not in metrics


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_four_decode_steps_match_reference(arch):
    check_family_prefill_and_decode(arch)


def test_gemma3_windowed_layers_through_the_chunked_path_match_reference():
    """S ≥ 512 takes both packages' chunked attention; reduced gemma3's local
    layers (window 32) mask inside each 64-query chunk."""
    check_family_prefill_and_decode("gemma3-4b", B=1, S=576, n_decode=2, seed=3)


def test_dense_prefill_under_use_pallas_launches_nothing_and_matches_reference():
    """A decoder layer's window is a 0-d tensor in both packages, so
    ``use_pallas`` leaves self-attention on ``sdpa``: the same numbers as the
    reference's ``use_pallas`` prefill, and no kernel wrapper is called."""
    from repro_torch.kernels.flash_attention import kernel as FK

    before = FK.flash_attention_fwd.launches
    check_family_prefill_and_decode("gemma3-4b", n_decode=1, use_pallas=True)
    assert FK.flash_attention_fwd.launches == before


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------


def test_train_cli_resumes_a_reference_gemma3_checkpoint(tmp_path):
    cli_resume_round_trip("gemma3-4b", tmp_path)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_serve_cli_runs_every_new_arch_on_the_cpu(arch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        t_serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4", "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("generated (2, 12) in ")
    assert lines[1].startswith("sample: [") and len(eval(lines[1][len("sample: "):])) == 4
    assert lines[2] == "device: cpu"


def test_chip_smoke_kernel_cases_come_from_the_configs():
    """``chip_smoke.py``'s flash_decode and rmsnorm cases read their shapes
    from the configs and input shapes, and they are the shapes the kernels
    were measured at before they were derived; jamba's SSD case is its
    config's layer at the serve_families prefill."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert chip_smoke.decode_cases() == [
        ("qwen3-1.7b decode_32k", 128, 16, 8, 32768, 128, None),
        ("gemma3-4b long_500k global", 1, 8, 4, 524288, 256, None),
        ("gemma3-4b long_500k local", 1, 8, 4, 524288, 256, 1024),
    ]
    assert chip_smoke.rms_cases() == [
        ("qwen3-1.7b prefill_32k", 32 * 32768, 2048),
        ("mamba2-1.3b serve prefill", 4 * 2048, 2048),
    ]
    assert chip_smoke.jamba_ssd_shape() == dict(B=2, S=2048, nh=128, hd=64, G=1, ds=16, chunk=64)
    for arch, layers in chip_smoke.FAMILY_DEPTHS:
        cfg = chip_smoke.family_config(arch, layers)
        assert 4 * cfg.param_count() <= chip_smoke.FAMILY_WEIGHT_BYTES, arch
        assert (layers is None) == (cfg.n_layers == t_configs.get_config(arch).n_layers)
    jamba = chip_smoke.family_config("jamba-v0.1-52b", 6)
    assert sum(k.mixer == "ssm" for k in jamba.layer_kinds()) == chip_smoke.JAMBA_SSM_LAYERS
    assert {(k.mixer, k.ffn) for k in jamba.layer_kinds()} == \
        {("ssm", "dense"), ("ssm", "moe"), ("attn", "dense")}


# ---------------------------------------------------------------------------
# Entry points run on the card unless asked for the CPU
# ---------------------------------------------------------------------------


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    """``Model.init``, ``ClientWorker``, ``SocketBackend``,
    ``empty_cache_desc``, ``Model.init_cache``, ``transformer.init_cache``,
    ``ssm.empty_ssm_cache`` and ``common.init_params`` called without
    ``device`` ask for the card; where torch sees none, each raises instead
    of falling back to the CPU. With ``device="cpu"`` each runs here."""
    from repro_torch.core.federated import FederatedConfig
    from repro_torch.core.sampler import ParticipationConfig
    from repro_torch.models import ssm, transformer
    from repro_torch.models.attention import empty_cache_desc
    from repro_torch.models.common import init_params
    from repro_torch.runtime import ClientWorker, SocketBackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = t_build(t_configs.get_config("qwen3-1.7b").reduced())
    fed, pcfg = FederatedConfig(), ParticipationConfig(population=4, clients_per_round=2)
    calls = {
        "Model.init": lambda **kw: model.init(0, **kw),
        "ClientWorker": lambda **kw: ClientWorker(lambda p, b: None, fed, pcfg,
                                                  make_batches=lambda cid: None, **kw),
        "SocketBackend": lambda **kw: SocketBackend(port=0, **kw),
        "empty_cache_desc": lambda **kw: empty_cache_desc(model.cfg, 1, 4, torch.float32, **kw),
        "Model.init_cache": lambda **kw: model.init_cache(1, 4, **kw),
        "transformer.init_cache": lambda **kw: transformer.init_cache(model.cfg, 1, 4, **kw),
        "ssm.empty_ssm_cache": lambda **kw: ssm.empty_ssm_cache(
            t_configs.get_config("mamba2-1.3b").reduced(), 1, **kw),
        "common.init_params": lambda **kw: init_params(0, model.desc(), **kw),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        made = call(device="cpu")
        assert made is not None, name
        if name == "SocketBackend":
            made.close()
