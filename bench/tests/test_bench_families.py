"""The reference side found by family: every number the benchmark reads is
what the configuration's own file of pinned readings holds
(``readings/<config>.json``, from ``readings.py``), a family of another
architecture and a configuration of a new family join as new files alone,
and the program's configuration is held to every field that its config class
holds to a configuration file."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Tuple

import pytest

import readings
from conftest import BENCH, CELLS, CONFIGS, ROOT, SPEC
from harness import spec
from harness.program import build
from reference import layout


def _config(name):
    return spec.load_json(ROOT / next(c["file"] for c in SPEC["configs"] if c["name"] == name))


@pytest.mark.parametrize("name", CONFIGS)
def test_the_yardstick_reads_what_it_read_before_the_families_moved(name):
    want = {k: v for k, v in readings.load(name).items() if k != "tiny"}
    got = readings.yardstick(name)
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("name", CONFIGS)
def test_the_tiny_cells_reference_reads_the_same_bits(name):
    want = readings.load(name)["tiny"]
    got = readings.reference(name, want["seed"])
    for key in readings.REFERENCE_KEYS:
        assert got[key] == want[key], key


def test_a_configuration_without_pinned_readings_names_the_file_and_its_writer(monkeypatch,
                                                                              tmp_path):
    monkeypatch.setattr(readings, "DIR", tmp_path)
    with pytest.raises(FileNotFoundError) as err:
        readings.load(CONFIGS[0])
    assert str(tmp_path / f"{CONFIGS[0]}.json") in str(err.value)
    assert f"python3 bench/tests/readings.py --config {CONFIGS[0]}" in str(err.value)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("field, value", [("n_experts", 8), ("hybrid_pattern", "MA"),
                                          ("head_dim", 64)])
def test_a_configuration_file_unlike_the_program_is_refused_by_field(name, field, value):
    cell = spec.load_cell(CELLS[name])
    shapes = {leaf.name: leaf.shape for leaf in layout.leaves(cell.config)}
    build(cell.config, cell.traffic["seq_len"], shapes)  # the file as committed passes
    with pytest.raises(SystemExit, match=field):
        build(dict(cell.config, **{field: value}), cell.traffic["seq_len"], shapes)


#: two fields that only a program's own config class has, as the file states them
EXTRA = {"expert_share": [8, 64], "rope_scaling": {"type": "yarn", "factor": 40.0}}


@pytest.fixture
def own_class(monkeypatch):
    """The program's registry patched to return its configs as a subclass of
    ModelConfig with :data:`EXTRA`'s fields (a tuple and a dict)."""
    import repro_torch.configs as configs
    from repro_torch.configs.base import ModelConfig

    @dataclasses.dataclass(frozen=True)
    class Extended(ModelConfig):
        expert_share: Tuple[int, ...] = (8, 64)
        rope_scaling: dict = dataclasses.field(
            default_factory=lambda: {"type": "yarn", "factor": 40.0})

    plain = configs.get_config
    monkeypatch.setattr(configs, "get_config",
                        lambda name: Extended(**dataclasses.asdict(plain(name))))
    return Extended


@pytest.mark.parametrize("field, value", [("expert_share", [8, 32]),
                                          ("rope_scaling", {"type": "yarn", "factor": 4.0})])
def test_a_field_that_only_the_programs_config_class_has_is_held_to_the_file(own_class, field,
                                                                             value):
    cell = spec.load_cell(CELLS[CONFIGS[0]])
    shapes = {leaf.name: leaf.shape for leaf in layout.leaves(cell.config)}
    seq_len = cell.traffic["seq_len"]
    build(dict(cell.config, **EXTRA), seq_len, shapes)  # equal in JSON form: passes
    with pytest.raises(SystemExit, match=field):
        build(dict(cell.config, **dict(EXTRA, **{field: value})), seq_len, shapes)
    with pytest.raises(SystemExit, match=f"does not state.*{field}"):
        build(dict(cell.config, **{k: v for k, v in EXTRA.items() if k != field}), seq_len,
              shapes)


def test_the_tiny_cell_cuts_a_field_of_the_programs_own_class(own_class, tiny_cell, monkeypatch):
    import repro_torch.configs as configs

    name = CONFIGS[0]
    family = layout.family(_config(name))
    monkeypatch.setattr(family, "TINY", dict(
        family.TINY, config=dict(family.TINY["config"], expert_share=[2, 8])))
    load = spec.load_cell
    monkeypatch.setattr(spec, "load_cell", lambda cell: dataclasses.replace(
        load(cell), config=dict(load(cell).config, **EXTRA)))
    cell = tiny_cell(name)
    port = configs.get_config(cell.config["arch"])
    assert type(port) is own_class and port.expert_share == (2, 8)
    assert port.rope_scaling == EXTRA["rope_scaling"]
    assert port.d_model == family.TINY["config"]["d_model"]
    shapes = {leaf.name: leaf.shape for leaf in layout.leaves(cell.config)}
    build(cell.config, cell.traffic["seq_len"], shapes)


#: a hybrid family as a later change would add it: Mamba-2 and attention
#: layers in ``hybrid_pattern``, a routed FFN on every ``moe_every``-th layer,
#: an untied head; a layout with no reference model
HYBRID = '''"""A Mamba-2/attention hybrid with routed FFNs and an untied head."""
import torch

from reference.flops import causal_attention_flops_per_token
from reference.layout import Leaf, layer_groups, n_params, padded_vocab

TINY = {"config": {}, "traffic": {"seq_len": 64, "batch": 1}, "workload": {"grad_accum": 1}}
INITS = {"uniform": lambda shape, scale, gen, device: torch.rand(
    shape, generator=gen, device=device).mul_(2.0).sub_(1.0).mul_(scale)}


def kinds(cfg):
    pattern = cfg["hybrid_pattern"]
    return [(pattern[i % len(pattern)], i % cfg["moe_every"] == cfg["moe_offset"])
            for i in range(cfg["n_layers"])]


def layer(cfg, mixer, routed):
    d, std = cfg["d_model"], cfg["init_std"]
    out = [("norm1.scale", (d,), "ones", 0.0), ("norm2.scale", (d,), "ones", 0.0)]
    if mixer == "A":
        h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
        out += [("mixer.wq", (d, h, hd), "normal", std), ("mixer.wk", (d, kv, hd), "normal", std),
                ("mixer.wv", (d, kv, hd), "normal", std), ("mixer.wo", (h, hd, d), "normal", std)]
    else:
        di, g, ds = cfg["ssm_expand"] * d, cfg["ssm_n_groups"], cfg["ssm_state"]
        nh, conv = di // cfg["ssm_head_dim"], di + 2 * g * ds
        out += [("mixer.in_proj", (d, 2 * di + 2 * g * ds + nh), "normal", std),
                ("mixer.conv_w", (cfg["ssm_conv_width"], conv), "normal", 0.2),
                ("mixer.conv_b", (conv,), "zeros", 0.0), ("mixer.A_log", (nh,), "ssm_a", 0.0),
                ("mixer.dt_bias", (nh,), "ssm_dt", 0.0), ("mixer.D_skip", (nh,), "ones", 0.0),
                ("mixer.norm_scale", (di,), "ones", 0.0),
                ("mixer.out_proj", (di, d), "normal", std)]
    e, ff = (cfg["n_experts"], cfg["moe_d_ff"]) if routed else (None, cfg["d_ff"])
    lead = (e,) if routed else ()
    out += [("ffn.w_in", lead + (d, ff), "normal", std),
            ("ffn.w_gate", lead + (d, ff), "normal", std),
            ("ffn.w_out", lead + (ff, d), "normal", std)]
    return out + ([("ffn.router", (d, e), "uniform", std)] if routed else [])


def leaves(cfg):
    d, v, std = cfg["d_model"], padded_vocab(cfg), cfg["init_std"]
    out = [Leaf("embed", (v, d), "normal", std, vocab_axis=0),
           Leaf("lm_head", (d, v), "normal", std, vocab_axis=1),
           Leaf("final_norm.scale", (d,), "ones", 0.0)]
    ks = kinds(cfg)
    for prefix, layers in layer_groups(ks):
        n = len(layers)
        for name, shape, init, scale in layer(cfg, *ks[layers[0]]):
            out.append(Leaf(prefix + name, (n,) * (n > 1) + shape, init, scale, stacked=n > 1))
    return out


def flops_per_token(cfg, seq_len):
    ks = kinds(cfg)
    idle = (sum(routed for _, routed in ks) * (cfg["n_experts"] - cfg["moe_top_k"])
            * 3 * cfg["d_model"] * cfg["moe_d_ff"])
    attention = causal_attention_flops_per_token(
        sum(m == "A" for m, _ in ks), seq_len, cfg["n_heads"] * cfg["head_dim"])
    return 6 * (n_params(cfg) - idle) + attention


def loss(cfg, w, tokens, mm):
    raise NotImplementedError("a layout with no reference model")
'''

#: the program's jamba-v0.1-52b at ``reduced()`` widths and 13 layers: one
#: layer of its own at segments.0, then stacks of 6 at segments.1.pos0 and pos1
HYBRID_CONFIG = dict(
    name="hybrid-tiny", arch="jamba-v0.1-52b", family="hybrid_test",
    source="arXiv:2403.19887", n_layers=13, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=500, n_experts=4, moe_top_k=2, moe_every=2, moe_offset=1,
    moe_d_ff=128, hybrid_pattern="MA", ssm_state=32, ssm_head_dim=32, ssm_expand=2,
    ssm_conv_width=4, ssm_n_groups=1, pos_embedding="none", tie_embeddings=False,
    norm="rmsnorm", activation="silu", norm_eps=1e-6, init_std=0.02, vocab_pad_multiple=256)

CHECK = '''
import dataclasses, json
import torch
import repro_torch.configs as configs
from harness import spec
from harness.program import build
from reference import federated, flops, layout
from reference.model import mm_fp32

port = dataclasses.replace(configs.get_config("jamba-v0.1-52b").reduced(), n_layers=13,
                           vocab_size=500)
configs.get_config = lambda name: port
cell = spec.load_cell("hybrid-tiny.train_int8")
cfg = cell.config
params = layout.make_params(cfg, 2**31 + 9, "cpu")
build(cfg, cell.traffic["seq_len"], {n: tuple(t.shape) for n, t in params.items()})
family = layout.family(cfg)
per_layer = {}


def squares(cfg, w, tokens, mm):  # a stand-in loss: the sum of every weight squared
    per_layer.update({n: len(v) for n, v in w.items() if isinstance(v, list)})
    s = sum((x * x).sum() for v in w.values() for x in (v if isinstance(v, list) else [v]))
    return s, s


family.loss = squares
grads = {n: torch.zeros_like(t) for n, t in params.items()}
federated.value_and_grad(cfg, params, torch.zeros(1, 8, dtype=torch.long), mm_fp32, grads)
router = params["segments.1.pos0.ffn.router"]
print(json.dumps({
    "family": family.__file__, "tiny": family.TINY, "stacked": sorted(layout.stacked(cfg)),
    "per_layer": per_layer, "grads": all(torch.equal(grads[n], 2 * t) for n, t in params.items()),
    "padded": layout.n_params(cfg, padded=True), "n_params": layout.n_params(cfg),
    "numel": sum(t.numel() for t in params.values()), "flops": flops.train_flops(cfg, 1000, 64),
    "per_token": family.flops_per_token(cfg, 64),
    "finite": all(bool(t.isfinite().all()) for t in params.values()),
    "router": [float(router.abs().max()), float(router.abs().min())]}))
'''


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_family_joins_as_files_and_entries_only(tmp_path):
    copy = tmp_path / "bench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(copy)
    (copy / "reference" / "families" / "hybrid_test.py").write_text(HYBRID)
    (copy / "configs" / "hybrid-tiny.json").write_text(json.dumps(HYBRID_CONFIG))
    (copy / "workloads" / "hybrid-tiny.train_int8.json").write_text(json.dumps(
        dict(spec.load_json(BENCH / "workloads" / "mamba2-1.3b.train_int8.json"), remat=False)))
    new = json.loads(json.dumps(SPEC))
    new["configs"].append({"name": "hybrid-tiny", "source": "https://arxiv.org/abs/2403.19887",
                           "file": "bench/configs/hybrid-tiny.json", "reduced": ["n_layers"],
                           "why": "hybrid stacks at two positions, routed FFNs, an untied head"})
    new["workloads"].append({"name": "hybrid-tiny.train_int8", "config": "hybrid-tiny",
                             "traffic": "train_int8", "chips": 1, "why": "a hybrid family"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    after = _files(copy)
    assert {n: b for n, b in after.items() if n in before} == before
    assert sorted(set(after) - set(before)) == [
        "configs/hybrid-tiny.json", "reference/families/hybrid_test.py",
        "workloads/hybrid-tiny.train_int8.json"]

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(copy), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", CHECK], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.splitlines()[-1])
    assert Path(got["family"]) == (copy / "reference" / "families" / "hybrid_test.py").resolve()
    assert got["tiny"]["traffic"] == {"seq_len": 64, "batch": 1}
    # every leaf of the two stacks, and no other, is one autograd leaf per layer
    assert got["stacked"] and all(n.startswith(("segments.1.pos0.", "segments.1.pos1."))
                                  for n in got["stacked"])
    assert got["per_layer"] == {n: 6 for n in got["stacked"]} and got["grads"]
    assert got["padded"] == got["numel"]
    # 12 padding rows of 256 in the embedding and in the untied head
    assert got["n_params"] == got["numel"] - 2 * 12 * 256
    # 6 routed layers use 2 of their 4 experts; 6 attention layers of 4 x 64
    idle = 6 * 2 * 3 * 256 * 128
    assert got["per_token"] == 6 * (got["n_params"] - idle) + 6 * 6 * 64 * 256
    assert got["flops"] == 1000 * got["per_token"]
    assert got["finite"] and 0.0 < got["router"][1] and got["router"][0] <= 0.02


def test_a_configuration_of_a_new_family_passes_every_test_over_configs_in_a_copy(tmp_path):
    """A twin of photon under a new family and name, added to a copy as new
    files (its family module, configuration, workload and the readings its
    writer wrote) and entries, passes the copy's own tests of every
    configuration, and no file that was there changes."""
    copy, name = tmp_path / "bench", "photon-twin"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(copy)
    shutil.copy(BENCH / "reference" / "families" / "photon.py",
                copy / "reference" / "families" / "photon_twin.py")
    (copy / "configs" / f"{name}.json").write_text(json.dumps(
        dict(_config("photon-1.3b"), name=name, family="photon_twin")))
    shutil.copy(BENCH / "workloads" / "photon-1.3b.train_s2048.json",
                copy / "workloads" / f"{name}.train_s2048.json")
    new = json.loads(json.dumps(SPEC))
    new["configs"].append({"name": name, "source": "https://arxiv.org/abs/2405.10853",
                           "file": f"bench/configs/{name}.json", "reduced": [],
                           "why": "photon-1.3b under a family of its own"})
    new["workloads"].append({"name": f"{name}.train_s2048", "config": name,
                             "traffic": "train_s2048", "chips": 1, "why": "a new family"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    write = subprocess.run([sys.executable, str(copy / "tests" / "readings.py"), "--config", name],
                           capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert write.returncode == 0, write.stderr[-4000:]
    # the same model under another family reads what photon-1.3b reads
    assert spec.load_json(copy / "tests" / "readings" / f"{name}.json") == readings.load(
        "photon-1.3b")
    tests = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                            "-k", name, str(copy / "tests")],
                           capture_output=True, text=True, env=env, cwd=tmp_path, timeout=900)
    summary = tests.stdout.strip().splitlines()[-1]
    assert tests.returncode == 0, tests.stdout[-4000:]
    # per configuration: 5 of this file, 7 of test_bench_harness.py
    assert int(summary.split(" passed")[0].split()[-1]) >= 12, summary
    assert "failed" not in summary and "error" not in summary, summary

    after = _files(copy)
    assert {n: b for n, b in after.items() if n in before} == before
    assert sorted(set(after) - set(before)) == [
        f"configs/{name}.json", "reference/families/photon_twin.py",
        f"tests/readings/{name}.json", f"workloads/{name}.train_s2048.json"]


def test_a_family_with_no_module_is_refused_by_name():
    with pytest.raises(ValueError, match="no reference/families/nope.py"):
        layout.leaves(dict(_config(CONFIGS[0]), family="nope"))
