"""The harness on the CPU: its files and names, what it may import, its
refusal without a card, a cell added as files alone, and whole runs of tiny
cells through the program's plain kernels, sound and with the timed path
broken (the comparison must then read ``correct`` false)."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, CONFIGS, ROOT
from harness import judge, runner, spec
from harness.calibrate import half_batch_feed
from reference.model import mm_fp8

SPEC = spec.load_json(ROOT / "BENCHMARK.json")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_benchmark_json_keeps_the_contracts_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = {
        "configs": [c["name"] for c in SPEC["configs"]],
        "workloads": WORKLOADS,
        "traffic": [w["traffic"] for w in SPEC["workloads"]],
        "metrics": [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]],
        "reduced": [k for c in SPEC["configs"] for k in c["reduced"]],
    }
    for kind in ("configs", "workloads", "traffic", "metrics", "reduced"):
        assert all(spec.NAME.match(n) for n in names[kind]), kind
    for kind in ("configs", "workloads", "metrics"):
        assert len(set(names[kind])) == len(names[kind]), kind
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and ONE_LINE.match(c["why"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and ONE_LINE.match(w["why"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and ONE_LINE.match(m["layer"])
        assert set(m["workloads"]) <= set(WORKLOADS)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert spec.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("path", sorted(str(p.relative_to(BENCH)) for d in
                                        ("configs", "traffic", "workloads")
                                        for p in (BENCH / d).glob("*.json")))
def test_every_data_file_loads_and_is_named_from_a_name(path):
    assert isinstance(spec.load_json(BENCH / path), dict)
    assert spec.NAME.match(os.path.basename(path)[: -len(".json")])


@pytest.mark.parametrize("name", WORKLOADS)
def test_every_cell_loads_with_its_limits_and_readers(name):
    cell = spec.load_cell(name)
    limits = cell.workload["limits"]
    assert limits and set(limits) <= {"loss_gap", "pg_gap", "change_gap", "pg_dist",
                                      "grad_norm_gap"}
    assert all(0.0 < v < 1.0 for v in limits.values())
    assert cell.config["name"] == next(w["config"] for w in SPEC["workloads"] if w["name"] == name)
    for m in cell.metrics(trace=True):
        assert callable(spec.metric_reader(m["name"]))
    assert {m["name"] for m in cell.metrics(trace=False)} == {
        m["name"] for m in SPEC["end_to_end"]}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(str(p.relative_to(BENCH)) for p in BENCH.rglob("*.py")))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(BENCH / path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if path.startswith("reference"):  # the reference takes nothing of the program
        assert not tops & {"repro_torch", "harness"}, tops


def test_run_exits_nonzero_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", WORKLOADS[0],
                          "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr and "never falls back to the CPU" in out.stderr


def test_a_new_cell_config_and_metric_are_files_and_entries_only(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(SPEC))
    traffic = dict(spec.load_json(BENCH / "traffic" / "train_s2048.json"), clients_per_round=3)
    (tmp_path / "bench" / "traffic" / "train_k3.json").write_text(json.dumps(traffic))
    workload = dict(spec.load_json(BENCH / "workloads" / "photon-1.3b.train_s2048.json"),
                    grad_accum=2)
    (tmp_path / "bench" / "workloads" / "photon-1.3b.train_k3.json").write_text(
        json.dumps(workload))
    (tmp_path / "bench" / "metrics" / "rounds_seen.py").write_text(
        "def read(trace):\n    return float(len(trace['spans'])) or None\n")
    new["workloads"].append({"name": "photon-1.3b.train_k3", "config": "photon-1.3b",
                             "traffic": "train_k3", "chips": 1, "why": "three clients"})
    new["per_layer"].append({"name": "rounds_seen", "unit": "rounds", "better": "higher",
                             "source": "program_span", "layer": "aggregator round loop",
                             "moves": "train_tokens_per_s",
                             "workloads": ["photon-1.3b.train_k3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = spec.load_cell("photon-1.3b.train_k3", tmp_path / "BENCHMARK.json")
    assert cell.traffic["clients_per_round"] == 3 and cell.workload["grad_accum"] == 2
    assert [m["name"] for m in cell.metrics(trace=True)] == ["rounds_seen"]
    old = spec.load_cell("photon-1.3b.train_s2048", tmp_path / "BENCHMARK.json")
    assert "rounds_seen" not in [m["name"] for m in old.metrics(trace=True)]


def _run(cell, feed=None, seconds=0.0):
    return runner.run(cell, 2**31 + 11, seconds, False, torch.device("cpu"), time.perf_counter(),
                      log=lambda m: None, feed=feed)


@pytest.mark.parametrize("config", CONFIGS)
def test_a_sound_tiny_run_is_correct_and_prints_the_result_keys(tiny_cell, config):
    res = _run(tiny_cell(config))
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] == 3
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {m["name"] for m in SPEC["end_to_end"]}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("config", CONFIGS)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(tiny_cell, config, monkeypatch):
    from repro_torch.core.aggregator import SyncAggregator

    plain = SyncAggregator.run_round

    def unchanged(self, batches, plan):
        state = self.state
        metrics = plain(self, batches, plan)
        self.state = state
        return metrics

    monkeypatch.setattr(SyncAggregator, "run_round", unchanged)
    res = _run(tiny_cell(config))
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("config", CONFIGS)
def test_half_the_batch_left_out_is_not_correct(tiny_cell, config):
    res = _run(tiny_cell(config), feed=half_batch_feed)
    assert res["correct"] is False


@pytest.mark.parametrize("config", CONFIGS)
def test_the_fp8_control_in_the_programs_place_is_not_correct(tiny_cell, config):
    cell = tiny_cell(config)
    dev = torch.device("cpu")
    seed = 2**31 + 3
    from harness.calibrate import program_readings

    _, rounds = program_readings(cell, seed, dev)
    ref = runner.follow(cell, seed, rounds, dev)
    control = runner.follow(cell, seed, rounds, dev, mm=mm_fp8)
    ok, rows = judge.judge(judge.numbers(control, ref), cell.workload["limits"])
    assert not ok, rows


def test_bf16_products_alone_move_pg_dist_far_more_than_the_float32_programs_gap(tiny_cell):
    """The witness behind ``pg_dist``'s lower reading: with float32 compute
    the program meets the reference element by element, and bfloat16 products
    in the reference itself, with no program, move the elements by hundreds
    of times as much."""
    from harness.calibrate import program_readings, witness_rows

    cell = tiny_cell("mamba2-1.3b")
    dev = torch.device("cpu")
    seed = 2**31 + 5
    prog, rounds = program_readings(cell, seed, dev)
    ref = runner.follow(cell, seed, rounds, dev)
    program = judge.numbers(prog, ref)["pg_dist"][0]
    bf16 = witness_rows(cell, seed, dev)["bf16_reference"]["pg_dist"][0]
    assert program < 1e-3 and bf16 > 100 * program, (program, bf16)
