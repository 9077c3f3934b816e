"""The control of ``correct`` on the card, at each cell's own size: the plain
reference in the program's place with every product in fp8 (the nearest
precision below the configurations' bfloat16) must fail the cell's limits,
on three seeds. Marked ``gpu``: it skips where torch sees no CUDA device.

    python3 -m pytest -q -m gpu bench/tests/test_bench_control.py
"""
import pytest
import torch

from harness import judge, runner, spec
from harness.traffic import Traffic
from reference.model import mm_fp8

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_the_fp8_control_fails_the_cells_limits(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    cell = spec.load_cell(name)
    dev = torch.device("cuda")
    gen = Traffic(cell.traffic, cell.config["vocab_size"], seed, dev)
    rounds = [gen.round_tokens(r) for r in range(cell.workload["probe_rounds"])]
    ref = runner.follow(cell, seed, rounds, dev)
    control = runner.follow(cell, seed, rounds, dev, mm=mm_fp8)
    ok, rows = judge.judge(judge.numbers(control, ref), cell.workload["limits"])
    assert not ok, rows
