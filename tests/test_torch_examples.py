"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/*.py``), on the CPU.

Each pair runs from the same weights: the reference example's
``model.init(PRNGKey(0))`` params, carried across to the port's side (same-
seed runs of the two packages start from different weights). Their printed
rows are parsed and held line for line: the text between the numbers equal;
every integer equal (selected clients, eff_K, stragglers, dropped, staleness
max, buffer fill, rescued clients, parameter and token counts; generated
tokens at float32 compute); every float within ``rtol·|ref|`` plus one unit of
its last printed digit (two values that close may round to neighbours).
Every federating example also hands each evaluation's perplexity and global
params to a recorder on both sides, held at full precision.

Tolerances (printed floats and perplexities relative; the final params as
the relative L2 error of the whole tree, so that the few coordinates AdamW's
normalized step or a top-k threshold singles out weigh what they move):
- float32 compute (both configs patched to ``compute_dtype="float32"``):
  floats rel 1e-4, params 3e-5 — the packages take the same f32 products in
  other orders (~1e-7 each) over up to 32 AdamW steps (measured: at most
  7.7e-6). With the top-k uplink, params 3e-4: a coordinate that f32
  rounding moves across the threshold changes by the threshold's size
  (measured: 6.7e-5).
- the default bf16 compute: floats rel 1e-2 and params 1e-2, about two bf16
  ulps (measured: at most 1.9e-3 and 3.1e-3); generated tokens not compared
  (bf16 logits can tie and flip an argmax).

The ``--fused-server`` runs are held against the reference example patched
to its own fused switches (``get_codec(fused=True)``, ``SyncAggregator`` and
``AsyncFederationDriver(fused_server=True)``), the ones the port's flag maps
onto. ``pretrain_e2e``: the train CLI's arguments are the reference's plus
``--device``, and from a shared round-0 checkpoint its final train_loss is the
reference example's (bf16, rel 2e-2, as ``tests/test_torch_train.py``).
``socket_federation``: the port's commands are the reference's with
``repro`` → ``repro_torch`` and ``--device cpu``; ``--demo round`` runs here
(about 20 s, one thread per process); ``kill-resume``, ``chaos``, ``corrupt``
and a fused ``round`` spawn 4–8 processes each and are marked ``slow``, as the
reference's socket tests are."""
import argparse
import dataclasses
import functools
import importlib
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_parity import assert_close, jax_flat, jax_to_torch, torch_flat

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

#: (printed-float and perplexity rtol, params relative L2) by compute dtype
TOL = {"float32": (1e-4, 3e-5), "bfloat16": (1e-2, 1e-2)}
TOPK_PARAMS_F32 = 3e-4


def reference_example(name):
    """``examples/<name>.py`` as a fresh module (it is not a package)."""
    spec = importlib.util.spec_from_file_location(f"_reference_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _with_dtype(cfg, dtype):
    return dataclasses.replace(cfg, compute_dtype=dtype) if dtype else cfg


def patch_reference(mod, inits, evals, dtype=None, fused=False):
    """The reference example with its model built at ``dtype`` (None: the
    default), its ``init`` params recorded by config name, its evaluations
    recorded, and, with ``fused``, its own fused switches on."""
    build = mod.build_model

    def build_model(cfg):
        model = build(_with_dtype(cfg, dtype))
        init = model.init

        def recorded(*a, **kw):
            params = init(*a, **kw)
            inits[cfg.name] = params
            return params

        model.init = recorded
        return model

    mod.build_model = build_model
    if hasattr(mod, "evaluate_perplexity"):
        mod.evaluate_perplexity = _recorder(mod.evaluate_perplexity, evals, jax_flat)
    if fused:
        mod.get_codec = functools.partial(mod.get_codec, fused=True)
        mod.SyncAggregator = functools.partial(mod.SyncAggregator, fused_server=True)
        mod.AsyncFederationDriver = functools.partial(mod.AsyncFederationDriver,
                                                      fused_server=True)
    return mod


def patch_port(monkeypatch, mod, inits, evals, dtype=None):
    """The port's example with the reference's recorded params as its weights."""
    build = mod.build_model

    def build_model(cfg):
        model = build(_with_dtype(cfg, dtype))
        model.init = lambda seed, device="cuda", dtype=None: jax_to_torch(inits[cfg.name],
                                                                          device)
        return model

    monkeypatch.setattr(mod, "build_model", build_model)
    if hasattr(mod, "evaluate_perplexity"):
        monkeypatch.setattr(mod, "evaluate_perplexity",
                            _recorder(mod.evaluate_perplexity, evals, torch_flat))
    return mod


def _recorder(evaluate, log, flat):
    def recorded(model, params, *a, **kw):
        ppl = evaluate(model, params, *a, **kw)
        log.append((ppl, flat(params)))
        return ppl

    return recorded


_NUM = re.compile(r"-?\d+(?:\.\d+)?")


def _split(line):
    line = re.sub(r" in \d+\.\ds ", " in <t>s ", line)  # serve_batched's wall time
    # the reference's fused codecs also echo their Pallas switches, which the
    # port's have not
    line = re.sub(r", use_pallas=\w+, interpret=\w+, block=\d+\)", ")", line)
    return _NUM.sub("#", line), _NUM.findall(line)


def assert_rows_agree(got: str, want: str, rtol: float, skip_after=None):
    """Line for line: the text between the numbers equal, integers equal,
    floats within ``rtol·|want|`` + one unit of the last printed digit.
    ``skip_after``: a marker past which a line's numbers are not compared."""
    got_lines, want_lines = got.strip().splitlines(), want.strip().splitlines()
    assert len(got_lines) == len(want_lines), (got, want)
    for g, w in zip(got_lines, want_lines):
        if skip_after is not None and skip_after in w:
            g, w = g.split(skip_after)[0], w.split(skip_after)[0]
        (g_text, g_nums), (w_text, w_nums) = _split(g), _split(w)
        assert g_text == w_text, (g, w)
        for a, b in zip(g_nums, w_nums):
            if "." not in b:
                assert a == b, (g, w)
                continue
            unit = 10.0 ** -len(b.split(".")[1])
            assert abs(float(a) - float(b)) <= rtol * abs(float(b)) + unit * (1 + 1e-9), (g, w)


def assert_evals_agree(got, want, rtol, params_rel):
    assert len(got) == len(want) > 0
    for (g_ppl, _), (w_ppl, _) in zip(got, want):
        assert_close(g_ppl, w_ppl, rtol=rtol, what="val_ppl")
    (_, g_params), (_, w_params) = got[-1], want[-1]  # the final global params
    assert sorted(g_params) == sorted(w_params)
    err = sum(float(np.sum((g_params[k].astype(np.float64) - w_params[k]) ** 2))
              for k in w_params)
    ref = sum(float(np.sum(w_params[k].astype(np.float64) ** 2)) for k in w_params)
    assert np.sqrt(err / ref) <= params_rel, (np.sqrt(err / ref), params_rel)


def run_pair(monkeypatch, capsys, name, argv=(), dtype="float32", fused=False):
    """The reference example, then the port's on the CPU; both outputs and
    both evaluation logs."""
    inits, j_evals, t_evals = {}, [], []
    ref = patch_reference(reference_example(name), inits, j_evals,
                          dtype if dtype == "float32" else None, fused)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    ref.main()
    want = capsys.readouterr().out
    port = patch_port(monkeypatch, importlib.import_module(f"repro_torch.examples.{name}"),
                      inits, t_evals, dtype if dtype == "float32" else None)
    port.main([*argv, "--device", "cpu"] + (["--fused-server"] if fused else []))
    got = capsys.readouterr().out
    return got, want, t_evals, j_evals


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quickstart_matches_the_reference(monkeypatch, capsys, dtype):
    got, want, t_evals, j_evals = run_pair(monkeypatch, capsys, "quickstart", dtype=dtype)
    assert "round 3: clients=" in want
    assert_rows_agree(got, want, TOL[dtype][0])
    assert_evals_agree(t_evals, j_evals, *TOL[dtype])


HETERO_CASES = [
    ("sync", [], "float32", False),
    ("sync", [], "float32", True),
    ("sync topk", ["--uplink", "topk"], "float32", False),
    ("sync topk", ["--uplink", "topk"], "float32", True),
    ("async int8", ["--aggregation", "async", "--uplink", "int8"], "float32", False),
    ("async int8", ["--aggregation", "async", "--uplink", "int8"], "float32", True),
    ("sync", [], "bfloat16", False),
]


@pytest.mark.parametrize("case,argv,dtype,fused", HETERO_CASES,
                         ids=[f"{c}-{d}-{'fused' if f else 'plain'}"
                              for c, _, d, f in HETERO_CASES])
def test_heterogeneous_federation_matches_the_reference(monkeypatch, capsys, case, argv,
                                                        dtype, fused):
    got, want, t_evals, j_evals = run_pair(
        monkeypatch, capsys, "heterogeneous_federation", ["--rounds", "2", *argv], dtype, fused)
    assert ("update 1:" if "async" in case else "round 1:") in want
    if fused and argv:
        assert "uplink codec: Fused" in want
    assert_rows_agree(got, want, TOL[dtype][0])
    rtol, params_rel = TOL[dtype]
    if "topk" in case and dtype == "float32":
        params_rel = TOPK_PARAMS_F32
    assert_evals_agree(t_evals, j_evals, rtol, params_rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_batched_matches_the_reference(monkeypatch, capsys, dtype):
    got, want, _, _ = run_pair(monkeypatch, capsys, "serve_batched", dtype=dtype)
    assert len(want.strip().splitlines()) == 3
    assert_rows_agree(got, want, TOL[dtype][0],
                      skip_after=None if dtype == "float32" else "->")


def test_examples_refuse_a_cuda_run_without_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is real here")
    for name in ("quickstart", "serve_batched", "heterogeneous_federation", "pretrain_e2e",
                 "socket_federation"):
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])


def test_evaluate_perplexity_runs_where_the_params_are():
    """The examples call ``evaluate_perplexity`` as the reference's do, with
    no device: the batches follow the params (it once defaulted to the CPU,
    which fails against params on the card)."""
    from repro_torch.metrics import evaluate_perplexity

    seen = []

    class Model:
        def loss(self, params, batch):
            seen.append(batch["tokens"].device)
            return None, {"ce": torch.tensor(1.0)}

    class Stream:
        def next_batch(self, b):
            return np.zeros((b, 8), np.int32)

    params = {"w": torch.zeros(3, device="meta")}
    assert evaluate_perplexity(Model(), params, Stream(), batches=2, batch_size=2) == np.exp(1.0)
    assert [d.type for d in seen] == ["meta", "meta"]
    evaluate_perplexity(Model(), params, Stream(), batches=1, batch_size=2, device="cpu")
    assert seen[-1].type == "cpu"


# ---------------------------------------------------------------------------
# pretrain_e2e
# ---------------------------------------------------------------------------


def _reference_argv(monkeypatch, argv):
    ref = reference_example("pretrain_e2e")
    seen = []
    monkeypatch.setattr(ref, "parse_args", lambda a: seen.append(list(a)))
    monkeypatch.setattr(ref, "run", lambda args: {"history": []})
    monkeypatch.setattr(sys, "argv", ["pretrain_e2e.py", *argv])
    ref.main()
    return seen[0]


@pytest.mark.parametrize("full", [False, True], ids=["demo", "full"])
def test_pretrain_e2e_passes_the_references_arguments(monkeypatch, full):
    from repro_torch.examples import pretrain_e2e

    want = _reference_argv(monkeypatch, ["--full"] if full else [])
    seen = []
    monkeypatch.setattr(pretrain_e2e, "run", lambda args: seen.append(args) or {"history": []})
    pretrain_e2e.main((["--full"] if full else []) + ["--device", "cpu"])
    pretrain_e2e.main((["--full"] if full else []) + ["--device", "cpu", "--fused-server"])
    from repro_torch.launch.train import parse_args

    assert vars(seen[0]) == vars(parse_args(want + ["--device", "cpu"]))
    assert vars(seen[1]) == vars(parse_args(want + ["--device", "cpu", "--fused-server"]))
    assert pretrain_e2e.train_argv(argparse.Namespace(full=full, device="cpu",
                                                      fused_server=False)) == want + [
        "--device", "cpu"]


def test_pretrain_e2e_demo_matches_the_reference_from_a_shared_checkpoint(
        monkeypatch, capsys, tmp_path):
    """The reference's train CLI writes round 0 of the demo; the reference
    example and the port's each resume a copy and train rounds 1–4."""
    from repro.launch import train as jt
    from repro_torch.examples import pretrain_e2e

    argv = _reference_argv(monkeypatch, [])
    ck = argv[argv.index("--ckpt-dir") + 1]
    rounds = argv.index("--rounds") + 1
    first = list(argv)
    first[rounds] = "1"
    for side in ("ref", "port"):
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "ref")
    jt.run(jt.parse_args(first))
    shutil.copytree(tmp_path / "ref" / ck, tmp_path / "port" / ck)

    capsys.readouterr()
    reference_example("pretrain_e2e").main()
    want = capsys.readouterr().out
    monkeypatch.chdir(tmp_path / "port")
    out = pretrain_e2e.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert [int(r["round"]) for r in out["history"]] == [1, 2, 3, 4]
    w_loss = float(re.search(r"^final: (\S+)$", want, re.M).group(1))
    g_loss = float(re.search(r"^final: (\S+)$", got, re.M).group(1))
    assert np.isfinite(g_loss)
    assert_close(g_loss, w_loss, rtol=2e-2, what="final train_loss")


# ---------------------------------------------------------------------------
# socket_federation
# ---------------------------------------------------------------------------


def _socket_args(**kw):
    base = dict(seed=3, trace_dir=None, device="cpu", fused_server=False)
    return argparse.Namespace(**{**base, **kw})


def _as_port(cmd, n_base):
    """A reference command as the port's: the module renamed, ``--device
    cpu`` after the base command's ``n_base`` entries."""
    cmd = ["repro_torch.launch.train" if c == "repro.launch.train" else c for c in cmd]
    return cmd[:n_base] + ["--device", "cpu"] + cmd[n_base:]


@pytest.mark.parametrize("trace_dir", [None, "/tmp/traces"])
def test_socket_commands_are_the_references(trace_dir):
    from repro_torch.examples import socket_federation as port

    ref = reference_example("socket_federation")
    args = _socket_args(trace_dir=trace_dir)
    n = len(ref._base_cmd(args))
    assert port._base_cmd(args) == _as_port(ref._base_cmd(args), n)
    chaos_cases = [None, {"drop": 0.1, "delay": 0.15, "kill": 0.04, "seed": 7},
                   {"corrupt": 0.9, "corrupt_kinds": "nan,inf", "seed": 11}]
    for chaos in chaos_cases:
        want = ref._worker_cmd(args, 2, 4567, "w1", chaos=chaos)
        assert port._worker_cmd(args, 2, 4567, "w1", chaos=chaos) == _as_port(want, n)
    fused = _socket_args(trace_dir=trace_dir, fused_server=True)
    assert port._base_cmd(fused) == _as_port(ref._base_cmd(args), n) + ["--fused-server"]


def _run_demo(demo, extra=(), timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.socket_federation", "--demo", demo,
         "--device", "cpu", *extra],
        capture_output=True, text=True, env=env, timeout=timeout, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_socket_round_demo_is_bitwise_the_in_process_run():
    out = _run_demo("round")
    assert re.search(r"^PASS: \d+ arrays bitwise-equal \(round_000001\)$", out, re.M), out


@pytest.mark.slow
@pytest.mark.parametrize("demo,extra,want", [
    ("kill-resume", [], r"^PASS: \d+ arrays bitwise-equal \(round_000002\)$"),
    ("chaos", [], r"^PASS: chaos run converged"),
    ("corrupt", [], r"^PASS: trace check"),
    ("round", ["--fused-server"], r"^PASS: \d+ arrays bitwise-equal \(round_000001\)$"),
    ("corrupt", ["--fused-server"], r"^PASS: corrupt run converged"),
], ids=["kill-resume", "chaos", "corrupt", "round-fused", "corrupt-fused"])
def test_socket_demos(demo, extra, want):
    out = _run_demo(demo, extra, timeout=1200)
    assert re.search(want, out, re.M), out
