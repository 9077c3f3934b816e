#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

Phases, one JSON line each:

  env           torch/CUDA versions and the card's name and power limit
  build         compiles every CUDA kernel of the port from ``src/repro_torch/csrc``
  server_apply  the fused server-step kernel against its plain PyTorch version at
                photon-75m's flat size (Np = 74,104,832, C = 4) for FedAvg,
                FedMom and FedAdam, with and without DP noise: max errors,
                run-to-run bitwise norms, kernel / plain / bound times
  check         a reduced photon round on the card agrees with the same round on
                the CPU (float32 compute)
  train         ``repro_torch.launch.train --arch photon-75m --fused-server``
                for two rounds at full width on the card; the kernel launch
                counts are zeroed just before and read just after
  kernels       one line {"kernels": [...]} with every kernel's numbers

The last line is {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device the script exits 2 before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
NP_PHOTON_75M = 74_104_832  # photon-75m's 74,100,992 params padded to 8192-blocks
COHORT = 4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event timings after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build() -> dict:
    from repro_torch.kernels.fedcore import kernel as K

    t0 = time.perf_counter()
    path, log = K.build()
    seconds = time.perf_counter() - t0
    ptxas = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
    emit("build", kernel="server_apply", library=os.path.relpath(path, ROOT),
         seconds=seconds, ptxas=ptxas)
    return {"seconds": seconds}


def _server_apply_case(opt: str, with_noise: bool, gen, dev: str = "cuda",
                       Np: int = NP_PHOTON_75M) -> dict:
    import torch
    from repro_torch.kernels.fedcore import kernel as K

    C = COHORT
    deltas = torch.randn((C, Np), generator=gen, device=dev) * 1e-2
    w = torch.tensor([1.0, 2.0, 0.0, 0.5], device=dev)  # one zero-weight client
    wn = w / w.sum()
    params = torch.randn(Np, generator=gen, device=dev) * 0.02
    # optimizer lanes as one earlier outer step with pseudo-gradient g0 left them
    g0 = torch.randn(Np, generator=gen, device=dev) * 5e-3
    lanes = {"fedavg": [], "fedmom": [g0], "fedadam": [0.1 * g0, 0.01 * g0.square()]}[opt]
    noise = torch.randn(Np, generator=gen, device=dev) * 1e-3 if with_noise else None
    hyper = {
        "fedavg": dict(lr=1.0),
        "fedmom": dict(lr=0.7, momentum=0.9, nesterov=True),
        "fedadam": dict(lr=0.1, momentum=0.9, beta2=0.99, eps=1e-8,
                        bias_corr=(1.0 - 0.9 ** 2, 1.0 - 0.99 ** 2)),
    }[opt]
    n_lanes = len(lanes)

    def run(fn):
        p, ls = params.clone(), [x.clone() for x in lanes]
        norms = fn(deltas, wn, p, ls, opt=opt, noise=noise, **hyper)
        if dev == "cuda":
            torch.cuda.synchronize()
        return p, ls, torch.stack([norms[0], norms[1], *norms[2]])

    p_k, l_k, n_k = run(K.server_apply)
    p_k2, l_k2, n_k2 = run(K.server_apply)
    p_p, l_p, n_p = run(K.server_apply_plain)

    scale = max(1.0, float(p_p.abs().max()))
    err_p = float((p_k - p_p).abs().max())
    err_lanes = max([float((a - b).abs().max()) for a, b in zip(l_k, l_p)] or [0.0])
    lane_scale = max([max(1.0, float(b.abs().max())) for b in l_p] or [1.0])
    rel_norms = float(((n_k.double() - n_p.double()).abs() / n_p.double().abs()).max())
    bitwise = bool(torch.equal(n_k, n_k2) and torch.equal(p_k, p_k2)
                   and all(torch.equal(a, b) for a, b in zip(l_k, l_k2)))
    assert err_p <= 1e-6 * scale, (opt, with_noise, "params", err_p)
    assert err_lanes <= 1e-6 * lane_scale, (opt, with_noise, "lanes", err_lanes)
    assert rel_norms <= 1e-5, (opt, with_noise, "norms", rel_norms)
    assert bitwise, (opt, with_noise, "two launches differ")
    assert torch.isfinite(n_k).all(), (opt, with_noise, "non-finite norms")

    p_t, l_t = params.clone(), [x.clone() for x in lanes]
    kernel_ms = time_ms(lambda: K.server_apply(deltas, wn, p_t, l_t, opt=opt, noise=noise,
                                               **hyper), reps=20, warmup=3)
    plain_ms = time_ms(lambda: K.server_apply_plain(deltas, wn, p_t, l_t, opt=opt,
                                                    noise=noise, **hyper), reps=5)
    n_streams = C + 2 + 2 * n_lanes + (1 if with_noise else 0)
    nbytes = 4 * (n_streams * Np + C + 2 + C)  # + weights in, norms out
    flops = Np * (4 * C + 6 + {"fedavg": 2, "fedmom": 6, "fedadam": 14}[opt])
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_OPS_PER_S * 1e3
    return {
        "opt": opt, "noise": with_noise, "C": C, "Np": Np,
        "max_abs_err_params": err_p, "max_abs_err_lanes": err_lanes,
        "max_rel_err_norms": rel_norms, "norms_bitwise_across_launches": bitwise,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "kernel_GBps": nbytes / (kernel_ms * 1e-3) / 1e9,
    }


def phase_server_apply() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for opt in ("fedavg", "fedmom", "fedadam"):
        for with_noise in (False, True):
            r = _server_apply_case(opt, with_noise, gen)
            emit("server_apply", **r)
            results[(opt, with_noise)] = r
            torch.cuda.empty_cache()
    return results


def phase_check() -> None:
    """One reduced photon round (float32 compute) on the card and on the CPU
    from the same seed must agree: the card's numerics are the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T

    cfg = dataclasses.replace(get_config("photon-75m").reduced(), compute_dtype="float32")
    rows = {}
    for dev in ("cpu", "cuda"):
        args = T.parse_args(["--reduced", "--rounds", "1", "--local-steps", "2",
                             "--clients", "2", "--population", "4", "--seq-len", "64",
                             "--fused-server", "--device", dev])
        rows[dev] = T.run(args, cfg=cfg)["history"][0]
    keys = ("train_loss", "pseudo_grad_norm", "global_model_norm", "val_ppl")
    rel = {k: abs(rows["cuda"][k] - rows["cpu"][k]) / abs(rows["cpu"][k]) for k in keys}
    emit("check", cuda={k: rows["cuda"][k] for k in keys},
         cpu={k: rows["cpu"][k] for k in keys}, rel_err=rel)
    assert all(math.isfinite(rows["cuda"][k]) for k in keys), rows["cuda"]
    assert max(rel.values()) <= 1e-3, rel


def phase_train() -> dict:
    import torch
    from repro_torch.kernels.fedcore import kernel as K
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_leaves

    args = T.parse_args(["--arch", "photon-75m", "--fused-server", "--rounds", "2",
                         "--device", "cuda"])
    torch.cuda.synchronize()
    K.server_apply.launches = 0
    t0 = time.perf_counter()
    out = T.run(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"server_apply": K.server_apply.launches}

    tokens_per_round = args.clients * args.local_steps * args.batch * args.seq_len
    for row in out["history"]:
        emit("train", round=row["round"], loss=row["train_loss"], val_ppl=row["val_ppl"],
             pseudo_grad_norm=row["pseudo_grad_norm"],
             global_model_norm=row["global_model_norm"], seconds=row["seconds"],
             tokens_per_s=tokens_per_round / row["seconds"])
    leaves = tree_leaves(out["state"]["params"])
    n_params = sum(x.numel() for x in leaves)
    emit("train", total_seconds=seconds, launches=launches, n_params=n_params,
         peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9)
    # photon-75m's 74,100,992 params fill exactly the flat length the kernel
    # phase ran at, once padded to the reference's 8192-element blocks
    assert -(-n_params // 8192) * 8192 == NP_PHOTON_75M, n_params
    assert all(bool(torch.isfinite(x).all()) for x in leaves), "non-finite params"
    for row in out["history"]:
        assert math.isfinite(row["train_loss"]) and math.isfinite(row["val_ppl"]), row
    assert launches["server_apply"] == args.rounds, launches
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.fedcore import kernel  # noqa: F401  (fails outside a checkout)

    smi = gpu_name_and_power()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    phase_build()
    sa = phase_server_apply()
    phase_check()
    launches = phase_train()

    main_case = sa[("fedavg", False)]  # the main path: FedAvg, no DP noise, C = 4
    print(json.dumps({"kernels": [{
        "name": "server_apply",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fedcore_server_apply.cu",
        "replaces": "src/repro/kernels/fedcore/kernel.py:141",
        "launches": launches["server_apply"],
        "max_abs_err": main_case["max_abs_err_params"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
