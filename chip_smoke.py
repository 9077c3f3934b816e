#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with an H100:

    python3 chip_smoke.py

Phases, one JSON line each:

  env           torch/CUDA versions and the card's name and power limit
  build         compiles every CUDA source of the port from ``src/repro_torch/csrc``
                (the two fedcore sources, ssd_scan.cu, flash_attention.cu,
                flash_decode.cu and rmsnorm.cu), one nvcc each, all at once
  server_apply  the fused server-step kernel against its plain PyTorch version at
                photon-75m's flat size (Np = 74,104,832, C = 4) for FedAvg,
                FedMom and FedAdam, with and without DP noise, and FedAvg at
                C = 40 (two chunks of clients): max errors, run-to-run bitwise
                norms, kernel / plain / bound times
  topk_mask_ef, sr_bf16, int8_quant, int8_dequant
                each uplink codec kernel at Np = 74,104,832, C = 4, bitwise
                against its plain version: kernel / plain / bound times, GB/s;
                the top-k phase also times the threshold selection
  ssd_scan      the SSD chunk-scan kernel against its plain version at
                mamba2-1.3b's full per-layer prefill shape (B = 4, S = 2048,
                nh = 64, hd = 64, G = 1, ds = 128, chunk = 64, bf16), from a
                nonzero state, and at S = 2000 through ``ops.ssd``'s padding
  flash_attention
                the flash attention kernel against its plain version at
                whisper-large-v3's encoder layer (B = 4, H = 20, S = 1500,
                hd = 64, bf16, non-causal) and at small cases (causal with
                q_offset, sliding windows, GQA groups of 2 and 4, hd 128,
                f32, ragged lengths, rows that see no key): max error,
                kernel / plain / F.scaled_dot_product_attention / bound times
  flash_decode  the flash decode kernel through its entry point ``ops.flash_decode``
                (model-layout caches read in place) at qwen3-1.7b's decode_32k
                attention layer (B = 128, Hq = 16, Hkv = 8, S = 32768, hd = 128,
                bf16; 17.18 GB of cache) and gemma3-4b's long_500k global and
                local (window 1024) layers (B = 1, Hq = 8, Hkv = 4, S = 524288,
                hd = 256, bf16), each call with the launch counts zeroed just
                before and read just after; against its plain version (on the
                first 8 rows at B = 128) and at small masked, GQA and ragged
                cases in bf16 and f32: max error, kernel / plain /
                F.scaled_dot_product_attention (and the kernels it ran) / bound
                times over the bytes the seen keys need
  rmsnorm       the RMSNorm kernel through ``ops.rmsnorm`` at qwen3-1.7b's
                prefill_32k activations (1,048,576 x 2048, bf16) and at
                mamba2-1.3b's serve prefill rows (8192 x 2048, bf16), counted
                as above, and at small cases (ragged widths, rows too long for
                registers, f32): max error, kernel / plain / F.rms_norm / bound
  check         a reduced photon round on the card agrees with the same round on
                the CPU (float32 compute), with the float32 and the top-k uplink;
                reduced mamba2-1.3b, photon-75m and whisper-large-v3 ``generate``
                (float32, use_pallas) give the same tokens on the card and on
                the CPU
  train         ``repro_torch.launch.train --arch photon-75m --fused-server``
                for two rounds at full width on the card, with ``--uplink``
                float32, topk, bf16 and int8; the kernel launch counts are
                zeroed just before each and read just after
  serve         full-width mamba2-1.3b (48 layers, random weights from seed 0):
                ``Model.prefill(use_pallas=True)`` at B = 4, S = 2048 against
                ``use_pallas=False`` on the card (float32 compute: held to a
                tolerance; bf16: reported), then ``generate(use_pallas=True)``
                with 16 new tokens, exactly 48 ssd_scan launches per prefill and
                none per decode step; then full-width photon-75m ``generate`` at
                B = 4, prompt 512, 16 new tokens, with no kernel launched.
                Prefill seconds, decode tokens/s, peak device memory, and a
                torch.profiler breakdown of one prefill and one decode step
                (device time by kernel, the device's busy share)
  serve_whisper full-width whisper-large-v3 (32 encoder and 32 decoder layers,
                random weights from seed 0): B = 4, 1500 audio frames of randn
                embeddings, a 432-token prompt, 16 new tokens (448 decoder
                positions, Whisper's text context). Float32
                ``prefill(use_pallas=True)`` against ``use_pallas=False`` on the
                card (held to 1e-4), the bf16 greedy tokens of both compared,
                then ``generate(use_pallas=True)``: exactly 32 flash_attention
                launches per prefill, none per decode step, no other kernel;
                the serve numbers and profile as above
  kernels       one line {"kernels": [...]} with every kernel's numbers

No model path launches flash_decode or rmsnorm (none does in the JAX package
either): the train and serve phases hold their counts at 0, and their
launches in the kernels line are those of the entry-point calls above.

The last line is {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without a CUDA device the script exits 2 before printing a result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
#: mamba2-1.3b's per-layer prefill shape in the ssd_scan phase and the serve phase
SSD_SHAPE = dict(B=4, S=2048, nh=64, hd=64, G=1, ds=128, chunk=64)
SSD_RAGGED_S = 2000  # not a multiple of the chunk: ops.ssd pads it
SERVE_BATCH, SERVE_GEN, PHOTON_PROMPT = 4, 16, 512
MAMBA2_LAYERS = 48
WHISPER_LAYERS = 32  # encoder layers: one flash_attention launch each per prefill
WHISPER_PROMPT = 448 - SERVE_GEN  # prompt + new tokens = Whisper's 448-token text context
BF16_TC_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
#: whisper-large-v3's encoder self-attention (B, Hq, Hkv, Sq, Sk, hd, causal,
#: window, q_offset), then small cases of every other option the kernel takes
FLASH_ENCODER = (4, 20, 20, 1500, 1500, 64, False, None, 0)
FLASH_SMALL = [
    (2, 8, 8, 512, 512, 64, True, None, 0),  # causal
    (2, 8, 8, 256, 1024, 64, True, None, 768),  # causal, q_offset = Sk - Sq
    (2, 8, 8, 1000, 1000, 64, True, 128, 0),  # sliding window, ragged
    (2, 16, 8, 700, 700, 128, False, None, 0),  # GQA grp 2, hd 128, ragged
    (2, 16, 4, 333, 333, 64, True, 64, 0),  # GQA grp 4, window, ragged
    (1, 4, 2, 64, 40, 64, True, None, -16),  # rows that see no key
]
#: (case, B, Hq, Hkv, S, hd, window), kv_len = S on every row: qwen3-1.7b's
#: attention at decode_32k, gemma3-4b's global and local layers at long_500k
DECODE_CASES = [
    ("qwen3-1.7b decode_32k", 128, 16, 8, 32768, 128, None),
    ("gemma3-4b long_500k global", 1, 8, 4, 524288, 256, None),
    ("gemma3-4b long_500k local", 1, 8, 4, 524288, 256, 1024),
]
#: rows the plain version takes at B = 128 (its f32 copies of all 128 would be 34 GB)
DECODE_PLAIN_ROWS = 8
#: small masked, GQA and ragged cases: (B, Hq, Hkv, S, hd, kv_len per row, window)
DECODE_SMALL = [
    (4, 8, 2, 1000, 64, (1000, 517, 0, 1), None),  # grp 4, ragged rows, an empty row
    (3, 4, 4, 333, 32, (333, 100, 5), 64),  # grp 1, hd 32, window, kv_len < window
    (2, 16, 2, 4097, 128, (4097, 2000), 100),  # grp 8, window
    (2, 6, 2, 700, 256, (10, 700), 5000),  # grp 3, hd 256, window past the cache
]
#: (case, R, D) in bf16: qwen3-1.7b's prefill_32k activations, mamba2-1.3b's serve prefill
RMS_CASES = [
    ("qwen3-1.7b prefill_32k", 32 * 32768, 2048),
    ("mamba2-1.3b serve prefill", 4 * 2048, 2048),
]
#: small cases: ragged widths (no 16-byte access), rows too long for registers
RMS_SMALL = [(105, 1000), (3, 8192), (7, 4096), (64, 2048), (5, 12288)]
NP_PHOTON_75M = 74_104_832  # photon-75m's 74,100,992 params padded to 8192-blocks
COHORT = 4
WIDE_COHORT = 40  # more clients than one server_apply launch holds (32)
TOPK_FRACTION = 0.05  # the launcher's --topk-fraction default
#: (kernel, the --uplink that runs it, line of the TPU kernel, why no library call)
CODEC_KERNELS = (
    ("topk_mask_ef", "topk", 236,
     "no single PyTorch call computes both the masked payload and the residual"),
    ("sr_bf16", "bf16", 271, "PyTorch has no stochastic-rounding cast"),
    ("int8_quant", "int8", 303,
     "no single PyTorch call quantizes with a per-(client, leaf) scale table"),
    ("int8_dequant", "int8", 330,
     "no single PyTorch call dequantizes with a per-(client, leaf) scale table"),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device ms per call: ``reps`` calls issued back to back between one
    pair of CUDA events, after ``warmup`` calls. The host queues each call
    while the previous one runs, as in a round, so the wrapper's own host
    time is hidden unless it waits for the card."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def all_kernels() -> dict:
    """Every kernel wrapper of the port, by name (each counts its launches)."""
    from repro_torch.kernels.fedcore import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_decode import kernel as DK
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.ssd_scan import kernel as SK

    return {**K.KERNELS, **SK.KERNELS, **FK.KERNELS, **DK.KERNELS, **RK.KERNELS}


def zero_launches() -> None:
    for fn in all_kernels().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in all_kernels().items()}


def phase_build() -> dict:
    from repro_torch.kernels import build as KB

    t0 = time.perf_counter()
    built = KB.build_all()
    seconds = time.perf_counter() - t0
    for source, (path, log) in built.items():
        ptxas = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
        emit("build", source=source, library=os.path.relpath(path, ROOT), ptxas=ptxas)
    emit("build", seconds=seconds, sources=len(built))
    return {"seconds": seconds}


def _server_apply_case(opt: str, with_noise: bool, gen, dev: str = "cuda",
                       Np: int = NP_PHOTON_75M, C: int = COHORT) -> dict:
    import torch
    from repro_torch.kernels.fedcore import kernel as K

    deltas = torch.randn((C, Np), generator=gen, device=dev) * 1e-2
    w = torch.tensor([1.0, 2.0, 0.0, 0.5] * (C // 4), device=dev)  # zero-weight clients
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
    # a cohort wider than one launch's 32 register accumulators: two chunks
    r = _server_apply_case("fedavg", False, gen, C=WIDE_COHORT)
    emit("server_apply", **r)
    results[("fedavg", False, WIDE_COHORT)] = r
    torch.cuda.empty_cache()
    return results


def _bits(t):
    import torch

    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()])


def _codec_case(name: str, kernel, plain, args, nbytes: int, extra=None) -> dict:
    """Kernel against plain, bitwise, then both timed at the given inputs."""
    import torch

    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    got, want = (got if isinstance(got, tuple) else (got,)), \
        (want if isinstance(want, tuple) else (want,))
    bitwise = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
    max_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    assert bitwise, (name, "kernel differs from its plain version", max_err)
    del got, want
    kernel_ms = time_ms(lambda: kernel(*args), reps=20, warmup=3)
    plain_ms = time_ms(lambda: plain(*args), reps=5)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    r = {"C": COHORT, "Np": NP_PHOTON_75M, "bitwise": bitwise, "max_abs_err": max_err,
         "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bytes": nbytes, "bound_ms": bound_ms,
         "bound_by": "bytes", "kernel_GBps": nbytes / (kernel_ms * 1e-3) / 1e9,
         **(extra or {})}
    emit(name, **r)
    torch.cuda.empty_cache()
    return r


def phase_codecs() -> dict:
    """The four uplink codec kernels at photon-75m's packed cohort buffer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.compression import int8_scale
    from repro_torch.kernels.fedcore import FusedTopKCodec, kernel as K
    from repro_torch.kernels.fedcore.ops import BLOCK, FlatSpec

    C, Np = COHORT, NP_PHOTON_75M
    shapes = photon_leaf_shapes(get_config("photon-75m"))
    n = sum(math.prod(sh) for sh in shapes)
    spec = FlatSpec(shapes=tuple(shapes), n=n, n_pad=-(-n // BLOCK) * BLOCK)
    assert spec.n_pad == Np, (spec.n_pad, Np)
    offsets = spec.offsets + (n,)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.zeros((C, Np), device="cuda")
    x[:, :n] = torch.randn((C, n), generator=gen, device="cuda") * 1e-3
    out = {}

    codec = FusedTopKCodec(k_fraction=TOPK_FRACTION)
    thresh = codec.threshold(x, n)
    select_ms = time_ms(lambda: codec.threshold(x, n), reps=5)
    out["topk_mask_ef"] = _codec_case(
        "topk_mask_ef", K.topk_mask_ef, K.topk_mask_ef_plain, (x, thresh), 12 * C * Np + 4 * C,
        {"threshold_select_ms": select_ms, "k": max(1, int(n * TOPK_FRACTION))})
    del thresh

    noise = torch.randint(0, 1 << 16, (C, Np), generator=gen, device="cuda", dtype=torch.int32)
    out["sr_bf16"] = _codec_case("sr_bf16", K.sr_bf16, K.sr_bf16_plain, (x, noise), 10 * C * Np)
    del noise

    scales = torch.stack([int8_scale(x[:, a:b], dim=1) for a, b in zip(offsets, offsets[1:])],
                         dim=1).contiguous()
    out["int8_quant"] = _codec_case("int8_quant", K.int8_quant, K.int8_quant_plain,
                                    (x, scales, offsets), 5 * C * Np,
                                    {"leaves": len(shapes)})
    q = K.int8_quant(x, scales, offsets)
    del x
    out["int8_dequant"] = _codec_case("int8_dequant", K.int8_dequant, K.int8_dequant_plain,
                                      (q, scales, offsets), 5 * C * Np,
                                      {"leaves": len(shapes)})
    return out


def photon_leaf_shapes(cfg):
    """photon's parameter shapes in flatten order, from an abstract init."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    params = build_model(cfg).init(0, device="meta")
    return [tuple(x.shape) for x in tree_leaves(params)]


def phase_check() -> None:
    """One reduced photon round (float32 compute) on the card and on the CPU
    from the same seed must agree: the card's numerics are the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as T

    cfg = dataclasses.replace(get_config("photon-75m").reduced(), compute_dtype="float32")
    for uplink in ("float32", "topk"):
        rows = {}
        for dev in ("cpu", "cuda"):
            args = T.parse_args(["--reduced", "--rounds", "1", "--local-steps", "2",
                                 "--clients", "2", "--population", "4", "--seq-len", "64",
                                 "--fused-server", "--uplink", uplink, "--device", dev])
            rows[dev] = T.run(args, cfg=cfg)["history"][0]
        keys = ("train_loss", "pseudo_grad_norm", "global_model_norm", "val_ppl")
        keys += ("uplink_residual_norm",) if uplink == "topk" else ()
        rel = {k: abs(rows["cuda"][k] - rows["cpu"][k]) / abs(rows["cpu"][k]) for k in keys}
        emit("check", uplink=uplink, cuda={k: rows["cuda"][k] for k in keys},
             cpu={k: rows["cpu"][k] for k in keys}, rel_err=rel)
        assert all(math.isfinite(rows["cuda"][k]) for k in keys), rows["cuda"]
        assert max(rel.values()) <= 1e-3, (uplink, rel)


#: the kernels each train phase must launch once per round, and no other
TRAIN_KERNELS = {
    "float32": ("server_apply",),
    "topk": ("server_apply", "topk_mask_ef"),
    "bf16": ("server_apply", "sr_bf16"),
    "int8": ("server_apply", "int8_quant", "int8_dequant"),
}


def phase_train(uplink: str) -> dict:
    import torch
    from repro_torch.launch import train as T
    from repro_torch.tree import tree_leaves

    args = T.parse_args(["--arch", "photon-75m", "--fused-server", "--rounds", "2",
                         "--uplink", uplink, "--device", "cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = T.run(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()

    tokens_per_round = args.clients * args.local_steps * args.batch * args.seq_len
    for row in out["history"]:
        emit("train", uplink=uplink, round=row["round"], loss=row["train_loss"],
             val_ppl=row["val_ppl"], pseudo_grad_norm=row["pseudo_grad_norm"],
             global_model_norm=row["global_model_norm"], seconds=row["seconds"],
             tokens_per_s=tokens_per_round / row["seconds"],
             uplink_residual_norm=row.get("uplink_residual_norm"),
             uplink_bytes_per_client=row["uplink_bytes_per_client"],
             uplink_compression_ratio=row["uplink_compression_ratio"])
    leaves = tree_leaves(out["state"]["params"])
    n_params = sum(x.numel() for x in leaves)
    emit("train", uplink=uplink, total_seconds=seconds, launches=launches, n_params=n_params,
         peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9)
    # photon-75m's 74,100,992 params fill exactly the flat length the kernel
    # phases ran at, once padded to the reference's 8192-element blocks
    assert -(-n_params // 8192) * 8192 == NP_PHOTON_75M, n_params
    assert all(bool(torch.isfinite(x).all()) for x in leaves), "non-finite params"
    for row in out["history"]:
        assert math.isfinite(row["train_loss"]) and math.isfinite(row["val_ppl"]), row
        if uplink == "topk":
            assert math.isfinite(row["uplink_residual_norm"]), row
    want = {name: args.rounds if name in TRAIN_KERNELS[uplink] else 0 for name in launches}
    assert launches == want, (uplink, launches, want)
    del out
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The SSD chunk scan and the serving path
# ---------------------------------------------------------------------------


def ssd_bound(B, S, nh, hd, G, ds, chunk, itemsize: int = 2):
    """(bytes, flops) the chunk scan must move and do: x, Bm, Cm and y in
    ``itemsize`` bytes, dt, A and both states in f32, each read or written
    once; the products at 2 flops per multiply-add: C·Bᵀ once per
    (b, g, chunk), since it does not depend on the head, and per (b, h, chunk)
    (C·Bᵀ∘L)·dx, C·Sᵀ and the state update. L is zero above the diagonal, so
    both intra-chunk products count only the entries j ≤ i."""
    nbytes = itemsize * (2 * B * nh * S * hd + 2 * B * G * S * ds) \
        + 4 * (B * nh * S + nh + 2 * B * nh * hd * ds)
    tri = chunk * (chunk + 1) // 2
    flops = 2 * (S // chunk) * (B * G * tri * ds + B * nh * (tri * hd + 2 * chunk * hd * ds))
    return nbytes, flops


def ssd_case(S: int, gen, ragged: bool = False) -> dict:
    """Kernel against plain version on the card at mamba2-1.3b's layer shape.
    y: |Δ| ≤ 2⁻⁷·|y| + 1e-5·max|y| (one bf16 ulp: both sides sum in f32 in
    other orders, then round); final state: |Δ| ≤ 1e-5·max|S|."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import kernel as SK, ops

    sh = dict(SSD_SHAPE, S=S)
    B, nh, hd, G, ds, chunk = (sh[k] for k in ("B", "nh", "hd", "G", "ds", "chunk"))
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x = rnd(B, S, nh, hd).bfloat16()  # model layout, as ssm_block hands it to ops.ssd
    dt = F.softplus(rnd(B, S, nh) - 1.0)
    A = -torch.exp(0.5 * rnd(nh))
    Bm, Cm = rnd(B, S, G, ds).bfloat16(), rnd(B, S, G, ds).bfloat16()
    init = 0.1 * rnd(B, nh, hd, ds)

    pad = (-S) % chunk
    padded = [F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)).movedim(1, 2).contiguous()
              for t in (x, dt, Bm, Cm)]
    args = (padded[0], padded[1], A, padded[2], padded[3], init)
    if ragged:
        run = lambda: ops.ssd(x, dt, A, Bm, Cm, chunk, init)  # noqa: E731
        got = run()
        got = (got[0].movedim(1, 2), got[1])
    else:
        run = lambda: SK.ssd_scan_fwd(*args, chunk=chunk)  # noqa: E731
        got = run()
    want = SK.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    y, y0 = got[0].float(), want[0][:, :, :S].float()
    y_err = float((y - y0).abs().max())
    y_units = float(((y - y0).abs() / (2.0 ** -7 * y0.abs() + 1e-5 * y0.abs().max())).max())
    s_err = float((got[1] - want[1]).abs().max())
    s_units = s_err / (1e-5 * float(want[1].abs().max()))
    r = {"S": S, "padded_S": S + pad, "path": "ops.ssd" if ragged else "ssd_scan_fwd",
         "max_abs_err_y": y_err, "y_err_in_tolerance_units": y_units,
         "max_abs_err_state": s_err, "state_err_in_tolerance_units": s_units,
         "max_abs_y": float(y0.abs().max()), "max_abs_state": float(want[1].abs().max())}
    assert y_units <= 1.0 and s_units <= 1.0, r
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(got[1]).all()), r
    if not ragged:
        nbytes, flops = ssd_bound(B, S, nh, hd, G, ds, chunk)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_OPS_PER_S * 1e3
        kernel_ms = time_ms(run, reps=20, warmup=3)
        r.update(kernel_ms=kernel_ms,
                 plain_ms=time_ms(lambda: SK.ssd_scan_plain(*args, chunk=chunk), reps=3),
                 bytes=nbytes, flops=flops, bytes_ms=bytes_ms, ops_ms=ops_ms,
                 bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 kernel_TFLOPs=flops / (kernel_ms * 1e-3) / 1e12, library_ms=None)
    emit("ssd_scan", **r)
    return r


def phase_ssd_scan() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    full = ssd_case(SSD_SHAPE["S"], gen)
    ssd_case(SSD_RAGGED_S, gen, ragged=True)
    torch.cuda.empty_cache()
    return full


def ulp_units(got, want) -> float:
    """Error in units of the tolerance |Δ| ≤ rtol·|y| + 1e-5·max|y|, rtol 2⁻⁷
    for bf16 (one bf16 ulp: both sides sum in f32 in other orders, then
    round), 0 for f32."""
    import torch

    y, y0 = got.float(), want.float()
    rtol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    bound = rtol * y0.abs() + 1e-5 * y0.abs().max()
    err = (y - y0).abs()
    return float(torch.where(err == 0, torch.zeros_like(err), err / bound).max())


def flash_bound(B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset, itemsize: int = 2):
    """(bytes, flops) flash attention must move and do: q, k, v and o each
    read or written once in ``itemsize`` bytes; both products at 2 flops per
    multiply-add over the (query, key) pairs these masks let through."""
    import torch

    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    seen = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        seen &= kp <= qp
    if window is not None:
        seen &= qp - kp < window
    nbytes = itemsize * hd * (2 * B * Hq * Sq + 2 * B * Hkv * Sk)
    return nbytes, 4 * B * Hq * int(seen.sum()) * hd


def flash_case(case, dtype, gen) -> dict:
    """Kernel against plain version on the card. y: |Δ| ≤ 2⁻⁷·|y| +
    1e-5·max|y| for bf16 (one bf16 ulp: both sides sum in f32 in other
    orders, then round), 1e-5·max|y| for f32. Times: the kernel, its plain
    version, and F.scaled_dot_product_attention (non-causal, the same shape;
    k and v repeated to Hq heads first where Hkv < Hq) as a yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK

    B, Hq, Hkv, Sq, Sk, hd, causal, window, q_offset = case
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v = rnd(B, Hq, Sq, hd), rnd(B, Hkv, Sk, hd), rnd(B, Hkv, Sk, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = FK.flash_attention_fwd(q, k, v, **kw)
    want = FK.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    units = ulp_units(got, want)
    r = {"B": B, "Hq": Hq, "Hkv": Hkv, "Sq": Sq, "Sk": Sk, "hd": hd, "causal": causal,
         "window": window, "q_offset": q_offset, "dtype": str(dtype).replace("torch.", ""),
         "max_abs_err": float((got.float() - want.float()).abs().max()),
         "err_in_tolerance_units": units, "max_abs_y": float(want.float().abs().max())}
    assert units <= 1.0 and bool(torch.isfinite(got).all()), r
    del got, want
    nbytes, flops = flash_bound(*case, itemsize=q.element_size())
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_OPS_PER_S * 1e3
    kr, vr = (k, v) if Hkv == Hq else (k.repeat_interleave(Hq // Hkv, 1),
                                       v.repeat_interleave(Hq // Hkv, 1))
    kernel_ms = time_ms(lambda: FK.flash_attention_fwd(q, k, v, **kw), reps=20, warmup=3)
    r.update(kernel_ms=kernel_ms,
             plain_ms=time_ms(lambda: FK.flash_attention_plain(q, k, v, **kw), reps=3),
             library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, kr, vr),
                                reps=20, warmup=3),
             bytes=nbytes, flops=flops, bytes_ms=bytes_ms, ops_ms=ops_ms,
             bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             bf16_tensor_core_ms=flops / BF16_TC_OPS_PER_S * 1e3,
             kernel_TFLOPs=flops / (kernel_ms * 1e-3) / 1e12)
    emit("flash_attention", **r)
    return r


def phase_flash_attention() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    encoder = flash_case(FLASH_ENCODER, torch.bfloat16, gen)
    for case in [FLASH_ENCODER] + FLASH_SMALL:
        for dtype in (torch.bfloat16, torch.float32):
            if (case, dtype) != (FLASH_ENCODER, torch.bfloat16):
                flash_case(case, dtype, gen)
    torch.cuda.empty_cache()
    return encoder


# ---------------------------------------------------------------------------
# Flash decode and RMSNorm, through their entry points
# ---------------------------------------------------------------------------


def entry_call(name: str, fn):
    """One call of an entry point as a user makes it, the launch counts zeroed
    just before and read just after: exactly one launch of ``name``. Returns
    the output and that count."""
    import torch

    torch.cuda.synchronize()
    zero_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = read_launches()
    assert launches == {n: int(n == name) for n in launches}, (name, launches)
    return out, launches[name]


def decode_bound(B, Hq, Hkv, S, hd, kv_len, window, itemsize: int = 2):
    """(bytes, flops) decode attention must move and do: q and o once, kv_len,
    and the key and value rows each batch row sees, once per kv head; both
    products at 2 flops per multiply-add for every query head."""
    seen = 0
    for n in kv_len:
        lo = 0 if window is None else max(0, n - window)
        seen += max(0, min(n, S) - lo)
    nbytes = itemsize * (2 * B * Hq * hd + 2 * seen * Hkv * hd) + 4 * B
    return nbytes, 4 * seen * Hq * hd


def _bound_fields(nbytes: int, flops: int, kernel_ms: float) -> dict:
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "kernel_GBps": nbytes / (kernel_ms * 1e-3) / 1e9}


def randn_cuda(shape, gen):
    import torch

    return torch.randn(shape, generator=gen, device="cuda")


def device_and_host(call) -> dict:
    """The device time of one call (its kernels under ``torch.profiler``) and
    the host's time to enqueue one, without waiting for the card: where the
    second is the larger, back-to-back calls (``kernel_ms``) wait on the host."""
    import torch

    prof = profile_device(call)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        call()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    return {"device_ms": prof["device_ms"], "device_kernels_ms": prof["top_kernels_ms"],
            "host_enqueue_ms": host_ms}


def _fill_randn(t, gen, rows: int) -> None:
    """Fill a bf16 tensor with randn in slices of ``rows`` along dim 0 (the
    f32 draw of the whole would need twice its size again)."""
    for i in range(0, t.shape[0], rows):
        t[i:i + rows] = randn_cuda(t[i:i + rows].shape, gen)


def decode_case(case, gen) -> dict:
    """One full-size decode layer: the entry point once (counted), its output
    against the plain version, then kernel, plain and SDPA times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import kernel as DK, ops

    name, B, Hq, Hkv, S, hd, window = case
    q = randn_cuda((B, 1, Hq, hd), gen).bfloat16()
    kc = torch.empty((B, S, Hkv, hd), dtype=torch.bfloat16, device="cuda")  # model layout
    vc = torch.empty_like(kc)
    _fill_randn(kc, gen, max(1, B // 16))
    _fill_randn(vc, gen, max(1, B // 16))
    kv_len = torch.full((B,), S, dtype=torch.int32, device="cuda")
    out, launches = entry_call("flash_decode",
                               lambda: ops.flash_decode(q, kc, vc, kv_len, window=window))
    k, v = kc.movedim(1, 2), vc.movedim(1, 2)  # (B, Hkv, S, hd) views of the caches
    n = min(B, DECODE_PLAIN_ROWS)
    want = DK.flash_decode_plain(q[:n, 0], k[:n], v[:n], kv_len[:n], window=window)
    torch.cuda.synchronize()
    units = ulp_units(out[:n, 0], want)
    err = float((out[:n, 0].float() - want.float()).abs().max())
    r = {"case": name, "B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "hd": hd, "window": window,
         "kv_len": S, "dtype": "bfloat16", "launches": launches, "compared_rows": n,
         "max_abs_err": err,
         "err_in_tolerance_units": units, "max_abs_y": float(want.float().abs().max()),
         "n_split": DK.n_splits(B, Hq, Hkv, S, window, DK.sm_count(0))}
    assert units <= 1.0 and bool(torch.isfinite(out).all()), r
    del out, want

    if window is None:
        lens = [kv_len]
    else:  # 16 windows in turn (67 MB together): no launch finds its keys in the 50 MB L2
        lens = [torch.full((B,), S - i * window, dtype=torch.int32, device="cuda")
                for i in range(16)]
    turn = iter(range(1 << 30))
    call = lambda: DK.flash_decode_fwd(q[:, 0], k, v, lens[next(turn) % len(lens)],  # noqa: E731
                                       window=window)
    kernel_ms = time_ms(call, reps=16, warmup=2)

    def plain_all_rows():  # the plain version over every row, DECODE_PLAIN_ROWS at a time
        for i in range(0, B, n):
            DK.flash_decode_plain(q[i:i + n, 0], k[i:i + n], v[i:i + n], kv_len[i:i + n],
                                  window=window)

    plain_ms = time_ms(plain_all_rows, reps=2, warmup=1)
    pos = torch.arange(S, device="cuda")[None]
    mask = pos < kv_len[:, None]
    if window is not None:
        mask &= pos > (kv_len - 1 - window)[:, None]
    qh = q.transpose(1, 2)  # (B, Hq, 1, hd)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qh, k, v, attn_mask=mask[:, None, None], enable_gqa=True)
    try:
        library_ms = time_ms(sdpa, reps=5, warmup=1)
        library_kernels = list(profile_device(sdpa)["top_kernels_ms"])[:3]
    except torch.cuda.OutOfMemoryError:
        library_ms, library_kernels = None, ["out of device memory"]
    nbytes, flops = decode_bound(B, Hq, Hkv, S, hd, [S] * B, window)
    r.update(kernel_ms=kernel_ms, **device_and_host(call), plain_ms=plain_ms,
             library_ms=library_ms, library_kernels=library_kernels,
             **_bound_fields(nbytes, flops, kernel_ms))
    emit("flash_decode", **r)
    del q, kc, vc, k, v, mask, lens
    gc.collect()
    torch.cuda.empty_cache()
    return r


def phase_flash_decode() -> dict:
    import torch
    from repro_torch.kernels.flash_decode import kernel as DK

    gen = torch.Generator(device="cuda").manual_seed(5)
    full = {case[0]: decode_case(case, gen) for case in DECODE_CASES}
    for B, Hq, Hkv, S, hd, kv_len, window in DECODE_SMALL:
        for dtype in (torch.bfloat16, torch.float32):
            q = randn_cuda((B, Hq, hd), gen).to(dtype)
            k, v = (randn_cuda((B, Hkv, S, hd), gen).to(dtype) for _ in range(2))
            kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
            got = DK.flash_decode_fwd(q, k, v, kl, window=window)
            want = DK.flash_decode_plain(q, k, v, kl, window=window)
            torch.cuda.synchronize()
            units = ulp_units(got, want)
            r = {"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "hd": hd, "kv_len": list(kv_len),
                 "window": window, "dtype": str(dtype).replace("torch.", ""),
                 "max_abs_err": float((got.float() - want.float()).abs().max()),
                 "err_in_tolerance_units": units}
            emit("flash_decode", **r)
            seen = torch.tensor([n > 0 and window != 0 for n in kv_len], device="cuda")
            assert units <= 1.0 and bool((got[~seen] == 0).all()), r
    return full


def rms_units(got, want) -> float:
    """Error in units of the tolerance: bf16 |Δ| ≤ one bf16 ulp of y; f32
    |Δ| ≤ 2e-6·|y| (the sum of squares taken in another order)."""
    import torch

    y, y0 = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        bound = torch.ldexp(torch.ones_like(y0), torch.frexp(y0.abs())[1] - 8)
    else:
        bound = 2e-6 * y0.abs()
    err = (y - y0).abs()
    return float(torch.where(err == 0, torch.zeros_like(err), err / bound).max())


def rms_case(name: str, R: int, D: int, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import kernel as RK, ops

    x = torch.empty((R, D), dtype=torch.bfloat16, device="cuda")
    _fill_randn(x, gen, 65536)
    scale = 1.0 + 0.1 * randn_cuda((D,), gen)
    y, launches = entry_call("rmsnorm", lambda: ops.rmsnorm(x, scale))
    want = RK.rmsnorm_plain(x, scale)
    torch.cuda.synchronize()
    units = rms_units(y, want)
    r = {"case": name, "R": R, "D": D, "dtype": "bfloat16", "launches": launches,
         "max_abs_err": float((y.float() - want.float()).abs().max()),
         "err_in_tolerance_units": units}
    assert units <= 1.0 and bool(torch.isfinite(y).all()), r
    del y, want
    call = lambda: RK.rmsnorm_fwd(x, scale)  # noqa: E731
    kernel_ms = time_ms(call, reps=10, warmup=2)
    plain_ms = time_ms(lambda: RK.rmsnorm_plain(x, scale), reps=3, warmup=1)
    scale_x = scale.to(x.dtype)  # F.rms_norm takes its weight in x's dtype
    library_ms = time_ms(lambda: F.rms_norm(x, (D,), scale_x, 1e-6), reps=10, warmup=2)
    nbytes, flops = 2 * R * D * x.element_size() + 4 * D, 4 * R * D
    r.update(kernel_ms=kernel_ms, **device_and_host(call), plain_ms=plain_ms,
             library_ms=library_ms, **_bound_fields(nbytes, flops, kernel_ms))
    emit("rmsnorm", **r)
    del x
    torch.cuda.empty_cache()
    return r


def phase_rmsnorm() -> dict:
    import torch
    from repro_torch.kernels.rmsnorm import kernel as RK

    gen = torch.Generator(device="cuda").manual_seed(6)
    full = {name: rms_case(name, R, D, gen) for name, R, D in RMS_CASES}
    for R, D in RMS_SMALL:
        for dtype in (torch.bfloat16, torch.float32):
            x = randn_cuda((R, D), gen).to(dtype)
            scale = 1.0 + 0.1 * randn_cuda((D,), gen)
            got, want = RK.rmsnorm_fwd(x, scale), RK.rmsnorm_plain(x, scale)
            torch.cuda.synchronize()
            r = {"R": R, "D": D, "dtype": str(dtype).replace("torch.", ""),
                 "max_abs_err": float((got.float() - want.float()).abs().max()),
                 "err_in_tolerance_units": rms_units(got, want)}
            emit("rmsnorm", **r)
            assert r["err_in_tolerance_units"] <= 1.0, r
    return full


def phase_serve_check() -> None:
    """Reduced mamba2-1.3b, photon-75m and whisper-large-v3 serve the same
    greedy tokens on the card (the SSD and flash kernels under use_pallas) and
    on the CPU (their plain versions), float32 compute, the same seed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    for arch in ("mamba2-1.3b", "photon-75m", "whisper-large-v3"):
        cfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype="float32")
        model = build_model(cfg)
        gen = torch.Generator().manual_seed(3)
        prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, dtype=torch.int32)
        audio = torch.randn((2, cfg.n_audio_frames, cfg.d_model), generator=gen) \
            if cfg.enc_dec else None
        out = {dev: generate(model, model.init(0, device=dev), prompt.to(dev), 8,
                             audio_embed=None if audio is None else audio.to(dev),
                             use_pallas=True).cpu() for dev in ("cpu", "cuda")}
        same = bool(torch.equal(out["cpu"], out["cuda"]))
        emit("check", serve=arch, tokens_cuda=out["cuda"][:, 40:].tolist(),
             tokens_cpu=out["cpu"][:, 40:].tolist(), same=same)
        assert same, arch


def rel_err(got, want) -> float:
    """max|got - want| / max|want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / float(want.abs().max())


def profile_device(fn) -> dict:
    """Device time of one call of ``fn`` under ``torch.profiler``, by kernel
    name (the eight longest), with the call's wall time under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}  # kernel names cut to 90 characters; kernels that share those add up
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": sum(by_name.values()), "profiled_wall_ms": wall_ms,
            "top_kernels_ms": dict(top)}


def _serve(model, params, prompt, use_pallas: bool, audio=None) -> dict:
    """``generate`` as a user calls it (the launch counts zeroed just before,
    read just after), then its two parts timed apart: one prefill, and the
    decode steps from that prefill's cache."""
    import torch
    from repro_torch.launch.serve import generate, merge

    B, S0 = prompt.shape
    batch = {"tokens": prompt} if audio is None else {"tokens": prompt, "audio_embed": audio}
    gc.collect()  # reference cycles of earlier phases may still hold device memory
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 1e9  # the weights and the inputs
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = generate(model, params, prompt, SERVE_GEN, audio_embed=audio, use_pallas=use_pallas)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, use_pallas=use_pallas)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = read_launches()
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    prefill_end = torch.cuda.memory_allocated() / 1e9  # + the prefill's cache and logits
    cache = merge(model.init_cache(B, S0 + SERVE_GEN, device=prompt.device), cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9  # weights and the grown cache
    t0 = time.perf_counter()
    for i in range(SERVE_GEN - 1):
        logits, cache = model.decode_step(params, cache, tok, S0 + i, use_pallas=use_pallas)
        tok = torch.argmax(logits[:, 0], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = read_launches()
    decode_peak = torch.cuda.max_memory_allocated() / 1e9
    assert tuple(out.shape) == (B, S0 + SERVE_GEN), out.shape
    assert bool(((out >= 0) & (out < model.cfg.vocab_size)).all())
    assert bool(torch.isfinite(logits).all())

    # where the time goes: device time per kernel, and the device's busy share
    # of the unprofiled wall time (prefill; one decode step)
    prof_prefill = profile_device(lambda: model.prefill(params, batch, use_pallas=use_pallas))
    prof_decode = profile_device(
        lambda: model.decode_step(params, cache, tok, S0 + SERVE_GEN - 1, use_pallas=use_pallas))
    step_ms = decode_s / (SERVE_GEN - 1) * 1e3
    return {"generate_s": generate_s, "prefill_s": prefill_s, "decode_s": decode_s,
            "prefill_tokens_per_s": B * S0 / prefill_s,
            "decode_tokens_per_s": B * (SERVE_GEN - 1) / decode_s, "decode_step_ms": step_ms,
            "resident_mem_GB": resident, "peak_mem_GB": peak, "prefill_peak_mem_GB": prefill_peak,
            "prefill_end_mem_GB": prefill_end,
            "decode_start_mem_GB": held, "decode_peak_mem_GB": decode_peak,
            "launches": launches, "prefill_launches": prefill_launches,
            "decode_launches": decode_launches, "tokens": out[:, S0:].tolist(),
            "prefill_device_busy_share": prof_prefill["device_ms"] / (prefill_s * 1e3),
            "decode_device_busy_share": prof_decode["device_ms"] / step_ms,
            "prefill_profile": prof_prefill, "decode_step_profile": prof_decode}


def phase_serve_mamba2() -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config("mamba2-1.3b")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    assert cfg.n_layers == MAMBA2_LAYERS and cfg.d_model == 2048
    t0 = time.perf_counter()
    params = build_model(cfg).init(0, device="cuda")
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SSD_SHAPE["S"]), generator=gen,
                           dtype=torch.int32).cuda()
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_params=n_params, param_count=cfg.param_count(), init_s=init_s)

    # use_pallas against the plain path on the card, float32 then bf16 compute
    for c in (cfg32, cfg):
        model = build_model(c)
        lk, ck = model.prefill(params, {"tokens": prompt}, use_pallas=True)
        lp, cp = model.prefill(params, {"tokens": prompt}, use_pallas=False)
        torch.cuda.synchronize()
        scale = float(lp.float().abs().max())
        logit_err = float((lk.float() - lp.float()).abs().max())
        cache_err = {name: rel_err(ck[0]["pos0"]["mixer"][name], cp[0]["pos0"]["mixer"][name])
                     for name in ("conv", "ssd")}
        same_tokens = bool(torch.equal(torch.argmax(lk[:, -1], -1), torch.argmax(lp[:, -1], -1)))
        r = {"compute_dtype": c.compute_dtype, "logits_max_abs_err": logit_err,
             "logits_max_abs": scale, "logits_rel_err": logit_err / scale,
             "cache_rel_err": cache_err, "same_greedy_tokens": same_tokens}
        emit("serve", arch=cfg.name, check="prefill use_pallas vs plain", **r)
        assert all(math.isfinite(v) for v in (logit_err, *cache_err.values())), r
        if c.compute_dtype == "float32":
            # 48 layers of f32 sums that the kernel and the einsum chain may
            # take in other orders (on the H100 with cuBLAS's f32 GEMMs both
            # run one FMA chain per output in k order, and they agree bitwise)
            assert logit_err <= 1e-4 * scale, r
            assert max(cache_err.values()) <= 1e-4, r
        del lk, ck, lp, cp
        torch.cuda.empty_cache()

    model = build_model(cfg)
    r = _serve(model, params, prompt, use_pallas=True)
    emit("serve", arch=cfg.name, batch=SERVE_BATCH, prompt=SSD_SHAPE["S"], new_tokens=SERVE_GEN,
         use_pallas=True, **r)
    others = {n: 0 for n in r["launches"] if n != "ssd_scan"}
    assert r["launches"] == {"ssd_scan": MAMBA2_LAYERS, **others}, r["launches"]
    assert r["prefill_launches"] == {"ssd_scan": MAMBA2_LAYERS, **others}, r
    assert r["decode_launches"] == {"ssd_scan": 0, **others}, r
    del params
    torch.cuda.empty_cache()
    return r


def phase_serve_photon() -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("photon-75m")
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PHOTON_PROMPT), generator=gen,
                           dtype=torch.int32).cuda()
    r = _serve(model, params, prompt, use_pallas=False)
    emit("serve", arch=cfg.name, batch=SERVE_BATCH, prompt=PHOTON_PROMPT, new_tokens=SERVE_GEN,
         use_pallas=False, **r)
    for launches in (r["launches"], r["prefill_launches"], r["decode_launches"]):
        assert all(v == 0 for v in launches.values()), launches
    del params
    torch.cuda.empty_cache()
    return r


def phase_serve_whisper() -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config("whisper-large-v3")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    assert cfg.n_encoder_layers == WHISPER_LAYERS and cfg.d_model == 1280
    t0 = time.perf_counter()
    params = build_model(cfg).init(0, device="cuda")
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, WHISPER_PROMPT), generator=gen,
                           dtype=torch.int32).cuda()
    audio = torch.randn((SERVE_BATCH, cfg.n_audio_frames, cfg.d_model), generator=gen).cuda()
    batch = {"tokens": prompt, "audio_embed": audio}
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, n_encoder_layers=cfg.n_encoder_layers,
         d_model=cfg.d_model, n_params=n_params, param_count=cfg.param_count(), init_s=init_s)
    assert n_params == 1_578_803_200, n_params

    # use_pallas against the plain path on the card, float32 then bf16 compute
    for c in (cfg32, cfg):
        model = build_model(c)
        lk, ck = model.prefill(params, batch, use_pallas=True)
        lp, cp = model.prefill(params, batch, use_pallas=False)
        torch.cuda.synchronize()
        scale = float(lp.float().abs().max())
        logit_err = float((lk.float() - lp.float()).abs().max())
        cache_err = {name: rel_err(ck[0]["pos0"][name]["k"], cp[0]["pos0"][name]["k"])
                     for name in ("mixer", "cross")}
        same = int((torch.argmax(lk[:, -1], -1) == torch.argmax(lp[:, -1], -1)).sum())
        r = {"compute_dtype": c.compute_dtype, "logits_max_abs_err": logit_err,
             "logits_max_abs": scale, "logits_rel_err": logit_err / scale,
             "cache_rel_err": cache_err, "same_next_tokens": same, "of": SERVE_BATCH}
        emit("serve", arch=cfg.name, check="prefill use_pallas vs plain", **r)
        assert all(math.isfinite(v) for v in (logit_err, *cache_err.values())), r
        if c.compute_dtype == "float32":
            # 32 encoder layers whose attention the kernel sums in another order
            # than the einsums, then 32 decoder layers on that output
            assert logit_err <= 1e-4 * scale, r
            assert max(cache_err.values()) <= 1e-4, r
        del lk, ck, lp, cp
        torch.cuda.empty_cache()

    model = build_model(cfg)
    plain = generate(model, params, prompt, SERVE_GEN, audio_embed=audio).cpu()
    r = _serve(model, params, prompt, use_pallas=True, audio=audio)
    agree = int((torch.tensor(r["tokens"]) == plain[:, WHISPER_PROMPT:]).sum())
    emit("serve", arch=cfg.name, batch=SERVE_BATCH, prompt=WHISPER_PROMPT,
         audio_frames=cfg.n_audio_frames, new_tokens=SERVE_GEN, use_pallas=True,
         bf16_tokens_agreeing_with_plain_path=agree, of=SERVE_BATCH * SERVE_GEN, **r)
    others = {n: 0 for n in r["launches"] if n != "flash_attention"}
    assert r["launches"] == {"flash_attention": WHISPER_LAYERS, **others}, r["launches"]
    assert r["prefill_launches"] == {"flash_attention": WHISPER_LAYERS, **others}, r
    assert r["decode_launches"] == {"flash_attention": 0, **others}, r
    del params
    torch.cuda.empty_cache()
    return r


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.fedcore import kernel  # noqa: F401  (fails outside a checkout)

    # float32 products in full float32 (the plain versions' and the checks' numerics)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    phase_build()
    sa = phase_server_apply()
    codecs = phase_codecs()
    ssd = phase_ssd_scan()
    flash = phase_flash_attention()
    decode = phase_flash_decode()
    rms = phase_rmsnorm()
    phase_check()
    phase_serve_check()
    launches = {uplink: phase_train(uplink) for uplink in TRAIN_KERNELS}
    mamba2 = phase_serve_mamba2()
    phase_serve_photon()
    whisper = phase_serve_whisper()

    main_case = sa[("fedavg", False)]  # the main path: FedAvg, no DP noise, C = 4
    kernels = [{
        "name": "server_apply",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fedcore_server_apply.cu",
        "replaces": "src/repro/kernels/fedcore/kernel.py:141",
        "launches": launches["float32"]["server_apply"],
        "max_abs_err": main_case["max_abs_err_params"],
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the fused mean + update + norms",
    }]
    for name, uplink, line, note in CODEC_KERNELS:
        r = codecs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/fedcore_codecs.cu",
            "replaces": f"src/repro/kernels/fedcore/kernel.py:{line}",
            "launches": launches[uplink][name], "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "library_note": note,
        })
    kernels.append({
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:88",
        "launches": mamba2["launches"]["ssd_scan"], "max_abs_err": ssd["max_abs_err_y"],
        "ms": ssd["kernel_ms"], "plain_ms": ssd["plain_ms"], "bound_ms": ssd["bound_ms"],
        "bound_by": ssd["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes the SSD chunk scan",
    })
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
        "launches": whisper["launches"]["flash_attention"], "max_abs_err": flash["max_abs_err"],
        "ms": flash["kernel_ms"], "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "library_note": "F.scaled_dot_product_attention at the encoder layer's shape",
    })
    for name, line, full, source, note in (
            ("flash_decode", 75, decode, "flash_decode.cu",
             "F.scaled_dot_product_attention, boolean mask, enable_gqa=True"),
            ("rmsnorm", 28, rms, "rmsnorm.cu", "F.rms_norm, weight in x's dtype")):
        head = next(iter(full.values()))  # the largest case
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{name}/kernel.py:{line}",
            # the entry-point calls' counts: no model path calls it
            "launches": sum(r["launches"] for r in full.values()),
            "max_abs_err": max(r["max_abs_err"] for r in full.values()),
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library_note": note, "case": head["case"],
            "cases": [{k: r[k] for k in ("case", "kernel_ms", "device_ms", "host_enqueue_ms",
                                         "bound_ms", "plain_ms", "library_ms")}
                      for r in full.values()],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
