#!/usr/bin/env python3
"""Time the PyTorch port's redesigned kernels from several checkouts, in
turns, on one NVIDIA GPU.

    python3 tools/kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example the parent commit
unpacked with ``git archive`` next to the working tree). Every ROOT runs in a
process of its own, in the order given, so list them as parent, change,
change, parent to see the spread. Each prints one JSON line:

  device ms     CUDA events over back-to-back calls (after a warm-up):
                ``ssd_scan_fwd`` at mamba2-1.3b's per-layer prefill shape
                (B 4, S 2048, nh 64, hd 64, G 1, ds 128, chunk 64) in bf16
                and f32; ``flash_decode_fwd`` at qwen3-1.7b's decode_32k
                layer (B 128, Hq 16, Hkv 8, S 32768, hd 128, bf16, the cache
                read through the model layout's strides) beside
                F.scaled_dot_product_attention on the same views
  host ms       the host's time to enqueue one call without waiting for the
                card, as ``chip_smoke.py`` reads it (the mean of 20 calls),
                taken five times in a row (all five are printed):
                ``flash_decode_fwd`` with a (B,) kv_len tensor and
                ``ops.flash_decode`` with an int and with a tensor kv_len at
                gemma3-4b's long_500k local layer (B 1, Hq 8, Hkv 4,
                S 524288, hd 256, window 1024); ``flash_attention_fwd`` at
                whisper-large-v3's encoder layer (B 4, H 20, S 1500, hd 64,
                bf16); ``ssd_scan_fwd`` bf16 at the shape above

The inputs are drawn on the card from fixed seeds. The card's name and
power limit are printed first. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def timed(fn, reps: int, warmup: int) -> float:
    """Device ms per call: CUDA events around ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, readings: int = 5) -> list:
    """Host ms to enqueue one call (the mean of 20 calls, no wait for the
    card), ``readings`` times in a row."""
    import torch

    fn()
    out = []
    for _ in range(readings):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        out.append((time.perf_counter() - t0) / 20 * 1e3)
    torch.cuda.synchronize()
    return out


def run_one(root: str) -> dict:
    """Time the kernels of the checkout at ``root`` (in this process)."""
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_decode import kernel as DK, ops as DO
    from repro_torch.kernels.ssd_scan import kernel as SK

    out = {"root": root}
    gen = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    B, S, nh, hd, G, ds = 4, 2048, 64, 64, 1, 128
    for dtype in (torch.bfloat16, torch.float32):
        x = rnd(B, nh, S, hd).to(dtype)
        dt = F.softplus(rnd(B, nh, S) - 1.0)
        A = -torch.exp(0.5 * rnd(nh))
        Bm, Cm = rnd(B, G, S, ds).to(dtype), rnd(B, G, S, ds).to(dtype)
        init = 0.1 * rnd(B, nh, hd, ds)
        ssd = lambda: SK.ssd_scan_fwd(x, dt, A, Bm, Cm, init, chunk=64)  # noqa: E731
        name = str(dtype)[6:]
        out[f"ssd_scan_{name}_ms"] = timed(ssd, 20, 3)
        if dtype == torch.bfloat16:
            out["ssd_scan_bfloat16_host_ms"] = host_ms(ssd)
        del x, Bm, Cm
    torch.cuda.empty_cache()

    B, Hq, Hkv, S, hd = 128, 16, 8, 32768, 128
    q = rnd(B, Hq, hd).bfloat16()
    kc = torch.empty((B, S, Hkv, hd), dtype=torch.bfloat16, device="cuda")
    vc = torch.empty_like(kc)
    for i in range(0, B, 8):
        kc[i:i + 8] = rnd(8, S, Hkv, hd)
        vc[i:i + 8] = rnd(8, S, Hkv, hd)
    k, v = kc.movedim(1, 2), vc.movedim(1, 2)
    kv_len = torch.full((B,), S, dtype=torch.int32, device="cuda")
    sdpa = lambda: F.scaled_dot_product_attention(q[:, :, None], k, v,  # noqa: E731
                                                  enable_gqa=True)
    out["sdpa_ms"] = timed(sdpa, 10, 2)
    out["flash_decode_ms"] = timed(lambda: DK.flash_decode_fwd(q, k, v, kv_len), 10, 2)
    out["sdpa_again_ms"] = timed(sdpa, 10, 2)
    del q, kc, vc, k, v
    torch.cuda.empty_cache()

    B, Hq, Hkv, S, hd, window = 1, 8, 4, 524288, 256, 1024
    q = rnd(B, 1, Hq, hd).bfloat16()
    kc = rnd(B, S, Hkv, hd).bfloat16()
    vc = rnd(B, S, Hkv, hd).bfloat16()
    k, v = kc.movedim(1, 2), vc.movedim(1, 2)
    kv_len = torch.full((B,), S, dtype=torch.int32, device="cuda")
    out["flash_decode_fwd_tensor_kv_len_host_ms"] = host_ms(
        lambda: DK.flash_decode_fwd(q[:, 0], k, v, kv_len, window=window))
    out["ops_flash_decode_int_kv_len_host_ms"] = host_ms(
        lambda: DO.flash_decode(q, kc, vc, S, window=window))
    out["ops_flash_decode_tensor_kv_len_host_ms"] = host_ms(
        lambda: DO.flash_decode(q, kc, vc, kv_len, window=window))
    del q, kc, vc, k, v
    torch.cuda.empty_cache()

    q, k, v = (rnd(4, 20, 1500, 64).bfloat16() for _ in range(3))
    out["flash_attention_host_ms"] = host_ms(lambda: FK.flash_attention_fwd(q, k, v))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the child process: one root
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    if args.one is not None:
        print(json.dumps(run_one(args.one)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              timeout=900)
        if proc.returncode:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
