"""Serving entry point: prefill + batched greedy decode with the KV/SSM cache, the
counterpart of ``repro.launch.serve``. The run is on ``cuda`` unless
``--device cpu`` is given; asking for cuda where there is none is an error,
never a silent fall back.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --reduced \\
      --batch 2 --prompt-len 32 --gen 16 --device cpu

An encoder-decoder model (whisper-large-v3) also takes audio frame
embeddings: ``generate(..., audio_embed=)`` hands them to the prefill, which
runs the encoder and writes each decoder layer's cross-attention cache; the
CLI draws them with ``randn`` from the seed's generator, as the reference's.

``generate(..., use_pallas=True)`` sends the prefill of every SSM layer
through the CUDA chunk-scan kernel (``kernels/ssd_scan``) and every self-
attention of whisper's encoder through the CUDA flash-attention kernel
(``kernels/flash_attention``), as the reference's
``model.prefill(p, b, use_pallas=True)`` sends them to its Pallas kernels;
decode steps run neither. The CLI, like the reference's, leaves
``use_pallas`` off.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model


def merge(dst, src):
    """``src`` (the prefill cache) in ``dst``'s layout: each leaf cast to
    ``dst``'s dtype and zero-padded at the end of every axis to its shape."""
    if isinstance(dst, dict):
        return {k: merge(dst[k], src[k]) if k in src else dst[k] for k in dst}
    if isinstance(dst, list):
        return [merge(d, s) for d, s in zip(dst, src)]
    src = src.to(dst.dtype)
    if dst.shape != src.shape:
        pad = [p for d, s in zip(reversed(dst.shape), reversed(src.shape)) for p in (0, d - s)]
        src = F.pad(src, pad)
    return src


@torch.no_grad()
def generate(model, params, prompt_tokens: torch.Tensor, max_new: int, *,
             audio_embed: Optional[torch.Tensor] = None,
             use_pallas: bool = False) -> torch.Tensor:
    """Greedy decode. prompt_tokens: (B, S0). Returns (B, S0+max_new)."""
    B, S0 = prompt_tokens.shape
    batch = {"tokens": prompt_tokens}
    if audio_embed is not None:
        batch["audio_embed"] = audio_embed
    logits, cache = model.prefill(params, batch, use_pallas=use_pallas)

    # grow attention caches to S0 + max_new
    full = model.init_cache(B, S0 + max_new, dtype=torch.bfloat16, device=prompt_tokens.device)
    cache = merge(full, cache)

    tokens = [torch.argmax(logits[:, -1], -1).to(torch.int32)]
    out = prompt_tokens
    for i in range(max_new):
        tok = tokens[-1][:, None]
        out = torch.cat([out, tok.to(out.dtype)], dim=1)
        if i == max_new - 1:
            break
        logits, cache = model.decode_step(params, cache, tok, S0 + i, use_pallas=use_pallas)
        tokens.append(torch.argmax(logits[:, 0], -1).to(torch.int32))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    rng = np.random.RandomState(args.seed)
    prompt = torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(device)
    audio = None
    if cfg.enc_dec:
        audio = torch.from_numpy(
            rng.randn(args.batch, cfg.n_audio_frames, cfg.d_model).astype(np.float32)
        ).to(device)
    t0 = time.perf_counter()
    out = generate(model, params, prompt, args.gen, audio_embed=audio).cpu()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", out[0, -args.gen:].tolist())
    print("device:", torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")


if __name__ == "__main__":
    main()
