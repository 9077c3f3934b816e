"""Batched serving example, the port of ``examples/serve_batched.py``: prefill +
greedy decode with a KV/SSM cache across three architecture families (dense
GQA, Mamba2/SSD, sliding-window), each reduced, through
``repro_torch.launch.serve.generate`` with the reference's prompts.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched               # on the card
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.serve import generate
from repro_torch.models import build_model

ARCHS = ["qwen3-1.7b", "mamba2-1.3b", "gemma3-4b"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    device = resolve_device(parse_args(argv).device)
    rng = np.random.RandomState(0)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params = model.init(0, device=device)
        prompt = torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (2, 24)).astype(np.int32)
        ).to(device)
        t0 = time.time()
        out = generate(model, params, prompt, max_new=8).cpu()  # waits for the device
        dt = time.time() - t0
        print(f"{arch:14s} [{cfg.family:6s}] generated {out.shape[1]-24} tokens/seq "
              f"x{out.shape[0]} in {dt:.1f}s -> {out[0, -8:].tolist()}")


if __name__ == "__main__":
    main()
