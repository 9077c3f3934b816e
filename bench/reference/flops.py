"""Model FLOPs of a training step, frozen here so that no change to the
program can change what a FLOP is: 6·N·T for the weights' forward and
backward products, with N every parameter (the tied embedding counted once,
as the output head; the embedding's padding rows not at all) and T the
tokens, plus 6·L·S·d·T for causal attention's score and value products (half
of the full S×S block). Recomputation is not counted, and neither is the SSD
scan of Mamba-2, which is not a product of weights."""
from __future__ import annotations

from reference.layout import n_params


def attention_flops_per_token(cfg: dict, seq_len: int) -> int:
    if cfg["family"] != "photon":
        return 0
    return 6 * cfg["n_layers"] * seq_len * cfg["d_model"]


def train_flops(cfg: dict, tokens: int, seq_len: int) -> int:
    """Model FLOPs of a forward and backward pass over ``tokens`` tokens in
    sequences of ``seq_len``."""
    return (6 * n_params(cfg) + attention_flops_per_token(cfg, seq_len)) * tokens
