"""Model FLOPs of a training step, frozen here so that no change to the
program can change what a FLOP is: 6 for each weight a token's forward and
backward products use (a tied embedding counted once, as the output head; the
vocabulary's padding rows not at all), plus 6·S·width per causal attention
layer for its score and value products (half of the full S×S block). Each
family counts its own (``flops_per_token`` of ``families/<family>.py``).
Recomputation is not counted, and neither is a scan that is not a product of
weights, such as Mamba-2's SSD."""
from __future__ import annotations

from reference.layout import family


def causal_attention_flops_per_token(n_layers: int, seq_len: int, width: int) -> int:
    """The score and value products of ``n_layers`` causal attention layers
    of ``width`` query channels (heads × head size)."""
    return 6 * n_layers * seq_len * width


def train_flops(cfg: dict, tokens: int, seq_len: int) -> int:
    """Model FLOPs of a forward and backward pass over ``tokens`` tokens in
    sequences of ``seq_len``."""
    return family(cfg).flops_per_token(cfg, seq_len) * tokens
