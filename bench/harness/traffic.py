"""The one generator of training traffic: each round's tokens (τ, C, B, S),
drawn on the card from ``--seed`` and the round.

The language is a frozen copy of the category-structured synthetic stream the
Photon repository trains on offline: each category has a Zipfian unigram
distribution over the vocabulary (exponent ``zipf_a``) blended 55/45 with the
same distribution rotated by ``category·V/n_categories``, and every odd
position repeats its predecessor shifted by ``category + 1``. Slot c of round r
draws from category ``(seed + r·C + c) mod n_categories``, so every seed and
round has the same sizes and only the text differs.
"""
from __future__ import annotations

import numpy as np
import torch


def _mix(*words: int) -> int:
    h = 0x6A09E667F3BCC909
    for w in words:
        h = (h ^ (int(w) & ((1 << 64) - 1))) * 0x100000001B3 % (1 << 64)
    return h % (1 << 63)


class Traffic:
    def __init__(self, traffic: dict, vocab_size: int, seed: int, device):
        data = traffic["data"]
        self.tau, self.clients = traffic["local_steps"], traffic["clients_per_round"]
        self.batch, self.seq_len = traffic["batch"], traffic["seq_len"]
        self.n_cat, self.vocab, self.seed, self.device = data["n_categories"], vocab_size, seed, device
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        base = ranks ** (-float(data["zipf_a"]))
        base /= base.sum()
        cdfs = []
        for cat in range(self.n_cat):
            p = 0.55 * base + 0.45 * np.roll(base, cat * vocab_size // self.n_cat)
            cdfs.append(np.cumsum(p / p.sum()))
        self.cdf = torch.tensor(np.stack(cdfs), dtype=torch.float64, device=device)

    def tokens_per_round(self) -> int:
        return self.tau * self.clients * self.batch * self.seq_len

    def category(self, rnd: int, slot: int) -> int:
        return (self.seed + rnd * self.clients + slot) % self.n_cat

    def round_tokens(self, rnd: int) -> torch.Tensor:
        """Round ``rnd``'s tokens, int32 (τ, C, B, S) on the card."""
        gen = torch.Generator(device=self.device).manual_seed(_mix(self.seed, rnd))
        shape = (self.tau, self.batch, self.seq_len)
        out = torch.empty((self.tau, self.clients) + shape[1:], dtype=torch.int32,
                          device=self.device)
        for c in range(self.clients):
            cat = self.category(rnd, c)
            u = torch.rand(shape, generator=gen, dtype=torch.float64, device=self.device)
            tok = torch.searchsorted(self.cdf[cat], u.reshape(-1)).clamp_(max=self.vocab - 1)
            tok = tok.reshape(shape)
            tok[..., 1::2] = (tok[..., 0::2][..., : self.seq_len // 2] + cat + 1) % self.vocab
            out[:, c] = tok
        return out
