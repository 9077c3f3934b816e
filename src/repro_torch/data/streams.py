"""Streaming data sources — the Photon Data Source abstraction.

A ``TokenStream`` continuously yields fixed-length token sequences and carries a
resumable cursor (the paper's client checkpoints track the data-loading index state,
§4.1). Streams compose: a client binds one or more streams (``MixedStream``), matching
Photon's "clients draw upon arbitrary data streams with full control over sampling"
(§5.2). Synthetic category-structured generators stand in for the
C4 / Pile shard files so that every pipeline stage is runnable offline; a file-backed
stream reads pre-tokenized .npy shards with identical semantics.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class StreamState:
    cursor: int = 0
    epoch: int = 0


class TokenStream:
    """Base: infinite stream of (seq_len,) int32 token sequences with resumable state."""

    def __init__(self, seq_len: int):
        self.seq_len = seq_len
        self.state = StreamState()

    def next_batch(self, batch_size: int) -> np.ndarray:
        out = np.stack([self._next_seq() for _ in range(batch_size)])
        return out.astype(np.int32)

    def _next_seq(self) -> np.ndarray:
        raise NotImplementedError

    # --- checkpointing -------------------------------------------------
    def state_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: dict) -> None:
        self.state = StreamState(**d)


class SyntheticCategoryStream(TokenStream):
    """Category-conditioned synthetic language: each category has its own Zipfian
    unigram distribution over a vocabulary slice plus a small Markov structure, giving
    learnable, *statistically heterogeneous* data (different categories model the
    paper's Pile subsets: Wikipedia / ArXiv / PG-19 / ...).

    Deterministic in (category, bucket, cursor) — replaying from a checkpointed cursor
    reproduces the exact byte stream, like a seekable MosaicML StreamingDataset shard.
    """

    def __init__(
        self,
        seq_len: int,
        vocab_size: int,
        category: int,
        bucket: int = 0,
        n_categories: int = 8,
        zipf_a: float = 1.2,
    ):
        super().__init__(seq_len)
        self.vocab_size = vocab_size
        self.category = category
        self.bucket = bucket
        self.n_categories = n_categories
        # category-specific vocabulary emphasis blended with a shared core — natural
        # text domains overlap heavily (function words) while differing in topical
        # vocabulary; fully disjoint vocabularies would overstate heterogeneity.
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        base = ranks ** (-zipf_a)
        base /= base.sum()
        shift = (category * vocab_size) // max(1, n_categories)
        specific = np.roll(base, shift)
        self._probs = 0.55 * base + 0.45 * specific
        self._probs /= self._probs.sum()

    def _next_seq(self) -> np.ndarray:
        seed = np.random.SeedSequence(
            [self.category, self.bucket, self.state.epoch, self.state.cursor]
        )
        rng = np.random.default_rng(seed)
        self.state.cursor += 1
        toks = rng.choice(self.vocab_size, size=self.seq_len, p=self._probs)
        # light Markov structure: every other token correlates with its predecessor
        toks[1::2] = (toks[0::2][: len(toks[1::2])] + self.category + 1) % self.vocab_size
        return toks


class FileShardStream(TokenStream):
    """Reads pre-tokenized shards (one flat .npy of int32 tokens per shard file)."""

    def __init__(self, seq_len: int, shard_paths: Sequence[str]):
        super().__init__(seq_len)
        if not shard_paths:
            raise ValueError("FileShardStream needs at least one shard")
        self.shard_paths = list(shard_paths)
        self._shards = [np.load(p, mmap_mode="r") for p in self.shard_paths]
        self._sizes = [len(s) // seq_len for s in self._shards]
        self._total = sum(self._sizes)

    def _next_seq(self) -> np.ndarray:
        i = self.state.cursor % self._total
        self.state.cursor += 1
        if self.state.cursor % self._total == 0:
            self.state.epoch += 1
        for shard, n in zip(self._shards, self._sizes):
            if i < n:
                return np.asarray(shard[i * self.seq_len : (i + 1) * self.seq_len])
            i -= n
        raise AssertionError


class MixedStream(TokenStream):
    """A client's merged data stream (Algorithm 1, L.13 BindStream): samples among the
    bound sub-streams with given weights; deterministic in the cursor."""

    def __init__(self, streams: List[TokenStream], weights: Optional[Sequence[float]] = None, seed: int = 0):
        assert streams
        super().__init__(streams[0].seq_len)
        self.streams = streams
        w = np.asarray(weights if weights is not None else [1.0] * len(streams), np.float64)
        self.weights = w / w.sum()
        self.seed = seed

    def _next_seq(self) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.state.cursor]))
        self.state.cursor += 1
        idx = rng.choice(len(self.streams), p=self.weights)
        return self.streams[idx]._next_seq()

    def state_dict(self) -> dict:
        return {
            "cursor": self.state.cursor,
            "epoch": self.state.epoch,
            "sub": [s.state_dict() for s in self.streams],
        }

    def load_state_dict(self, d: dict) -> None:
        self.state = StreamState(cursor=d["cursor"], epoch=d["epoch"])
        for s, sd in zip(self.streams, d["sub"]):
            s.load_state_dict(sd)


def round_batches(
    streams: List[TokenStream], tau: int, per_client_batch: int
) -> Dict[str, np.ndarray]:
    """Materialize one federated round's batches: tokens (τ, C, B, S)."""
    c = len(streams)
    seq = streams[0].seq_len
    out = np.empty((tau, c, per_client_batch, seq), np.int32)
    for ci, s in enumerate(streams):
        for t in range(tau):
            out[t, ci] = s.next_batch(per_client_batch)
    return {"tokens": out}
