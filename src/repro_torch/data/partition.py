"""The paper's heterogeneous data partitioner (§6.2.1).

Each heterogeneous dataset is first partitioned by *category* (Pile source / mC4
language), then each category is split into J × |C| disjoint *buckets*, where |C| is the
number of clients and J the maximum number of categories a client may draw upon. Each
bucket maps to AT MOST ONE client, so two clients drawing from the same category always
sample disjoint data. This implements that exact bookkeeping plus the IID fallback.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.streams import MixedStream, SyntheticCategoryStream, TokenStream

# The Pile categories used in the paper's heterogeneous experiments (§6.3).
PILE_CATEGORIES = [
    "Wikipedia(en)",
    "ArXiv",
    "PG-19",
    "HackerNews",
    "PubMedCentral",
    "FreeLaw",
    "PhilPapers",
    "StackExchange",
]


@dataclass(frozen=True)
class BucketAssignment:
    category: int
    bucket: int  # bucket index within the category (globally unique per category)


def make_heterogeneous_partition(
    n_clients: int,
    n_categories: int,
    j_max: int,
    seed: int = 0,
) -> List[List[BucketAssignment]]:
    """Assign each client up to ``j_max`` category-buckets. Buckets are never shared:
    category c has J×|C| buckets; a bucket is consumed by at most one client."""
    rng = np.random.default_rng(seed)
    next_free = np.zeros(n_categories, np.int64)  # next unassigned bucket per category
    n_buckets = j_max * n_clients
    assignments: List[List[BucketAssignment]] = []
    for _ in range(n_clients):
        cats = rng.choice(n_categories, size=min(j_max, n_categories), replace=False)
        client: List[BucketAssignment] = []
        for c in cats:
            b = int(next_free[c])
            if b >= n_buckets:
                continue  # category exhausted (cannot happen for j_max*|C| buckets)
            next_free[c] += 1
            client.append(BucketAssignment(category=int(c), bucket=b))
        assignments.append(client)
    return assignments


def validate_disjoint(assignments: Sequence[Sequence[BucketAssignment]]) -> bool:
    seen = set()
    for client in assignments:
        for a in client:
            key = (a.category, a.bucket)
            if key in seen:
                return False
            seen.add(key)
    return True


def build_client_streams(
    n_clients: int,
    seq_len: int,
    vocab_size: int,
    *,
    heterogeneous: bool,
    n_categories: int = len(PILE_CATEGORIES),
    j_max: int = 1,
    seed: int = 0,
) -> List[TokenStream]:
    """Materialize one stream per client.

    IID mode (paper's C4 experiments): every client draws from the same distribution
    but from disjoint buckets. Heterogeneous (Pile) mode: clients draw from distinct
    category buckets via the J×|C| partitioner.
    """
    if not heterogeneous:
        return [
            SyntheticCategoryStream(
                seq_len, vocab_size, category=0, bucket=i, n_categories=1
            )
            for i in range(n_clients)
        ]
    assignments = make_heterogeneous_partition(n_clients, n_categories, j_max, seed)
    assert validate_disjoint(assignments)
    streams: List[TokenStream] = []
    for ci, client in enumerate(assignments):
        subs = [
            SyntheticCategoryStream(
                seq_len, vocab_size, category=a.category, bucket=a.bucket,
                n_categories=n_categories,
            )
            for a in client
        ]
        streams.append(subs[0] if len(subs) == 1 else MixedStream(subs, seed=seed + ci))
    return streams


def validation_stream(seq_len: int, vocab_size: int, heterogeneous: bool,
                      n_categories: int = len(PILE_CATEGORIES)) -> TokenStream:
    """Held-out split: the validation bucket is a reserved bucket id (2**20) no client
    can be assigned, preserving the paper's held-out guarantee (§4.2)."""
    if not heterogeneous:
        return SyntheticCategoryStream(seq_len, vocab_size, category=0,
                                       bucket=1 << 20, n_categories=1)
    subs = [
        SyntheticCategoryStream(seq_len, vocab_size, category=c, bucket=1 << 20,
                                n_categories=n_categories)
        for c in range(n_categories)
    ]
    return MixedStream(subs, seed=12345)
