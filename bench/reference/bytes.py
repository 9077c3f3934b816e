"""Least bytes the federated kernels must move, frozen here: each input read
once and each output written once, in float32 (4 B) and int8 (1 B).

- ``server_apply`` over a (C, Np) delta buffer with an outer optimiser of
  ``lanes`` state lanes (FedAvg 0, FedMom 1, FedAdam 2): reads the C deltas,
  the params and the lanes, writes the params and the lanes:
  4·Np·(C + 2 + 2·lanes).
- ``int8_quant``: reads C·Np float32, writes C·Np int8; ``int8_dequant`` the
  reverse: 5·C·Np each.

Np is the flat buffer's length: the parameter count padded to a multiple of
8192, the block of the program's flat layout."""
from __future__ import annotations

from reference.layout import n_params

FLAT_BLOCK = 8192
OUTER_LANES = {"fedavg": 0, "fedmom": 1, "fedadam": 2}


def flat_len(n: int) -> int:
    return (n + FLAT_BLOCK - 1) // FLAT_BLOCK * FLAT_BLOCK


def model_flat_len(cfg: dict) -> int:
    """Np of a configuration: every parameter, padding rows included."""
    return flat_len(n_params(cfg, padded=True))


def server_apply_bytes(np_: int, clients: int, outer: str) -> int:
    return 4 * np_ * (clients + 2 + 2 * OUTER_LANES[outer])


def int8_codec_bytes(np_: int, clients: int) -> int:
    """One ``int8_quant`` or one ``int8_dequant`` launch."""
    return 5 * clients * np_
