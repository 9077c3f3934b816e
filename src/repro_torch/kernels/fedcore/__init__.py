"""Fused federation kernels: the flat-buffer server apply and the uplink
codec kernels (see ``ops.py``)."""
from repro_torch.kernels.fedcore.kernel import server_apply, server_apply_plain  # noqa: F401
from repro_torch.kernels.fedcore.ops import (  # noqa: F401
    BLOCK,
    FlatSpec,
    FusedBf16Codec,
    FusedInt8Codec,
    FusedTopKCodec,
    dtype_group_indices,
    fused_apply_aggregate,
    pack_client_leaves,
    pack_flat,
    pack_leaves,
    server_apply_bytes,
    topk_encode_bytes,
    unpack_client_leaves,
    unpack_flat,
    unpack_leaves,
)
