"""Fused federation kernels on the flat-buffer layout (see ``ops.py``)."""
from repro_torch.kernels.fedcore.kernel import server_apply, server_apply_plain  # noqa: F401
from repro_torch.kernels.fedcore.ops import (  # noqa: F401
    BLOCK,
    FlatSpec,
    dtype_group_indices,
    fused_apply_aggregate,
    pack_client_leaves,
    pack_leaves,
    unpack_leaves,
)
