"""The per-leaf references of the fedcore kernels, under the kernel-layer
names — as ``repro/kernels/fedcore/ref.py`` re-exports the production
defaults (the ``core/compression`` primitives and ``apply_aggregate``), so the
fused path is compared with exactly the code the plain round runs."""
from __future__ import annotations

from repro_torch.core.compression import (  # noqa: F401
    cast_compress as sr_bf16_ref,
    int8_compress as int8_quant_ref,
    int8_decompress as int8_dequant_ref,
    topk_compress as topk_ef_ref,
)
from repro_torch.core.federated import apply_aggregate as server_apply_ref  # noqa: F401
