"""The per-leaf reference of the fedcore server step, under the kernel-layer
name — as ``repro/kernels/fedcore/ref.py`` re-exports the production default,
so the fused path is compared with exactly the code the plain round runs."""
from __future__ import annotations

from repro_torch.core.federated import apply_aggregate as server_apply_ref  # noqa: F401
