"""Flash attention forward: the CUDA kernel and its plain version
(``kernel.py``), the model-layout wrapper (``ops.py``) and the oracle
(``ref.py``)."""
from repro_torch.kernels.flash_attention import ops, ref  # noqa: F401
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    flash_attention_fwd,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
