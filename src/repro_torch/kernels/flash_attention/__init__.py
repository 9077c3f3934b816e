"""Flash attention: the CUDA kernels and their plain versions (``kernel.py``;
the forward, and the causal ALiBi training pair), the model-layout wrappers
(``ops.py``) and the oracles (``ref.py``)."""
from repro_torch.kernels.flash_attention import ops, ref  # noqa: F401
from repro_torch.kernels.flash_attention.kernel import (  # noqa: F401
    flash_attention_alibi_bwd,
    flash_attention_alibi_fwd,
    flash_attention_fwd,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention,
    flash_attention_alibi,
)
