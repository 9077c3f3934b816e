"""Flash decode (one query token against a long KV cache): the CUDA kernel and
its plain version (``kernel.py``), the model-layout wrapper (``ops.py``) and
the oracle (``ref.py``)."""
from repro_torch.kernels.flash_decode import ops, ref  # noqa: F401
from repro_torch.kernels.flash_decode.kernel import (  # noqa: F401
    flash_decode_fwd,
    flash_decode_plain,
)
from repro_torch.kernels.flash_decode.ops import flash_decode  # noqa: F401
