"""RMSNorm forward: the CUDA kernel and its plain version (``kernel.py``), the
any-leading-dims wrapper (``ops.py``) and the oracle (``ref.py``)."""
from repro_torch.kernels.rmsnorm import ops, ref  # noqa: F401
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_fwd, rmsnorm_plain  # noqa: F401
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: F401
