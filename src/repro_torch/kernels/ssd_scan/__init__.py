"""The Mamba2 SSD chunk scan: the CUDA kernel and its plain version
(``kernel.py``), the model-layout wrapper (``ops.py``) and its oracles
(``ref.py``)."""
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: F401
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd, ssd_scan_plain  # noqa: F401
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: F401
