"""Config registry: importing this package registers every ported architecture
(the photon family, mamba2-1.3b and whisper-large-v3; other families arrive
with their models, ROADMAP.md)."""
from repro_torch.configs.base import (  # noqa: F401
    LayerKind,
    ModelConfig,
    get_config,
    list_configs,
)

from repro_torch.configs import mamba2_1_3b, photon, whisper_large_v3  # noqa: F401  (registration side effects)
