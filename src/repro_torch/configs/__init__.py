"""Config registry: importing this package registers every ported architecture
(the photon family; other families arrive with their models, ROADMAP.md)."""
from repro_torch.configs.base import (  # noqa: F401
    LayerKind,
    ModelConfig,
    get_config,
    list_configs,
)

from repro_torch.configs import photon  # noqa: F401  (registration side effect)
