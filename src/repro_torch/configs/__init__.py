"""Config registry: importing this package registers every architecture of
``repro.configs``, from the same numbers."""
from repro_torch.configs.base import (  # noqa: F401
    ASSIGNED_ARCHS,
    INPUT_SHAPES,
    InputShape,
    LayerKind,
    ModelConfig,
    get_config,
    list_configs,
)

# Registration side effects:
from repro_torch.configs import granite_3_2b  # noqa: F401
from repro_torch.configs import qwen3_1_7b  # noqa: F401
from repro_torch.configs import mamba2_1_3b  # noqa: F401
from repro_torch.configs import jamba_v0_1_52b  # noqa: F401
from repro_torch.configs import deepseek_moe_16b  # noqa: F401
from repro_torch.configs import llama4_scout_17b_a16e  # noqa: F401
from repro_torch.configs import whisper_large_v3  # noqa: F401
from repro_torch.configs import chameleon_34b  # noqa: F401
from repro_torch.configs import deepseek_coder_33b  # noqa: F401
from repro_torch.configs import gemma3_4b  # noqa: F401
from repro_torch.configs import photon  # noqa: F401
