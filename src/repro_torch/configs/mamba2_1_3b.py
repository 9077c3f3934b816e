"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free. [arXiv:2405.21060]
Copied from ``repro.configs.mamba2_1_3b``."""
from repro_torch.configs.base import ModelConfig, register

MAMBA2_1_3B = register(
    ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        source="arXiv:2405.21060",
        n_layers=48,
        d_model=2048,
        n_heads=1,  # unused for pure SSM
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50_280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_n_groups=1,
        pos_embedding="none",  # SSM needs no positional encoding
        tie_embeddings=True,
        norm="rmsnorm",
    )
)
