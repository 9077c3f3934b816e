"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887]

Jamba block structure (period 8): attention at position 4 of each period (1:7 ratio),
MoE FFN every other layer (odd positions). We use Mamba2/SSD blocks for the SSM layers
(the original uses Mamba1) for framework uniformity — noted in DESIGN.md §2.
Jamba's SSM uses d_state=16.
Copied from ``repro.configs.jamba_v0_1_52b``."""
from repro_torch.configs.base import ModelConfig, register

JAMBA_V0_1_52B = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        source="arXiv:2403.19887",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14_336,
        vocab_size=65_536,
        n_experts=16,
        moe_top_k=2,
        moe_every=2,
        moe_offset=1,
        moe_d_ff=14_336,
        moe_capacity_factor=1.0,  # memory: its 14336-wide experts dominate residency
        hybrid_pattern="MMMMAMMM",
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=2,
        pos_embedding="none",  # Jamba uses no explicit positional embeddings
        tie_embeddings=False,
    )
)
