"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6, first layer
dense. [arXiv:2401.06066]
Copied from ``repro.configs.deepseek_moe_16b``."""
from repro_torch.configs.base import ModelConfig, register

DEEPSEEK_MOE_16B = register(
    ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        source="arXiv:2401.06066",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408 * 8,  # dense-FFN layers use the standard expansion (10944 in HF; 8x approx)
        vocab_size=102_400,
        n_experts=64,
        n_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
        first_layer_dense=True,
        pos_embedding="rope",
        tie_embeddings=False,
    )
)
