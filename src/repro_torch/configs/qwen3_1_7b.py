"""qwen3-1.7b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family]
Copied from ``repro.configs.qwen3_1_7b``."""
from repro_torch.configs.base import ModelConfig, register

QWEN3_1_7B = register(
    ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        source="hf:Qwen/Qwen3-8B",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=6144,
        vocab_size=151_936,
        qk_norm=True,
        pos_embedding="rope",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )
)
