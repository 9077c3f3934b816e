"""deepseek-coder-33b [dense] — llama-arch. [arXiv:2401.14196]
Copied from ``repro.configs.deepseek_coder_33b``."""
from repro_torch.configs.base import ModelConfig, register

DEEPSEEK_CODER_33B = register(
    ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        source="arXiv:2401.14196",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19_200,
        vocab_size=32_256,
        pos_embedding="rope",
        rope_theta=100_000.0,
        tie_embeddings=False,
    )
)
