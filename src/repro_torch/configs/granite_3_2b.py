"""granite-3-2b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base]
Copied from ``repro.configs.granite_3_2b``."""
from repro_torch.configs.base import ModelConfig, register

GRANITE_3_2B = register(
    ModelConfig(
        name="granite-3-2b",
        family="dense",
        source="hf:ibm-granite/granite-3.0-2b-base",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=49_155,
        pos_embedding="rope",
        tie_embeddings=True,
    )
)
