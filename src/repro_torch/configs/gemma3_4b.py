"""gemma3-4b [dense] — 5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt family]
Copied from ``repro.configs.gemma3_4b``."""
from repro_torch.configs.base import ModelConfig, register

GEMMA3_4B = register(
    ModelConfig(
        name="gemma3-4b",
        family="dense",
        source="hf:google/gemma-3-1b-pt",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10_240,
        vocab_size=262_144,
        sliding_window=1024,
        global_attn_every=6,  # layers 6,12,... are global; rest local (5:1)
        qk_norm=True,
        pos_embedding="rope",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        max_seq_len=1_048_576,
    )
)
