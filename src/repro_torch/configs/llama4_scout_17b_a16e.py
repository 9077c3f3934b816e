"""llama4-scout-17b-a16e [moe] — MoE 16e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Early-fusion multimodality enters through the shared token vocabulary (like chameleon);
the vision encoder is out of scope (text backbone per assignment).
Copied from ``repro.configs.llama4_scout_17b_a16e``."""
from repro_torch.configs.base import ModelConfig, register

LLAMA4_SCOUT = register(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202_048,
        n_experts=16,
        n_shared_experts=1,  # llama4 uses a shared expert alongside top-1 routing
        moe_top_k=1,
        moe_d_ff=8192,
        pos_embedding="rope",
        rope_theta=500_000.0,
        tie_embeddings=False,
    )
)
