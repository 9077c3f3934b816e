"""chameleon-34b [vlm] — early-fusion, VQ image tokens share the text vocabulary; the
VQ-GAN image tokenizer is STUBBED (inputs are plain token ids). [arXiv:2405.09818]
Copied from ``repro.configs.chameleon_34b``."""
from repro_torch.configs.base import ModelConfig, register

CHAMELEON_34B = register(
    ModelConfig(
        name="chameleon-34b",
        family="vlm",
        source="arXiv:2405.09818",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22_016,
        vocab_size=65_536,
        qk_norm=True,  # chameleon's QK-norm is central to its training stability
        pos_embedding="rope",
        tie_embeddings=False,
        norm="layernorm",  # chameleon uses (swin-style) layernorm placement
    )
)
