"""whisper-large-v3 [audio] — encoder-decoder transformer backbone; conv/mel
frontend stubbed (the caller hands in precomputed frame embeddings).
[arXiv:2212.04356] Copied from ``repro.configs.whisper_large_v3``.

kv=20 == n_heads: whisper uses MHA (no GQA). Learned positions on the decoder.
"""
from repro_torch.configs.base import ModelConfig, register

WHISPER_LARGE_V3 = register(
    ModelConfig(
        name="whisper-large-v3",
        family="audio",
        source="arXiv:2212.04356",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51_866,
        enc_dec=True,
        n_encoder_layers=32,
        n_audio_frames=1500,
        pos_embedding="learned",
        max_seq_len=32_768,  # mechanically extended for the assigned shapes
        norm="layernorm",
        activation="gelu",
        tie_embeddings=True,
    )
)
