"""The paper's own model family (Table 2): MPT-style decoder transformers with
ALiBi — 75M, 125M, 350M, 1.3B, 3B, 7B. Copied from ``repro.configs.photon``."""
from repro_torch.configs.base import ModelConfig, register

_COMMON = dict(
    family="dense",
    source="Photon paper Table 2 (MPT-style, ALiBi, vocab 50368 [gpt-neox-20b tokenizer])",
    n_kv_heads=-1,  # filled below: MPT uses MHA
    vocab_size=50_368,
    pos_embedding="alibi",
    norm="layernorm",
    activation="gelu",
    tie_embeddings=True,
    max_seq_len=2048,
)


def _photon(name, n_layers, d_model, n_heads, seq_len):
    kw = dict(_COMMON)
    kw.update(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        d_ff=4 * d_model,
        max_seq_len=seq_len,
    )
    return register(ModelConfig(name=name, **kw))


PHOTON_75M = _photon("photon-75m", 3, 896, 16, 1024)
PHOTON_125M = _photon("photon-125m", 12, 768, 12, 2048)
PHOTON_350M = _photon("photon-350m", 24, 1024, 16, 2048)
PHOTON_1_3B = _photon("photon-1.3b", 24, 2048, 16, 2048)
PHOTON_3B = _photon("photon-3b", 32, 2560, 20, 2048)
PHOTON_7B = _photon("photon-7b", 32, 4096, 32, 2048)
