"""Model configuration, copied from ``repro.configs.base`` so the port imports
nothing of the JAX package. Field for field the same dataclass: a config built
here and its ``repro`` twin compare equal field by field (tested), which is what
lets the two packages describe one model.

Layer heterogeneity is described declaratively via ``layer_kinds()`` (one
``LayerKind`` per depth index); the transformer groups equal-signature layers
into stacks with a leading ``layers`` axis.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class LayerKind:
    """Static description of one layer's structure.

    ``mixer``:  'attn' | 'ssm'
    ``ffn``:    'dense' | 'moe' | 'none'
    ``window``: attention window (None = full causal). A *value*, not structure:
                layers that differ only in window share a stack.
    """

    mixer: str = "attn"
    ffn: str = "dense"
    window: Optional[int] = None
    cross_attn: bool = False  # decoder layers of enc-dec models

    @property
    def signature(self) -> Tuple:
        """Stacking signature: layers with equal signature share parameter
        shapes and stack on one leading axis. ``window`` deliberately excluded."""
        return (self.mixer, self.ffn, self.cross_attn)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'audio' | 'vlm'
    source: str  # citation for the config numbers

    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 50_368
    head_dim: Optional[int] = None  # default: d_model // n_heads

    # --- attention options ------------------------------------------------
    pos_embedding: str = "rope"  # 'rope' | 'alibi' | 'learned' | 'none'
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    global_attn_every: Optional[int] = None
    tie_embeddings: bool = True
    max_seq_len: int = 131_072

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: Optional[int] = None
    moe_every: int = 1
    moe_offset: int = 0
    first_layer_dense: bool = False
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_n_groups: int = 1
    ssm_chunk: int = 64

    # --- hybrid pattern -------------------------------------------------------
    hybrid_pattern: Optional[str] = None

    # --- encoder/decoder (audio) ----------------------------------------------
    enc_dec: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500

    # --- numerics / norm ------------------------------------------------------
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    activation: str = "silu"  # 'silu' | 'gelu'
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    z_loss: float = 1e-4

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256; logits are sliced back to vocab_size."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    # ------------------------------------------------------------------
    def layer_kinds(self) -> List[LayerKind]:
        """One LayerKind per decoder layer index."""
        kinds: List[LayerKind] = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                mixer = "ssm"
            elif self.hybrid_pattern:
                mixer = "attn" if self.hybrid_pattern[i % len(self.hybrid_pattern)] == "A" else "ssm"
            else:
                mixer = "attn"
            if self.family == "ssm":
                ffn = "none"
            elif self.is_moe:
                if self.first_layer_dense and i == 0:
                    ffn = "dense"
                elif i % self.moe_every == self.moe_offset:
                    ffn = "moe"
                else:
                    ffn = "dense"
            else:
                ffn = "dense"
            window: Optional[int] = None
            if mixer == "attn" and self.sliding_window is not None:
                if self.global_attn_every:
                    is_global = (i + 1) % self.global_attn_every == 0
                    window = None if is_global else self.sliding_window
                else:
                    window = self.sliding_window
            kinds.append(
                LayerKind(mixer=mixer, ffn=ffn, window=window, cross_attn=self.enc_dec)
            )
        return kinds

    def encoder_layer_kinds(self) -> List[LayerKind]:
        return [LayerKind(mixer="attn", ffn="dense") for _ in range(self.n_encoder_layers)]

    # ------------------------------------------------------------------
    def supports_shape(self, shape_name: str) -> Tuple[bool, str]:
        """Whether this arch runs the given input shape (long_500k gating)."""
        shape = INPUT_SHAPES[shape_name]
        if shape.name == "long_500k":
            sub_quadratic = (
                self.family in ("ssm", "hybrid")
                or self.sliding_window is not None
            )
            if not sub_quadratic:
                return False, "full-attention arch: long_500k skipped (see DESIGN.md)"
        if self.enc_dec and shape.name == "long_500k":
            return False, "enc-dec context model caps far below 500k; skipped"
        return True, ""

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks); used for 6ND."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        if self.pos_embedding == "learned":
            total += self.max_seq_len * d

        def attn_params() -> int:
            return d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d

        def dense_ffn(dff: int) -> int:
            return 3 * d * dff if self.activation == "silu" else 2 * d * dff

        def moe_ffn() -> int:
            dff = self.moe_d_ff or self.d_ff
            routed = self.n_experts * 3 * d * dff
            shared = self.n_shared_experts * 3 * d * dff
            router = d * self.n_experts
            return routed + shared + router

        def ssm_params() -> int:
            di, g, ds, nh = self.d_inner, self.ssm_n_groups, self.ssm_state, self.ssm_n_heads
            conv_dim = di + 2 * g * ds
            return (
                d * (2 * di + 2 * g * ds + nh)
                + conv_dim * self.ssm_conv_width
                + nh * 2
                + nh
                + di
                + di * d
            )

        for k in self.layer_kinds():
            total += 2 * d
            if k.mixer == "attn":
                total += attn_params()
                if k.cross_attn:
                    total += attn_params() + d
            else:
                total += ssm_params()
            if k.ffn == "dense":
                total += dense_ffn(self.d_ff)
            elif k.ffn == "moe":
                total += moe_ffn()
        for _ in range(self.n_encoder_layers):
            total += 2 * d + attn_params() + dense_ffn(self.d_ff)
        total += d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dff = self.moe_d_ff or self.d_ff
        inactive_per_moe_layer = (self.n_experts - self.moe_top_k) * 3 * d * dff
        n_moe_layers = sum(1 for k in self.layer_kinds() if k.ffn == "moe")
        return self.param_count() - n_moe_layers * inactive_per_moe_layer

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        kw = dict(
            n_layers=2,
            d_model=256,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=64,
            d_ff=512,
            vocab_size=512,
            max_seq_len=32_768 if self.pos_embedding == "learned" else 4096,
        )
        if self.is_moe:
            kw.update(n_experts=4, moe_top_k=min(self.moe_top_k, 2), moe_d_ff=128,
                      n_shared_experts=min(self.n_shared_experts, 1))
        if self.ssm_state:
            kw.update(ssm_state=32, ssm_head_dim=32, ssm_chunk=16)
        if self.hybrid_pattern:
            kw.update(hybrid_pattern="MA")
        if self.sliding_window is not None:
            kw.update(sliding_window=32, global_attn_every=2)
        if self.enc_dec:
            kw.update(n_encoder_layers=2, n_audio_frames=16)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config: {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _  # noqa: F401  (registration side effects)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    from repro_torch import configs as _  # noqa: F401

    return sorted(_REGISTRY)


ASSIGNED_ARCHS = [
    "granite-3-2b",
    "qwen3-1.7b",
    "mamba2-1.3b",
    "jamba-v0.1-52b",
    "deepseek-moe-16b",
    "llama4-scout-17b-a16e",
    "whisper-large-v3",
    "chameleon-34b",
    "deepseek-coder-33b",
    "gemma3-4b",
]
