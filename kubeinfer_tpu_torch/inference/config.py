"""Model configuration for the port's inference runtime.

Field names follow the HuggingFace llama config vocabulary so checkpoints
map 1:1 (weights.py); presets cover the model families the reference's
samples reference (facebook/opt-style tiny demo models up through
llama-70B-class shapes for sizing math).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


def _hf_head_dim_override(d: dict) -> int:
    """Explicit head width from a HF config dict, 0 when derivable.

    GemmaConfig defaults head_dim to 256 REGARDLESS of
    hidden_size/num_heads, so a gemma config.json that omits the key
    still means 256 — deriving it would build a wrong-geometry model
    whose q reshape fails against the checkpoint's 256-wide heads.
    """
    derived = d["hidden_size"] // d["num_attention_heads"]
    default = 256 if d.get("model_type") == "gemma" else derived
    hd = d.get("head_dim", default)
    return hd if hd != derived else 0


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32  # < heads => grouped-query attention
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    # Qwen2-family attention: biases on q/k/v projections (o stays
    # bias-free — the Qwen2 scheme; published llama checkpoints never
    # ship attention biases, so the hypothetical llama attention_bias
    # o-projection bias is deliberately unsupported)
    qkv_bias: bool = False
    # Mixtral-family sparse MLP: >0 replaces every dense MLP with a
    # top-k routed mixture of SwiGLU experts (moe.py)
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    # Gemma-family deltas from the llama recipe: tanh-approx GeGLU
    # instead of SwiGLU ("gelu_pytorch_tanh"), embeddings scaled by
    # sqrt(hidden_size) on the way in, and RMSNorm weights stored as an
    # OFFSET from 1 (x_norm * (1 + w), zero-init) rather than a gain
    hidden_act: str = "silu"
    scale_embeddings: bool = False
    rmsnorm_offset: bool = False
    # Explicit head width for families where it is NOT
    # hidden_size/num_heads (gemma-7b: 16 heads x 256 on a 3072 hidden —
    # the q/o projections are then [H, heads*head_dim] rectangles, which
    # the decoder already handles generically). 0 = derive.
    head_dim_override: int = 0

    @property
    def head_dim(self) -> int:
        if self.head_dim_override:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    def __post_init__(self) -> None:
        if not self.head_dim_override and (
            self.hidden_size % self.num_attention_heads
        ):
            raise ValueError("hidden_size must divide by num_attention_heads")
        # refuse-at-config-time (same convention as the attention_bias
        # check in from_hf_dict): an unknown activation would otherwise
        # only raise mid-jit-trace inside the first forward
        if self.hidden_act not in ("silu", "gelu_pytorch_tanh"):
            raise ValueError(
                f"unsupported hidden_act {self.hidden_act!r} "
                "(silu and gelu_pytorch_tanh are implemented)"
            )
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                "num_attention_heads must divide by num_key_value_heads"
            )

    @classmethod
    def from_hf_dict(cls, d: dict[str, Any]) -> "ModelConfig":
        """Build from a HuggingFace config.json dict (llama family)."""
        # llama-style attention_bias=true also puts a bias on o_proj,
        # which this runtime does not model; loading such a checkpoint
        # with that bias silently dropped would corrupt every layer's
        # attention output, so refuse at config time instead.
        if d.get("attention_bias", False) and d.get("model_type") != "qwen2":
            raise ValueError(
                "attention_bias=true (o_proj bias) is not supported; "
                "only the Qwen2 q/k/v-bias scheme is implemented"
            )
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d.get(
                "num_key_value_heads", d["num_attention_heads"]
            ),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            tie_word_embeddings=d.get("tie_word_embeddings", False)
            or d.get("model_type") == "gemma",
            qkv_bias=d.get("model_type") == "qwen2",
            num_local_experts=d.get("num_local_experts", 0),
            num_experts_per_tok=d.get("num_experts_per_tok", 2),
            hidden_act=(
                "gelu_pytorch_tanh"
                if d.get("model_type") == "gemma"
                else d.get("hidden_act", "silu")
            ),
            scale_embeddings=d.get("model_type") == "gemma",
            rmsnorm_offset=d.get("model_type") == "gemma",
            head_dim_override=_hf_head_dim_override(d),
        )


PRESETS: dict[str, ModelConfig] = {
    # CI-sized model: small enough for the 1-core test box, GQA on
    "tiny": ModelConfig(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=512,
    ),
    # benchmark-sized model (~280M params): big enough that decode is
    # HBM-bound like production models, small enough to init on-chip in
    # seconds
    "bench-280m": ModelConfig(
        vocab_size=32000,
        hidden_size=1024,
        intermediate_size=4096,
        num_hidden_layers=16,
        num_attention_heads=16,
        num_key_value_heads=8,
        max_position_embeddings=4096,
    ),
    # serving-scale benchmark model (~1.7B params, llama-family shape):
    # big enough that HBM pressure, bucketing, and flash attention bite,
    # small enough to random-init with headroom for KV caches (bf16
    # weights ~3.5GB)
    "bench-1p7b": ModelConfig(
        vocab_size=32000,
        hidden_size=2048,
        intermediate_size=8192,
        num_hidden_layers=24,
        num_attention_heads=16,
        num_key_value_heads=8,
        max_position_embeddings=4096,
    ),
    "qwen2-7b": ModelConfig(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_hidden_layers=28,
        num_attention_heads=28,
        num_key_value_heads=4,
        rms_norm_eps=1e-6,
        rope_theta=1000000.0,
        max_position_embeddings=32768,
        qkv_bias=True,
    ),
    "tiny-gemma": ModelConfig(  # demo/e2e-sized gemma-family config
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=1,
        rms_norm_eps=1e-6,
        max_position_embeddings=512,
        tie_word_embeddings=True,
        hidden_act="gelu_pytorch_tanh",
        scale_embeddings=True,
        rmsnorm_offset=True,
    ),
    "gemma-2b": ModelConfig(
        vocab_size=256000,
        hidden_size=2048,
        intermediate_size=16384,
        num_hidden_layers=18,
        num_attention_heads=8,
        num_key_value_heads=1,  # multi-query attention
        rms_norm_eps=1e-6,
        max_position_embeddings=8192,
        tie_word_embeddings=True,
        hidden_act="gelu_pytorch_tanh",
        scale_embeddings=True,
        rmsnorm_offset=True,
    ),
    "gemma-7b": ModelConfig(
        vocab_size=256000,
        hidden_size=3072,
        intermediate_size=24576,
        num_hidden_layers=28,
        num_attention_heads=16,
        num_key_value_heads=16,
        head_dim_override=256,  # 16 x 256 = 4096-wide q/o on 3072 hidden
        rms_norm_eps=1e-6,
        max_position_embeddings=8192,
        tie_word_embeddings=True,
        hidden_act="gelu_pytorch_tanh",
        scale_embeddings=True,
        rmsnorm_offset=True,
    ),
    "mixtral-8x7b": ModelConfig(
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        rms_norm_eps=1e-5,
        rope_theta=1000000.0,
        max_position_embeddings=32768,
        num_local_experts=8,
        num_experts_per_tok=2,
    ),
    "llama-3-8b": ModelConfig(
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        rope_theta=500000.0,
        max_position_embeddings=8192,
    ),
    "llama-3-70b": ModelConfig(
        vocab_size=128256,
        hidden_size=8192,
        intermediate_size=28672,
        num_hidden_layers=80,
        num_attention_heads=64,
        num_key_value_heads=8,
        rope_theta=500000.0,
        max_position_embeddings=8192,
    ),
}
