"""Decoder-only transformer configuration.

The port's copy of `lmrl_gym_tpu/models/config.py`: the same fields,
derived sizes, presets, dict round-trip and mesh partition rules, so a
saved `config.json` crosses between the two packages. The rules are the
JAX table over flax key paths; `parallel/mesh.py::match_partition_rules`
transposes a kernel's spec onto the port's [out, in] weight.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from lmrl_gym_torch.parallel.mesh import Spec


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None  # default 4*hidden
    activation: str = "gelu_new"
    position_embedding: str = "learned"  # 'learned' | 'rotary'
    rotary_dim: Optional[int] = None  # GPT-J: 64
    rotary_interleaved: bool = False  # GPT-J pair convention vs NeoX half-split
    rotary_base: float = 10000.0
    parallel_ffn: bool = False  # GPT-J: True (attn & mlp share residual)
    norm: str = "layernorm"  # 'layernorm' | 'rmsnorm' (LLaMA)
    gated_mlp: bool = False  # SwiGLU-style gate·up → proj (LLaMA)
    attn_bias: bool = True
    mlp_bias: bool = True
    lm_head_bias: bool = True
    layer_norm_epsilon: float = 1e-5
    tie_word_embeddings: bool = True
    embd_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    initializer_range: float = 0.02
    # vocab padded up to a multiple of this; logits above `vocab_size` are
    # masked at decode (mask_pad_logits)
    pad_vocab_to_multiple: int = 128
    dtype: str = "bfloat16"  # activation dtype
    remat: bool = False
    # The JAX package's kernel switches. With use_flash_attention off, every
    # attention call takes the einsum route, as in the JAX model
    # (models/transformer.py::Attention).
    use_flash_attention: bool = True
    sequence_parallel: bool = False

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("hidden_size must be a multiple of num_heads")
        return self.hidden_size // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def padded_vocab_size(self) -> int:
        m = self.pad_vocab_to_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def replace(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TransformerConfig":
        return cls(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})

    def partition_rules(self) -> Tuple[Tuple[str, Spec], ...]:
        """regex → Spec over flax key paths, the JAX package's table: 2-D
        weights (fsdp, mp) or (mp, fsdp), embeddings sharded over their
        vocab or position dim, everything else replicated."""
        return (
            ("wte/embedding", Spec(("mp", "fsdp"), None)),
            ("wpe/embedding", Spec(("mp", "fsdp"), None)),
            ("attn/qkv/kernel", Spec("fsdp", "mp")),
            ("attn/out/kernel", Spec("mp", "fsdp")),
            ("mlp/fc/kernel", Spec("fsdp", "mp")),
            ("mlp/gate/kernel", Spec("fsdp", "mp")),
            ("mlp/proj/kernel", Spec("mp", "fsdp")),
            ("attn/qkv/bias", Spec("mp")),
            ("mlp/fc/bias", Spec("mp")),
            ("lm_head/kernel", Spec("fsdp", "mp")),
            (".*bias", Spec()),
            (".*scale", Spec()),
            (".*", Spec()),
        )


def gpt2_small() -> TransformerConfig:
    return TransformerConfig()


def gpt2_medium() -> TransformerConfig:
    return TransformerConfig(hidden_size=1024, num_layers=24, num_heads=16)


def gpt2_large() -> TransformerConfig:
    return TransformerConfig(hidden_size=1280, num_layers=36, num_heads=20)


def gpt2_xl() -> TransformerConfig:
    return TransformerConfig(hidden_size=1600, num_layers=48, num_heads=25)


def gptj_6b() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=50400,
        max_position_embeddings=2048,
        hidden_size=4096,
        num_layers=28,
        num_heads=16,
        position_embedding="rotary",
        rotary_dim=64,
        rotary_interleaved=True,
        parallel_ffn=True,
        tie_word_embeddings=False,
        embd_pdrop=0.0,
        resid_pdrop=0.0,
        attn_pdrop=0.0,
    )


def llama_7b() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=32000,
        max_position_embeddings=4096,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        intermediate_size=11008,
        activation="silu",
        position_embedding="rotary",
        norm="rmsnorm",
        gated_mlp=True,
        attn_bias=False,
        mlp_bias=False,
        lm_head_bias=False,
        tie_word_embeddings=False,
        layer_norm_epsilon=1e-6,
        embd_pdrop=0.0,
        resid_pdrop=0.0,
        attn_pdrop=0.0,
    )


def tiny_test_config(**kw) -> TransformerConfig:
    """Small config for tests: fits CPU, exercises all code paths."""
    base = dict(
        vocab_size=259,  # ByteTokenizer
        max_position_embeddings=128,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        embd_pdrop=0.0,
        resid_pdrop=0.0,
        attn_pdrop=0.0,
        pad_vocab_to_multiple=64,
        dtype="float32",
    )
    base.update(kw)
    return TransformerConfig(**base)
