"""Model architecture configs (a copy of ``tgq/models/config.py``): the
llama family (Qwen3, Qwen2.5, Llama-3), GPT-2 and OPT, and their tiny
test variants.

The fields are the JAX package's, so a checkpoint's ``config.json``
written by either package builds the same ``ModelConfig``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 1e6
    rms_norm_eps: float = 1e-6
    qk_norm: bool = True          # Qwen3 per-head q/k RMSNorm
    attention_bias: bool = False  # Qwen2-style qkv bias
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 40960
    seqlen: int = 2048            # calibration/eval window
    family: str = "llama"         # llama | gpt2 | opt

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim


PRESETS: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    PRESETS[cfg.name] = cfg
    return cfg


QWEN3_0_6B = _register(ModelConfig(
    name="qwen3-0.6b", vocab_size=151936, hidden_size=1024,
    intermediate_size=3072, num_layers=28, num_heads=16, num_kv_heads=8,
    head_dim=128, rope_theta=1e6, tie_word_embeddings=True,
))
QWEN3_8B = _register(ModelConfig(
    name="qwen3-8b", vocab_size=151936, hidden_size=4096,
    intermediate_size=12288, num_layers=36, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=1e6,
))
LLAMA3_8B = _register(ModelConfig(
    name="llama3-8b", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
    head_dim=128, rope_theta=5e5, rms_norm_eps=1e-5, qk_norm=False,
))
LLAMA3_70B = _register(ModelConfig(
    name="llama3-70b", vocab_size=128256, hidden_size=8192,
    intermediate_size=28672, num_layers=80, num_heads=64, num_kv_heads=8,
    head_dim=128, rope_theta=5e5, rms_norm_eps=1e-5, qk_norm=False,
))
QWEN25_7B = _register(ModelConfig(
    name="qwen2.5-7b", vocab_size=152064, hidden_size=3584,
    intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
    head_dim=128, rope_theta=1e6, qk_norm=False, attention_bias=True,
))

# GPT-2 family (transformer.h layout; intermediate = 4·hidden, ctx 1024)
GPT2 = _register(ModelConfig(
    name="gpt2", vocab_size=50257, hidden_size=768, intermediate_size=3072,
    num_layers=12, num_heads=12, num_kv_heads=12, head_dim=64,
    rms_norm_eps=1e-5, qk_norm=False, tie_word_embeddings=True,
    max_position_embeddings=1024, seqlen=1024, family="gpt2",
))
GPT2_XL = _register(ModelConfig(
    name="gpt2-xl", vocab_size=50257, hidden_size=1600,
    intermediate_size=6400, num_layers=48, num_heads=25, num_kv_heads=25,
    head_dim=64, rms_norm_eps=1e-5, qk_norm=False, tie_word_embeddings=True,
    max_position_embeddings=1024, seqlen=1024, family="gpt2",
))

# OPT family (model.decoder.layers layout, learned positions with the HF
# +2 offset).  Pre-norm variants only: opt-350m is refused at import.
OPT_125M = _register(ModelConfig(
    name="opt-125m", vocab_size=50272, hidden_size=768,
    intermediate_size=3072, num_layers=12, num_heads=12, num_kv_heads=12,
    head_dim=64, rms_norm_eps=1e-5, qk_norm=False, tie_word_embeddings=True,
    max_position_embeddings=2048, seqlen=2048, family="opt",
))
OPT_1_3B = _register(ModelConfig(
    name="opt-1.3b", vocab_size=50272, hidden_size=2048,
    intermediate_size=8192, num_layers=24, num_heads=32, num_kv_heads=32,
    head_dim=64, rms_norm_eps=1e-5, qk_norm=False, tie_word_embeddings=True,
    max_position_embeddings=2048, seqlen=2048, family="opt",
))

TINY_QWEN3 = _register(ModelConfig(
    name="tiny-qwen3", vocab_size=512, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=1e4, tie_word_embeddings=True, seqlen=128,
))
TINY_QWEN3_KV128 = _register(ModelConfig(
    name="tiny-qwen3-kv128", vocab_size=512, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=64, rope_theta=1e4, tie_word_embeddings=True, seqlen=128,
))
TINY_LLAMA = _register(ModelConfig(
    name="tiny-llama", vocab_size=512, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=1e4, qk_norm=False, seqlen=128,
))
TINY_QWEN2 = _register(ModelConfig(
    name="tiny-qwen2", vocab_size=512, hidden_size=64,
    intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, rope_theta=1e4, qk_norm=False, attention_bias=True,
    seqlen=128,
))
TINY_GPT2 = _register(ModelConfig(
    name="tiny-gpt2", vocab_size=512, hidden_size=64,
    intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=4,
    head_dim=16, rms_norm_eps=1e-5, qk_norm=False,
    tie_word_embeddings=True, max_position_embeddings=256, seqlen=128,
    family="gpt2",
))
TINY_OPT = _register(ModelConfig(
    name="tiny-opt", vocab_size=512, hidden_size=64,
    intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=4,
    head_dim=16, rms_norm_eps=1e-5, qk_norm=False,
    tie_word_embeddings=True, max_position_embeddings=256, seqlen=128,
    family="opt",
))
