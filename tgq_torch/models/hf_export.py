"""HF-format export of quantized models (mirrors ``tgq/models/hf_export.py``).

Writes dequantized bf16 safetensors (``tgq_torch.models.safetensors_io``,
sharded at about 4 GB with an index, as HF shards) and an HF
``config.json``: the artifact the reference writes with
``save_pretrained``, loadable by HF tools and by
:func:`tgq_torch.models.hf_import.load_hf_checkpoint`.  The port's
primary checkpoint stays the packed-INT npz (``tgq_torch.core.checkpoint``).
"""
from __future__ import annotations

import json
import logging
import os

import torch

from tgq_torch.core.packing import PackedLinear
from tgq_torch.models.config import ModelConfig
from tgq_torch.models.safetensors_io import save_checkpoint

logger = logging.getLogger(__name__)

_MAX_SHARD_BYTES = 4 * 1024**3  # HF convention: ~4 GB shards


def hf_config_dict(cfg: ModelConfig) -> dict:
    """ModelConfig → HF config.json dict (the inverse of
    ``hf_import.config_from_hf``).  model_type: family gpt2 / opt, else
    qwen3 with qk_norm, qwen2 with attention_bias, else llama."""
    if cfg.family == "gpt2":
        return {
            "model_type": "gpt2",
            "architectures": ["GPT2LMHeadModel"],
            "vocab_size": cfg.vocab_size,
            "n_embd": cfg.hidden_size,
            "n_inner": cfg.intermediate_size,
            "n_layer": cfg.num_layers,
            "n_head": cfg.num_heads,
            "n_positions": cfg.max_position_embeddings,
            "n_ctx": cfg.max_position_embeddings,
            "layer_norm_epsilon": cfg.rms_norm_eps,
            "activation_function": "gelu_new",
            "tie_word_embeddings": True,
            "torch_dtype": "bfloat16",
            "_name_or_path": cfg.name,
        }
    if cfg.family == "opt":
        return {
            "model_type": "opt",
            "architectures": ["OPTForCausalLM"],
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "ffn_dim": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "word_embed_proj_dim": cfg.hidden_size,
            "do_layer_norm_before": True,
            "activation_function": "relu",
            "tie_word_embeddings": True,
            "torch_dtype": "bfloat16",
            "_name_or_path": cfg.name,
        }
    if cfg.qk_norm:
        model_type, arch = "qwen3", "Qwen3ForCausalLM"
    elif cfg.attention_bias:
        model_type, arch = "qwen2", "Qwen2ForCausalLM"
    else:
        model_type, arch = "llama", "LlamaForCausalLM"
    return {
        "model_type": model_type,
        "architectures": [arch],
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "attention_bias": cfg.attention_bias,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings,
        "hidden_act": "silu",
        "torch_dtype": "bfloat16",
        "_name_or_path": cfg.name,
    }


def _hf_state_dict(params, dtype) -> dict[str, torch.Tensor]:
    """Flatten the parameter tree to HF names as CPU tensors, dequantizing
    packed linears; ``w`` → ``weight``, ``b`` → ``bias``, floating leaves
    cast to ``dtype``."""
    out: dict[str, torch.Tensor] = {}

    def cast(t: torch.Tensor) -> torch.Tensor:
        return (t.to(dtype) if t.is_floating_point() else t).cpu()

    def walk(node, prefix: str):
        if isinstance(node, PackedLinear):
            out[f"{prefix}.weight"] = cast(node.dequantize())
            if node.bias is not None:
                out[f"{prefix}.bias"] = cast(node.bias)
        elif isinstance(node, dict) and "w" in node:  # dense linear
            out[f"{prefix}.weight"] = cast(node["w"])
            if "b" in node:
                out[f"{prefix}.bias"] = cast(node["b"])
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}")
        else:
            out[prefix] = cast(node)

    walk(params, "")
    return out


def _rename(name: str, table) -> str:
    for ours, hf in table:
        if name.startswith(ours):
            return hf + name[len(ours):]
    return name


_GPT2_NAMES = (("model.embed_tokens.", "transformer.wte."), ("model.wpe.", "transformer.wpe."),
               ("model.norm.", "transformer.ln_f."), ("model.layers.", "transformer.h."))
_OPT_NAMES = (("model.embed_tokens.", "model.decoder.embed_tokens."),
              ("model.wpe.", "model.decoder.embed_positions."),
              ("model.norm.", "model.decoder.final_layer_norm."),
              ("model.layers.", "model.decoder.layers."))


def _gpt2_state_dict(params, dtype) -> dict[str, torch.Tensor]:
    """gpt2 flatten: the Conv1D modules (c_attn, c_proj, c_fc) store
    (in, out), so their (out, in) weights transpose back (the exact inverse
    of the import's transpose)."""
    out = {}
    for name, t in _hf_state_dict(params, dtype).items():
        parts = name.split(".")
        if parts[-1] == "weight" and parts[-2] in ("c_attn", "c_proj", "c_fc"):
            t = t.T.contiguous()
        out[_rename(name, _GPT2_NAMES)] = t
    return out


def _opt_state_dict(params, dtype) -> dict[str, torch.Tensor]:
    """opt flatten: nn.Linear weights, renamed under ``model.decoder``."""
    return {_rename(name, _OPT_NAMES): t for name, t in _hf_state_dict(params, dtype).items()}


def export_hf(path: str, params, cfg: ModelConfig, tokenizer=None,
              dtype=torch.bfloat16, max_shard_bytes: int = _MAX_SHARD_BYTES) -> None:
    """Write an HF checkpoint directory: bf16 safetensors (sharded past
    ``max_shard_bytes``, with an index) and ``config.json``; tokenizer
    files when a tokenizer is given.  ``params`` may hold packed linears
    (dequantized on the way) or dense ones."""
    if cfg.family == "gpt2":
        state = _gpt2_state_dict(params, dtype)
    elif cfg.family == "opt":
        state = _opt_state_dict(params, dtype)
    else:
        state = _hf_state_dict(params, dtype)
    if cfg.family in ("gpt2", "opt") or cfg.tie_word_embeddings:
        state.pop("lm_head.weight", None)  # tied to the token embeddings
    n_files = save_checkpoint(path, state, max_shard_bytes)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=2)
    if tokenizer is not None:
        tokenizer.save_pretrained(path)
    logger.info("[hf-export] wrote %d tensors (%d file%s) to %s", len(state), n_files,
                "s" if n_files > 1 else "", path)
