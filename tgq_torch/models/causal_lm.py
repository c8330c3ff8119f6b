"""Decoder-only causal LM, llama family (mirrors ``tgq/models/causal_lm.py``).

Parameters are a nested dict of tensors with the JAX tree's key paths
(``model.layers.<i>.self_attn.q_proj.w`` …), so ``get_nested``/``set_nested``,
checkpoint names and ``tgq_torch.models.convert`` map one to one.  Every
linear is ``{"w": (out, in)[, "b": (out,)]}``.

Numerics follow the JAX package: bf16 weights and activations, f32 for
RMSNorm, rope and the naive attention's softmax.  Attention on CUDA is
``torch.nn.functional.scaled_dot_product_attention`` (the JAX package
calls the upstream Pallas flash-attention op there, which tgq did not
write); on the CPU it is the plain masked softmax.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from tgq_torch.core.packing import PackedLinear
from tgq_torch.models.config import ModelConfig
from tgq_torch.utils.precision import resolve_device

Params = dict


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "llama":
        raise NotImplementedError(
            f"tgq_torch ports the llama family only; {cfg.family!r} is "
            "queued in ROADMAP.md (slice 3)")


# ----------------------------------------------------------------- linears


def apply_linear(p, x: torch.Tensor) -> torch.Tensor:
    """x @ Wᵀ (+ b) on a dense ``{"w", "b"}`` linear."""
    if isinstance(p, PackedLinear):
        raise NotImplementedError(
            "apply_linear on a PackedLinear needs the fused dequant-matmul "
            "kernel K3 (ROADMAP.md queue 2, slice 2)")
    y = x @ p["w"].T.to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ------------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


# -------------------------------------------------------------------- rope


def rope_cache(cfg: ModelConfig, seq_len: int, device=None, dtype=torch.float32):
    """(cos, sin) of shape (seq_len, head_dim), HF rotate-half layout."""
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, half, dtype=torch.float32, device=device) / half))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, n_heads, head_dim); cos/sin: (seq, head_dim)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    c = cos[:, None, :].float()
    s = sin[:, None, :].float()
    return (x.float() * c + rotated.float() * s).to(x.dtype)


# --------------------------------------------------------------- attention


def _naive_causal_attention(q, k, v):
    """q: (b, s, h, d); k, v: (b, s, kv, d).  Returns (b, s, h, d)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    logits = logits.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _sdpa_causal_attention(q, k, v):
    """PyTorch's fused attention (GQA heads expanded as the JAX flash
    path does), in the (b, s, h, d) layout of the naive version."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, scale=1.0 / (q.shape[-1] ** 0.5))
    return out.transpose(1, 2)


def causal_attention(q, k, v, impl: str = "auto"):
    if impl == "auto":
        impl = "flash" if q.is_cuda else "naive"
    if impl == "flash":
        return _sdpa_causal_attention(q, k, v)
    return _naive_causal_attention(q, k, v)


# ------------------------------------------------------------ decoder layer


def attn_input(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Input to quantization group 0 (q/k/v_proj)."""
    return rms_norm(x, lp["input_layernorm"]["weight"], cfg.rms_norm_eps)


def attn_core(lp: Params, cfg: ModelConfig, h: torch.Tensor, cos, sin,
              attn_impl: str = "auto") -> torch.Tensor:
    """q/k/v through attention; returns the group-1 input (o_proj),
    shape (batch, seq, q_size)."""
    b, s, _ = h.shape
    q = apply_linear(lp["self_attn"]["q_proj"], h).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = apply_linear(lp["self_attn"]["k_proj"], h).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = apply_linear(lp["self_attn"]["v_proj"], h).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, lp["self_attn"]["q_norm"]["weight"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["self_attn"]["k_norm"]["weight"], cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = causal_attention(q, k, v, impl=attn_impl)
    return attn.reshape(b, s, cfg.q_size)


def mlp_input(lp: Params, cfg: ModelConfig, x2: torch.Tensor) -> torch.Tensor:
    """Input to quantization group 2 (gate/up_proj)."""
    return rms_norm(x2, lp["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)


def mlp_act(lp: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Group-3 input: silu(gate)·up."""
    gate = apply_linear(lp["mlp"]["gate_proj"], h)
    up = apply_linear(lp["mlp"]["up_proj"], h)
    return F.silu(gate) * up


def attn_out_proj(lp: Params, cfg: ModelConfig, attn: torch.Tensor) -> torch.Tensor:
    return apply_linear(lp["self_attn"]["o_proj"], attn)


def mlp_out_proj(lp: Params, cfg: ModelConfig, act: torch.Tensor) -> torch.Tensor:
    return apply_linear(lp["mlp"]["down_proj"], act)


def decoder_layer(lp: Params, cfg: ModelConfig, x: torch.Tensor, cos, sin,
                  attn_impl: str = "auto") -> torch.Tensor:
    """One pre-norm decoder block; x: (batch, seq, hidden)."""
    h = attn_input(lp, cfg, x)
    attn = attn_core(lp, cfg, h, cos, sin, attn_impl=attn_impl)
    x = x + attn_out_proj(lp, cfg, attn)
    h2 = mlp_input(lp, cfg, x)
    return x + mlp_out_proj(lp, cfg, mlp_act(lp, cfg, h2))


# -------------------------------------------------------------- full model


def embed_tokens(params: Params, input_ids: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    return params["model"]["embed_tokens"]["weight"][input_ids].to(dtype)


def apply_final_norm(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, params["model"]["norm"]["weight"], cfg.rms_norm_eps)


def lm_logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_word_embeddings:
        w = params["model"]["embed_tokens"]["weight"]
    elif isinstance(params["lm_head"], PackedLinear):
        raise NotImplementedError(
            "a packed lm_head needs the fused dequant-matmul kernel K3 "
            "(ROADMAP.md queue 2, slice 2)")
    else:
        w = params["lm_head"]["w"]
    return x.float() @ w.T.float()


@torch.no_grad()
def forward(params: Params, cfg: ModelConfig, input_ids: torch.Tensor,
            attn_impl: str = "auto") -> torch.Tensor:
    """Full forward, returns (batch, seq, vocab) f32 logits."""
    _check_family(cfg)
    x = embed_tokens(params, input_ids)
    cos, sin = rope_cache(cfg, input_ids.shape[1], device=x.device)
    for lp in params["model"]["layers"]:
        x = decoder_layer(lp, cfg, x, cos, sin, attn_impl=attn_impl)
    x = apply_final_norm(params, cfg, x)
    return lm_logits(params, cfg, x)


# ---------------------------------------------------------------- init


def init_params(cfg: ModelConfig, seed: int = 0, device: str = "cuda",
                dtype=torch.bfloat16) -> Params:
    """Random init with standard LLM scaling, from ``seed`` (the numbers
    differ from ``jax.random``'s; share weights through
    ``tgq_torch.models.convert`` where the two must agree)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return w * torch.tensor(scale, dtype=dtype, device=dev)

    def dense(out_f, in_f, scale=None):
        return {"w": normal((out_f, in_f), 1.0 / in_f ** 0.5 if scale is None else scale)}

    def maybe_bias(p, out_f):
        if cfg.attention_bias:
            p["b"] = torch.zeros((out_f,), dtype=dtype, device=dev)
        return p

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    layers = []
    for _ in range(cfg.num_layers):
        lp = {
            "input_layernorm": {"weight": ones(cfg.hidden_size)},
            "post_attention_layernorm": {"weight": ones(cfg.hidden_size)},
            "self_attn": {
                "q_proj": maybe_bias(dense(cfg.q_size, cfg.hidden_size), cfg.q_size),
                "k_proj": maybe_bias(dense(cfg.kv_size, cfg.hidden_size), cfg.kv_size),
                "v_proj": maybe_bias(dense(cfg.kv_size, cfg.hidden_size), cfg.kv_size),
                "o_proj": dense(cfg.hidden_size, cfg.q_size),
            },
            "mlp": {
                "gate_proj": dense(cfg.intermediate_size, cfg.hidden_size),
                "up_proj": dense(cfg.intermediate_size, cfg.hidden_size),
                "down_proj": dense(cfg.hidden_size, cfg.intermediate_size),
            },
        }
        if cfg.qk_norm:
            lp["self_attn"]["q_norm"] = {"weight": ones(cfg.head_dim)}
            lp["self_attn"]["k_norm"] = {"weight": ones(cfg.head_dim)}
        layers.append(lp)

    params: Params = {
        "model": {
            "embed_tokens": {"weight": normal((cfg.vocab_size, cfg.hidden_size), 0.02)},
            "layers": layers,
            "norm": {"weight": ones(cfg.hidden_size)},
        }
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(cfg.vocab_size, cfg.hidden_size, scale=0.02)
    return params


# ------------------------------------------------- quantization plumbing


def sequenced_groups(cfg: ModelConfig) -> list[list[str]]:
    """Quantization order within a decoder layer: 4 sequential groups that
    share one input Hessian each."""
    _check_family(cfg)
    return [
        ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"],
        ["self_attn.o_proj"],
        ["mlp.gate_proj", "mlp.up_proj"],
        ["mlp.down_proj"],
    ]


def find_linear_paths(cfg: ModelConfig) -> list[str]:
    """All quantizable linears in one decoder layer."""
    return [name for group in sequenced_groups(cfg) for name in group]


def get_nested(tree: Params, dotted: str):
    cur = tree
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def set_nested(tree: Params, dotted: str, value) -> None:
    parts = dotted.split(".")
    cur = tree
    for part in parts[:-1]:
        cur = cur[part]
    cur[parts[-1]] = value


def tree_to(tree, device):
    """Copy a parameter (sub)tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)
