"""Decoder-only causal LM (mirrors ``tgq/models/causal_lm.py``): the llama
family here, GPT-2 (``tgq_torch.models.gpt2``) and OPT
(``tgq_torch.models.opt``) behind the same staged functions.

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
from tgq_torch.kernels.dequant_matmul import glu_act, quantized_matmul
from tgq_torch.models.config import ModelConfig
from tgq_torch.utils.precision import resolve_device

Params = dict


def _family_fn(cfg: ModelConfig, name: str):
    """``<family>_<name>`` of the gpt2 or opt module, or None for the
    llama family (whose versions are the functions of this module)."""
    if cfg.family == "llama":
        return None
    if cfg.family == "gpt2":
        from tgq_torch.models import gpt2 as mod
    elif cfg.family == "opt":
        from tgq_torch.models import opt as mod
    else:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return getattr(mod, f"{cfg.family}_{name}")


# ----------------------------------------------------------------- linears


def apply_linear(p, x: torch.Tensor, glu: bool = False) -> torch.Tensor:
    """x @ Wᵀ (+ b) on a dense ``{"w", "b"}`` linear or a
    :class:`PackedLinear` (the packed-weight kernels K3/K4,
    ``tgq_torch.kernels.dequant_matmul``).

    ``glu``: x's last dim is 2·in_features holding [gate | up], and the
    matmul input is silu(gate)·up."""
    if isinstance(p, PackedLinear):
        return quantized_matmul(x, p, glu=glu)
    if glu:
        n = p["w"].shape[1]
        x = glu_act(x[..., :n], x[..., n:])
    y = x @ p["w"].T.to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def linear_weight(p) -> torch.Tensor:
    """Dense (out, in) view of a linear (dequantized if packed)."""
    if isinstance(p, PackedLinear):
        return p.dequantize()
    return p["w"]


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
    """Input to quantization group 0 (q/k/v_proj; gpt2: c_attn)."""
    if fn := _family_fn(cfg, "attn_input"):
        return fn(lp, cfg, x)
    return rms_norm(x, lp["input_layernorm"]["weight"], cfg.rms_norm_eps)


def attn_core(lp: Params, cfg: ModelConfig, h: torch.Tensor, cos, sin,
              attn_impl: str = "auto") -> torch.Tensor:
    """q/k/v through attention; returns the group-1 input (o_proj; gpt2:
    attn.c_proj; opt: out_proj), shape (batch, seq, q_size)."""
    if fn := _family_fn(cfg, "attn_core"):
        return fn(lp, cfg, h, attn_impl=attn_impl)
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
    """Input to quantization group 2 (gate/up_proj; gpt2: c_fc; opt: fc1)."""
    if fn := _family_fn(cfg, "mlp_input"):
        return fn(lp, cfg, x2)
    return rms_norm(x2, lp["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)


def mlp_act(lp: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Group-3 input: silu(gate)·up (gpt2: gelu(c_fc h); opt: relu(fc1 h))."""
    if fn := _family_fn(cfg, "mlp_act"):
        return fn(lp, cfg, h)
    gate = apply_linear(lp["mlp"]["gate_proj"], h)
    up = apply_linear(lp["mlp"]["up_proj"], h)
    return glu_act(gate, up)


def attn_out_proj(lp: Params, cfg: ModelConfig, attn: torch.Tensor) -> torch.Tensor:
    if fn := _family_fn(cfg, "attn_out"):
        return fn(lp, cfg, attn)
    return apply_linear(lp["self_attn"]["o_proj"], attn)


def mlp_out_proj(lp: Params, cfg: ModelConfig, act: torch.Tensor) -> torch.Tensor:
    if fn := _family_fn(cfg, "mlp_out"):
        return fn(lp, cfg, act)
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


def embed_tokens(params: Params, input_ids: torch.Tensor, dtype=torch.bfloat16,
                 cfg: ModelConfig | None = None) -> torch.Tensor:
    """Token embeddings, plus the learned positions of gpt2/opt (which
    need ``cfg``)."""
    if cfg is not None and (fn := _family_fn(cfg, "embed")):
        return fn(params, input_ids, dtype)
    return params["model"]["embed_tokens"]["weight"][input_ids].to(dtype)


def apply_final_norm(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if fn := _family_fn(cfg, "final_norm"):
        return fn(params, cfg, x)
    return rms_norm(x, params["model"]["norm"]["weight"], cfg.rms_norm_eps)


def lm_logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_word_embeddings:
        w = params["model"]["embed_tokens"]["weight"]
    elif isinstance(params["lm_head"], PackedLinear):
        # a head packed with lane padding (core.packing.pad_out) yields
        # ~0 pad logits that must not reach sampling
        y = quantized_matmul(x, params["lm_head"], out_dtype=torch.float32)
        return y[..., : cfg.vocab_size]
    else:
        w = params["lm_head"]["w"]
    return x.float() @ w.T.float()


@torch.no_grad()
def forward(params: Params, cfg: ModelConfig, input_ids: torch.Tensor,
            attn_impl: str = "auto") -> torch.Tensor:
    """Full forward, returns (batch, seq, vocab) f32 logits."""
    x = embed_tokens(params, input_ids, cfg=cfg)
    cos, sin = rope_cache(cfg, input_ids.shape[1], device=x.device)
    for lp in params["model"]["layers"]:
        x = decoder_layer(lp, cfg, x, cos, sin, attn_impl=attn_impl)
    x = apply_final_norm(params, cfg, x)
    return lm_logits(params, cfg, x)


@torch.no_grad()
def greedy_generate(params: Params, cfg: ModelConfig, prompt_ids, max_new_tokens: int,
                    attn_impl: str = "auto") -> list[int]:
    """Family-agnostic greedy generation by full-recompute ``forward``
    (the generation path of gpt2/opt, which the paged engine does not
    serve).  The sequence lives in one fixed (1, L) buffer: causal
    attention makes positions >= i irrelevant to token i's logits, as in
    the JAX package's single compiled loop.  O(n²·L): a correctness
    path, not a serving path."""
    prompt = [int(t) for t in prompt_ids]
    n_prompt = len(prompt)
    total = n_prompt + max_new_tokens
    if total > cfg.max_position_embeddings:
        raise ValueError(f"{total} tokens exceed max_position_embeddings "
                         f"{cfg.max_position_embeddings}")
    dev = params["model"]["embed_tokens"]["weight"].device
    ids = torch.zeros((1, total), dtype=torch.int64, device=dev)
    ids[0, :n_prompt] = torch.tensor(prompt, dtype=torch.int64)
    for pos in range(n_prompt, total):
        logits = forward(params, cfg, ids, attn_impl=attn_impl)
        ids[0, pos] = torch.argmax(logits[0, pos - 1])
    return ids[0, n_prompt:].tolist()


# ---------------------------------------------------------------- init


def init_params(cfg: ModelConfig, seed: int = 0, device: str = "cuda",
                dtype=torch.bfloat16) -> Params:
    """Random init with standard LLM scaling, from ``seed`` (the numbers
    differ from ``jax.random``'s; share weights through
    ``tgq_torch.models.convert`` where the two must agree)."""
    if cfg.family == "gpt2":
        from tgq_torch.models.gpt2 import init_gpt2_params

        return init_gpt2_params(cfg, seed, device, dtype)
    if cfg.family == "opt":
        from tgq_torch.models.opt import init_opt_params

        return init_opt_params(cfg, seed, device, dtype)
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
    if fn := _family_fn(cfg, "sequenced_groups"):
        return fn(cfg)
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
