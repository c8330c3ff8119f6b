"""GPT-2 family: the transformer.h decoder layout (mirrors
``tgq/models/gpt2.py``).

LayerNorm with bias, fused QKV in one ``attn.c_attn`` linear, a tanh-GELU
MLP (``mlp.c_fc`` → ``mlp.c_proj``), learned position embeddings instead
of rope, and a tied head.  The four sequential quantization groups are
[c_attn] → [attn.c_proj] → [c_fc] → [mlp.c_proj].

Tree layout (``hf_import`` maps ``transformer.h.N.*`` here and transposes
the HF Conv1D weights to the (out, in) convention):

  model.embed_tokens.weight   (wte)
  model.wpe.weight
  model.layers[i].ln_1.{weight,bias}
  model.layers[i].attn.c_attn  {"w": (3h, h), "b": (3h,)}
  model.layers[i].attn.c_proj  {"w": (h, h),  "b": (h,)}
  model.layers[i].ln_2.{weight,bias}
  model.layers[i].mlp.c_fc     {"w": (4h, h), "b": (4h,)}
  model.layers[i].mlp.c_proj   {"w": (h, 4h), "b": (h,)}
  model.norm.{weight,bias}     (ln_f)
"""
from __future__ import annotations

import math

import torch

from tgq_torch.models.config import ModelConfig
from tgq_torch.utils.precision import resolve_device

Params = dict


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) * (xf - mu)).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` as XLA computes it on a bf16
    ``x``: 0.5·x·(1 + tanh(sqrt(2/π)·(x + 0.044715·x³))) with every step
    rounded to x's dtype.  ``F.gelu(approximate="tanh")`` rounds once and
    differs in about 40 % of bf16 values."""
    dt = x.dtype

    def c(v):
        return torch.tensor(v, dtype=dt, device=x.device)

    inner = x + c(0.044715) * (x * x * x)
    cdf = c(0.5) * (c(1.0) + torch.tanh(c(math.sqrt(2.0 / math.pi)) * inner))
    return x * cdf


def gpt2_embed(params: Params, input_ids: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    """wte[ids] + wpe[positions]."""
    wte = params["model"]["embed_tokens"]["weight"]
    wpe = params["model"]["wpe"]["weight"]
    seq = input_ids.shape[-1]
    return (wte[input_ids] + wpe[:seq][None]).to(dtype)


def gpt2_attn_input(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """ln_1(x): the c_attn (group 0) input."""
    return layer_norm(x, lp["ln_1"]["weight"], lp["ln_1"]["bias"], cfg.rms_norm_eps)


def gpt2_attn_core(lp: Params, cfg: ModelConfig, h: torch.Tensor,
                   attn_impl: str = "auto") -> torch.Tensor:
    """Fused-QKV causal attention; returns the attn.c_proj (group 1)
    input, shape (batch, seq, hidden)."""
    from tgq_torch.models.causal_lm import apply_linear, causal_attention

    b, s, _ = h.shape
    q, k, v = apply_linear(lp["attn"]["c_attn"], h).chunk(3, dim=-1)
    shape = (b, s, cfg.num_heads, cfg.head_dim)
    attn = causal_attention(q.reshape(shape), k.reshape(shape), v.reshape(shape),
                            impl=attn_impl)
    return attn.reshape(b, s, cfg.hidden_size)


def gpt2_attn_out(lp: Params, cfg: ModelConfig, attn: torch.Tensor) -> torch.Tensor:
    from tgq_torch.models.causal_lm import apply_linear

    return apply_linear(lp["attn"]["c_proj"], attn)


def gpt2_mlp_input(lp: Params, cfg: ModelConfig, x2: torch.Tensor) -> torch.Tensor:
    """ln_2(x2): the mlp.c_fc (group 2) input."""
    return layer_norm(x2, lp["ln_2"]["weight"], lp["ln_2"]["bias"], cfg.rms_norm_eps)


def gpt2_mlp_act(lp: Params, cfg: ModelConfig, h2: torch.Tensor) -> torch.Tensor:
    """gelu(c_fc(h2)): the mlp.c_proj (group 3) input."""
    from tgq_torch.models.causal_lm import apply_linear

    return gelu_tanh(apply_linear(lp["mlp"]["c_fc"], h2))


def gpt2_mlp_out(lp: Params, cfg: ModelConfig, act: torch.Tensor) -> torch.Tensor:
    from tgq_torch.models.causal_lm import apply_linear

    return apply_linear(lp["mlp"]["c_proj"], act)


def gpt2_decoder_layer(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                       attn_impl: str = "auto") -> torch.Tensor:
    h = gpt2_attn_input(lp, cfg, x)
    x = x + gpt2_attn_out(lp, cfg, gpt2_attn_core(lp, cfg, h, attn_impl=attn_impl))
    h2 = gpt2_mlp_input(lp, cfg, x)
    return x + gpt2_mlp_out(lp, cfg, gpt2_mlp_act(lp, cfg, h2))


def gpt2_final_norm(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    n = params["model"]["norm"]
    return layer_norm(x, n["weight"], n["bias"], cfg.rms_norm_eps)


def gpt2_sequenced_groups(cfg: ModelConfig) -> list[list[str]]:
    """Four sequential quantization groups sharing one Hessian each;
    c_attn is already fused."""
    return [["attn.c_attn"], ["attn.c_proj"], ["mlp.c_fc"], ["mlp.c_proj"]]


def init_gpt2_params(cfg: ModelConfig, seed: int = 0, device: str = "cuda",
                     dtype=torch.bfloat16) -> Params:
    """Random init with the JAX package's scales, from ``seed`` (the
    numbers are ``torch.Generator``'s, not ``jax.random``'s)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return w * torch.tensor(scale, dtype=dtype, device=dev)

    def dense(out_f, in_f):
        return {"w": normal((out_f, in_f), 1.0 / in_f ** 0.5),
                "b": torch.zeros((out_f,), dtype=dtype, device=dev)}

    def ln(n):
        return {"weight": torch.ones((n,), dtype=dtype, device=dev),
                "bias": torch.zeros((n,), dtype=dtype, device=dev)}

    h = cfg.hidden_size
    layers = [{
        "ln_1": ln(h),
        "attn": {"c_attn": dense(3 * h, h), "c_proj": dense(h, h)},
        "ln_2": ln(h),
        "mlp": {"c_fc": dense(cfg.intermediate_size, h),
                "c_proj": dense(h, cfg.intermediate_size)},
    } for _ in range(cfg.num_layers)]
    return {"model": {
        "embed_tokens": {"weight": normal((cfg.vocab_size, h), 0.02)},
        "wpe": {"weight": normal((cfg.max_position_embeddings, h), 0.01)},
        "layers": layers,
        "norm": ln(h),
    }}
