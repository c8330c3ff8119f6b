"""The llama family (Qwen3, Qwen2.5, Llama-3): pre-RMSNorm, per-head q/k
RMSNorm where the model type is ``qwen3``, rotate-half RoPE, GQA with
optional q/k/v bias, a SiLU GLU.  Every layer is alike: four quantization
groups (q/k/v, o, gate/up, down), each fed by every calibration token.
The port's serving engine runs this family.

Weights (``lib/weights.py``): the linears from one draw a layer,
embeddings and an untied head N(0, 0.02^2), norm weights ones.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.lib import weights
from portbench.lib.plan import LayerPlan, Linear, dense
from portbench.reference.layers import causal_attention, linear, rms_norm, rope

SERVES = True


@dataclasses.dataclass(frozen=True)
class Dims:
    family: str
    hidden: int
    ff: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    max_pos: int
    eps: float
    tie: bool
    qk_norm: bool = False
    bias: bool = False    # q/k/v bias
    rope_theta: float = 0.0

    @property
    def q_size(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.kv_heads * self.head_dim


def dims(conf: dict) -> Dims:
    """Sizes from a configuration file's published keys."""
    return Dims(family=conf["family"], hidden=conf["hidden_size"], ff=conf["intermediate_size"],
                layers=conf["num_hidden_layers"], heads=conf["num_attention_heads"],
                kv_heads=conf["num_key_value_heads"],
                head_dim=conf.get("head_dim") or conf["hidden_size"] // conf["num_attention_heads"],
                vocab=conf["vocab_size"], max_pos=conf["max_position_embeddings"],
                eps=conf["rms_norm_eps"], tie=conf["tie_word_embeddings"],
                qk_norm=conf["model_type"] == "qwen3",
                bias=conf.get("attention_bias", False), rope_theta=conf["rope_theta"])


def port_config(conf: dict, name: str) -> dict:
    """The fields of the port's ``ModelConfig``."""
    d = dims(conf)
    return dict(name=name, vocab_size=d.vocab, hidden_size=d.hidden, intermediate_size=d.ff,
                num_layers=d.layers, num_heads=d.heads, num_kv_heads=d.kv_heads,
                head_dim=d.head_dim, rope_theta=d.rope_theta or 1e6, rms_norm_eps=d.eps,
                qk_norm=d.qk_norm, attention_bias=d.bias, tie_word_embeddings=d.tie,
                max_position_embeddings=d.max_pos, family=d.family)


def layer_plan(d: Dims, li: int) -> LayerPlan:
    lin = [Linear("self_attn.q_proj", d.q_size, d.hidden, d.bias),
           Linear("self_attn.k_proj", d.kv_size, d.hidden, d.bias),
           Linear("self_attn.v_proj", d.kv_size, d.hidden, d.bias),
           Linear("self_attn.o_proj", d.hidden, d.q_size, False),
           Linear("mlp.gate_proj", d.ff, d.hidden, False),
           Linear("mlp.up_proj", d.ff, d.hidden, False),
           Linear("mlp.down_proj", d.hidden, d.ff, False)]
    names = [x.path for x in lin]
    return dense(lin, [names[0:3], names[3:4], names[4:6], names[6:7]], attention=True)


def make_layer(d: Dims, seed: int, li: int, dtype, device) -> dict:
    """Layer ``li``'s tree, from one draw."""
    lp = weights.draw_linears(layer_plan(d, li).linears, seed, li, dtype, device)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    lp["input_layernorm"] = {"weight": ones(d.hidden)}
    lp["post_attention_layernorm"] = {"weight": ones(d.hidden)}
    if d.qk_norm:
        lp["self_attn"]["q_norm"] = {"weight": ones(d.head_dim)}
        lp["self_attn"]["k_norm"] = {"weight": ones(d.head_dim)}
    return lp


def make_outer(d: Dims, seed: int, dtype, device) -> dict:
    """Everything outside the layers: embeddings, final norm, head."""
    model: dict = {"embed_tokens": {"weight": torch.randn(
        (d.vocab, d.hidden), generator=weights.gen(device, seed, "embed"), dtype=dtype,
        device=device).mul_(0.02)}}
    out: dict = {"model": model}
    model["norm"] = {"weight": torch.ones((d.hidden,), dtype=dtype, device=device)}
    if not d.tie:
        out["lm_head"] = {"w": torch.randn(
            (d.vocab, d.hidden), generator=weights.gen(device, seed, "head"), dtype=dtype,
            device=device).mul_(0.02)}
    return out


# ------------------------------------------------ the plain reference (f32 / f64)

def ref_outer(d: Dims, outer: dict, dtype) -> dict:
    m = outer["model"]
    return {"embed": m["embed_tokens"]["weight"], "norm": (m["norm"]["weight"].to(dtype),),
            "head": outer["lm_head"]["w"] if "lm_head" in outer
            else m["embed_tokens"]["weight"]}


def ref_embed(d: Dims, o: dict, ids, dtype):
    return o["embed"][ids].to(dtype)


def ref_final(d: Dims, o: dict, x):
    return rms_norm(x, o["norm"][0], d.eps)


def ref_tensors(d: Dims, lp: dict, dtype) -> dict:
    """The layer's tensors other than its linears (its norm weights)."""
    out = {"input_layernorm": (lp["input_layernorm"]["weight"].to(dtype),),
           "post_attention_layernorm": (lp["post_attention_layernorm"]["weight"].to(dtype),)}
    if d.qk_norm:
        out["self_attn.q_norm"] = (lp["self_attn"]["q_norm"]["weight"].to(dtype),)
        out["self_attn.k_norm"] = (lp["self_attn"]["k_norm"]["weight"].to(dtype),)
    return out


def ref_layer(d: Dims, li: int, w: dict, t: dict, x):
    """Layer ``li`` on ``x`` (b, s, hidden): yields each group's input in
    sweep order, then the layer's output.  ``w`` maps a linear's path to
    (weight, bias or None), ``t`` is ``ref_tensors``; weights are read as
    the generator reaches them."""
    h = rms_norm(x, t["input_layernorm"][0], d.eps)
    yield h
    b, s, _ = h.shape
    q = linear(h, w["self_attn.q_proj"]).reshape(b, s, d.heads, d.head_dim)
    k = linear(h, w["self_attn.k_proj"]).reshape(b, s, d.kv_heads, d.head_dim)
    v = linear(h, w["self_attn.v_proj"]).reshape(b, s, d.kv_heads, d.head_dim)
    if d.qk_norm:
        q = rms_norm(q, t["self_attn.q_norm"][0], d.eps)
        k = rms_norm(k, t["self_attn.k_norm"][0], d.eps)
    q, k = rope(q, d.rope_theta), rope(k, d.rope_theta)
    a = causal_attention(q, k, v).reshape(b, s, d.q_size)
    del q, k, v
    yield a
    x2 = x + linear(a, w["self_attn.o_proj"])
    h2 = rms_norm(x2, t["post_attention_layernorm"][0], d.eps)
    yield h2
    act = torch.nn.functional.silu(linear(h2, w["mlp.gate_proj"])) * linear(h2, w["mlp.up_proj"])
    yield act
    yield x2 + linear(act, w["mlp.down_proj"])
