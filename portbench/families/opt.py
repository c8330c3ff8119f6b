"""The OPT family (pre-LayerNorm variants): learned positions at an
offset of 2, biased multi-head attention, LayerNorm, a ReLU MLP.  Every
layer is alike: four quantization groups (q/k/v, out_proj, fc1, fc2),
each fed by every calibration token.  The port's serving engine does not
run this family.

Weights (``lib/weights.py``): the linears and their biases from one draw
a layer, token embeddings N(0, 0.02^2) (the head is tied), learned
positions N(0, 0.01^2), LayerNorm weights ones and biases zeros.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench.lib import weights
from portbench.lib.plan import LayerPlan, Linear, dense
from portbench.reference.layers import causal_attention, layer_norm, linear

SERVES = False
POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding: row = position + 2
EPS = 1e-5      # torch's LayerNorm default, which OPT uses


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
    eps: float = EPS


def dims(conf: dict) -> Dims:
    """Sizes from a configuration file's published keys."""
    h, heads = conf["hidden_size"], conf["num_attention_heads"]
    return Dims(family=conf["family"], hidden=h, ff=conf["ffn_dim"],
                layers=conf["num_hidden_layers"], heads=heads, kv_heads=heads,
                head_dim=h // heads, vocab=conf["vocab_size"],
                max_pos=conf["max_position_embeddings"])


def port_config(conf: dict, name: str) -> dict:
    """The fields of the port's ``ModelConfig``."""
    d = dims(conf)
    return dict(name=name, vocab_size=d.vocab, hidden_size=d.hidden, intermediate_size=d.ff,
                num_layers=d.layers, num_heads=d.heads, num_kv_heads=d.kv_heads,
                head_dim=d.head_dim, rope_theta=1e6, rms_norm_eps=d.eps, qk_norm=False,
                attention_bias=False, tie_word_embeddings=True,
                max_position_embeddings=d.max_pos, family=d.family)


def layer_plan(d: Dims, li: int) -> LayerPlan:
    h = d.hidden
    lin = [Linear("self_attn.q_proj", h, h, True), Linear("self_attn.k_proj", h, h, True),
           Linear("self_attn.v_proj", h, h, True), Linear("self_attn.out_proj", h, h, True),
           Linear("fc1", d.ff, h, True), Linear("fc2", h, d.ff, True)]
    names = [x.path for x in lin]
    return dense(lin, [names[0:3], names[3:4], names[4:5], names[5:6]], attention=True)


def make_layer(d: Dims, seed: int, li: int, dtype, device) -> dict:
    """Layer ``li``'s tree, from one draw."""
    lp = weights.draw_linears(layer_plan(d, li).linears, seed, li, dtype, device)
    for ln in ("self_attn_layer_norm", "final_layer_norm"):
        lp[ln] = {"weight": torch.ones((d.hidden,), dtype=dtype, device=device),
                  "bias": torch.zeros((d.hidden,), dtype=dtype, device=device)}
    return lp


def make_outer(d: Dims, seed: int, dtype, device) -> dict:
    """Everything outside the layers: embeddings, positions, final norm."""
    model: dict = {"embed_tokens": {"weight": torch.randn(
        (d.vocab, d.hidden), generator=weights.gen(device, seed, "embed"), dtype=dtype,
        device=device).mul_(0.02)}}
    model["wpe"] = {"weight": torch.randn(
        (d.max_pos + POS_OFFSET, d.hidden), generator=weights.gen(device, seed, "wpe"),
        dtype=dtype, device=device).mul_(0.01)}
    model["norm"] = {"weight": torch.ones((d.hidden,), dtype=dtype, device=device),
                     "bias": torch.zeros((d.hidden,), dtype=dtype, device=device)}
    return {"model": model}


# ------------------------------------------------ the plain reference (f32 / f64)

def ref_outer(d: Dims, outer: dict, dtype) -> dict:
    m = outer["model"]
    return {"embed": m["embed_tokens"]["weight"],
            "norm": (m["norm"]["weight"].to(dtype), m["norm"]["bias"].to(dtype)),
            "wpe": m["wpe"]["weight"], "head": m["embed_tokens"]["weight"]}


def ref_embed(d: Dims, o: dict, ids, dtype):
    s = ids.shape[-1]
    return o["embed"][ids].to(dtype) + o["wpe"][POS_OFFSET:POS_OFFSET + s].to(dtype)[None]


def ref_final(d: Dims, o: dict, x):
    return layer_norm(x, *o["norm"], d.eps)


def ref_tensors(d: Dims, lp: dict, dtype) -> dict:
    """The layer's tensors other than its linears (its LayerNorms)."""
    return {n: (lp[n]["weight"].to(dtype), lp[n]["bias"].to(dtype))
            for n in ("self_attn_layer_norm", "final_layer_norm")}


def ref_layer(d: Dims, li: int, w: dict, t: dict, x):
    """Layer ``li`` on ``x`` (b, s, hidden): yields each group's input in
    sweep order, then the layer's output (as ``llama.ref_layer``)."""
    h = layer_norm(x, *t["self_attn_layer_norm"], d.eps)
    yield h
    b, s, _ = h.shape
    q = linear(h, w["self_attn.q_proj"]).reshape(b, s, d.heads, d.head_dim)
    k = linear(h, w["self_attn.k_proj"]).reshape(b, s, d.kv_heads, d.head_dim)
    v = linear(h, w["self_attn.v_proj"]).reshape(b, s, d.kv_heads, d.head_dim)
    a = causal_attention(q, k, v).reshape(b, s, d.hidden)
    del q, k, v
    yield a
    x2 = x + linear(a, w["self_attn.out_proj"])
    h2 = layer_norm(x2, *t["final_layer_norm"], d.eps)
    yield h2
    act = torch.relu(linear(h2, w["fc1"]))
    yield act
    yield x2 + linear(act, w["fc2"])
