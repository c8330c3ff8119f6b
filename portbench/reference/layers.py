"""Plain decoder-layer pieces in the precision of their inputs (f32 or
f64), for the llama family (Qwen3: RMSNorm, per-head q/k RMSNorm, rotate-
half RoPE, GQA, SiLU GLU) and OPT (pre-LayerNorm, learned positions at
an offset of 2, biased MHA, ReLU).  Each follows the published model
description; the split into a group's input, its product and the
residual is the quantization sweep's order.

``w`` maps a linear's path (``self_attn.q_proj``) to ``(weight, bias or
None)`` in the compute dtype; ``norms`` maps a norm's path to its tensors.
"""
from __future__ import annotations

import math

import torch


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def linear(x, wb):
    w, b = wb
    y = x @ w.T
    return y if b is None else y + b


def rope(x, theta: float, pos0: int = 0):
    """Rotate-half RoPE of x (b, s, h, d) at positions pos0 .. pos0+s-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(0, half, dtype=torch.float64, device=x.device) / half)
    ang = torch.outer(torch.arange(pos0, pos0 + s, dtype=torch.float64, device=x.device), inv)
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().to(x.dtype)[None, :, None], ang.sin().to(x.dtype)[None, :, None]
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def causal_attention(q, k, v, heads_at_once: int = 8):
    """Softmax(q k^T / sqrt(d)) v under a causal mask, every head;
    q (b, s, h, d), k and v (b, s, kvh, d), GQA by repeating k and v."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    out = torch.empty_like(q)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scale = 1.0 / math.sqrt(d)
    for h0 in range(0, h, heads_at_once):
        hs = slice(h0, min(h, h0 + heads_at_once))
        kv_idx = torch.arange(hs.start, hs.stop, device=q.device) // rep
        qh = q[:, :, hs].transpose(1, 2)                      # (b, hh, s, d)
        kh = k[:, :, kv_idx].transpose(1, 2)
        vh = v[:, :, kv_idx].transpose(1, 2)
        sc = (qh @ kh.transpose(-1, -2)) * scale
        sc = sc.masked_fill(~mask, float("-inf"))
        out[:, :, hs] = (torch.softmax(sc, -1) @ vh).transpose(1, 2)
    return out


class Family:
    """The pieces of one family's layer, split at the group inputs."""

    def __init__(self, d):
        self.d = d

    def embed(self, outer, ids, dtype, pos0: int = 0):
        e = outer["embed"][ids].to(dtype)
        if self.d.family == "opt":
            s = ids.shape[-1]
            e = e + outer["wpe"][2 + pos0:2 + pos0 + s].to(dtype)[None]
        return e

    def input0(self, norms, x):
        """Group 0's input (q/k/v)."""
        d = self.d
        if d.family == "opt":
            return layer_norm(x, *norms["self_attn_layer_norm"], d.eps)
        return rms_norm(x, norms["input_layernorm"][0], d.eps)

    def attention(self, w, norms, h):
        """Group 1's input: attention over h's q/k/v."""
        d = self.d
        b, s, _ = h.shape
        q = linear(h, w["self_attn.q_proj"]).reshape(b, s, d.heads, d.head_dim)
        k = linear(h, w["self_attn.k_proj"]).reshape(b, s, d.kv_heads, d.head_dim)
        v = linear(h, w["self_attn.v_proj"]).reshape(b, s, d.kv_heads, d.head_dim)
        if d.family == "llama":
            if d.qk_norm:
                q = rms_norm(q, norms["self_attn.q_norm"][0], d.eps)
                k = rms_norm(k, norms["self_attn.k_norm"][0], d.eps)
            q, k = rope(q, d.rope_theta), rope(k, d.rope_theta)
        return causal_attention(q, k, v).reshape(b, s, d.q_size)

    def out_proj_name(self) -> str:
        return "self_attn.o_proj" if self.d.family == "llama" else "self_attn.out_proj"

    def input2(self, norms, x2):
        """Group 2's input (gate/up, fc1)."""
        d = self.d
        if d.family == "opt":
            return layer_norm(x2, *norms["final_layer_norm"], d.eps)
        return rms_norm(x2, norms["post_attention_layernorm"][0], d.eps)

    def act(self, w, h2):
        """Group 3's input (down_proj, fc2)."""
        if self.d.family == "opt":
            return torch.relu(linear(h2, w["fc1"]))
        return torch.nn.functional.silu(linear(h2, w["mlp.gate_proj"])) * linear(
            h2, w["mlp.up_proj"])

    def down_name(self) -> str:
        return "mlp.down_proj" if self.d.family == "llama" else "fc2"

    def final(self, outer, x):
        d = self.d
        if d.family == "opt":
            return layer_norm(x, *outer["norm"], d.eps)
        return rms_norm(x, outer["norm"][0], d.eps)


def norm_tensors(lp: dict, d, dtype) -> dict:
    """A layer tree's norm weights (and LayerNorm biases), by path."""
    out = {}
    if d.family == "llama":
        out["input_layernorm"] = (lp["input_layernorm"]["weight"].to(dtype),)
        out["post_attention_layernorm"] = (lp["post_attention_layernorm"]["weight"].to(dtype),)
        if d.qk_norm:
            out["self_attn.q_norm"] = (lp["self_attn"]["q_norm"]["weight"].to(dtype),)
            out["self_attn.k_norm"] = (lp["self_attn"]["k_norm"]["weight"].to(dtype),)
    else:
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            out[n] = (lp[n]["weight"].to(dtype), lp[n]["bias"].to(dtype))
    return out


def outer_tensors(outer: dict, d, dtype) -> dict:
    m = outer["model"]
    out = {"embed": m["embed_tokens"]["weight"],
           "norm": (m["norm"]["weight"].to(dtype),) if d.family == "llama"
           else (m["norm"]["weight"].to(dtype), m["norm"]["bias"].to(dtype))}
    if d.family == "opt":
        out["wpe"] = m["wpe"]["weight"]
    out["head"] = (outer["lm_head"]["w"] if "lm_head" in outer
                   else m["embed_tokens"]["weight"])
    return out
