"""Plain pieces of decoder layers in the precision of their inputs (f32
or f64): norms, linears, RoPE, causal attention.  Each family's layer is
put together from them in ``families/<family>.py`` (``ref_layer``), after
the published model description.
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
