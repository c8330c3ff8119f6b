"""Calibration of static per-channel KV equalizers (mirrors
``tgq/serve/kv_calibrate.py``).

Per-token absmax KV quantization (``tgq_torch.serve.kv_cache``) spends its
whole range on the largest channel of each token row.  A static
per-channel equalizer, rows stored as K/k_eq and V/v_eq, flattens the
channel profile before the per-token absmax; the decode step folds the
equalizers into the query and the attention output
(``tgq_torch.serve.decode``).

``estimate_kv_equalizers`` measures the per-channel RMS of post-rope K and
of V on a calibration batch, layer by layer, through the model's own
staged functions (so the profile is of the K the cache stores),
normalized to mean 1 per KV head.  Llama family only, as the engine.
"""
from __future__ import annotations

import numpy as np
import torch

from tgq_torch.models.config import ModelConfig


def _channel_profile(t: torch.Tensor) -> torch.Tensor:
    """(batch, seq, kvh, d) → (kvh·d,) per-channel RMS, mean 1 per head,
    floored at 1e-3."""
    r = torch.sqrt(torch.mean(torch.square(t.float()), dim=(0, 1)) + 1e-12)  # (kvh, d)
    r = r / torch.mean(r, dim=-1, keepdim=True)
    return torch.clamp(r, min=1e-3).reshape(-1)


@torch.no_grad()
def estimate_kv_equalizers(params, cfg: ModelConfig, input_ids, attn_impl: str = "auto"):
    """(k_eq, v_eq), each (layers, kv_heads·head_dim) f32 numpy.

    ``params``: the plain per-layer tree (before ``Engine`` fuses q/k/v),
    dense or packed (packed projections run through K3), on the device the
    calibration runs on.  ``input_ids``: (batch, seq) calibration tokens,
    numpy or a tensor; a few hundred tokens give stable profiles."""
    from tgq_torch.models.causal_lm import (
        apply_linear,
        apply_rope,
        attn_input,
        decoder_layer,
        embed_tokens,
        rms_norm,
        rope_cache,
    )

    if cfg.family != "llama":
        raise NotImplementedError("KV equalizers are calibrated for the llama family")
    dev = params["model"]["embed_tokens"]["weight"].device
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long).to(dev)
    b, s = ids.shape
    x = embed_tokens(params, ids)
    cos, sin = rope_cache(cfg, s, device=dev)
    kvh, d = cfg.num_kv_heads, cfg.head_dim
    k_eqs, v_eqs = [], []
    for lp in params["model"]["layers"]:
        sa = lp["self_attn"]
        h = attn_input(lp, cfg, x)
        k = apply_linear(sa["k_proj"], h).reshape(b, s, kvh, d)
        v = apply_linear(sa["v_proj"], h).reshape(b, s, kvh, d)
        if cfg.qk_norm:
            k = rms_norm(k, sa["k_norm"]["weight"], cfg.rms_norm_eps)
        k = apply_rope(k, cos, sin)  # the cache stores post-rope K
        k_eqs.append(_channel_profile(k))
        v_eqs.append(_channel_profile(v))
        x = decoder_layer(lp, cfg, x, cos, sin, attn_impl=attn_impl)
    return (torch.stack(k_eqs).cpu().numpy(), torch.stack(v_eqs).cpu().numpy())
