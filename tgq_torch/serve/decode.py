"""Prefill and decode steps over the paged KV cache (mirrors
``tgq/serve/decode.py``, single device).

Decode runs every slot every step (inactive slots compute garbage that
the host drops; their KV writes are gated off by ``live``), one layer
after another.  Each layer's attention is
``tgq_torch.kernels.paged_attention.paged_decode_attention`` (K5 on CUDA,
its plain version on the CPU): the current token's K/V are folded in from
registers and the kernel itself stores them into the pools
(``write_current``), so the step does no other pool writes.  Every packed
projection goes through ``quantized_matmul`` (K3, or K4 for A8 weights).

``decode_steps`` runs ``n_steps`` tokens with sampling on the device; only
the ``(n_steps, slots)`` int32 block leaves it.  Greedy sampling is
``argmax`` (first index on ties, as ``jnp.argmax``).  Temperature sampling
is Gumbel-max on noise drawn by ``_uniform`` from a ``torch.Generator``:
the noise is not JAX's threefry stream, but given the same noise the two
samplers pick the same tokens.  Prefill attention is ``causal_attention``
(SDPA on CUDA, the naive f32 softmax on the CPU) over the prompt itself.
"""
from __future__ import annotations

import numpy as np
import torch

from tgq_torch.models.causal_lm import (
    apply_final_norm,
    apply_linear,
    apply_rope,
    causal_attention,
    embed_tokens,
    glu_act,
    lm_logits,
    rms_norm,
    rope_cache,
)
from tgq_torch.models.config import ModelConfig
from tgq_torch.serve.kv_cache import PagedKVCache, kv_write_pages


def fuse_packed_projections(params):
    """Fuse each layer's q/k/v and gate/up PackedLinears into ``qkv_proj``
    / ``gate_up_proj`` (``core.packing.concat_out``, exact: groups run
    along in_features) — 7 → 4 packed matmuls per layer.  A no-op unless
    every projection is packed."""
    from tgq_torch.core.packing import PackedLinear, concat_out

    fused = []
    for lp in params["model"]["layers"]:
        sa, mlp = lp["self_attn"], lp["mlp"]
        if not all(isinstance(sa.get(k), PackedLinear) for k in ("q_proj", "k_proj", "v_proj")):
            return params
        if not all(isinstance(mlp.get(k), PackedLinear) for k in ("gate_proj", "up_proj")):
            return params
        sa2 = {k: v for k, v in sa.items() if k not in ("q_proj", "k_proj", "v_proj")}
        sa2["qkv_proj"] = concat_out([sa["q_proj"], sa["k_proj"], sa["v_proj"]])
        mlp2 = {k: v for k, v in mlp.items() if k not in ("gate_proj", "up_proj")}
        mlp2["gate_up_proj"] = concat_out([mlp["gate_proj"], mlp["up_proj"]])
        fused.append({**lp, "self_attn": sa2, "mlp": mlp2})
    out = dict(params)
    out["model"] = {**params["model"], "layers": fused}
    return out


def _rope_at(cos_p, sin_p, x):
    """Rotary with per-slot rows.  x: (slots, heads, d); cos_p/sin_p:
    (slots, d)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos_p[:, None, :] + rot.float() * sin_p[:, None, :]).to(x.dtype)


def _rope_rows(cfg: ModelConfig, pos: torch.Tensor):
    """(cos, sin) rows at positions ``pos`` — the rows of ``rope_cache``."""
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, half, dtype=torch.float32, device=pos.device) / half))
    freqs = pos.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _qkv(lp, cfg: ModelConfig, h):
    sa = lp["self_attn"]
    if "qkv_proj" in sa:
        return torch.split(apply_linear(sa["qkv_proj"], h),
                           [cfg.q_size, cfg.kv_size, cfg.kv_size], dim=-1)
    return (apply_linear(sa["q_proj"], h), apply_linear(sa["k_proj"], h),
            apply_linear(sa["v_proj"], h))


def _mlp(lp, x, h2):
    mlp = lp["mlp"]
    if "gate_up_proj" in mlp:
        gate, up = apply_linear(mlp["gate_up_proj"], h2).chunk(2, dim=-1)
    else:
        gate, up = apply_linear(mlp["gate_proj"], h2), apply_linear(mlp["up_proj"], h2)
    return x + apply_linear(mlp["down_proj"], glu_act(gate, up))


def _decode_layer(lp, li: int, cfg: ModelConfig, x, cache: PagedKVCache, cos_p, sin_p,
                  table, lens, live):
    """One decoder layer's decode for all slots; writes this layer's
    current-token K/V into the pools (through the attention kernel)."""
    from tgq_torch.kernels.paged_attention import paged_decode_attention

    slots = x.shape[0]
    kvh, d = cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["input_layernorm"]["weight"], cfg.rms_norm_eps)
    q, k, v = _qkv(lp, cfg, h)
    q = q.reshape(slots, cfg.num_heads, d)
    k = k.reshape(slots, kvh, d)
    v = v.reshape(slots, kvh, d)
    if cfg.qk_norm:
        q = rms_norm(q, lp["self_attn"]["q_norm"]["weight"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["self_attn"]["k_norm"]["weight"], cfg.rms_norm_eps)
    q = _rope_at(cos_p, sin_p, q)
    k = _rope_at(cos_p, sin_p, k)
    # 1/sqrt(d) in f32 on the host: a scalar tensor made on the device
    # would be a synchronizing copy every layer
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    qs = q.float() * scale
    k_cur = k.reshape(slots, -1).float()
    v_cur = v.reshape(slots, -1).float()
    rep = cfg.num_heads // kvh
    if cache.k_eq is not None:
        # stored rows are K/eq: fold eq into the query, divide the current row
        ek = cache.k_eq[li]
        qs = (qs.reshape(slots, kvh, rep, d) * ek.reshape(kvh, 1, d)).reshape(
            slots, cfg.num_heads, d)
        k_cur = k_cur / ek
    if cache.v_eq is not None:
        v_cur = v_cur / cache.v_eq[li]
    quantized = cache.ks is not None
    attn = paged_decode_attention(
        qs, cache.k[li], cache.v[li], cache.ks[li] if quantized else None,
        cache.vs[li] if quantized else None, lens, table, k_cur, v_cur, live=live,
        num_kv_heads=kvh, write_current=True)
    if cache.v_eq is not None:
        attn = (attn.reshape(slots, kvh, rep, d) * cache.v_eq[li].reshape(kvh, 1, d)).reshape(
            slots, cfg.num_heads, d)
    x = x + apply_linear(lp["self_attn"]["o_proj"], attn.reshape(slots, cfg.q_size).to(x.dtype))
    h2 = rms_norm(x, lp["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
    return _mlp(lp, x, h2)


def _decode_core(params, cache: PagedKVCache, cfg: ModelConfig, table, lens, tokens, pos,
                 live=None):
    """One token for every slot.  table (slots, mpps) int32; lens (slots,)
    lengths including the token being decoded; tokens (slots,) the input
    token; pos (slots,) its position (lens - 1).  Returns (slots, vocab)
    f32 logits; the cache is updated in place."""
    x = embed_tokens(params, tokens[:, None])[:, 0]
    cos_p, sin_p = _rope_rows(cfg, pos)
    for li, lp in enumerate(params["model"]["layers"]):
        x = _decode_layer(lp, li, cfg, x, cache, cos_p, sin_p, table, lens, live)
    x = apply_final_norm(params, cfg, x[:, None])[:, 0]
    return lm_logits(params, cfg, x[:, None])[:, 0]


@torch.no_grad()
def decode_step(params, cache: PagedKVCache, cfg: ModelConfig, table, lens, tokens, pos,
                live=None):
    """One decode token per slot → (logits (slots, vocab) f32, cache)."""
    return _decode_core(params, cache, cfg, table, lens, tokens, pos, live), cache


def _uniform(shape, gen: torch.Generator, device) -> torch.Tensor:
    """The sampler's noise: f32 uniforms in [tiny, 1) from ``gen``, the
    range of ``jax.random.uniform(minval=tiny)`` in ``jax.random.gumbel``."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u.clamp_(min=torch.finfo(torch.float32).tiny)


def _sample_tokens(logits, temps, gen: torch.Generator, greedy_only: bool = False):
    """Per-slot greedy / temperature sampling on the logits' device.
    temps (slots,), 0 = greedy.  Gumbel-max on ``_uniform``'s noise,
    argmax(-log(-log(u)) + logits / t) as ``jax.random.categorical``."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if greedy_only:
        return greedy
    u = _uniform(logits.shape, gen, logits.device)
    t = torch.clamp(temps, min=1e-6)[:, None]
    sampled = torch.argmax(-torch.log(-torch.log(u)) + logits.float() / t, dim=-1)
    return torch.where(temps > 0, sampled.to(torch.int32), greedy)


@torch.no_grad()
def decode_steps(params, cache: PagedKVCache, cfg: ModelConfig, table, lens, tokens, pos,
                 temps, gen: torch.Generator, n_steps: int, greedy_only: bool = False,
                 live=None):
    """``n_steps`` tokens for every slot, sampled on the device.  The page
    table must already cover ``lens + n_steps - 1`` tokens per slot.
    lens/pos follow ``decode_step`` at step 0 and advance by one each step.
    Returns (tokens (n_steps, slots) int32, cache)."""
    toks = []
    tok = tokens
    for _ in range(n_steps):
        logits = _decode_core(params, cache, cfg, table, lens, tok, pos, live)
        tok = _sample_tokens(logits, temps, gen, greedy_only)
        toks.append(tok)
        lens, pos = lens + 1, pos + 1
    return torch.stack(toks), cache


def _prefill_layer(lp, li: int, cfg: ModelConfig, x, cache: PagedKVCache, cos, sin,
                   slot_pages):
    """One layer of batched prefill: writes the prompt's pages, attends
    within the prompt."""
    b, seq, _ = x.shape
    h = rms_norm(x, lp["input_layernorm"]["weight"], cfg.rms_norm_eps)
    q, k, v = _qkv(lp, cfg, h)
    q = q.reshape(b, seq, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, seq, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, seq, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, lp["self_attn"]["q_norm"]["weight"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["self_attn"]["k_norm"]["weight"], cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    kv_write_pages(cache, li, slot_pages, k, v)
    attn = causal_attention(q, k, v)
    x = x + apply_linear(lp["self_attn"]["o_proj"],
                         attn.reshape(b, seq, cfg.q_size).to(x.dtype))
    h2 = rms_norm(x, lp["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
    return _mlp(lp, x, h2)


def _prefill_core(params, cache: PagedKVCache, cfg: ModelConfig, slot_pages, input_ids,
                  true_len):
    """Batched prefill of b prompts padded to the same page multiple.
    slot_pages (b, n_pages); input_ids (b, seq_pad); true_len (b,).
    Returns the last real token's logits (b, vocab)."""
    b, seq = input_ids.shape
    x = embed_tokens(params, input_ids)
    cos, sin = rope_cache(cfg, seq, device=x.device)
    for li, lp in enumerate(params["model"]["layers"]):
        x = _prefill_layer(lp, li, cfg, x, cache, cos, sin, slot_pages)
    x = apply_final_norm(params, cfg, x)
    last = x[torch.arange(b, device=x.device), true_len.long() - 1][:, None]
    return lm_logits(params, cfg, last)[:, 0]


@torch.no_grad()
def prefill(params, cache: PagedKVCache, cfg: ModelConfig, slot_pages, input_ids, true_len):
    """One prompt: slot_pages (n_pages,), input_ids (1, seq_pad), true_len
    scalar → (last-token logits (vocab,), cache)."""
    tl = torch.as_tensor(true_len, device=input_ids.device).reshape(1)
    logits = _prefill_core(params, cache, cfg, slot_pages[None], input_ids, tl)
    return logits[0], cache


@torch.no_grad()
def prefill_batch(params, cache: PagedKVCache, cfg: ModelConfig, slot_pages, input_ids,
                  true_len, temps, gen: torch.Generator, greedy_only: bool = False):
    """Batched prefill with on-device sampling → (first tokens (b,) int32,
    cache)."""
    logits = _prefill_core(params, cache, cfg, slot_pages, input_ids, true_len)
    return _sample_tokens(logits, temps, gen, greedy_only), cache
