"""Prefill and decode steps over the paged KV cache (mirrors
``tgq/serve/decode.py``).

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
(K6 on CUDA, its plain f32 softmax on the CPU) over the prompt itself.

Under a tensor-parallel mesh each rank runs these functions on its own
shards and kv heads (``tgq_torch.parallel``; each rank holds ``kvh/tp``
whole GQA groups, so attention needs no collective), and a decode chunk
of more than one step runs in chunk-window mode as in the JAX package:
the pools stay untouched during the chunk, each step's raw K/V rows go
into a bf16 window (``kv_cache.window_init``), K5 covers the pools with
``w_live`` and returns flash partials, ``_window_partial`` attends the
window with torch ops, ``_merge_partials`` joins the two, and one
``window_flush`` per chunk quantizes the rows into the pools.

On one CUDA card a greedy chunk outside chunk-window mode is a fixed chain
of launches that reads nothing on the host, so ``decode_steps`` can replay
it from a CUDA graph (:class:`DecodeGraphs`, one graph per chunk length)
in place of dispatching its few thousand launches one by one from Python.
The graph holds the same kernels in the same order as the eager chunk, so
its tokens are the eager chunk's.  The kernels' ``launches`` counters rise
at each replay by what the chunk launches, as they would eagerly.
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
from tgq_torch.serve.kv_cache import (
    PagedKVCache,
    kv_write_pages,
    window_flush,
    window_init,
    window_write_step,
)


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
    return x + apply_linear(mlp["down_proj"], glu_act(gate, up), row=True)


def _window_partial(q_scaled, win, li: int, w_live: int, num_kv_heads: int):
    """Flash partials (acc, m, l) of attention over the chunk window's
    first ``w_live`` raw rows of layer ``li`` — the JAX package's
    arithmetic: bf16 query and rows with f32 products, every kv head's
    rows against every q head with the off-group logits masked, the
    probabilities rounded to bf16 for the value product.  q_scaled
    (slots, H, d) f32 with 1/sqrt(d), WITHOUT the equalizer fold.
    Returns acc (slots, H, d) f32 un-normalised, m and l (slots, H, 1)."""
    from tgq_torch.kernels.paged_attention import DEFAULT_MASK_VALUE

    wk, wv = win
    slots, H, d = q_scaled.shape
    kvh = num_kv_heads
    rep = H // kvh
    W = wk.shape[3]
    kw = wk[li].reshape(slots, kvh * W, d).float()
    vw = wv[li].reshape(slots, kvh * W, d).float()
    q_bf = q_scaled.to(torch.bfloat16).float()
    logits = torch.bmm(q_bf, kw.transpose(1, 2))                   # (slots, H, kvh·W)
    view = logits.reshape(slots, kvh, rep, kvh, W)
    dev = logits.device
    k_own = torch.arange(kvh, device=dev).reshape(1, kvh, 1, 1, 1)
    k_row = torch.arange(kvh, device=dev).reshape(1, 1, 1, kvh, 1)
    wcol = torch.arange(W, device=dev).reshape(1, 1, 1, 1, W)
    valid = (k_own == k_row) & (wcol < w_live)
    logits = torch.where(valid, view, DEFAULT_MASK_VALUE).reshape(slots, H, kvh * W)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.bmm(p.to(torch.bfloat16).float(), vw)
    return acc, m, l


def _merge_partials(a, b):
    """Exact merge of two flash partials (acc, m, l) into the normalised
    output.  An empty side carries the finite mask max, so its weight
    underflows to zero instead of forming -inf - -inf."""
    acc_a, m_a, l_a = a
    acc_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    ca, cb = torch.exp(m_a - m), torch.exp(m_b - m)
    l = ca * l_a + cb * l_b
    return (ca * acc_a + cb * acc_b) / torch.clamp(l, min=1e-30)


def _decode_layer(lp, li: int, cfg: ModelConfig, x, cache: PagedKVCache, cos_p, sin_p,
                  table, lens, live, win=None, w_live: int = 0):
    """One decoder layer's decode for all slots; writes this layer's
    current-token K/V into the pools (through the attention kernel), or,
    in chunk-window mode (``win``), into window column ``w_live``."""
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
    q_raw = qs  # the window's rows are raw: they take the query before the fold
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
    pools = (cache.k[li], cache.v[li], cache.ks[li] if quantized else None,
             cache.vs[li] if quantized else None)
    if win is None:
        attn = paged_decode_attention(qs, *pools, lens, table, k_cur, v_cur, live=live,
                                      num_kv_heads=kvh, write_current=True)
    else:
        attn = paged_decode_attention(qs, *pools, lens, table, k_cur, v_cur, num_kv_heads=kvh,
                                      w_live=w_live, return_stats=True)
    if cache.v_eq is not None:
        # stored rows are V/eq: scale the (linear in V) pool part back, and
        # never the raw window's part
        veq = cache.v_eq[li].reshape(kvh, 1, d)
        scale_v = lambda a: (a.reshape(slots, kvh, rep, d) * veq).reshape(  # noqa: E731
            slots, cfg.num_heads, d)
        attn = scale_v(attn) if win is None else (scale_v(attn[0]),) + attn[1:]
    if win is not None:
        attn = _merge_partials(attn, _window_partial(q_raw, win, li, w_live, kvh))
        window_write_step(win, w_live, li, k, v)
    x = x + apply_linear(lp["self_attn"]["o_proj"], attn.reshape(slots, cfg.q_size).to(x.dtype),
                         row=True)
    h2 = rms_norm(x, lp["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
    return _mlp(lp, x, h2)


def _decode_core(params, cache: PagedKVCache, cfg: ModelConfig, table, lens, tokens, pos,
                 live=None, win=None, w_live: int = 0):
    """One token for every slot.  table (slots, mpps) int32; lens (slots,)
    lengths including the token being decoded; tokens (slots,) the input
    token; pos (slots,) its position (lens - 1).  Returns (slots, vocab)
    f32 logits; the cache (or, with ``win``, the window) is updated in
    place."""
    x = embed_tokens(params, tokens[:, None])[:, 0]
    cos_p, sin_p = _rope_rows(cfg, pos)
    for li, lp in enumerate(params["model"]["layers"]):
        x = _decode_layer(lp, li, cfg, x, cache, cos_p, sin_p, table, lens, live,
                          win=win, w_live=w_live)
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


def _decode_chunk(params, cache: PagedKVCache, cfg: ModelConfig, table, lens, tokens, pos,
                  temps, gen, n_steps: int, greedy_only: bool, live, win):
    """The chunk's steps, eagerly: (n_steps, slots) int32 tokens."""
    toks = []
    tok = tokens
    for i in range(n_steps):
        logits = _decode_core(params, cache, cfg, table, lens, tok, pos, live,
                              win=win, w_live=i)
        tok = _sample_tokens(logits, temps, gen, greedy_only)
        toks.append(tok)
        lens, pos = lens + 1, pos + 1
    return torch.stack(toks)


def graph_eligible(device, greedy_only: bool) -> bool:
    """Whether a chunk handed a :class:`DecodeGraphs` replays from it: on a
    CUDA device and greedy (temperature sampling draws from the host's
    generator state).  The holder's owner decides the rest: the engine
    builds one only on a CUDA card outside a mesh, where no chunk runs a
    collective or chunk-window mode."""
    return torch.device(device).type == "cuda" and greedy_only


def _launch_counters():
    """The launch counters of the kernels a decode chunk runs: K3 and K4
    (``dequant_matmul``) and K5 (``paged_attention``), as (module, name)."""
    from tgq_torch.kernels import dequant_matmul, paged_attention

    return ((dequant_matmul, "launches"), (dequant_matmul, "launches_a8"),
            (paged_attention, "launches"))


class DecodeGraphs:
    """CUDA graphs of one engine's greedy decode chunks, one per chunk
    length: the powers of two up to ``max_chunk`` (the engine rounds every
    chunk down to one).

    The graphs read their inputs from static buffers — ``table`` (slots,
    mpps), ``lens``, ``tokens``, ``pos`` and ``live`` (slots,), all int32 —
    and write their tokens into a static (n, slots) block each.  They share
    one memory pool: replays run one at a time on the current stream, and
    :meth:`replay` copies each block out before the next replay can
    overwrite it.  All graphs are captured at the first replay: each length
    first runs once eagerly with no slot live (no KV write), so that every
    lazy allocation and build happens outside the capture, on the capture
    stream.  The kernels' launch counters leave out those warm-ups and
    captures; each replay adds what its length's capture launched."""

    def __init__(self, params, cache: PagedKVCache, cfg: ModelConfig, slots: int, mpps: int,
                 max_chunk: int, device):
        self.params, self.cache, self.cfg = params, cache, cfg
        self.lengths = tuple(1 << i for i in range(max(1, max_chunk).bit_length()))
        i32 = dict(dtype=torch.int32, device=device)
        self.table = torch.zeros((slots, mpps), **i32)
        self.lens, self.tokens, self.pos, self.live = (
            torch.zeros((slots,), **i32) for _ in range(4))
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self.out: dict[int, torch.Tensor] = {}
        self.launches: dict[int, list[int]] = {}  # per length: each counter's rise a replay
        self.k5_counters = None  # K5's merge counters, which the graphs read by address
        self.captures = 0        # graphs captured
        self.replays = 0         # chunks replayed from a graph

    def _chunk(self, n_steps: int) -> torch.Tensor:
        return _decode_chunk(self.params, self.cache, self.cfg, self.table, self.lens,
                             self.tokens, self.pos, None, None, n_steps, True, self.live, None)

    @torch.no_grad()
    def capture(self) -> None:
        """Warm up and capture every length's graph (the class docstring)."""
        from tgq_torch.kernels.paged_attention import _merge_counters

        dev = self.table.device
        counters = _launch_counters()
        start = [getattr(m, k) for m, k in counters]
        self.live.zero_()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(side):
            for n in self.lengths:
                self._chunk(n)
                before = [getattr(m, k) for m, k in counters]
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    self.out[n] = self._chunk(n)
                self.launches[n] = [getattr(m, k) - b for (m, k), b in zip(counters, before)]
                self.graphs[n] = graph
                self.captures += 1
        torch.cuda.current_stream(dev).wait_stream(side)
        for (m, k), v in zip(counters, start):
            setattr(m, k, v)
        self.k5_counters = _merge_counters(dev, 0)

    def replay(self, table, lens, tokens, pos, live, n_steps: int) -> torch.Tensor:
        """The chunk's (n_steps, slots) int32 tokens, in a fresh tensor."""
        assert (n_steps in self.lengths and table.shape == self.table.shape
                and tokens.shape == self.tokens.shape), (
            "no graph of this chunk", n_steps, self.lengths, tuple(table.shape),
            tuple(self.table.shape))
        if not self.graphs:
            self.capture()
        for static, x in ((self.table, table), (self.lens, lens), (self.tokens, tokens),
                          (self.pos, pos)):
            static.copy_(x)
        if live is None:
            self.live.fill_(1)
        else:
            self.live.copy_(live)
        self.graphs[n_steps].replay()
        for (m, k), d in zip(_launch_counters(), self.launches[n_steps]):
            setattr(m, k, getattr(m, k) + d)
        self.replays += 1
        return self.out[n_steps].clone()


@torch.no_grad()
def decode_steps(params, cache: PagedKVCache, cfg: ModelConfig, table, lens, tokens, pos,
                 temps, gen: torch.Generator, n_steps: int, greedy_only: bool = False,
                 live=None, window: bool = False, graphs: DecodeGraphs | None = None):
    """``n_steps`` tokens for every slot, sampled on the device.  The page
    table must already cover ``lens + n_steps - 1`` tokens per slot.
    lens/pos follow ``decode_step`` at step 0 and advance by one each step.
    ``window`` (tensor-parallel serving): a chunk of more than one step
    runs in chunk-window mode (the module docstring).  ``graphs``: where
    ``graph_eligible`` holds, the chunk is replayed from the holder's CUDA
    graph of its length, which must be one of the holder's, as must the
    weights, pools and shapes.  Returns (tokens (n_steps, slots) int32,
    cache)."""
    if graphs is not None and graph_eligible(tokens.device, greedy_only):
        assert not window and params is graphs.params and cache is graphs.cache, (
            "a DecodeGraphs replays only its own weights and pools, outside chunk-window mode")
        return graphs.replay(table, lens, tokens, pos, live, n_steps), cache
    win = window_init(cache, tokens.shape[0], n_steps) if window and n_steps > 1 else None
    toks = _decode_chunk(params, cache, cfg, table, lens, tokens, pos, temps, gen, n_steps,
                         greedy_only, live, win)
    if win is not None:
        window_flush(cache, win, table, pos, n_steps, live=live)
    return toks, cache


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
                         attn.reshape(b, seq, cfg.q_size).to(x.dtype), row=True)
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
