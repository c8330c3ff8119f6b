"""Paged decode attention: CUDA kernel K5 and its plain version.

Port of ``tgq/kernels/paged_attention.py::paged_decode_attention`` (the
Pallas kernel ``_kernel``), on ONE layer's views of the pools
(``cache.k[li]`` …) instead of the layer-stacked arrays plus a layer
index: in torch a layer's slice is a free view.  CUDA tensors launch
``csrc/paged_attention.cu``; CPU tensors run
:func:`paged_decode_attention_plain`, which gathers the pages
(``tgq_torch.serve.kv_cache.gather_pools``) and computes in f32.
:func:`_k5_plan` picks how many blocks split each slot's context and
:func:`_k5_ranges` gives each split's tokens, as the kernel derives them
on the device from the slot's length.

Not ported: ``alias_pools`` (XLA buffer ownership; torch writes in
place) and the TP chunk-window mode (``w_live``, ``return_stats``;
ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from tgq_torch.kernels import _build

launches = 0  # kernel launches of paged_decode_attention (CUDA only)

# K5's split of a slot's context (csrc/paged_attention.cu): 32-token tiles;
# as many splits as give about one wave of resident blocks (4 a SM at
# d = 128) over the (slot, kv head) pairs, and enough that the table's
# longest context takes at most 8 tiles a split; never more than the
# table's tiles, at most 64.  One wave, not two: on the H100, 8 slots of up
# to 2048 tokens ran 38.2 us at S = 8 against 43.7 at 17 and 47.8 at 34
# (sweep_k45, PERF.md), the merge's reads growing with S.
_K5_TILE = 32
_K5_TARGET_BLOCKS = 132 * 4  # H100 SXM: 132 SMs, 4 resident blocks each
_K5_TILES_PER_SPLIT = 8
_K5_MAX_SPLITS = 64


@dataclasses.dataclass(frozen=True)
class K5Plan:
    """How K5 runs one call: ``splits`` blocks per (slot, kv head), each
    taking a contiguous range of ``tile``-token tiles of the context."""

    splits: int
    tile: int


@functools.lru_cache(maxsize=1024)
def _k5_plan(slots: int, num_kv_heads: int, mpps: int, page: int) -> K5Plan:
    """K5's split count from what the host knows without a sync: slots, kv
    heads and the page table's width (the lengths stay on the device)."""
    if min(slots, num_kv_heads, mpps, page) <= 0:
        raise ValueError("K5: slots, kv heads, pages per slot and page size must be > 0")
    max_tiles = -(-(mpps * page) // _K5_TILE)
    splits = max(-(-_K5_TARGET_BLOCKS // (slots * num_kv_heads)),
                 -(-max_tiles // _K5_TILES_PER_SPLIT))
    return K5Plan(splits=max(1, min(splits, max_tiles, _K5_MAX_SPLITS)), tile=_K5_TILE)


def _k5_ranges(pool_len: int, splits: int, tile: int = _K5_TILE) -> list[tuple[int, int]]:
    """The token range [begin, end) of each split of a context of
    ``pool_len`` pool tokens, as the kernel computes it: ``ceil(pool_len /
    splits)`` rounded up to the tile; splits past the end are empty (begin
    = end).  The kernel merges the first ``max(1, number of non-empty)``."""
    chunk = -(-(-(-pool_len // splits)) // tile) * tile
    return [(min(s * chunk, pool_len), min((s + 1) * chunk, pool_len)) for s in range(splits)]


_counters: dict = {}  # per device: the int32 merge counters, zero between launches


def _merge_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device``; the kernel sets
    each back to 0 after its merge, so one buffer serves every launch on
    the stream (two streams must not run K5 at once)."""
    c = _counters.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _counters[device] = c
    return c


def _pool_len(lengths: torch.Tensor, has_current: bool) -> torch.Tensor:
    return torch.clamp(lengths - 1, min=0) if has_current else lengths


def _write_current(k_pool, v_pool, k_scales, v_scales, lengths, page_indices,
                   k_current, v_current, live, num_kv_heads: int) -> None:
    """Store the current rows at position len-1 (slots with len > 0 and
    live > 0), quantized as the cache's writes are."""
    from tgq_torch.serve.kv_cache import _absmax_quantize, _absmax_quantize4

    gate = lengths > 0
    if live is not None:
        gate = gate & (live > 0)
    slots = torch.nonzero(gate).flatten()
    if slots.numel() == 0:
        return
    page = k_pool.shape[1]
    last = (lengths[slots] - 1).long()
    pages = page_indices[slots, last // page].long()
    offs = last % page
    for pool, scales, cur in ((k_pool, k_scales, k_current), (v_pool, v_scales, v_current)):
        rows = cur[slots].float()
        if scales is None:
            pool[pages, offs] = rows.to(pool.dtype)
            continue
        quant = _absmax_quantize4 if pool.dtype == torch.uint8 else _absmax_quantize
        codes, s = quant(rows.reshape(len(slots), num_kv_heads, -1))
        pool[pages, offs] = codes.reshape(len(slots), -1)
        scales[pages, :, offs] = s


def paged_decode_attention_plain(q, k_pool, v_pool, k_scales, v_scales, lengths,
                                 page_indices, k_current=None, v_current=None, live=None,
                                 *, num_kv_heads: int, attn_logits_soft_cap=None,
                                 write_current: bool = False) -> torch.Tensor:
    """Plain version of :func:`paged_decode_attention` (same contract),
    in f32 from the stored values: the pool tokens [0, pool_len) and the
    current row (unquantized) as one masked softmax."""
    from tgq_torch.serve.kv_cache import gather_pools

    slots, H, d = q.shape
    has_current = k_current is not None
    kg, vg = gather_pools(k_pool, v_pool, k_scales, v_scales, page_indices,
                          num_kv_heads, torch.float32)           # (slots, T, kvh, d)
    if has_current:
        kg = torch.cat([kg, k_current.float().reshape(slots, 1, num_kv_heads, d)], dim=1)
        vg = torch.cat([vg, v_current.float().reshape(slots, 1, num_kv_heads, d)], dim=1)
    T = kg.shape[1]
    rep = H // num_kv_heads
    qg = q.float().reshape(slots, num_kv_heads, rep, d)
    logits = torch.einsum("skgd,stkd->skgt", qg, kg)
    if attn_logits_soft_cap is not None:
        c = attn_logits_soft_cap
        logits = torch.tanh(logits / c) * c
    t_ids = torch.arange(T, device=q.device)[None, :]
    valid = t_ids < _pool_len(lengths, has_current)[:, None].to(t_ids.dtype)
    if has_current:
        valid[:, -1] = True
    valid = valid & (lengths > 0)[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], -math.inf)
    probs = torch.softmax(logits, dim=-1).nan_to_num(0.0)         # len == 0: all masked
    out = torch.einsum("skgt,stkd->skgd", probs, vg).reshape(slots, H, d)
    if write_current:
        _write_current(k_pool, v_pool, k_scales, v_scales, lengths, page_indices,
                       k_current, v_current, live, num_kv_heads)
    return out


def _check(q, k_pool, v_pool, k_scales, v_scales, lengths, page_indices, k_current,
           v_current, live, num_kv_heads, write_current):
    slots, H, d = q.shape
    if q.dtype != torch.float32:
        raise TypeError("paged_decode_attention: q must be f32")
    if k_pool.dim() != 3 or k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError("paged_decode_attention: pools are one layer's (P, page, F) views")
    quantized = k_pool.dtype in (torch.int8, torch.uint8)
    if quantized != (k_scales is not None) or (k_scales is None) != (v_scales is None):
        raise ValueError("paged_decode_attention: scales go with int8/int4 pools only")
    fused = k_pool.shape[-1] * (2 if k_pool.dtype == torch.uint8 else 1)
    if fused != num_kv_heads * d or H % num_kv_heads:
        raise ValueError(f"paged_decode_attention: fused {fused} vs {num_kv_heads}x{d}, "
                         f"{H} q heads")
    if lengths.shape != (slots,) or page_indices.shape[0] != slots:
        raise ValueError("paged_decode_attention: lengths/page_indices per slot")
    if (k_current is None) != (v_current is None):
        raise ValueError("paged_decode_attention: k_current and v_current together")
    if write_current and k_current is None:
        raise ValueError("paged_decode_attention: write_current needs the current rows")
    ts = [q, k_pool, v_pool, lengths, page_indices] + [
        t for t in (k_scales, v_scales, k_current, v_current, live) if t is not None]
    if len({t.device for t in ts}) != 1:
        raise ValueError("paged_decode_attention: tensors on different devices")


def paged_decode_attention(q, k_pool, v_pool, k_scales, v_scales, lengths, page_indices,
                           k_current=None, v_current=None, live=None, *, num_kv_heads: int,
                           attn_logits_soft_cap=None, write_current: bool = False):
    """Decode attention for one layer of the paged pools.

    q: (slots, H, d) f32, pre-scaled by 1/sqrt(d).  k_pool/v_pool: the
    layer's (P, page, F) bf16 or int8, or (P, page, F/2) uint8 (int4);
    k_scales/v_scales: (P, kvh, spad) f32 for int8/int4, else None.
    lengths: (slots,) int32 including the current token (0 = idle slot →
    zeros); page_indices: (slots, mpps) int32.  k_current/v_current:
    (slots, F) — the pools then cover [0, len-1) and the current row is
    folded in unquantized.  ``write_current`` also stores the current row
    (quantized like the cache's writes) at position len-1, in place, for
    slots with len > 0 and ``live`` > 0.  Returns (slots, H, d) f32.
    """
    global launches
    _check(q, k_pool, v_pool, k_scales, v_scales, lengths, page_indices, k_current,
           v_current, live, num_kv_heads, write_current)
    kw = dict(num_kv_heads=num_kv_heads, attn_logits_soft_cap=attn_logits_soft_cap,
              write_current=write_current)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, k_scales, v_scales, lengths,
                                            page_indices, k_current, v_current, live, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    slots, H, d = q.shape
    page = k_pool.shape[1]
    kv_bits = {torch.bfloat16: 16, torch.int8: 8, torch.uint8: 4}.get(k_pool.dtype)
    if kv_bits is None:
        raise TypeError(f"paged_decode_attention: pool dtype {k_pool.dtype}")
    if d not in (32, 64, 128, 256) or H // num_kv_heads > 8 or (
            kv_bits == 4 and num_kv_heads % 2):
        raise NotImplementedError(
            f"paged_decode_attention kernel: head_dim {d} (32/64/128/256), GQA group "
            f"{H // num_kv_heads} (<= 8), int4 needs an even kv-head count")
    pools = [k_pool, v_pool] + ([k_scales, v_scales] if k_scales is not None else [])
    if not all(t.is_contiguous() for t in pools):
        raise ValueError("paged_decode_attention: pools must be contiguous views")
    lib = _build.lib()
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    page_indices = page_indices.to(torch.int32).contiguous()
    kc = vc = None
    if k_current is not None:  # rows read in pairs: 8-byte aligned
        kc, vc = (c.float().reshape(slots, -1).contiguous() for c in (k_current, v_current))
        kc, vc = (c.clone() if c.data_ptr() % 8 else c for c in (kc, vc))
    lv = None if live is None else live.to(torch.int32).contiguous()
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_decode_attention: q and the pools must be 16-byte aligned")
    out = torch.empty((slots, H, d), dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    spad = k_scales.shape[-1] if k_scales is not None else 0
    mpps = page_indices.shape[1]
    plan = _k5_plan(slots, num_kv_heads, mpps, page)
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty((slots * num_kv_heads * plan.splits * H // num_kv_heads * (d + 2),),
                         dtype=torch.float32, device=q.device)
        counters = _merge_counters(q.device, slots * num_kv_heads)
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    err = lib.tgq_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scales), ptr(v_scales),
        lengths.data_ptr(), page_indices.data_ptr(), ptr(kc), ptr(vc), ptr(lv),
        out.data_ptr(), ptr(ws), ptr(counters), slots, H, num_kv_heads, d, page, mpps, spad,
        kv_bits, plan.splits, int(write_current), float(attn_logits_soft_cap or 0.0), dev,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention launch")
    launches += 1
    return out
