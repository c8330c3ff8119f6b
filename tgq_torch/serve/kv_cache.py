"""Paged KV cache (mirrors ``tgq/serve/kv_cache.py``, single device).

- One **page pool** stacked over layers: K and V of shape ``(layers,
  num_pages, page_size, kv_heads·head_dim)``, the JAX package's layout, so
  pools and checkpoints compare byte for byte.  Storage is bf16, int8
  with per-token-per-head absmax scales (``kv_bits=8``), or int4 nibbles
  (``kv_bits=4``, uint8 split-half along the fused row, codes biased by
  8).  Scales are ``(layers, num_pages, kv_heads, scale_pad)`` f32; only
  the first ``page_size`` entries of the last axis are used.
- A host-side allocator (:class:`PageTable`: the native C++ backend,
  ``tgq_torch._native``, or the pure-Python one, with the same semantics)
  mapping each decode slot's logical blocks to physical pages.  Page 0 is
  the scratch page that freed slots' entries clamp to.
- Writes update the pools in place (``index_put_``); a layer is the view
  ``cache.k[li]``.
- ``pack_segments``: int4 rows packed split-half within that many equal
  segments of the fused row, the JAX package's tensor-parallel layout (a
  shard's byte slice of a ``pack_segments == tp`` pool is the one-segment
  pool of its own heads, which is what a rank of ``tgq_torch.parallel``
  holds).
- The chunk window of tensor-parallel decode (``window_init``,
  ``window_write_step``, ``window_flush``): a chunk's decoded K/V rows,
  raw bf16, flushed into the pools once per chunk.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from tgq_torch.models.config import ModelConfig

logger = logging.getLogger(__name__)


def host_to_device(arr, device) -> torch.Tensor:
    """A fresh device copy of a host array, enqueued without waiting: on
    CUDA it goes through pinned memory (a copy from pageable memory would
    synchronize the stream, and the host would wait for every step
    dispatched before it)."""
    t = torch.as_tensor(np.array(arr, copy=True))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def scale_pad(page_size: int) -> int:
    """Token-dim padding of the scale pools (the JAX layout's 128 lanes)."""
    return max(128, -(-page_size // 128) * 128)


class PageTable:
    """Host-side page allocator + per-slot logical→physical mapping.

    Two backends with the JAX package's semantics: the native C++
    allocator (``tgq_torch/_native/pagealloc.cc``, built with g++ at first
    use) and a pure-Python one.  ``backend``: "auto" takes the native one
    when it builds and the Python one otherwise, "native" raises when it
    does not build, "python" never builds it.  :attr:`backend` says which
    is live."""

    def __init__(self, num_pages: int, page_size: int, max_slots: int,
                 max_pages_per_slot: int, backend: str = "auto"):
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"PageTable: unknown backend {backend!r}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_slots = max_slots
        self.max_pages_per_slot = max_pages_per_slot
        self._native = None
        if backend != "python":
            from tgq_torch._native import NativeBuildError, get_page_alloc_cls

            try:
                self._native = get_page_alloc_cls()(
                    num_pages=num_pages, page_size=page_size, max_slots=max_slots,
                    max_pages_per_slot=max_pages_per_slot)
            except NativeBuildError as e:
                if backend == "native":
                    raise
                logger.warning("native page allocator unavailable, using Python: %s", e)
        self.backend = "native" if self._native is not None else "python"
        if self._native is not None:
            self._tbuf = np.zeros((max_slots, max_pages_per_slot), np.int32)
            self._lbuf = np.zeros((max_slots,), np.int32)
        else:
            self._free = list(range(num_pages - 1, 0, -1))
            self._table = [[-1] * max_pages_per_slot for _ in range(max_slots)]
            self._lens = [0] * max_slots

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    @property
    def num_free(self) -> int:
        if self._native is not None:
            return self._native.num_free()
        return len(self._free)

    @property
    def lens(self) -> list[int]:
        if self._native is not None:
            return [self._native.get_len(s) for s in range(self.max_slots)]
        return list(self._lens)

    def can_alloc(self, n_tokens: int) -> bool:
        return self.num_free >= self.pages_needed(n_tokens)

    def alloc_slot(self, slot: int, n_tokens: int) -> tuple[int, ...]:
        """Allocate a slot's prompt pages; returns the physical pages."""
        if self._native is not None:
            return self._native.alloc_slot(slot, n_tokens)
        need = self.pages_needed(n_tokens)
        assert need <= self.max_pages_per_slot, (need, self.max_pages_per_slot)
        assert len(self._free) >= need, "page pool exhausted"
        for i in range(need):
            self._table[slot][i] = self._free.pop()
        self._lens[slot] = n_tokens
        return tuple(self._table[slot][:need])

    def extend(self, slot: int, n_new: int = 1) -> None:
        """Grow a slot by n_new tokens, allocating pages on crossing."""
        if self._native is not None:
            self._native.extend(slot, n_new)
            return
        old = self._lens[slot]
        new = old + n_new
        have = self.pages_needed(old) if old else 0
        for i in range(have, self.pages_needed(new)):
            assert self._free, "page pool exhausted"
            self._table[slot][i] = self._free.pop()
        self._lens[slot] = new

    def free_slot(self, slot: int) -> None:
        if self._native is not None:
            self._native.free_slot(slot)
            return
        for i, p in enumerate(self._table[slot]):
            if p >= 0:
                self._free.append(p)
                self._table[slot][i] = -1
        self._lens[slot] = 0

    def detach_slot(self, slot: int) -> tuple[int, ...]:
        """Clear a slot's mapping WITHOUT returning its pages — for retiring
        a slot while an in-flight decode chunk may still write them; the
        caller hands them to :meth:`release_pages` once that chunk has
        provably completed."""
        if self._native is not None:
            return self._native.detach_slot(slot)
        pages = tuple(p for p in self._table[slot] if p >= 0)
        self._table[slot] = [-1] * self.max_pages_per_slot
        self._lens[slot] = 0
        return pages

    def release_pages(self, pages) -> None:
        """Return detached pages to the free pool."""
        if self._native is not None:
            self._native.release_pages(tuple(int(p) for p in pages))
            return
        self._free.extend(int(p) for p in pages)

    def slot_pages(self, slot: int) -> tuple[int, ...]:
        if self._native is not None:
            return self._native.slot_pages(slot)
        return tuple(p for p in self._table[slot] if p >= 0)

    def device_tables(self, device="cpu"):
        """(table (slots, mpps) int32 — freed entries clamp to page 0 — and
        lens (slots,) int32), copied to ``device`` (fresh tensors: the host
        lists change while a dispatched step may still read these)."""
        if self._native is not None:
            self._native.fill_tables(self._tbuf, self._lbuf)
            return host_to_device(self._tbuf, device), host_to_device(self._lbuf, device)
        t = np.asarray(self._table, np.int32)
        table = np.where(t < 0, 0, t).astype(np.int32)
        return (host_to_device(table, device),
                host_to_device(np.asarray(self._lens, np.int32), device))


@dataclasses.dataclass
class PagedKVCache:
    """Layer-stacked device page pools (see the module docstring).  The
    dtype of ``k`` tells the format: bf16, int8 (8-bit) or uint8 (4-bit).
    ``k_eq``/``v_eq``: optional static per-channel equalizers (layers,
    kv_heads·head_dim) f32 — quantized writes store K/k_eq and V/v_eq."""

    k: torch.Tensor
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None
    vs: Optional[torch.Tensor] = None
    k_eq: Optional[torch.Tensor] = None
    v_eq: Optional[torch.Tensor] = None
    num_kv_heads: int = dataclasses.field(default=0, kw_only=True)
    pack_segments: int = dataclasses.field(default=1, kw_only=True)

    def __post_init__(self):
        if self.num_kv_heads <= 0 or self.fused_dim % self.num_kv_heads:
            raise ValueError(f"PagedKVCache: num_kv_heads={self.num_kv_heads}, "
                             f"fused dim {self.fused_dim}")
        seg = self.pack_segments
        if seg != 1 and (self.k.dtype != torch.uint8 or seg < 1 or self.num_kv_heads % seg
                         or (self.fused_dim // seg) % 2):
            raise ValueError(f"PagedKVCache: pack_segments={seg} needs int4 pools whose "
                             f"{self.num_kv_heads} kv heads split into even segments")

    @classmethod
    def init(cls, cfg: ModelConfig, num_pages: int, page_size: int,
             dtype=torch.bfloat16, kv_bits: int = 16, k_eq=None, v_eq=None,
             device="cpu", pack_segments: int = 1) -> "PagedKVCache":
        fused = cfg.num_kv_heads * cfg.head_dim
        shape = (cfg.num_layers, num_pages, page_size, fused)
        if kv_bits in (8, 4):
            sshape = (cfg.num_layers, num_pages, cfg.num_kv_heads, scale_pad(page_size))
            if kv_bits == 4:
                shape = shape[:-1] + (fused // 2,)
            dt = torch.int8 if kv_bits == 8 else torch.uint8

            def eq(e):
                if e is None:
                    return None
                return torch.as_tensor(np.asarray(e, np.float32)).reshape(
                    cfg.num_layers, fused).to(device)

            return cls(k=torch.zeros(shape, dtype=dt, device=device),
                       v=torch.zeros(shape, dtype=dt, device=device),
                       ks=torch.zeros(sshape, dtype=torch.float32, device=device),
                       vs=torch.zeros(sshape, dtype=torch.float32, device=device),
                       k_eq=eq(k_eq), v_eq=eq(v_eq), num_kv_heads=cfg.num_kv_heads,
                       pack_segments=pack_segments if kv_bits == 4 else 1)
        assert kv_bits == 16, kv_bits
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   num_kv_heads=cfg.num_kv_heads)

    @property
    def kv_bits(self) -> int:
        if self.k.dtype == torch.uint8:
            return 4
        return 8 if self.k.dtype == torch.int8 else 16

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def fused_dim(self) -> int:
        f = self.k.shape[3]
        return f * 2 if self.k.dtype == torch.uint8 else f

    @property
    def head_dim(self) -> int:
        return self.fused_dim // self.num_kv_heads


def _absmax_quantize(x: torch.Tensor):
    """(..., d) → int8 codes + (...,) f32 per-vector absmax scale.  The
    ``· (1/127)`` product is the JAX package's (XLA folds ``/ 127.0``)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * (1.0 / 127.0), min=1e-10)
    return torch.round(xf / s[..., None]).to(torch.int8), s


def _absmax_quantize4(x: torch.Tensor, segments: int = 1):
    """(..., kvh, d) → nibble-packed uint8 (..., kvh·d/2) + (..., kvh) f32
    per-head scales: symmetric absmax/7, codes clipped to [-7, 7] and
    biased by 8, split-half within each of ``segments`` equal contiguous
    chunks of the fused row (byte j of a segment of S features holds
    c[j] | c[j + S/2] << 4)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * (1.0 / 7.0), min=1e-10)
    q = torch.clamp(torch.round(xf / s[..., None]), -7, 7).to(torch.int32) + 8
    flat = q.reshape(*q.shape[:-2], -1)
    fused = flat.shape[-1]
    seg = flat.reshape(*flat.shape[:-1], segments, fused // segments)
    half = fused // segments // 2
    packed = (seg[..., :half] | (seg[..., half:] << 4)).reshape(*flat.shape[:-1], fused // 2)
    return packed.to(torch.uint8), s


def kv_unpack4(w: torch.Tensor, dtype=torch.float32, segments: int = 1) -> torch.Tensor:
    """Inverse of the nibble packing: (..., F/2) uint8 → (..., F) codes."""
    wi = w.to(torch.int32)
    seg = wi.reshape(*wi.shape[:-1], segments, wi.shape[-1] // segments)
    out = torch.cat([(seg & 0xF) - 8, ((seg >> 4) & 0xF) - 8], dim=-1)
    return out.reshape(*wi.shape[:-1], 2 * wi.shape[-1]).to(dtype)


def _eq_div(x: torch.Tensor, eq: Optional[torch.Tensor], layer: int) -> torch.Tensor:
    """Divide (..., kvh, d) rows by layer ``layer``'s channel equalizer."""
    if eq is None:
        return x
    kvh, d = x.shape[-2:]
    return x / eq[layer].reshape(kvh, d)


def _pad_scales(s: torch.Tensor, spad: int) -> torch.Tensor:
    """(..., page) → (..., spad) zero-padded."""
    if s.shape[-1] == spad:
        return s
    return torch.nn.functional.pad(s, (0, spad - s.shape[-1]))


def _quant(cache: PagedKVCache):
    if cache.kv_bits == 4:
        return lambda x: _absmax_quantize4(x, cache.pack_segments)
    return _absmax_quantize


def kv_write_token(cache: PagedKVCache, layer: int, pages: torch.Tensor,
                   offsets: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor) -> PagedKVCache:
    """Write one token's K/V per slot into layer ``layer`` (in place).
    pages/offsets: (slots,); k_new/v_new: (slots, kvh, d)."""
    slots = k_new.shape[0]
    pages, offsets = pages.long(), offsets.long()
    if cache.ks is None:
        cache.k[layer, pages, offsets] = k_new.reshape(slots, -1).to(cache.k.dtype)
        cache.v[layer, pages, offsets] = v_new.reshape(slots, -1).to(cache.v.dtype)
        return cache
    qk, sk = _quant(cache)(_eq_div(k_new, cache.k_eq, layer))
    qv, sv = _quant(cache)(_eq_div(v_new, cache.v_eq, layer))
    cache.k[layer, pages, offsets] = qk.reshape(slots, -1)
    cache.v[layer, pages, offsets] = qv.reshape(slots, -1)
    cache.ks[layer, pages, :, offsets] = sk
    cache.vs[layer, pages, :, offsets] = sv
    return cache


def _eq_div_all(x: torch.Tensor, eq: Optional[torch.Tensor]) -> torch.Tensor:
    """Divide (L, slots, kvh, d) rows by every layer's equalizer."""
    if eq is None:
        return x
    L, _, kvh, d = x.shape
    return x / eq.reshape(L, 1, kvh, d)


def kv_write_token_all(cache: PagedKVCache, pages: torch.Tensor, offsets: torch.Tensor,
                       k_all: torch.Tensor, v_all: torch.Tensor) -> PagedKVCache:
    """Write one token's K/V per slot for ALL layers in one update (in
    place).  pages/offsets: (slots,); k_all/v_all: (layers, slots, kvh, d)."""
    L, slots = k_all.shape[:2]
    pages, offsets = pages.long(), offsets.long()
    if cache.ks is None:
        cache.k[:, pages, offsets] = k_all.reshape(L, slots, -1).to(cache.k.dtype)
        cache.v[:, pages, offsets] = v_all.reshape(L, slots, -1).to(cache.v.dtype)
        return cache
    qk, sk = _quant(cache)(_eq_div_all(k_all, cache.k_eq))  # codes, (L, slots, kvh)
    qv, sv = _quant(cache)(_eq_div_all(v_all, cache.v_eq))
    cache.k[:, pages, offsets] = qk.reshape(L, slots, -1)
    cache.v[:, pages, offsets] = qv.reshape(L, slots, -1)
    # ks (L, P, kvh, spad): the slice between the two advanced indices moves
    # the broadcast (slots) dim to the front
    cache.ks[:, pages, :, offsets] = sk.transpose(0, 1)
    cache.vs[:, pages, :, offsets] = sv.transpose(0, 1)
    return cache


def kv_write_pages(cache: PagedKVCache, layer: int, slot_pages: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor) -> PagedKVCache:
    """Write full prompts' K/V (prefill) into layer ``layer`` (in place).
    slot_pages: ([b,] n_pages); k_new/v_new: ([b,] seq, kvh, d) with
    seq == n_pages · page_size."""
    page = cache.page_size
    lead, n_pages = slot_pages.shape[:-1], slot_pages.shape[-1]
    idx = slot_pages.long()

    def tile(x):  # ([b,] seq, f) → ([b,] n_pages, page, f)
        return x.reshape(*lead, n_pages, page, x.shape[-1])

    kf = k_new.reshape(*k_new.shape[:-2], -1)
    vf = v_new.reshape(*v_new.shape[:-2], -1)
    if cache.ks is None:
        cache.k[layer][idx] = tile(kf).to(cache.k.dtype)
        cache.v[layer][idx] = tile(vf).to(cache.v.dtype)
        return cache
    qk, sk = _quant(cache)(_eq_div(k_new, cache.k_eq, layer))  # ([b,] seq, kvh)
    qv, sv = _quant(cache)(_eq_div(v_new, cache.v_eq, layer))
    spad = cache.ks.shape[-1]

    def tile_s(s):  # ([b,] seq, kvh) → ([b,] n_pages, kvh, spad)
        s = s.reshape(*lead, n_pages, page, s.shape[-1]).transpose(-1, -2)
        return _pad_scales(s, spad)

    cache.k[layer][idx] = tile(qk.reshape(*kf.shape[:-1], -1))
    cache.v[layer][idx] = tile(qv.reshape(*vf.shape[:-1], -1))
    cache.ks[layer][idx] = tile_s(sk)
    cache.vs[layer][idx] = tile_s(sv)
    return cache


def gather_pools(k_pool: torch.Tensor, v_pool: torch.Tensor, k_scales, v_scales,
                 table: torch.Tensor, num_kv_heads: int, dtype=torch.float32,
                 segments: int = 1):
    """One layer's pools (P, page, Fs) [+ scales (P, kvh, spad)] gathered
    through ``table`` (slots, mpps) and dequantized element-wise:
    (slots, mpps·page, kvh, d) K and V, equalizers NOT applied."""
    page = k_pool.shape[1]
    slots, mpps = table.shape
    idx = table.long()
    k_l, v_l = k_pool[idx], v_pool[idx]           # (slots, mpps, page, Fs)
    if k_pool.dtype == torch.uint8:
        k_l, v_l = kv_unpack4(k_l, dtype, segments), kv_unpack4(v_l, dtype, segments)
    d = k_l.shape[-1] // num_kv_heads
    kg = k_l.reshape(slots, mpps * page, num_kv_heads, d).to(dtype)
    vg = v_l.reshape(slots, mpps * page, num_kv_heads, d).to(dtype)
    if k_scales is not None:
        def expand(s):  # (P, kvh, spad) → (slots, T, kvh, 1)
            s = s[:, :, :page][idx].transpose(-1, -2)
            return s.reshape(slots, mpps * page, num_kv_heads)[..., None].to(dtype)

        kg = kg * expand(k_scales)
        vg = vg * expand(v_scales)
    return kg, vg


def kv_gather(cache: PagedKVCache, layer: int, table: torch.Tensor,
              dtype=torch.bfloat16):
    """Gather + dequantize each slot's pages from layer ``layer``:
    (slots, mpps·page, kvh, d) K and V, equalizers applied."""
    kvh, d = cache.num_kv_heads, cache.head_dim
    kg, vg = gather_pools(cache.k[layer], cache.v[layer],
                          None if cache.ks is None else cache.ks[layer],
                          None if cache.vs is None else cache.vs[layer],
                          table, kvh, dtype, cache.pack_segments)
    if cache.ks is not None:
        if cache.k_eq is not None:
            kg = kg * cache.k_eq[layer].reshape(kvh, d).to(dtype)
        if cache.v_eq is not None:
            vg = vg * cache.v_eq[layer].reshape(kvh, d).to(dtype)
    return kg, vg


# ----------------------------------------------------- chunk window
#
# Tensor-parallel decode keeps a chunk's decoded K/V rows out of the pools
# until the chunk ends: they land raw (bf16, un-equalized) in this small
# layer-stacked window, which decode attends with plain torch ops
# (tgq_torch.serve.decode._window_partial) while K5 covers the pools, and
# one quantize + scatter per chunk moves them into the pools.


def window_init(cache: PagedKVCache, slots: int, w: int):
    """(wk, wv) zeros of shape (L, slots, kvh, w, d) bf16 — one decode
    chunk's raw K/V rows, kv heads ahead of tokens as in the JAX package."""
    L = cache.k.shape[0]
    shape = (L, slots, cache.num_kv_heads, w, cache.head_dim)
    return (torch.zeros(shape, dtype=torch.bfloat16, device=cache.k.device),
            torch.zeros(shape, dtype=torch.bfloat16, device=cache.k.device))


def window_write_step(win, i: int, layer: int, k_rows: torch.Tensor,
                      v_rows: torch.Tensor) -> None:
    """Write one step's raw (slots, kvh, d) rows of ``layer`` into window
    column ``i``, in place (decode writes each layer's rows as it makes
    them; the JAX package writes all layers' at once)."""
    wk, wv = win
    wk[layer, :, :, i] = k_rows.to(wk.dtype)
    wv[layer, :, :, i] = v_rows.to(wv.dtype)


def window_flush(cache: PagedKVCache, win, table: torch.Tensor, pos0: torch.Tensor,
                 n: int, live=None) -> PagedKVCache:
    """Quantize (for quantized pools, with the equalizers) and scatter the
    window's first ``n`` columns into the pools, in place.  table (slots,
    mpps); pos0 (slots,) the position of column 0; a slot with ``live`` 0
    flushes to the page-0 scratch."""
    wk, wv = win
    L, slots, kvh, _, d = wk.shape
    page = cache.page_size
    j = torch.arange(n, dtype=pos0.dtype, device=pos0.device)
    pos = (pos0[:, None] + j[None, :]).long()                  # (slots, n)
    pidx = torch.clamp(pos // page, 0, table.shape[1] - 1)
    pages = torch.gather(table.long(), 1, pidx)
    if live is not None:
        pages = torch.where(live[:, None] > 0, pages, torch.zeros_like(pages))
    offsets = (pos % page).reshape(-1)
    pages = pages.reshape(-1)
    # (L, slots, kvh, W, d) → (L, slots·n, kvh, d): tokens ahead of heads
    k_rows = wk[:, :, :, :n].transpose(2, 3).reshape(L, slots * n, kvh, d).float()
    v_rows = wv[:, :, :, :n].transpose(2, 3).reshape(L, slots * n, kvh, d).float()
    if cache.ks is None:
        cache.k[:, pages, offsets] = k_rows.reshape(L, slots * n, -1).to(cache.k.dtype)
        cache.v[:, pages, offsets] = v_rows.reshape(L, slots * n, -1).to(cache.v.dtype)
        return cache
    qk, sk = _quant(cache)(_eq_div_all(k_rows, cache.k_eq))   # codes, (L, slots·n, kvh)
    qv, sv = _quant(cache)(_eq_div_all(v_rows, cache.v_eq))
    cache.k[:, pages, offsets] = qk.reshape(L, slots * n, -1)
    cache.v[:, pages, offsets] = qv.reshape(L, slots * n, -1)
    cache.ks[:, pages, :, offsets] = sk.transpose(0, 1)
    cache.vs[:, pages, :, offsets] = sv.transpose(0, 1)
    return cache
