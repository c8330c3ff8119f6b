"""Continuous-batching generation engine (mirrors ``tgq/serve/engine.py``).

A fixed set of decode slots; a request is admitted into a free slot when
the page pool can hold its prompt, prefilled in chunks of prompts padded
to the same page multiple (dispatched asynchronously and collected a tick
later), and every tick decodes up to ``decode_chunk`` tokens for all
active slots with sampling on the device — the host syncs once per chunk.
With ``overlap_host`` the next chunk is dispatched from the previous
chunk's on-device tokens before those are fetched; a slot that finishes
inside the pipeline drops its speculative tokens, and its pages stay out
of the free pool until the in-flight chunk's tokens have been fetched.

With a ``mesh`` (``tgq_torch.parallel.make_mesh``) every rank builds the
same engine: it keeps its tensor-parallel shards of the weights and its
own kv heads' pools, and runs the host scheduling in lockstep with the
other ranks.  Every rank samples from the same gathered logits with a
generator seeded alike, so every rank holds the same tokens; a decode
chunk of more than one step runs in chunk-window mode
(``tgq_torch.serve.decode``).

On a CUDA card without a mesh the engine owns a ``DecodeGraphs``
(``Engine.graphs``) and hands it to every ``decode_steps`` call: each
greedy chunk is replayed from a CUDA graph of its length, captured at the
first decode chunk; temperature chunks stay eager, as does every chunk on
the CPU or under a mesh.  ``Engine.graphs = None`` keeps every chunk eager.

Under a recording ``torch.profiler`` each tick's host work is a
``tgq.engine.*`` span (``tgq_torch.utils.profiling.span``): ``step``
around the tick; inside it ``admit``, ``prefill_dispatch``,
``prefill_collect``, ``schedule`` (a decode chunk's page tables and
inputs), ``decode_dispatch`` (enqueueing the chunk's launches), ``fetch``
(waiting for its tokens) and ``fold`` (appending them, retiring).  No span
is opened inside a chunk.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from tgq_torch.models.config import ModelConfig
from tgq_torch.parallel.mesh import (
    collective_phase,
    local_config,
    mark_tp_kinds,
    serving_mesh_scope,
    shard_params,
)
from tgq_torch.serve.decode import (
    DecodeGraphs,
    decode_steps,
    fuse_packed_projections,
    prefill_batch,
)
from tgq_torch.serve.kv_cache import PagedKVCache, PageTable, host_to_device
from tgq_torch.utils.precision import resolve_device
from tgq_torch.utils.profiling import span

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ServeConfig:
    max_slots: int = 8
    page_size: int = 64
    num_pages: int = 512
    max_pages_per_slot: int = 32
    max_new_tokens: int = 128
    eos_id: Optional[int] = None
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0
    # max decode steps per dispatch, rounded down to a power of two per tick
    decode_chunk: int = 8
    # KV storage: 16 = bf16, 8 = int8 + scales, 4 = int4 nibbles + scales
    kv_bits: int = 16
    # optional static per-channel equalizers (layers, kv_heads·head_dim)
    kv_k_eq: Optional[object] = None
    kv_v_eq: Optional[object] = None
    # activation precision of the packed matmuls: 16, or 8 (W4A8, K4)
    a_bits: int = 16
    # dispatch decode chunk N+1 from chunk N's on-device tokens before
    # fetching chunk N (token-identical)
    overlap_host: bool = True
    # padded prompt tokens per prefill dispatch (0 = one wave)
    prefill_chunk_tokens: int = 4096
    # page allocator backend: "auto" (native when it builds), "native", "python"
    page_alloc: str = "auto"


@dataclasses.dataclass
class _Chunk:
    """An in-flight decode chunk: its device token block, the slot↔request
    binding at dispatch time, and the pages of slots retired while it was
    in flight (released once its tokens are fetched)."""

    toks: torch.Tensor               # (n, slots) int32 on the device
    group: list                      # [(slot, Request), ...]
    n: int
    deferred: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _PrefillChunk:
    """An in-flight prefill dispatch: first tokens on the device and the
    slot↔request binding; its slots sit in ``Engine._staging``."""

    toks: torch.Tensor               # (b,) int32 on the device
    group: list                      # [(slot, Request), ...]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 128
    temperature: Optional[float] = None
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0


def _mark_act_bits(params, bits: int):
    """Tag every packed DECODER-LAYER linear at bits <= 4 with the
    activation precision; the lm_head keeps its own path.  Returns
    ``(params, n_marked)``."""
    from tgq_torch.core.packing import PackedLinear

    n_marked = 0

    def walk(node):
        nonlocal n_marked
        if isinstance(node, PackedLinear):
            if node.bits in (2, 3, 4):
                n_marked += 1
                return dataclasses.replace(node, act_bits=bits)
            return node
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    out = dict(params)
    out["model"] = {**params["model"], "layers": walk(params["model"]["layers"])}
    return out, n_marked


def _local_heads(eq, cfg: ModelConfig, mesh) -> np.ndarray:
    """This rank's kv heads' columns of (layers, kv_heads·head_dim)
    equalizers."""
    e = np.asarray(eq.cpu() if isinstance(eq, torch.Tensor) else eq, np.float32)
    e = e.reshape(cfg.num_layers, cfg.num_kv_heads, cfg.head_dim)
    n = cfg.num_kv_heads // mesh.model
    return e[:, mesh.model_rank * n:(mesh.model_rank + 1) * n].reshape(cfg.num_layers, -1)


class Engine:
    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig, mesh=None,
                 device: str = "cuda"):
        """``params`` must already live on ``device`` (CUDA unless the
        caller asks for the CPU).  ``mesh``: this rank's
        ``tgq_torch.parallel.Mesh``; ``params`` are then the whole model,
        of which the engine keeps this rank's shards."""
        if cfg.family != "llama":
            raise NotImplementedError("the serving engine is llama-family")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = scfg
        self.mesh = mesh
        # the config this rank computes with: its heads and MLP width
        self.run_cfg = local_config(cfg, mesh)
        self.a8_active = False
        if scfg.a_bits == 8:
            params, n_marked = _mark_act_bits(params, 8)
            self.a8_active = n_marked > 0
            if not self.a8_active:
                logger.warning("a_bits=8 requested but no decoder-layer linear is packed "
                               "at bits <= 4: A8 is a no-op")
        k_eq, v_eq = scfg.kv_k_eq, scfg.kv_v_eq
        if mesh is not None:
            params = shard_params(mark_tp_kinds(params), mesh)
            k_eq, v_eq = (None if e is None else _local_heads(e, cfg, mesh) for e in (k_eq, v_eq))
        # fusing after sharding is exact: a rank's q/k/v (gate/up) shards
        # share its input and concatenate along their outputs
        self.params = fuse_packed_projections(params)
        self.cache = PagedKVCache.init(self.run_cfg, scfg.num_pages, scfg.page_size,
                                       kv_bits=scfg.kv_bits, k_eq=k_eq, v_eq=v_eq,
                                       device=self.device)
        self.pt = PageTable(scfg.num_pages, scfg.page_size, scfg.max_slots,
                            scfg.max_pages_per_slot, backend=scfg.page_alloc)
        self.slots: list[Optional[Request]] = [None] * scfg.max_slots
        self.queue: deque[Request] = deque()
        self.gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        self._next_rid = 0
        self.steps = 0
        self.tokens_emitted = 0
        self.chunks = 0        # decode chunks dispatched
        self.spec_chunks = 0   # of which dispatched before the previous chunk's fetch
        self.decode_wall_s = 0.0   # decode dispatch + token fetch
        self.prefill_wall_s = 0.0  # prefill dispatch + first-token fetch
        self._pending: Optional[_Chunk] = None
        self._spec: Optional[_Chunk] = None
        self._pf: deque[_PrefillChunk] = deque()
        self._staging: set = set()
        self.graphs = None
        if self.device.type == "cuda" and mesh is None:
            self.graphs = DecodeGraphs(self.params, self.cache, self.run_cfg, scfg.max_slots,
                                       scfg.max_pages_per_slot, scfg.decode_chunk, self.device)

    @property
    def graph_chunks(self) -> int:
        """Decode chunks replayed from a CUDA graph."""
        return self.graphs.replays if self.graphs is not None else 0

    @property
    def graph_captures(self) -> int:
        """CUDA graphs captured (one per chunk length, at the first chunk)."""
        return self.graphs.captures if self.graphs is not None else 0

    def _dev(self, arr) -> torch.Tensor:
        return host_to_device(arr, self.device)

    # ------------------------------------------------------------- API

    def submit(self, prompt: list[int], max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None) -> Request:
        req = Request(rid=self._next_rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens or self.scfg.max_new_tokens,
                      temperature=temperature, submit_t=time.time())
        self._next_rid += 1
        self.queue.append(req)
        return req

    @property
    def idle(self) -> bool:
        """True when nothing is queued, active, or in flight."""
        return not (self.queue or any(self.slots) or self._pending is not None or self._pf)

    def step(self) -> list[Request]:
        """One tick: admission, then (unless more of the queue can be
        admitted right now) one decode chunk.  Returns the requests that
        finished this tick; ``submit`` may be called between ticks."""
        with span("engine.step"):
            self._admit()
            if self._can_admit_more():
                return []
            return self._decode_tick()

    def run(self) -> list[Request]:
        """Drive until queue and slots are empty; returns finished reqs."""
        finished: list[Request] = []
        while not self.idle:
            finished.extend(self.step())
        return finished

    # -------------------------------------------------------- internals

    def _can_admit_more(self) -> bool:
        if not self.queue or not any(s is None for s in self.slots):
            return False
        return self.pt.num_free >= self.pt.pages_needed(len(self.queue[0].prompt) + 1)

    def _admit(self) -> None:
        """Collect in-flight prefill chunks beyond two, then dispatch at
        most one new chunk of head-of-queue prompts that pad to the same
        page count (bounded by free slots, pages and
        ``prefill_chunk_tokens``), without waiting for it."""
        with span("engine.admit"):
            page = self.scfg.page_size
            while len(self._pf) >= 2:
                self._collect_prefill()
            if not self.queue:
                return
            free = [s for s in range(self.scfg.max_slots) if self.slots[s] is None]
            if not free:
                return
            head_pages = self.pt.pages_needed(len(self.queue[0].prompt))
            cap_tok = self.scfg.prefill_chunk_tokens or 0
            group: list[Request] = []
            budget = self.pt.num_free
            for req in self.queue:
                need = self.pt.pages_needed(len(req.prompt) + 1)
                if (self.pt.pages_needed(len(req.prompt)) != head_pages
                        or need > budget or len(group) >= len(free)
                        or (group and cap_tok
                            and (len(group) + 1) * head_pages * page > cap_tok)):
                    break
                group.append(req)
                budget -= need
            if not group:
                return
            b = 1 << (len(group).bit_length() - 1)  # power-of-two batch
            group = group[:b]
            t0 = time.time()
            pad = head_pages * page
            ids = np.zeros((b, pad), np.int64)
            true_len = np.zeros((b,), np.int64)
            temps = np.zeros((b,), np.float32)
            slot_pages = np.zeros((b, head_pages), np.int64)
            slots = free[:b]
            for i, (s, req) in enumerate(zip(slots, group)):
                self.queue.popleft()
                ids[i, :len(req.prompt)] = req.prompt
                true_len[i] = len(req.prompt)
                temps[i] = req.temperature if req.temperature is not None else self.scfg.temperature
                slot_pages[i] = self.pt.alloc_slot(s, len(req.prompt))
                self.slots[s] = req
            with span("engine.prefill_dispatch"), serving_mesh_scope(self.mesh), \
                    collective_phase("prefill"):
                toks, self.cache = prefill_batch(
                    self.params, self.cache, self.run_cfg, self._dev(slot_pages), self._dev(ids),
                    self._dev(true_len), self._dev(temps), self.gen,
                    greedy_only=bool((temps == 0).all()))
            self.prefill_wall_s += time.time() - t0
            self._pf.append(_PrefillChunk(toks, list(zip(slots, group))))
            self._staging.update(slots)

    def _collect_prefill(self) -> None:
        """Fetch the oldest in-flight prefill chunk's first tokens (a real
        device sync) and make its slots decodable."""
        with span("engine.prefill_collect"):
            chunk = self._pf.popleft()
            t0 = time.time()
            toks = chunk.toks.cpu().numpy()
            now = time.time()
            self.prefill_wall_s += now - t0
            for i, (s, req) in enumerate(chunk.group):
                self._staging.discard(s)
                tok = int(toks[i])
                req.output.append(tok)
                req.first_token_t = now
                self.tokens_emitted += 1
                if self._finished(req, tok):
                    self._retire(s)

    def _finished(self, req: Request, tok: int) -> bool:
        if self.scfg.eos_id is not None and tok == self.scfg.eos_id:
            return True
        return len(req.output) >= req.max_new_tokens

    def _retire(self, s: int) -> None:
        req = self.slots[s]
        req.done = True
        req.finish_t = time.time()
        # an in-flight chunk's table still maps this slot's pages: hold them
        # back until that chunk's tokens are fetched
        holder = None
        for chunk in (self._spec, self._pending):
            if chunk is not None and any(cs == s for cs, _ in chunk.group):
                holder = chunk
                break
        if holder is not None:
            holder.deferred.extend(self.pt.detach_slot(s))
        else:
            self.pt.free_slot(s)
        self.slots[s] = None

    def _chunk_steps(self, active: list[int], lens0: np.ndarray) -> int:
        """Decode steps this tick: within every active slot's budget and
        the free pages, rounded down to a power of two."""
        n = self.scfg.decode_chunk
        cap = self.scfg.max_pages_per_slot * self.scfg.page_size
        for s in active:
            req = self.slots[s]
            n = min(n, req.max_new_tokens - len(req.output), cap - int(lens0[s]))
        n = max(n, 1)
        while n > 1:
            extra = sum(self.pt.pages_needed(int(lens0[s]) + n)
                        - self.pt.pages_needed(int(lens0[s])) for s in active)
            if extra <= self.pt.num_free:
                break
            n //= 2
        return 1 << (n.bit_length() - 1)

    def _dispatch(self, tokens: torch.Tensor, active: list[int]) -> _Chunk:
        """Dispatch one decode chunk without waiting.  ``tokens`` (slots,)
        int32 on the device (the speculative path passes the previous
        chunk's last tokens, still on the device)."""
        with span("engine.schedule"):
            lens0 = np.asarray(self.pt.lens, np.int32)
            n = self._chunk_steps(active, lens0)
            for s in active:
                self.pt.extend(s, n)
            table, _ = self.pt.device_tables(self.device)
            temps = np.zeros((self.scfg.max_slots,), np.float32)
            for s in active:
                req = self.slots[s]
                temps[s] = req.temperature if req.temperature is not None else self.scfg.temperature
            greedy = all(temps[s] == 0 for s in active)
            # every slot is computed, only active ones may write KV
            live = np.zeros((self.scfg.max_slots,), np.int32)
            live[active] = 1
            pos, lens = self._dev(lens0 + 1), self._dev(lens0)
            temps_d, live_d = self._dev(temps), self._dev(live)
        with span("engine.decode_dispatch"), serving_mesh_scope(self.mesh), \
                collective_phase("decode"):
            toks, self.cache = decode_steps(
                self.params, self.cache, self.run_cfg, table, pos, tokens, lens, temps_d,
                self.gen, n, greedy_only=greedy, live=live_d,
                window=self.mesh is not None and self.mesh.model > 1, graphs=self.graphs)
        self.steps += n
        self.chunks += 1
        return _Chunk(toks, [(s, self.slots[s]) for s in active], n)

    def _can_speculate(self, pending: _Chunk) -> bool:
        """Safe to dispatch chunk N+1 before reading chunk N's tokens: no
        slot of chunk N reaches its budget or the page cap during it."""
        if not self.scfg.overlap_host:
            return False
        cap = self.scfg.max_pages_per_slot * self.scfg.page_size
        for s, req in pending.group:
            if self.slots[s] is not req:
                return False
            if len(req.output) + pending.n >= req.max_new_tokens:
                return False
            if int(self.pt.lens[s]) + 1 > cap:
                return False
        return True

    def _collect(self, chunk: _Chunk) -> list[Request]:
        """Fetch a chunk's tokens and fold them into its requests; slots
        retired or replaced since dispatch drop theirs."""
        t0 = time.time()
        with span("engine.fetch"):
            toks = chunk.toks.cpu().numpy()  # (n, slots): waits for the chunk
        self.decode_wall_s += time.time() - t0
        finished = []
        with span("engine.fold"):
            for s, req in chunk.group:
                if self.slots[s] is not req:
                    continue
                for i in range(chunk.n):
                    tok = int(toks[i, s])
                    req.output.append(tok)
                    self.tokens_emitted += 1
                    if self._finished(req, tok):
                        self._retire(s)
                        finished.append(req)
                        break
            # the fetch above waited for the chunk: its KV writes have landed
            if chunk.deferred:
                self.pt.release_pages(chunk.deferred)
                chunk.deferred = []
        return finished

    def _decode_tick(self) -> list[Request]:
        if self._pending is None:
            # in-flight prefills precede anything dispatched now; collecting
            # them first lets their slots join this chunk
            while self._pf:
                self._collect_prefill()
        active = [s for s in range(self.scfg.max_slots)
                  if self.slots[s] and s not in self._staging]
        if self._pending is None:
            if not active:
                return []
            tokens = np.zeros((self.scfg.max_slots,), np.int32)
            for s in active:
                tokens[s] = self.slots[s].output[-1]
            t0 = time.time()
            self._pending = self._dispatch(self._dev(tokens), active)
            self.decode_wall_s += time.time() - t0
        pending = self._pending
        if self._can_speculate(pending) and set(active) == {s for s, _ in pending.group}:
            t0 = time.time()
            self._spec = self._dispatch(pending.toks[-1], [s for s, _ in pending.group])
            self.decode_wall_s += time.time() - t0
            self.spec_chunks += 1
        out = self._collect(pending)
        self._pending, self._spec = self._spec, None
        return out
