"""The ("data", "model") mesh and the tensor-parallel rules (mirrors
``tgq/parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` of devices in one
process and lets GSPMD insert the collectives.  Here every rank is a
process (``torch.distributed``), and :class:`Mesh` holds this rank's
coordinates and the process groups of its two axes; the model code calls
the collectives itself:

- q/k/v_proj, gate/up_proj: split by output (column-parallel), no
  collective;
- o_proj, down_proj: split by input (row-parallel), one ``all_reduce``
  over "model" after the matmul, in the output's dtype (the JAX
  package's ``psum``), a bias added once after it;
- embed_tokens and lm_head split by vocab: a masked lookup and an
  ``all_reduce``, the head's logits gathered;
- norms replicated; packed leaves are K-major, so their rules are the
  dense ones transposed;
- of the other families only OPT's q/k/v_proj match a rule (split by
  heads); OPT's out_proj, fc1, fc2 and all of a GPT-2 layer (c_attn,
  c_proj, c_fc) are replicated, as in the JAX package.

Global rank ``r`` sits at (data ``r // model``, model ``r % model``): a
model row is a run of consecutive ranks, so on a multi-host launch the TP
groups stay inside a host (``tgq_torch.parallel.launch``).  Data
parallelism splits the calibration batch on "data"; the Gram matrices
that make a Hessian are sums over tokens, and :func:`dp_sum` adds the
data ranks' batch Grams in the order one process would, so the Hessian
is the single-process one bit for bit (an ``all_reduce`` adds them in
another order: on Qwen3-8B's singular layer-0 Hessian that last-bit
difference moved 44 % of q_proj's quantized weights, PERF.md §6).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from tgq_torch.core.packing import PackedLinear

_COL_SHARDED = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW_SHARDED = ("o_proj", "down_proj")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, model) grid of ranks and the process
    groups of its data column and model row (None for an axis of size 1
    or a world of one process)."""

    data: int
    model: int
    data_rank: int = 0
    model_rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)
    backend: str = "none"

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def rank(self) -> int:
        return self.data_rank * self.model + self.model_rank

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.data_rank if axis == "data" else self.model_rank

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(data: int = 1, model: Optional[int] = None) -> Mesh:
    """This rank's mesh over the initialised default process group (a
    world of one when none is).  ``model`` defaults to world / data.  Every
    rank must call it, in the same order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model is None:
        if world % data:
            raise ValueError(f"make_mesh: data={data} does not divide {world} ranks")
        model = world // data
    if data * model != world:
        raise ValueError(f"make_mesh: data={data} x model={model} != {world} ranks")
    groups: dict = {}
    backend = dist.get_backend() if dist.is_initialized() else "none"
    if world > 1:
        # every rank creates every group, rows first, in one order
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == rank // model and model > 1:
                groups["model"] = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == rank % model and data > 1:
                groups["data"] = g
    return Mesh(data=data, model=model, data_rank=rank // model, model_rank=rank % model,
                groups=groups, backend=backend)


# --------------------------------------------------------- collectives

# The collectives this process issued, by phase ("prefill" and "decode"
# while the serving engine runs one, "other" elsewhere): {"calls": n,
# "seconds": s, "wait_seconds": w}.  The times are summed only while
# ``time_collectives`` is on: the device is then synchronised before each
# collective, a barrier of its group waits for the group's last rank
# (``wait_seconds``: the skew between the ranks, which on one shared card
# is mostly the other ranks' own work), and ``seconds`` is the collective
# itself up to the device's next synchronisation.
collective_stats: dict = {}
_PHASE: contextvars.ContextVar[str] = contextvars.ContextVar("tgq_torch_collective_phase",
                                                             default="other")
_timed = False


@contextlib.contextmanager
def collective_phase(name: str):
    """Count (and time) the collectives of this scope under ``name``."""
    token = _PHASE.set(name)
    try:
        yield
    finally:
        _PHASE.reset(token)


@contextlib.contextmanager
def time_collectives():
    """Time every collective of this scope (``collective_stats``)."""
    global _timed
    _timed = True
    try:
        yield
    finally:
        _timed = False


def collective_totals() -> dict:
    """A copy of ``collective_stats``, to subtract from a later one."""
    return {k: dict(v) for k, v in collective_stats.items()}


def _collective(group, x: torch.Tensor, op, *args, **kw) -> None:
    """``op(*args, group=group, **kw)``, counted (and timed) by phase;
    ``x`` names the device to synchronise."""
    st = collective_stats.setdefault(_PHASE.get(),
                                     {"calls": 0, "seconds": 0.0, "wait_seconds": 0.0})
    st["calls"] += 1
    if not _timed:
        op(*args, group=group, **kw)
        return
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    dist.barrier(group=group)
    t1 = time.perf_counter()
    op(*args, group=group, **kw)
    sync()
    st["wait_seconds"] += t1 - t0
    st["seconds"] += time.perf_counter() - t1


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, in ``x``'s dtype (a new
    tensor; ``x`` is left alone)."""
    if mesh.size(axis) == 1:
        return x
    y = x.contiguous().clone()
    _collective(mesh.group(axis), y, dist.all_reduce, y)
    return y


def all_gather_last(x: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """The ranks' ``x`` concatenated along the last dim, in rank order.
    Gloo's collectives on CUDA tensors are documented for ``broadcast``
    and ``all_reduce`` only, so there each rank places its piece in a
    zero buffer and the buffers are summed (exact: every element is one
    piece plus zeros)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    x = x.contiguous()
    if x.is_cuda and mesh.backend == "gloo":
        w = x.shape[-1]
        buf = torch.zeros((*x.shape[:-1], n * w), dtype=x.dtype, device=x.device)
        i = mesh.index(axis)
        buf[..., i * w:(i + 1) * w] = x
        _collective(mesh.group(axis), buf, dist.all_reduce, buf)
        return buf
    parts = [torch.empty_like(x) for _ in range(n)]
    _collective(mesh.group(axis), x, dist.all_gather, parts, x)
    return torch.cat(parts, dim=-1)


def broadcast_int(value: int, mesh: Mesh) -> int:
    """The ``value`` of the first rank of this rank's model row, on every
    rank of it: a host decision that every TP rank must take alike (which
    requests a serving step admits, when the decision reads the rank's
    own clock)."""
    if mesh.model == 1:
        return value
    dev = torch.device("cuda", torch.cuda.current_device()) if mesh.backend == "nccl" \
        else torch.device("cpu")
    t = torch.tensor([value], dtype=torch.int64, device=dev)
    _collective(mesh.group("model"), t, dist.broadcast, t, src=mesh.rank - mesh.model_rank)
    return int(t.item())


# --------------------------------------------------------- sharding rules


def linear_split(name: str) -> Optional[str]:
    """How the rules split the linear named ``name`` (a dotted path's last
    key decides): "col" (by output), "row" (by input) or None
    (replicated, as GPT-2's c_proj is)."""
    key = name.rsplit(".", 1)[-1]
    return "col" if key in _COL_SHARDED else "row" if key in _ROW_SHARDED else None


def _linear_spec(name: str, for_bias: bool = False) -> tuple:
    split = linear_split(name)
    if split == "col":
        return ("model",) if for_bias else ("model", None)
    if split == "row":
        return () if for_bias else (None, "model")
    return ()


def spec_for_path(keys: tuple) -> tuple:
    """The partition spec of one leaf, by its key path — the JAX
    package's ``_spec_for_path``: one entry per leading dim, "model" where
    that dim is split, ``()`` for a replicated leaf."""
    if "embed_tokens" in keys:
        return ("model", None)
    if "lm_head" in keys:
        if keys[-1] in ("codes", "scale", "zero"):
            return (None, "model")       # K-major (in/groups, vocab)
        if keys[-1] == "bias":
            return ("model",)
        return ("model", None)
    for k in keys:
        if k.endswith("_proj"):
            if keys[-1] in ("b", "bias"):
                return _linear_spec(k, for_bias=True)
            spec = _linear_spec(k)
            if keys[-1] in ("codes", "scale", "zero") and spec:
                return (spec[1], spec[0])    # K-major packed leaves
            return spec
    return ()


def _slice(t: torch.Tensor, spec: tuple, mesh: Mesh, what: str) -> torch.Tensor:
    n, i = mesh.model, mesh.model_rank
    for dim, ax in enumerate(spec):
        if ax != "model":
            continue
        if t.shape[dim] % n:
            raise ValueError(f"shard_params: {what} dim {dim} ({t.shape[dim]}) does not "
                             f"split into {n}")
        w = t.shape[dim] // n
        t = t.narrow(dim, i * w, w)
    return t.contiguous() if n > 1 else t


def shard_params(params, mesh: Mesh, path=()):
    """This rank's slices of a parameter tree (the rules of
    :func:`spec_for_path`).  Packed linears get their shard-local
    in/out features; a row-parallel packed linear is split at a multiple
    of its group, so each shard's byte rows hold whole groups."""
    if isinstance(params, PackedLinear):
        spec = spec_for_path(path + ("codes",))
        n_in, n_out = params.in_features, params.out_features
        if spec == ("model", None):
            n_in //= mesh.model
            if n_in % params.group_size:
                raise ValueError(f"shard_params: {'.'.join(path)} splits in_features "
                                 f"{params.in_features} inside a group")
        elif spec == (None, "model"):
            n_out //= mesh.model
        sl = lambda leaf: None if getattr(params, leaf) is None else _slice(  # noqa: E731
            getattr(params, leaf), spec_for_path(path + (leaf,)), mesh, ".".join(path))
        return dataclasses.replace(params, codes=sl("codes"), scale=sl("scale"),
                                   zero=sl("zero"), bias=sl("bias"), in_features=n_in,
                                   out_features=n_out)
    if isinstance(params, dict):
        return {k: shard_params(v, mesh, path + (k,)) for k, v in params.items()}
    if isinstance(params, list):
        return [shard_params(v, mesh, path + (str(i),)) for i, v in enumerate(params)]
    return _slice(params, spec_for_path(path), mesh, ".".join(path))


def local_config(cfg, mesh: Optional[Mesh]):
    """The model config one rank computes with, from what the rules split
    in its layers: the heads (q and kv) when the first quantization group
    (q/k/v_proj) is split by output, the MLP width when the third
    (gate/up_proj) is.  Llama splits both, OPT its heads (q/k/v_proj; fc1
    is replicated), GPT-2 neither (c_attn, c_fc).  Hidden size and
    vocabulary unchanged (``shard_params`` checks the vocabulary where it
    splits the embedding and head)."""
    from tgq_torch.models.causal_lm import sequenced_groups

    tp = 1 if mesh is None else mesh.model
    if tp == 1:
        return cfg
    groups = sequenced_groups(cfg)
    heads, mlp = (linear_split(groups[gi][0]) == "col" for gi in (0, 2))
    for what, n, split in (("heads", cfg.num_heads, heads), ("kv heads", cfg.num_kv_heads, heads),
                           ("intermediate size", cfg.intermediate_size, mlp)):
        if split and n % tp:
            raise ValueError(f"{cfg.name}: {what} {n} do not split into {tp} ranks")
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp if heads else cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads // tp if heads else cfg.num_kv_heads,
        intermediate_size=cfg.intermediate_size // tp if mlp else cfg.intermediate_size)


# ------------------------------------------------- data-parallel Hessian


def dp_sum(own, mesh: Mesh) -> torch.Tensor:
    """Σ of every data rank's batch Grams in one order: data rank 0 adds
    its parts one by one to zeros, each next data rank adds its own to the
    running sum the previous one broadcast, and the last broadcasts the
    total.  That is the association of one process adding all the parts
    in that order, so its bits do not depend on the data split; it costs
    ``data`` broadcasts of one part's size.  ``own`` is this rank's list
    of parts; data rank 0, first in the order, may give their running sum
    (a tensor) instead, and so keep one n x n Gram instead of a list."""
    n = mesh.size("data")
    if isinstance(own, torch.Tensor):
        if mesh.data_rank:
            raise ValueError("dp_sum: only data rank 0 may pass a running sum")
        acc = own
    else:
        acc = torch.zeros_like(own[0])
    for r in range(n):
        if mesh.data_rank == r and not isinstance(own, torch.Tensor):
            for part in own:
                acc += part
        if n > 1:
            _collective(mesh.group("data"), acc, dist.broadcast, acc,
                        src=r * mesh.model + mesh.model_rank)
    return acc


def dp_hessian_gram(xs, mesh: Mesh) -> torch.Tensor:
    """Exact data-parallel Gram: the f32 Gram (the 1024-token chunked Gram
    of ``tgq_torch.solver.hessian``) of each of this rank's batches ``xs``
    (a tensor or a list of them), summed over "data" by :func:`dp_sum`."""
    from tgq_torch.solver.hessian import gram

    return dp_sum([gram(x) for x in (xs if isinstance(xs, (list, tuple)) else [xs])], mesh)


# --------------------------------------- TP-routed packed matmul (serving)

# The mesh of the forward being run.  A ContextVar, not a module global:
# two engines (or an engine and a calibration run) in one process, even on
# different threads, each see only the mesh their own call scoped.
_SERVING_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "tgq_torch_serving_mesh", default=None)


def set_serving_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Set the serving mesh; returns the previous value (for restore)."""
    prev = _SERVING_MESH.get()
    _SERVING_MESH.set(mesh)
    return prev


def tp_mesh() -> Optional[Mesh]:
    """The serving mesh when its model axis is wider than one, else None."""
    mesh = _SERVING_MESH.get()
    return mesh if mesh is not None and mesh.model > 1 else None


@contextlib.contextmanager
def serving_mesh_scope(mesh: Optional[Mesh]):
    """Scope the serving mesh for one forward / dispatch."""
    prev = set_serving_mesh(mesh)
    try:
        yield
    finally:
        set_serving_mesh(prev)


def mark_tp_kinds(params):
    """Tag each packed projection with its TP role ("col"/"row") by name,
    the names :func:`spec_for_path` splits; dense linears are untouched."""

    def walk(node, name=None):
        if isinstance(node, PackedLinear):
            kind = None if name is None else linear_split(name)
            return node if kind is None else dataclasses.replace(node, tp_kind=kind)
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return node

    return walk(params)


def quantized_matmul_tp(x: torch.Tensor, w: PackedLinear, mesh: Mesh, out_dtype=None,
                        glu: bool = False) -> torch.Tensor:
    """The packed matmul of a rank-local TP shard ``w`` (from
    :func:`shard_params`): "col" runs locally on the replicated input and
    gives this rank's output columns; "row" runs locally on this rank's
    input slice, then one ``all_reduce`` over "model" in the output's
    dtype, and a bias is added once, after it."""
    from tgq_torch.kernels.dequant_matmul import quantized_matmul

    if w.tp_kind != "row":
        return quantized_matmul(x, w, out_dtype=out_dtype, glu=glu)
    y = quantized_matmul(x, dataclasses.replace(w, bias=None), out_dtype=out_dtype, glu=glu)
    y = all_reduce(y, mesh, "model")
    if w.bias is not None:
        y = y + w.bias.to(y.dtype)
    return y
