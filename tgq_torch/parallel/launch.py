"""Process bring-up: ``torch.distributed`` from torchrun's environment,
the (data, model) grid over (process, local device) pairs, and a spawn
helper that starts a command's own ranks (mirrors
``tgq/parallel/launch.py``, where ``jax.distributed`` joins the hosts and
one process drives every local chip).

Here one process runs one rank.  Ranks that each have a card of their
own talk over NCCL; ranks that share a card (more ranks than cards on a
host: NCCL refuses two ranks on one device) talk over gloo, which keeps
the tensors on the card and moves the collectives through host memory.
``init_distributed`` picks and logs the backend by that rule.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import multiprocessing
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 600.0  # a collective that waits longer fails the rank


@dataclasses.dataclass(frozen=True)
class Device:
    """One rank's device: its host (process index) and its index there."""

    process_index: int
    id: int


def pick_backend(local_ranks: int, device: str) -> str:
    """NCCL when every local rank has a card of its own, else gloo (the
    CPU, or ranks sharing a card)."""
    if device == "cuda" and torch.cuda.is_available() \
            and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device: str = "cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT;
    a world of one when they are absent) and return this rank's device:
    ``cuda:<LOCAL_RANK mod cards>`` or the CPU."""
    env = os.environ
    rank, world = int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("tgq_torch: CUDA is not available; pass device='cpu'")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif device == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"init_distributed: unsupported device {device!r}")
    backend = pick_backend(local_world, device)
    if not dist.is_initialized():
        addr = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT", "29500")
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s), **kw)
    logger.info("[dist] rank %d/%d (local %d/%d) on %s over %s", rank, world, local_rank,
                local_world, dev, backend)
    return dev


def build_device_grid(devices, local: int, model: Optional[int] = None) -> np.ndarray:
    """(data, model) grid of devices with the model axis inside a host.

    ``devices`` (each with ``process_index`` and ``id``) are sorted by
    (process, id) — never by the order given — then each model row is a
    contiguous run of one host's devices.  model <= local needs local %
    model == 0; model > local (TP across hosts) needs model % local == 0
    and keeps whole hosts in a row."""
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    n = len(devices)
    model = model if model is not None else local
    if n % model:
        raise ValueError(f"model={model} does not divide {n} devices")
    if model <= local:
        if local % model:
            raise ValueError(f"model={model} must divide local={local} so no TP group "
                             "straddles hosts")
    else:
        if model % local:
            raise ValueError(f"model={model} must be a multiple of local={local} so TP "
                             "groups hold whole hosts")
        logger.warning("[mesh] TP degree %d spans %d hosts: the row all_reduce crosses "
                       "the network", model, model // local)
    return np.asarray(devices, dtype=object).reshape(n // model, model)


def global_mesh(model_per_host: Optional[int] = None):
    """The ("data", "model") mesh over every rank of the process group,
    the model axis filled with a host's local ranks first."""
    from tgq_torch.parallel.mesh import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    devs = [Device(process_index=r // local, id=r % local) for r in range(world)]
    grid = build_device_grid(devs, local, model_per_host)
    return make_mesh(data=grid.shape[0], model=grid.shape[1])


# ----------------------------------------------------------------- spawn


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_host(x):
    """Results cross the process boundary as numpy / Python objects."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _worker(rank: int, world: int, port: int, device: str, timeout_s: float, fn, args,
            out) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    if device == "cpu":  # ranks share the host's cores
        n = max(1, min(4, (os.cpu_count() or 1) // world))
        torch.set_num_threads(n)
        # and so does the BLAS of the host factorizations (scipy's), which
        # reads this when it loads, after this point unless ``fn``'s module
        # imported it
        for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ.setdefault(k, str(n))
    try:
        init_distributed(device, timeout_s)
        out.put((rank, "ok", _to_host(fn(*args))))
    except BaseException:  # noqa: BLE001 — every failure goes to the parent
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, args=(), device: str = "cuda",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``world`` new ranks on this host (the ``spawn``
    start method, gloo or NCCL by :func:`pick_backend`) and return their
    results, rank 0 first.  ``fn`` must be importable by name.  A rank
    that raises, dies or outlives ``timeout_s`` fails the call: the other
    ranks are stopped and the error (with the rank's traceback) raised."""
    if device == "cuda":  # build the kernels once, not once a rank
        from tgq_torch.kernels import _build

        _build.build()
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, port, device, timeout_s, fn,
                                               tuple(args), out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, object] = {}
    errors: list[str] = []
    deadline = time.time() + timeout_s + 60.0
    try:
        while len(results) < world and not errors:
            try:
                rank, status, val = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    errors.append(f"rank(s) {dead} died with exit codes "
                                  f"{[procs[r].exitcode for r in dead]}")
                elif time.time() > deadline:
                    errors.append(f"ranks {sorted(set(range(world)) - set(results))} did "
                                  f"not finish within {timeout_s + 60.0:.0f} s")
                continue
            if status == "ok":
                results[rank] = val
            else:
                errors.append(f"rank {rank} failed:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=30.0 if not errors else 1.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawned ranks failed: " + "\n".join(errors))
    return [results[r] for r in range(world)]
