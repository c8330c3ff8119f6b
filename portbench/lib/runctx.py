"""What run.py hands a driver, and what a driver hands back."""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "tgq")


@dataclasses.dataclass
class Context:
    cell: object            # bench.Cell
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    t_start: float          # process start (time.time())
    control: Optional[dict] = None   # a control's switches (tests only)
    check: bool = True      # run the comparison after the window


@dataclasses.dataclass
class Outcome:
    e2e: dict               # end-to-end metric name -> value
    rec: dict               # what the per-layer readers read
    attempted: int
    failed: int
    checks: dict            # compared number name -> value
    memory_peak_bytes: int
    trace: Optional[dict] = None   # lib.trace summary of the traced window


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def model_config(conf: dict, name: str):
    """The port's ModelConfig for a configuration file, of the fields its
    family gives (``families/<family>.py::port_config``)."""
    from tgq_torch.models.config import ModelConfig

    from portbench.lib import bench
    return ModelConfig(**bench.family(conf["family"]).port_config(conf, name))


def sync(device) -> None:
    import torch
    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    import torch
    if getattr(device, "type", "cpu") != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def free_device(device) -> None:
    import gc

    import torch
    gc.collect()
    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
