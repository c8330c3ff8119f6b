"""Device timing and roofline bounds on one NVIDIA H100.

The port's counterpart of the JAX package's slope method
(``tgq/cli/decode_bench.py::_slope``): there, t(2N) - t(N) of chained
in-jit reps cancels a remote chip's dispatch and fetch.  Here CUDA events
bracket the launches on the device's own clock, and a spin kernel queued
ahead of them keeps the card busy while the host enqueues the timed calls,
so the events time the device and not the host's dispatch (a 20-60 us
Python wrapper otherwise hides a decode-sized kernel).

``bound_ms`` is the least time the card could take for a piece of work:
the larger of its bytes over the HBM rate and its operations over the
peak rate of their type (NVIDIA's H100 SXM data sheet, dense, at the
full 700 W power limit).
"""
from __future__ import annotations

import time

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
INT8_OP_PER_S = 1979e12     # H100 SXM int8 tensor cores, dense


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls.  A spin
    kernel keeps the card busy while the host queues the timed calls, so
    the events bracket the device's work and not the host's dispatch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2e9 * (2 * reps * host_s + 1e-3), 1e9)))  # ~2 GHz cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def busy_ms(fn, reps: int = 3, warmup: int = 1) -> float:
    """Mean device-busy milliseconds of ``fn()`` over ``reps`` calls: the
    durations of the kernels it launched, summed from a ``torch.profiler``
    trace (one stream, so they do not overlap).  For work of many launches,
    whose host dispatch outruns the launch queue that ``cuda_ms``'s spin
    kernel can hold, so that CUDA events would time the host.  A trace
    that holds no kernel is taken again once, then raises."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            total_us += dev_us if dev_us is not None else getattr(e, "self_cuda_time_total", 0.0)
        if total_us > 0:
            return total_us / 1e3 / reps
    raise RuntimeError("busy_ms: the profiler recorded no kernel of the timed calls")


def host_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean host-clock milliseconds of ``fn()`` over ``reps`` calls (CPU
    tensors: the work is done when ``fn`` returns)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def timer_for(device: torch.device):
    """``cuda_ms`` for a CUDA device, ``host_ms`` for the CPU."""
    return cuda_ms if torch.device(device).type == "cuda" else host_ms


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") for work that moves
    ``nbytes`` and does ``flops`` operations at ``rate`` per second."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
