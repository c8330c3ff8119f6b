"""The device trace of a traced window and its reduction.

``torch.profiler`` (CUPTI) records the window with CPU and CUDA
activity; the Chrome trace it exports (under ``TMPDIR``, deleted once
read) is reduced to:

- ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the window; ``window_s``: the window's length;
- ``kernels``: device seconds by kernel name;
The profiler stops at the traced window's end; its trace is exported and
reduced by ``finish`` once the measured window has closed.

- ``spans``: for each span the harness opened (``span``), the device
  seconds and count of the kernels it launched and the launch calls made
  inside it.  A kernel is tied to its span through the correlation id of
  the runtime or driver call that launched it; where no such call was
  recorded, through the device-side range of the span, and its launch is
  counted from the kernel event (``launch_source`` says which);
- ``device_ops`` and ``idle_gaps``: the ten device operations that took
  most time, and the idle time grouped by the host operation running in
  the middle of each gap;
- ``program`` and ``idle_by_program``: the program's own ``tgq.*`` spans
  (``lib/program.py``), so that a reader of a new span needs no other
  file.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

import torch

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_WORDS = ("LaunchKernel", "LaunchCooperativeKernel", "GraphLaunch")


def span(name: str, on: bool):
    """A named span of the harness around a call into the program (a no-op
    unless tracing)."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)


class DeviceTrace:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.summary: dict | None = None
        self._window = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self.t0 = time.perf_counter()

    @property
    def started(self) -> bool:
        return self.prof is not None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.summary is None and self.t1 == 0.0

    def stop(self) -> None:
        if not self.enabled or self.t1 or self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._window.__exit__(None, None, None)
        self.prof.stop()

    def finish(self) -> None:
        """Stop if still recording, then export and reduce the trace."""
        self.stop()
        if not self.enabled or self.summary is not None or self.prof is None:
            return
        fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        self.summary = reduce_events(events, self.t1 - self.t0)


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _host_op_at(t: float, starts: list[float], ops: list[dict]) -> str:
    """The innermost host operation running at ``t`` (trace microseconds)."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 400), -1):
        e = ops[j]
        if e["ts"] <= t <= e["ts"] + e.get("dur", 0):
            if best is None or e.get("dur", 0) < best.get("dur", 0):
                best = e
    return best["name"] if best is not None else "host: no operation"


def reduce_events(events: list[dict], wall_s: float) -> dict:
    from portbench.lib.program import reduce_program   # it reads this module's names
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if win:
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    else:
        w0 = min(e["ts"] for e in xs)
        w1 = max(e["ts"] + e.get("dur", 0) for e in xs)
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    kernels: dict[str, float] = {}
    for e in dev:
        kernels[e["name"]] = kernels.get(e["name"], 0.0) + e.get("dur", 0) * 1e-6
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)) for e in dev
                   if e["ts"] + e.get("dur", 0) > w0 and e["ts"] < w1])
    busy_s = sum(e - s for s, e in busy) * 1e-6

    # spans of the harness and the launch calls inside them
    spans = sorted((e for e in xs if e.get("cat") == "user_annotation"
                    and e["name"].startswith(SPAN_PREFIX) and e["name"] != WINDOW),
                   key=lambda e: e["ts"])
    span_starts = [e["ts"] for e in spans]

    def span_of(t: float):
        i = bisect.bisect_right(span_starts, t) - 1
        if i >= 0 and t <= spans[i]["ts"] + spans[i]["dur"]:
            return spans[i]["name"][len(SPAN_PREFIX):]
        return None

    gpu_ranges = sorted((e for e in xs if e.get("cat") == "gpu_user_annotation"
                         and e["name"].startswith(SPAN_PREFIX) and e["name"] != WINDOW),
                        key=lambda e: e["ts"])
    gpu_starts = [e["ts"] for e in gpu_ranges]

    def gpu_span_of(t: float):
        i = bisect.bisect_right(gpu_starts, t) - 1
        if i >= 0 and t <= gpu_ranges[i]["ts"] + gpu_ranges[i]["dur"]:
            return gpu_ranges[i]["name"][len(SPAN_PREFIX):]
        return None

    launches = {}
    out_spans: dict[str, dict] = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and any(
                w in e["name"] for w in LAUNCH_WORDS):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e["ts"]
            s = span_of(e["ts"])
            if s is not None:
                out_spans.setdefault(s, {"device_s": 0.0, "kernels": 0, "launches": 0})
                out_spans[s]["launches"] += 1
    unmatched = 0
    for e in dev:
        if e.get("cat") != "kernel":
            continue
        corr = e.get("args", {}).get("correlation")
        if corr in launches:
            s = span_of(launches[corr])
        else:
            unmatched += 1
            s = gpu_span_of(e["ts"])
            if s is not None:
                out_spans.setdefault(s, {"device_s": 0.0, "kernels": 0, "launches": 0})
                out_spans[s]["launches"] += 1
        if s is not None:
            out_spans.setdefault(s, {"device_s": 0.0, "kernels": 0, "launches": 0})
            out_spans[s]["device_s"] += e.get("dur", 0) * 1e-6
            out_spans[s]["kernels"] += 1
    n_kernels = sum(1 for e in dev if e.get("cat") == "kernel")

    # idle gaps inside the window, by the host operation in their middle
    ops = sorted((e for e in xs if e.get("cat") in ("cpu_op", "user_annotation")
                  and e["name"] != WINDOW), key=lambda e: e["ts"])
    op_starts = [e["ts"] for e in ops]
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            name = _host_op_at((s + e) / 2, op_starts, ops)
            gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6

    def top(d: dict) -> list:
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6 if win else wall_s,
            "kernels": kernels, "spans": out_spans, "n_kernels": n_kernels,
            "launch_source": "api" if unmatched == 0 else
            f"kernel events for {unmatched} of {n_kernels} kernels",
            "device_ops": top(kernels), "idle_gaps": top(gaps), **reduce_program(events)}


def kernel_seconds(summary: dict, *words: str, exclude: tuple = ()) -> float:
    """Device seconds of the kernels whose name holds every one of
    ``words`` and none of ``exclude``."""
    return sum(s for n, s in summary["kernels"].items()
               if all(w in n for w in words) and not any(x in n for x in exclude))
