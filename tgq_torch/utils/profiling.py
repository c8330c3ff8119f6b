"""Phase timers and the device trace (mirrors ``tgq/utils/profiling.py``)."""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

import torch

logger = logging.getLogger(__name__)


class PhaseTimers:
    """Accumulating named wall-clock timers.

    ``sync=True`` drains the CUDA stream before closing each phase, so
    each phase is charged its own device work (asynchronous launches
    otherwise charge everything to whichever phase synchronizes first)
    — at the cost of serializing host and device."""

    def __init__(self, sync: bool = False):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            dt = time.time() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_s": round(v / max(self.counts[k], 1), 4)}
            for k, v in sorted(self.totals.items())
        }

    def log_summary(self) -> None:
        for k, v in self.summary().items():
            logger.info("[timing] %-24s total %8.2fs  n=%4d  mean %7.3fs",
                        k, v["total_s"], v["count"], v["mean_s"])


TRACE_NAME = "trace.json"


@contextlib.contextmanager
def device_trace(trace_dir: str | None, cuda: bool = True):
    """``torch.profiler`` trace of the enclosed region, written on exit as
    a Chrome trace to ``<trace_dir>/trace.json`` (nothing when
    ``trace_dir`` is None).  ``cuda`` adds the CUDA activity (kernel
    launches and device time); a region run on the CPU traces the CPU."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(trace_dir, TRACE_NAME)
    prof.export_chrome_trace(path)
    logger.info("[profile] device trace written to %s", path)
