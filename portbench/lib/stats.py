"""The metric arithmetic: percentiles over every request (a missing one
counts above every finished one), rates over a window, and the spread
the bounds are set from."""
from __future__ import annotations

import math
import statistics


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks; ``math.inf`` entries sort last, and a percentile that
    lands on one is ``math.inf``."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(v[hi]):
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def ttft_p95(due: list[float], first: list[float | None]) -> float:
    """95th percentile over every request of (first token - due time); a
    request with no first token (None) is missing."""
    lat = [math.inf if f is None else f - d for d, f in zip(due, first)]
    return percentile(lat, 95.0)


def tpot(first: float, finish: float, n_out: int) -> float | None:
    """Seconds per output token after the first; None for one token."""
    if n_out < 2:
        return None
    return (finish - first) / (n_out - 1)


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return count / seconds


def s_per_layer(sweep_walls: list[float], layers_per_sweep: int) -> float:
    """Seconds a layer over whole sweeps: their summed walls over every
    layer they quantized."""
    if not sweep_walls:
        raise ValueError("no sweep in the window")
    return sum(sweep_walls) / (layers_per_sweep * len(sweep_walls))


def spread(values: list[float]) -> float:
    """(third quartile - first quartile) / median, by
    ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
