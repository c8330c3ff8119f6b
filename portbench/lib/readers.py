"""Arithmetic the per-layer metric readers share.  A reader returns
None where its run has nothing for it to read."""
from __future__ import annotations

from portbench.counts import work
from portbench.lib.trace import kernel_seconds


def phase_s_per_layer(rec: dict, *phases: str):
    """Seconds a layer of the program's named phases (the synchronizing
    phase timers of a traced quantize run)."""
    ph = rec.get("phase_s")
    if not ph or not any(p in ph for p in phases):
        return None
    return sum(ph.get(p, 0.0) for p in phases) / (rec["layers_per_sweep"] * rec["sweeps"])


def idle_share(rec: dict):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def serve_mfu(rec: dict):
    """The model operations of the traced window's tokens at the bf16
    peak, over that window."""
    t = rec.get("traced")
    if not t or t["window_s"] <= 0 or not t["requests"]:
        return None
    need = work.least_s(flops=work.window_flops(rec["dims"], t["requests"]))
    return 100.0 * need / t["window_s"]


def span_value(rec: dict, name: str, key: str):
    tr = rec.get("trace")
    if not tr or name not in tr["spans"]:
        return None
    return tr["spans"][name][key]


def kernel_time(rec: dict, *words: str, exclude: tuple = ()):
    tr = rec.get("trace")
    if not tr:
        return None
    s = kernel_seconds(tr, *words, exclude=exclude)
    return s if s > 0 else None
