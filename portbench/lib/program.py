"""The program's own spans in a traced window, and the engine metrics read
from them.

The port opens ``tgq.*`` spans (``tgq_torch.utils.profiling.span``) in the
same ``torch.profiler`` trace as the device's kernels, on the same clock.
``reduce_program`` reduces a window's Chrome events to:

- ``program``: for each ``tgq.`` span name, its host self-seconds (the
  time it was the innermost ``tgq.`` span open: its length less its
  ``tgq.`` children's) and how many times it was opened;
- ``idle_by_program``: the window's idle device time (no kernel, copy or
  set running) split exactly among the innermost ``tgq.`` span open at
  each instant, by a sweep over the spans' edges; idle time with no such
  span open is ``"outside"``.  The parts sum to ``window_s - busy_s`` of
  ``trace.reduce_events`` on the same events.

The window and the device's busy intervals are taken as
``trace.reduce_events`` takes them; it returns both keys beside its own,
so a reader finds them under ``rec["trace"]``.
"""
from __future__ import annotations

from portbench.lib.trace import DEVICE_CATS, WINDOW, _merge

PREFIX = "tgq."
OUTSIDE = "outside"
DISPATCH = "tgq.engine.decode_dispatch"
ENGINE = "tgq.engine."


def _window(xs: list[dict]) -> tuple[float, float]:
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if win:
        return win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    return min(e["ts"] for e in xs), max(e["ts"] + e.get("dur", 0) for e in xs)


def _innermost(spans: list[dict], w0: float, w1: float) -> list[tuple[float, float, str]]:
    """``[w0, w1]`` cut into (start, end, name) pieces, each named by the
    innermost span open through it (``OUTSIDE`` where none is)."""
    pieces: list[tuple[float, float, str]] = []
    stack: list[tuple[float, str]] = []      # (end, name), innermost last
    cur = w0

    def close_until(t: float) -> None:
        nonlocal cur
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > cur:
                pieces.append((cur, end, name))
                cur = end

    for e in sorted(spans, key=lambda e: (e["ts"], -e.get("dur", 0))):
        a, b = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)
        if b <= a:
            continue
        close_until(a)
        if a > cur:
            pieces.append((cur, a, stack[-1][1] if stack else OUTSIDE))
            cur = a
        # a child ends inside its parent (the same thread's spans nest)
        stack.append((min(b, stack[-1][0]) if stack else b, e["name"]))
    close_until(w1)
    if w1 > cur:
        pieces.append((cur, w1, OUTSIDE))
    return pieces


def reduce_program(events: list[dict]) -> dict:
    """``program`` and ``idle_by_program`` of a traced window's Chrome
    events (seconds)."""
    xs = [e for e in events if e.get("ph") == "X"]
    w0, w1 = _window(xs)
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)) for e in xs
                   if e.get("cat") in DEVICE_CATS
                   and e["ts"] + e.get("dur", 0) > w0 and e["ts"] < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    spans = [e for e in xs if e.get("cat") == "user_annotation"
             and e["name"].startswith(PREFIX)]
    pieces = _innermost(spans, w0, w1)

    program: dict[str, dict] = {}
    for e in spans:
        if e["ts"] + e.get("dur", 0) > w0 and e["ts"] < w1:
            program.setdefault(e["name"], {"self_s": 0.0, "count": 0})["count"] += 1
    idle_by: dict[str, float] = {}
    i = 0
    for a, b, name in pieces:
        if name != OUTSIDE:
            program[name]["self_s"] += (b - a) * 1e-6
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            ov = min(b, idle[j][1]) - max(a, idle[j][0])
            if ov > 0:
                idle_by[name] = idle_by.get(name, 0.0) + ov * 1e-6
            j += 1
    return {"program": program, "idle_by_program": idle_by}


def engine_metrics(program: dict, idle_by: dict, steps: int, chunks: int | None,
                   spec_chunks: int | None) -> dict:
    """The engine's per-step readings of a traced serve window: ``steps``
    decode steps dispatched in it, ``chunks`` / ``spec_chunks`` the
    engine's counters' rise over it (None where the program has none).
    A reading with nothing to read is left out."""
    out = {}
    if steps and DISPATCH in program:
        out["engine.dispatch_ms_per_step"] = 1e3 * program[DISPATCH]["self_s"] / steps
        out["engine.dispatch_idle_ms_per_step"] = 1e3 * idle_by.get(DISPATCH, 0.0) / steps
        out["engine.host_idle_ms_per_step"] = 1e3 * sum(
            v for k, v in idle_by.items() if k.startswith(ENGINE) and k != DISPATCH) / steps
    if chunks:
        out["engine.overlap_share"] = 100.0 * spec_chunks / chunks
        if steps:
            out["engine.steps_per_chunk"] = steps / chunks
    return out
