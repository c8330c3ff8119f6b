"""The split of a serve cell's traced window by the program's own spans.

    python3 portbench/engine_split.py --workload qwen3-8b.serve-decode --seed <n> [--seconds 51]

Runs the cell once as ``run.py --trace 1`` does and prints its result line,
then one JSON line: the window's ``program`` and ``idle_by_program``
(``lib/program.py``, in every traced summary), the engine's ``chunks`` and
``spec_chunks`` counters' rise over the traced window, the engine metrics
read from them (``program.engine_metrics``), the run's end-to-end metrics,
and ``split_gap``: how far the idle parts' sum lies from ``window_s -
busy_s``, as a share of it.  The benchmark's runs never run it: the
counters reach the benchmark's result line only once
``drivers/serve-closed.py`` takes them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import types
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COUNTERS = ("chunks", "spec_chunks")


@contextlib.contextmanager
def patched(seen: dict):
    """While open, a cell's run (``run.main``, or ``run`` of a ``drivers/`` module) leaves
    in ``seen`` its ``Outcome`` (``"out"``) and the engine's counters where
    the trace started and stopped (``"c0"``, ``"c1"``; None where the engine
    has none)."""
    from portbench.lib import bench, serving, trace

    real_build = serving.build_engine
    real_start, real_stop = trace.DeviceTrace.start, trace.DeviceTrace.stop
    real_driver = bench.driver

    def counters():
        eng = seen["engine"]()
        return {k: getattr(eng, k, None) for k in COUNTERS} if eng is not None else {}

    def build_engine(ctx, slots):
        eng, d = real_build(ctx, slots)
        seen["engine"] = weakref.ref(eng)   # serve-closed frees it before its check
        return eng, d

    def start(self):
        real_start(self)
        if self.enabled:
            seen["c0"] = counters()

    def stop(self):
        if self.enabled and self.prof is not None and not self.t1:
            seen["c1"] = counters()
        real_stop(self)

    def driver(kind):
        mod = real_driver(kind)

        def run(ctx):
            seen["out"] = mod.run(ctx)
            return seen["out"]
        return types.SimpleNamespace(run=run)

    serving.build_engine, bench.driver = build_engine, driver
    trace.DeviceTrace.start, trace.DeviceTrace.stop = start, stop
    try:
        yield seen
    finally:
        serving.build_engine = real_build
        bench.driver = real_driver
        trace.DeviceTrace.start, trace.DeviceTrace.stop = real_start, real_stop


def report(seen: dict) -> dict:
    """What ``patched`` saw, reduced to the engine's readings."""
    from portbench.lib import program

    out = seen["out"]
    tr = out.trace
    c0, c1 = seen.get("c0", {}), seen.get("c1", {})
    rise = {k: (c1[k] - c0[k]) if c0.get(k) is not None and c1.get(k) is not None else None
            for k in COUNTERS}
    steps = out.rec.get("traced_decode_steps", 0)
    idle = tr["window_s"] - tr["busy_s"]
    parts = sum(tr["idle_by_program"].values())
    return {"e2e": out.e2e, "busy_s": tr["busy_s"], "window_s": tr["window_s"],
            "traced_decode_steps": steps, "traced_chunks": rise["chunks"],
            "traced_spec_chunks": rise["spec_chunks"],
            "metrics": program.engine_metrics(tr["program"], tr["idle_by_program"], steps,
                                              rise["chunks"], rise["spec_chunks"]),
            "split_gap": abs(parts - idle) / idle if idle > 0 else 0.0,
            "outside_share": tr["idle_by_program"].get(program.OUTSIDE, 0.0) / idle
            if idle > 0 else 0.0,
            "program": tr["program"], "idle_by_program": tr["idle_by_program"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run

    with patched({}) as seen:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or "out" not in seen or not seen["out"].trace:
        return rc or 1
    import torch
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "card": torch.cuda.get_device_name(0), **report(seen)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
