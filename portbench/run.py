"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, driver, per-layer metric
readers and limits are found by the names in ``BENCHMARK.json``
(``portbench/lib/bench.py``).  The driver loads, warms up, measures for
``--seconds`` and checks what the timed path produced against the plain
reference; this prints each compared number beside its limit as the last
lines of standard error, and one JSON object as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``.

It exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, and if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = _args(argv)
    # fixed cache directories inside the checkout; no library may load JAX
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from portbench.lib import bench
    from portbench.lib.runctx import Context, forbidden_modules
    from portbench.lib.verdict import judge

    cell = bench.find_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark runs only on the card", 3)
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{cell.name} needs {cell.chips} cards, "
                     f"{torch.cuda.device_count()} present", 3)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=dev, t_start=T_START)
    out = bench.driver(cell.mix["driver"]).run(ctx)

    metrics = {}
    if not args.trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
    else:
        metrics = bench.per_layer_values(cell, out.rec, out.trace)
    bad = [k for k, v in metrics.items() if not math.isfinite(v["value"])]
    if bad:
        return _fail(f"no finite value for {', '.join(bad)}", 5)

    correct, checks = judge(out.checks, cell.limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": device}
    if args.trace and out.trace:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        result["breakdown"] = {"device_ops": out.trace["device_ops"],
                               "idle_gaps": out.trace["idle_gaps"]}
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        return _fail(f"loaded in this process: {', '.join(found)}", 4)
    print(f"portbench: setup_s {out.e2e['setup_s']!r} window_s {out.rec.get('window_s')!r} "
          f"check_s {out.rec.get('check_s')!r} total_s {time.time() - T_START!r}"
          + (f" launches_from {out.trace['launch_source']}" if out.trace else ""), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
