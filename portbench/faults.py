"""Readings of planted faults: a cell's run, check included, with the
program's timed path broken underneath, one fault at a time.

    python3 portbench/faults.py --workload <cell> --fault <name> --seeds <n>[,<n>...]

(``--seconds``, default 1, is the window: one sweep.)

The faults of the quantize cells, each planted in the program:

- ``half_batch``: every other calibration batch left out of the Grams
  (``solver.hessian``);
- ``rank``: the factorization handed ten times the configured eps, so
  the energy rule keeps too few pivots (the rank, ``solver.pchol``);
- ``rank_guard``: the numerical-rank guard at ten times its pivot
  ratio, so the rank stops at pivots the sweep resolves (the rank where
  the guard, not eps, decides it);
- ``stale_diagonal``: K1 handed the Hessian's own diagonal at every
  panel after the first, in place of the Schur diagonal the previous
  panel left, so it walks the wrong pivots and builds wrong Cholesky
  rows (the pivot order and the factor, K1);
- ``tf32_factor``: the factorization (K1's Schur updates and the factor
  build) with TF32 products, one precision below its exact f32.

Prints one JSON line a seed with the compared numbers and the verdict
under the cell's limits.  The benchmark's runs never run it; the CPU
tests plant the same faults at tiny sizes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def _patched(obj, name: str, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield real
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def half_batch():
    from tgq_torch.solver import hessian
    acc = hessian.HessianAccumulator
    real_u, real_t = acc.update, acc.update_t
    seen = {"n": 0}

    def update(self, x):
        seen["n"] += 1
        return self if seen["n"] % 2 else real_u(self, x)

    def update_t(self, xt):
        seen["n"] += 1
        return self if seen["n"] % 2 else real_t(self, xt)
    with _patched(acc, "update", update), _patched(acc, "update_t", update_t):
        yield


@contextlib.contextmanager
def rank():
    from tgq_torch.calib import pipeline
    real = pipeline._factorize
    with _patched(pipeline, "_factorize", lambda h, qcfg, eps: real(h, qcfg, eps * 10.0)):
        yield


@contextlib.contextmanager
def rank_guard():
    from tgq_torch.solver import pchol
    real = pchol._rank_f64
    with _patched(pchol, "_rank_f64",
                  lambda dhist, pivhist, eps, rtol: real(dhist, pivhist, eps, rtol * 10.0)):
        yield


@contextlib.contextmanager
def stale_diagonal():
    import torch

    from tgq_torch.solver import pchol
    real = pchol.pchol_panel
    first = {}

    def panel(a, d, done, panel=128, steps=None):
        if not bool(done.any()):
            first["d"] = d.clone()
        else:
            d = torch.where(done > 0, 0.0, first["d"]).contiguous()
        return real(a, d, done, panel=panel, steps=steps)
    with _patched(pchol, "pchol_panel", panel):
        yield


@contextlib.contextmanager
def tf32_factor():
    import torch

    from tgq_torch.calib import pipeline
    real = pipeline._factorize

    def factorize(h, qcfg, eps):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return real(h, qcfg, eps)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    with _patched(pipeline, "_factorize", factorize):
        yield


FAULTS = {"half_batch": half_batch, "rank": rank, "rank_guard": rank_guard,
          "stale_diagonal": stale_diagonal, "tf32_factor": tf32_factor}


def read(cell, fault: str, seed: int, seconds: float, device) -> dict:
    """The compared numbers of one run of ``cell`` with ``fault`` planted."""
    from portbench.lib import bench
    from portbench.lib.runctx import Context
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=False, device=device,
                  t_start=time.time())
    with FAULTS[fault]():
        return bench.driver(cell.mix["driver"]).run(ctx).checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.lib import bench
    from portbench.lib.verdict import judge
    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 3
    cell = bench.find_cell(args.workload, ROOT)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        nums = read(cell, args.fault, seed, args.seconds, dev)
        ok, table = judge(nums, cell.limits)
        print(json.dumps({"workload": cell.name, "fault": args.fault, "seed": seed,
                          "correct": ok, "checks": table, "seconds": time.time() - t}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
