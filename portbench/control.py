"""The control of a cell's check: the comparison fed by a computation one
precision below the configuration's, which has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n>[,<n>...] [--seconds <s>]

- quantize cells: the plain reference's own sweep in f32 with TF32
  products (``reference.check_quantize.control_captures``) takes the
  program's place, at the cell's sizes;
- serve cells: the program's own lower-precision path, its W4A8 matmuls
  (int8 activations, K4), serves the cell's traffic for ``--seconds``.

Prints one JSON line a seed with the compared numbers and the verdict
under the cell's limits.  The benchmark's runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def quantize_control(cell, seed: int, device) -> dict:
    import torch

    from portbench.lib import bench, traffic
    from portbench.reference.check_quantize import check_sweep, control_captures
    drv = bench.driver(cell.mix["driver"])
    mix, conf = cell.mix, cell.config
    fam = bench.family(conf["family"])
    d = fam.dims(conf)
    n_layers = int(conf["layers_per_sweep"])
    sample, solver_layers = drv.check_plan(mix, seed, n_layers)
    ids = traffic.synthetic_calibration(d.vocab, mix["n_samples"], mix["seq_len"], seed,
                                        mix["phrases"], mix["phrase_len"])

    def make_layer(li):
        return fam.make_layer(d, seed, li, torch.bfloat16, device)

    outer = fam.make_outer(d, seed, torch.bfloat16, device)
    caps = control_captures(d, make_layer, outer, ids, drv.settings(mix), n_layers, sample,
                            device)
    nums = check_sweep(d, make_layer, outer, ids, drv.settings(mix), caps, solver_layers,
                       sample, device)
    return dict(nums, sweeps_differ=0.0)


def serve_control(cell, seed: int, seconds: float, device) -> dict:
    from portbench.lib import bench
    from portbench.lib.runctx import Context
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=False, device=device,
                  t_start=time.time(), control={"a_bits": 8})
    return bench.driver(cell.mix["driver"]).run(ctx).checks


def control(cell, seed: int, seconds: float, device) -> dict:
    if cell.mix["driver"] == "quantize-sweep":
        return quantize_control(cell, seed, device)
    return serve_control(cell, seed, seconds, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
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
        nums = control(cell, seed, args.seconds, dev)
        ok, table = judge(nums, cell.limits)
        print(json.dumps({"workload": cell.name, "seed": seed, "correct": ok, "checks": table,
                          "seconds": time.time() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
