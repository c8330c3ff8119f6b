"""``python -m tgq_torch.cli.run_experiments`` — the ε grid sweep (mirrors
``tgq/cli/run_experiments.py``, the reference's run_experiments.py): a log
grid of truncation thresholds × bit widths through the port's quantize
CLI; writes ``<out>/final_results.csv`` after every row.  ``--bits``
keeps only the bit widths listed (all five configurations by default)."""
from __future__ import annotations

import argparse
import json
import os

from tgq_torch.cli.run_benchmark import add_common, base_argv, run_experiment, write_csv

BIT_CONFIGS = [(4, True), (3, True), (4, False), (3, False), (2, False)]


def run(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common(ap, batch_size=32, out="tuning_results")
    ap.add_argument("--solver", default="eigh", choices=["eigh", "pchol"])
    ap.add_argument("--eps_grid", default="1e-7,1e-6,1e-5,1e-4,1e-3,1e-2")
    ap.add_argument("--bits", default="4,3,2", help="bit widths to keep")
    args = ap.parse_args(argv)
    eps_values = [float(e) for e in args.eps_grid.split(",")]
    keep = {int(b) for b in args.bits.split(",")}
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for bits, sym in (c for c in BIT_CONFIGS if c[0] in keep):
        for eps in eps_values:
            exp = {"name": f"W{bits}_{'Sym' if sym else 'Asym'}_eps{eps:g}",
                   "mode": args.solver, "w_bits": bits, "sym": sym, "eps": eps,
                   "threshold_method": "energy"}
            rows.append(run_experiment(exp, base_argv(args), args.out))
            write_csv(os.path.join(args.out, "final_results.csv"), rows)
    return rows


def main(argv=None) -> int:
    print(json.dumps(run(argv), indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
