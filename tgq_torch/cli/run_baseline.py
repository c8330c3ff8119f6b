"""``python -m tgq_torch.cli.run_baseline`` — the minimal two-run harness
(mirrors ``tgq/cli/run_baseline.py``, the reference's run_baseline.py):
the FP baseline PPL and GPTQ W4 with ActOrder, through the port's
quantize CLI."""
from __future__ import annotations

import argparse
import json
import os

from tgq_torch.cli.run_benchmark import add_common, base_argv, run_experiment


def run(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_common(ap, batch_size=8, out="baseline_results")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    base = base_argv(args)
    return [
        run_experiment({"name": "FP_Baseline", "mode": "baseline"}, base, args.out),
        run_experiment({"name": "GPTQ_4bit", "mode": "gptq", "w_bits": 4, "actorder": True},
                       base, args.out),
    ]


def main(argv=None) -> int:
    print(json.dumps(run(argv), indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
