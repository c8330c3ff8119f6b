"""``python -m tgq_torch.cli.extract_log`` — post-hoc log miner (mirrors
``tgq/cli/extract_log.py``, the reference's extract_log.py): scans run
directories for ``quantization.log`` files, takes the per-module relative
prediction errors that the pipeline logs (``tgq_torch.calib.pipeline``
writes the JAX package's line format), and aggregates the mean and max
per module type per run into ``multi_run_summary.csv``."""
from __future__ import annotations

import argparse
import collections
import csv
import os
import re

# pipeline log line:  "   mlp.down_proj  | rank  123 | rel_err 0.0414 | 1.23s"
LINE_RE = re.compile(
    r"\s+(?P<name>[\w.]+)\s+\|\s+rank\s+(?P<rank>\S+)\s+\|\s+rel_err\s+"
    r"(?P<err>[\d.naif]+)\s+\|"
)
FIELDS = ["run", "module", "n", "mean_rel_err", "max_rel_err"]


def mine_log(path: str) -> dict[str, list[float]]:
    per_type: dict[str, list[float]] = collections.defaultdict(list)
    with open(path) as f:
        for line in f:
            m = LINE_RE.search(line)
            if not m:
                continue
            try:
                err = float(m.group("err"))
            except ValueError:
                continue
            if err == err:  # not nan
                per_type[m.group("name").split(".")[-1]].append(err)
    return per_type


def summarize(roots) -> list[dict]:
    """One row per (run directory, module type) under ``roots``."""
    rows = []
    for root in roots:
        for dirpath, _, files in sorted(os.walk(root)):
            if "quantization.log" not in files:
                continue
            per_type = mine_log(os.path.join(dirpath, "quantization.log"))
            for mod, errs in sorted(per_type.items()):
                rows.append({"run": os.path.relpath(dirpath), "module": mod, "n": len(errs),
                             "mean_rel_err": sum(errs) / len(errs),
                             "max_rel_err": max(errs)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+", help="run directories to scan")
    ap.add_argument("--out", default="multi_run_summary.csv")
    args = ap.parse_args(argv)
    rows = summarize(args.roots)
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
