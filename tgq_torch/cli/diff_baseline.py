"""``python -m tgq_torch.cli.diff_baseline`` — diff a run_benchmark
``final_benchmark.csv`` against the reference's published Qwen3-8B table
(BASELINE.md; the counterpart of ``scripts/diff_baseline.py``).

Tolerance: |ppl - ref| <= max(--abs_tol, --rel_tol · ref) per row.
Differences to expect inside it: bf16 weight storage against the
reference's fp16, the attention kernel's accumulation order (K6 on the
card), and calibration sampling with the same seed schedule but another
bit stream.  The method orderings (TruncGPTQ <= GPTQ at every matched
configuration, the reference's headline result) are checked unless
``--skip_ordering_check``.

Exit 0 when every present row passes, 1 on any mismatch.
"""
from __future__ import annotations

import argparse
import csv
import sys

# BASELINE.md rows (reference README.md:26-41 / final_benchmark.csv)
REFERENCE_PPL = {
    "FP16_Baseline": 8.5723,
    "GPTQ_W4_Asym": 8.7149,
    "GPTQ_W3_Asym": 9.5937,
    "GPTQ_W2_Asym": 24.8833,
    "GPTQ_W4_Sym": 8.8922,
    "GPTQ_W3_Sym": 10.2579,
    "Trunc_W4_Asym": 8.6452,
    "Trunc_W3_Asym": 9.2056,
    "Trunc_W2_Asym": 21.6318,
    "Trunc_W4_Sym": 8.6613,
    "Trunc_W3_Sym": 9.8558,
}

ORDERINGS = [  # (must be <=, than)
    ("Trunc_W4_Asym", "GPTQ_W4_Asym"),
    ("Trunc_W3_Asym", "GPTQ_W3_Asym"),
    ("Trunc_W2_Asym", "GPTQ_W2_Asym"),
    ("Trunc_W4_Sym", "GPTQ_W4_Sym"),
    ("Trunc_W3_Sym", "GPTQ_W3_Sym"),
]
ORDERING_SLACK = 0.02  # ties within noise do not invalidate the claim


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("csv_path")
    ap.add_argument("--abs_tol", type=float, default=0.15, help="absolute PPL tolerance per row")
    ap.add_argument("--rel_tol", type=float, default=0.02,
                    help="relative tolerance (W2 rows have PPL ~22-25)")
    ap.add_argument("--skip_reference_check", action="store_true",
                    help="skip per-row reference-PPL comparison")
    ap.add_argument("--skip_ordering_check", action="store_true",
                    help="skip the Trunc<=GPTQ orderings (random tiny models: method "
                         "differences are noise)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    with open(args.csv_path, newline="") as f:
        rows = {r["name"]: r for r in csv.DictReader(f)}
    ok = True
    got = {}
    for name, r in rows.items():
        if r["status"] != "OK" or not r["ppl"]:
            print(f"FAIL {name}: status={r['status']}")
            ok = False
            continue
        got[name] = float(r["ppl"])

    if not args.skip_reference_check:
        for name, ref in REFERENCE_PPL.items():
            if name not in got:
                print(f"SKIP {name}: not in run")
                continue
            tol = max(args.abs_tol, args.rel_tol * ref)
            delta = got[name] - ref
            good = abs(delta) <= tol
            print(f"{'ok' if good else 'FAIL':4s} {name:16s} ppl={got[name]:8.4f} "
                  f"ref={ref:8.4f} delta={delta:+7.4f} (tol {tol:.3f})")
            ok = ok and good

    for a, b in ([] if args.skip_ordering_check else ORDERINGS):
        if a in got and b in got:
            good = got[a] <= got[b] + ORDERING_SLACK
            print(f"{'ok' if good else 'FAIL':4s} ordering {a} <= {b}: "
                  f"{got[a]:.4f} vs {got[b]:.4f}")
            ok = ok and good

    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
