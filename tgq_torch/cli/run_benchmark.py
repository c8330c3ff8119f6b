"""``python -m tgq_torch.cli.run_benchmark`` — the published-table runner
(mirrors ``tgq/cli/run_benchmark.py``, the reference's run_benchmark.py).

Runs the reference's 11 experiments through the port's quantize CLI: the
FP baseline; GPTQ W4/3/2 asym and W4/3 sym; TruncGPTQ W4/3/2 asym (each
with the published table's ε) and W4/3 sym.  Writes results_partial.csv
after every row and final_benchmark.csv, with the reference's row schema.
In one process; each experiment runs under its own results directory on
a fresh model.  ``--solver pchol`` puts the TruncGPTQ rows on the
pivoted-Cholesky fast path (K1 and K2 on CUDA).  A failed experiment is
logged and recorded as ``status: "Failed: ..."``, and the sweep goes on.
"""
from __future__ import annotations

import argparse
import csv
import json
import logging
import os
import time

FIELDS = ["name", "status", "ppl", "time_s"]


def experiment_list(trunc_mode: str) -> list[dict]:
    exps: list[dict] = [{"name": "FP16_Baseline", "mode": "baseline"}]
    for bits, sym in ((4, False), (3, False), (2, False), (4, True), (3, True)):
        exps.append({
            "name": f"GPTQ_W{bits}_{'Sym' if sym else 'Asym'}",
            "mode": "gptq", "w_bits": bits, "sym": sym, "actorder": True,
        })
    # per-bit eps from the published table (reference run_benchmark.py:51-77)
    trunc_eps = {(4, False): 1e-6, (3, False): 1e-4, (2, False): 1e-5,
                 (4, True): 1e-4, (3, True): 1e-4}
    for (bits, sym), eps in trunc_eps.items():
        exps.append({
            "name": f"Trunc_W{bits}_{'Sym' if sym else 'Asym'}",
            "mode": trunc_mode, "w_bits": bits, "sym": sym, "eps": eps,
            "threshold_method": "energy",
        })
    return exps


def experiment_argv(exp: dict, base_args: list[str], out_root: str) -> list:
    """The full quantize-CLI argv for one experiment row."""
    save = os.path.join(out_root, exp["name"])
    argv = list(base_args) + ["--save_path", save, "--mode", exp["mode"]]
    for flag in ("w_bits", "eps", "threshold_method"):
        if flag in exp:
            argv += [f"--{flag}", str(exp[flag])]
    if exp.get("sym"):
        argv.append("--sym")
    if exp.get("actorder"):
        argv.append("--actorder")
    return argv


def run_experiment(exp: dict, base_args: list[str], out_root: str) -> dict:
    """One row through ``tgq_torch.cli.quantize.main``; a failure is caught
    and recorded in ``status`` so that the sweep goes on."""
    from tgq_torch.cli.quantize import main as quantize_main

    save = os.path.join(out_root, exp["name"])
    argv = experiment_argv(exp, base_args, out_root)
    t0 = time.time()
    row = {"name": exp["name"], "status": "OK", "ppl": None, "time_s": None, "config": exp}
    try:
        quantize_main(argv)
        with open(os.path.join(save, "results.json")) as f:
            res = json.load(f)
        m = res.get("metrics", {})
        row["ppl"] = m.get("quantized_ppl", m.get("baseline_ppl"))
        row["time_s"] = round(m.get("total_time", time.time() - t0), 1)
    except Exception as e:  # a failed experiment must not stop the sweep
        logging.exception("experiment %s failed", exp["name"])
        row["status"] = f"Failed: {e}"
    return row


def base_argv(args) -> list[str]:
    """The flags every experiment of a runner shares."""
    return ["--model_id", args.model_id, "--dataset", args.dataset,
            "--n_samples", str(args.n_samples), "--seq_len", str(args.seq_len),
            "--batch_size", str(args.batch_size), "--group_size", str(args.group_size),
            "--attn_impl", args.attn_impl, "--device", args.device, "--no_save"]


def write_csv(path: str, rows: list[dict]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS, extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)


def add_common(ap: argparse.ArgumentParser, batch_size: int, out: str) -> None:
    ap.add_argument("--model_id", default="qwen3-8b")
    ap.add_argument("--dataset", default="wikitext2")
    ap.add_argument("--n_samples", type=int, default=128)
    ap.add_argument("--seq_len", type=int, default=2048)
    ap.add_argument("--batch_size", type=int, default=batch_size)
    ap.add_argument("--group_size", type=int, default=128)
    ap.add_argument("--out", default=out)
    ap.add_argument("--attn_impl", default="auto")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])


def run(argv=None) -> list[dict]:
    """The table's rows (also written as CSV under ``--out``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # the reference's published experiments run calibration batch 32
    # (reference run_benchmark.py:37,48,62,76)
    add_common(ap, batch_size=32, out="benchmark_results")
    ap.add_argument("--solver", default="eigh", choices=["eigh", "pchol"],
                    help="solver for the TruncGPTQ rows")
    ap.add_argument("--only", default=None, help="comma-list of experiment names")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    exps = experiment_list(args.solver)
    if args.only:
        keep = set(args.only.split(","))
        exps = [e for e in exps if e["name"] in keep]
    rows = []
    for exp in exps:
        rows.append(run_experiment(exp, base_argv(args), args.out))
        write_csv(os.path.join(args.out, "results_partial.csv"), rows)
    write_csv(os.path.join(args.out, "final_benchmark.csv"), rows)
    return rows


def main(argv=None) -> int:
    print(json.dumps(run(argv), indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
