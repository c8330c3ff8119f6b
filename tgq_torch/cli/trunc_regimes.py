"""``python -m tgq_torch.cli.trunc_regimes`` — where does TruncGPTQ beat
damped-Cholesky GPTQ?  (mirrors ``tgq/cli/trunc_regimes.py``.)

The factor is built from an estimated Hessian ``H_est = XᵀX/N`` of N
sampled activations, and quality is scored against the true second
moment ``H_true = C·Cᵀ`` (calibration set → deployment): GPTQ's
compensation is in-sample optimal, so any advantage of truncation comes
from not compensating into the noise directions of a rank-deficient
estimate.  GPTQ stays at the reference's fixed ``damp_percent``; the
truncated solve sweeps ε over the reference's grid and reports the best
(its published protocol).  Spectra: "log" (cond 10^decades, random
eigenbasis), "outlier" (n/64 dominating directions) and "channel"
(axis-aligned outlier channels over an AR(1) correlation).

Metric (an exact expectation): err = ‖(W − W_q)·C‖_F / ‖W·C‖_F, with C
from H_true (out of sample) and from H_est (in sample).

Spectra, activations and weights come from numpy draw for draw as in the
JAX package; the factors are host f64 (``tgq_torch.solver.factorize``)
and the GPTQ sweep runs on ``--device`` (K2 on CUDA).  One change from
the JAX CLI: the summary's ``eps`` column of the ``trunc_best`` rows is
a ``;``-joined string of the winning ε values ("1e-06;0.0001"), not a
Python list's repr in the CSV.

Usage:
  python -m tgq_torch.cli.trunc_regimes [--n 512] [--m 256] [--seeds 3] \\
      [--decades 3,6,10] [--n_tokens 128,256,512,1024,4096] [--bits 2,3,4] \\
      [--device cuda]
"""
from __future__ import annotations

import argparse
import csv
import json
from collections import defaultdict

import numpy as np
import torch

EPS_GRID = (1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2)  # run_experiments.py:18-44


def make_true_cov(n: int, decades: float, rng, spectrum: str = "log",
                  out_scale: float = 1e4) -> tuple[np.ndarray, np.ndarray]:
    """(C, lam): H_true = C·Cᵀ.  "log": eigenvalues log-spaced over
    ``decades``, random orthogonal eigenbasis; "outlier": n/64 directions
    at ``out_scale`` over a 2-decade bulk and a tail down to ``decades``,
    random eigenbasis; "channel": H = D·R·D with D n/64 channels at
    √out_scale (at random positions) and the rest log-spaced over
    decades/2, R an AR(1) correlation (ρ = 0.9)."""
    if spectrum == "log":
        lam = np.logspace(0.0, -decades, n)
    elif spectrum == "outlier":
        k = max(1, n // 64)
        n_bulk = int(n * 0.75)
        n_tail = n - k - n_bulk
        lam = np.concatenate([
            np.full(k, out_scale),
            np.logspace(0.0, -2.0, n_bulk),
            np.logspace(-2.0, -decades, max(n_tail, 1))[:n_tail],
        ])
    elif spectrum == "channel":
        k = max(1, n // 64)
        d = np.concatenate([np.full(k, np.sqrt(out_scale)),
                            np.logspace(0.0, -decades / 2.0, n - k)])
        rng.shuffle(d)
        r_corr = 0.9 ** np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
        c = d[:, None] * np.linalg.cholesky(r_corr + 1e-12 * np.eye(n))
        return c.astype(np.float64), d ** 2
    else:
        raise ValueError(spectrum)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (q * np.sqrt(lam)[None, :]).astype(np.float64), lam


def sample_activations(c: np.ndarray, n_tokens: int, rng, heavy_tail: bool = False):
    """N draws of x with E[xxᵀ] = CCᵀ; Student-t(4) marginals (unit
    variance) with ``heavy_tail``."""
    n = c.shape[0]
    if heavy_tail:
        df = 4.0
        z = rng.standard_t(df, size=(n_tokens, n)) / np.sqrt(df / (df - 2.0))
    else:
        z = rng.standard_normal((n_tokens, n))
    return z @ c.T


def rel_err(dw: np.ndarray, w: np.ndarray, c: np.ndarray) -> float:
    return float(np.linalg.norm(dw @ c) / max(np.linalg.norm(w @ c), 1e-30))


def run_cell(n: int, m: int, decades: float, n_tokens: int, bits_list, seed: int,
             group_size: int, damp_percent: float, heavy_tail: bool, eps_grid=EPS_GRID,
             spectrum: str = "log", out_scale: float = 1e4, device="cpu") -> list[dict]:
    """One (spectrum, N, seed) cell: the factors once, then per bit width
    the rows of GPTQ, RTN and the best-ε truncated solve, each with its
    out-of-sample and in-sample error, rank, saturation share and the
    error's share in the top tenth of the true eigenbasis."""
    from tgq_torch.core.quant import QuantSpec, fake_quantize
    from tgq_torch.solver.factorize import gptq_cholesky_factor, trunc_spectral_factor
    from tgq_torch.solver.gptq_loop import quantize_weight

    rng = np.random.default_rng(seed * 1000 + int(decades) * 17 + n_tokens)
    c_true, _ = make_true_cov(n, decades, rng, spectrum=spectrum, out_scale=out_scale)
    x = sample_activations(c_true, n_tokens, rng, heavy_tail)
    h_est = (x.T @ x / n_tokens).astype(np.float64)
    lam_e, q_e = np.linalg.eigh(h_est)
    c_est = q_e * np.sqrt(np.clip(lam_e, 0.0, None))[None, :]
    lam_t, q_t = np.linalg.eigh(c_true @ c_true.T)
    topv = (q_t * np.sqrt(np.clip(lam_t, 0.0, None)))[:, ::-1][:, :n // 10]
    w = rng.standard_normal((m, n)).astype(np.float32)

    factors = {"gptq": gptq_cholesky_factor(h_est, actorder=True, damp_percent=damp_percent)}
    for eps in eps_grid:
        factors[f"trunc@{eps:g}"] = trunc_spectral_factor(h_est, eps=eps, method="energy")

    wt = torch.from_numpy(w).to(device)
    w64 = w.astype(np.float64)

    def stats(wq, codes, spec, rank):
        dw = w64 - wq
        sat = ("" if codes is None else round(float(np.mean(
            (codes <= spec.min_q) | (codes >= spec.max_q))), 4))
        mass_top = float(np.linalg.norm(dw @ topv) ** 2
                         / max(np.linalg.norm(dw @ c_true) ** 2, 1e-30))
        return rel_err(dw, w64, c_true), rel_err(dw, w64, c_est), rank, sat, round(mass_top, 4)

    rows = []
    for bits in bits_list:
        spec = QuantSpec(bits=bits, group_size=group_size, sym=False)
        per_method = {}
        for name, fr in factors.items():
            res = quantize_weight(wt, fr, spec, with_error=False)
            per_method[name] = stats(res.w_q.cpu().double().numpy(), res.codes.cpu().numpy(),
                                     spec, int(fr.rank))
        per_method["rtn"] = stats(fake_quantize(wt, spec).cpu().double().numpy(), None, spec, n)
        best = min((k for k in per_method if k.startswith("trunc@")),
                   key=lambda k: per_method[k][0])
        for name in ("gptq", "rtn", best):
            oos, ins, rank, sat, mass_top = per_method[name]
            rows.append({
                "decades": decades, "n_tokens": n_tokens, "seed": seed, "bits": bits,
                "method": "trunc_best" if name == best else name,
                "eps": float(best.split("@")[1]) if name == best else "",
                "rank": rank, "sat": sat, "mass_top": mass_top,
                "err_oos": round(oos, 6), "err_ins": round(ins, 6),
            })
    return rows


def summarize(rows) -> list[dict]:
    """Mean over seeds per (decades, n_tokens, bits, method); a
    ``trunc_best`` row's ``eps`` is its seeds' winning ε values, sorted and
    joined by ``;``."""
    acc = defaultdict(list)
    for r in rows:
        acc[(r["decades"], r["n_tokens"], r["bits"], r["method"])].append(r)
    out = []
    for (dec, nt, bits, method), rs in sorted(acc.items()):
        out.append({
            "decades": dec, "n_tokens": nt, "bits": bits, "method": method,
            "err_oos": round(float(np.mean([r["err_oos"] for r in rs])), 6),
            "err_ins": round(float(np.mean([r["err_ins"] for r in rs])), 6),
            "rank": int(np.mean([r["rank"] for r in rs])),
            "mass_top": round(float(np.mean([r["mass_top"] for r in rs])), 4),
            "eps": (";".join(f"{e:g}" for e in sorted({r["eps"] for r in rs if r["eps"] != ""}))
                    if method == "trunc_best" else ""),
        })
    return out


def trunc_wins(summary) -> tuple[int, int]:
    """(cells where trunc_best's out-of-sample error is at most GPTQ's, cells)."""
    gptq = {(s["decades"], s["n_tokens"], s["bits"]): s["err_oos"]
            for s in summary if s["method"] == "gptq"}
    best = [s for s in summary if s["method"] == "trunc_best"]
    wins = sum(1 for s in best if gptq[(s["decades"], s["n_tokens"], s["bits"])] >= s["err_oos"])
    return wins, len(best)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--decades", default="3,6,10")
    ap.add_argument("--n_tokens", default="128,256,512,1024,4096")
    ap.add_argument("--bits", default="2,3,4")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--group_size", type=int, default=128)
    ap.add_argument("--damp_percent", type=float, default=0.01,
                    help="reference default; NOT swept (run_benchmark.py)")
    ap.add_argument("--heavy_tail", action="store_true", help="Student-t(4) activation marginals")
    ap.add_argument("--spectrum", default="log", choices=("log", "outlier", "channel"))
    ap.add_argument("--out_scale", type=float, default=1e4,
                    help="outlier eigen/channel variance scale")
    ap.add_argument("--out", default=None, help="CSV output path (summary)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def run(args) -> dict:
    """Every cell of the grid (progress lines printed per (decades, N));
    writes the summary CSV under ``--out``; returns the headline."""
    from tgq_torch.utils.precision import exact_f32_matmul, resolve_device

    device = resolve_device(args.device)
    exact_f32_matmul()
    bits_list = [int(b) for b in args.bits.split(",")]
    rows = []
    for decades in (float(d) for d in args.decades.split(",")):
        for n_tokens in (int(t) for t in args.n_tokens.split(",")):
            for seed in range(args.seeds):
                rows.extend(run_cell(args.n, args.m, decades, n_tokens, bits_list, seed,
                                     args.group_size, args.damp_percent, args.heavy_tail,
                                     spectrum=args.spectrum, out_scale=args.out_scale,
                                     device=device))
            for s in summarize([r for r in rows
                                if r["decades"] == decades and r["n_tokens"] == n_tokens]):
                print(f"d{int(s['decades']):2d} N{s['n_tokens']:5d} W{s['bits']} "
                      f"{s['method']:11s} oos {s['err_oos']:.4f}  ins {s['err_ins']:.4f}  "
                      f"rank {s['rank']:4d} mtop {s['mass_top']:.3f} eps {s['eps']}",
                      flush=True)
    summary = summarize(rows)
    if args.out:
        with open(args.out, "w", newline="") as fh:
            wtr = csv.DictWriter(fh, fieldnames=list(summary[0].keys()))
            wtr.writeheader()
            wtr.writerows(summary)
    wins, total = trunc_wins(summary)
    return {"cells": total, "trunc_wins_oos": wins, "device": str(device)}


def main(argv=None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
