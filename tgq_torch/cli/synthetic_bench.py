"""``python -m tgq_torch.cli.synthetic_bench`` — solvers on synthetic
activations (mirrors ``tgq/cli/synthetic_bench.py``).

Controlled activation distributions (iid Gaussian, AR(1)-correlated,
Student-t, correlated-t, log-normal), made with numpy from ``--seed``
exactly as the JAX tool makes them, a known Y = XWᵀ, and the relative
output error ‖Y − XWqᵀ‖/‖Y‖ of each solver at each bit width.  On CUDA
the Hessian, the pchol sweep (K1) and the GPTQ block sweeps (K2) run on
the card; ``--device cpu`` runs their plain versions.
"""
from __future__ import annotations

import argparse
import csv
import json

import numpy as np
import torch


def make_activations(kind: str, rng, n_tokens: int, n_features: int,
                     rho: float = 0.9, df: float = 3.0) -> np.ndarray:
    if kind == "gaussian":
        x = rng.normal(size=(n_tokens, n_features))
    elif kind in ("ar1", "ar1_t"):
        cov_chol = np.linalg.cholesky(
            rho ** np.abs(np.subtract.outer(np.arange(n_features), np.arange(n_features)))
            + 1e-9 * np.eye(n_features))
        z = (rng.standard_t(df, size=(n_tokens, n_features))
             if kind == "ar1_t" else rng.normal(size=(n_tokens, n_features)))
        x = z @ cov_chol.T
    elif kind == "student_t":
        x = rng.standard_t(df, size=(n_tokens, n_features))
    elif kind == "lognormal":
        x = rng.lognormal(mean=0.0, sigma=1.0, size=(n_tokens, n_features))
        x = x - x.mean(axis=0, keepdims=True)
    else:
        raise ValueError(kind)
    return x.astype(np.float32)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_tokens", type=int, default=16384)
    ap.add_argument("--n_features", type=int, default=512)
    ap.add_argument("--out_features", type=int, default=512)
    ap.add_argument("--bits", default="4,3,2")
    ap.add_argument("--group_size", type=int, default=128)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--methods", default="pchol,eigh,gptq,rtn")
    ap.add_argument("--distributions", default="gaussian,ar1,student_t,ar1_t,lognormal")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="CSV output path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


@torch.no_grad()
def run(args) -> list[dict]:
    from tgq_torch.core.quant import QuantSpec, fake_quantize
    from tgq_torch.solver import (
        gptq_cholesky_factor,
        hessian_from_activations,
        quantize_weight,
        trunc_spectral_factor,
    )
    from tgq_torch.solver.pchol import pchol_factor
    from tgq_torch.utils.precision import resolve_device

    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    w = rng.normal(size=(args.out_features, args.n_features)).astype(np.float32)
    wt = torch.from_numpy(w).to(dev)
    rows = []
    for dist in args.distributions.split(","):
        x = make_activations(dist, rng, args.n_tokens, args.n_features)
        y = x @ w.T
        h = hessian_from_activations(torch.from_numpy(x).to(dev))
        factors = {}
        for m in args.methods.split(","):
            if m == "pchol":
                factors[m] = pchol_factor(h, eps=args.eps)
            elif m == "eigh":
                factors[m] = trunc_spectral_factor(h, eps=args.eps, method="energy")
            elif m == "gptq":
                factors[m] = gptq_cholesky_factor(h, actorder=True)
            elif m == "rtn":
                factors[m] = None
            else:
                raise ValueError(f"unknown method {m!r}")
        for bits in (int(b) for b in args.bits.split(",")):
            spec = QuantSpec(bits=bits, group_size=args.group_size, sym=False)
            for m, f in factors.items():
                if f is None:
                    wq = fake_quantize(wt, spec).cpu().numpy()
                    rank = args.n_features
                else:
                    res = quantize_weight(wt, f, spec, with_error=False)
                    wq, rank = res.w_q.cpu().numpy(), int(f.rank)
                err = float(np.linalg.norm(y - x @ wq.T) / np.linalg.norm(y))
                rows.append({"dist": dist, "bits": bits, "method": m, "rank": rank,
                             "rel_output_error": round(err, 6)})
                print(f"{dist:10s} W{bits} {m:6s} rank={rank:4d} rel_err={err:.5f}", flush=True)
    if args.out:
        with open(args.out, "w", newline="") as fh:
            wcsv = csv.DictWriter(fh, fieldnames=list(rows[0]))
            wcsv.writeheader()
            wcsv.writerows(rows)
    return rows


def main(argv=None) -> int:
    rows = run(build_parser().parse_args(argv))
    print(json.dumps({"rows": len(rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
