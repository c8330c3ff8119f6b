"""TruncGPTQ factorizations on the host in f64 (mirrors
``tgq/solver/factorize.py``).

- ``trunc_spectral_factor`` — mode "eigh": f64 eigh → truncated Λ^½Vᵀ →
  pivoted QR for the column order → QR of the permuted Λ^{-½}Vᵀ for the
  error-propagation factor R with RᵀR ≈ H⁺.
- ``gptq_cholesky_factor`` — mode "gptq": damped Cholesky ladder,
  norm-ActOrder.
- ``sketch_factor`` — mode "svd": the same product from a Gaussian sketch.

Every path returns a full (n, n) upper-triangular ``r_full`` whose rows
beyond the rank are identity rows, so the quantization loop runs one
shape-static pass and the truncated tail degrades to round-to-nearest.
The on-device path is ``tgq_torch.solver.pchol``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import scipy.linalg
import torch

from tgq_torch.solver.pqr import pivoted_qr

logger = logging.getLogger(__name__)

EIG_FLOOR = 1e-12


@dataclasses.dataclass
class FactorResult:
    """Solver output consumed by the quantization loop.

    r_full: (n, n) f32 upper-triangular; rows >= rank are identity rows.
    perm:   (n,) int column permutation (quantization order).
    rank:   retained rank.
    r_x:    optional (n, n) factor of H^{1/2} in permuted order (rows past
            rank zero), for the relative prediction error.
    Arrays are numpy on the host paths and tensors on the pchol path.
    """

    r_full: np.ndarray | torch.Tensor
    perm: np.ndarray | torch.Tensor
    rank: int
    r_x: Optional[np.ndarray | torch.Tensor] = None


def _host64(h) -> np.ndarray:
    if isinstance(h, torch.Tensor):
        return h.detach().cpu().double().numpy()
    return np.asarray(h, dtype=np.float64)


def truncate_rank(s: np.ndarray, eps: float, method: str = "energy") -> int:
    """Rank selection on a descending spectrum.

    - "energy": smallest prefix whose cumulative s² reaches (1-eps) of the total.
    - "mean_trimmed": values above eps × mean(s[1:33]).
    - anything else: full rank.
    """
    s = np.asarray(s)
    n = len(s)
    if method == "energy":
        energy = s.astype(np.float64) ** 2
        target = (1.0 - eps) * energy.sum()
        rank = int((np.cumsum(energy) <= target).sum())
        if rank < n:
            rank += 1
    elif method == "mean_trimmed":
        ref_k = min(33, n)
        ref_val = s[1:ref_k].mean() if n > 1 else s[0]
        rank = int((s > eps * ref_val).sum())
    else:
        rank = n
    return max(1, min(rank, n))


def _finish_factor(s: np.ndarray, vh: np.ndarray, n: int) -> FactorResult:
    """Common tail: pivoted QR order from S·Vᵀ, propagation R from Λ^{-½}Vᵀ."""
    rank = s.shape[0]
    r_x, perm = pivoted_qr(s[:, None] * vh)
    h_inv_partial = (1.0 / s)[:, None] * vh
    r_prime = scipy.linalg.qr(h_inv_partial[:, perm], mode="r")[0][:rank, :]

    # positive diagonals on both factors
    dsign = np.sign(np.diagonal(r_prime)[:rank])
    dsign[dsign == 0] = 1.0
    r = r_prime * dsign[:, None]
    dsign_x = np.sign(np.diagonal(r_x)[:rank])
    dsign_x[dsign_x == 0] = 1.0
    r_x = r_x * dsign_x[:, None]

    r_full = np.zeros((n, n), dtype=np.float64)
    r_full[:rank, :] = r
    if rank < n:
        idx = np.arange(rank, n)
        r_full[idx, idx] = 1.0
    r_x_full = np.zeros((n, n), dtype=np.float32)
    r_x_full[:rank, :] = r_x.astype(np.float32)
    return FactorResult(r_full=r_full.astype(np.float32), perm=perm.astype(np.int64),
                        rank=rank, r_x=r_x_full)


def trunc_spectral_factor(h, eps: float = 5e-4, method: str = "mean_trimmed",
                          precision: str = "f64") -> FactorResult:
    """TruncGPTQ solver ("eigh" mode).  h: (n, n) symmetric PSD Hessian.
    ``precision="f32"`` runs only the eigh on h's device in f32."""
    n = h.shape[0]
    if precision == "f64":
        lam, v = scipy.linalg.eigh(_host64(h))
    elif precision == "f32":
        lam_t, v_t = torch.linalg.eigh(torch.as_tensor(h, dtype=torch.float32))
        lam, v = lam_t.cpu().double().numpy(), v_t.cpu().double().numpy()
    else:
        raise ValueError(f"unknown precision {precision!r}")
    s = np.sqrt(np.clip(lam, EIG_FLOOR, None))[::-1]
    vh = v.T[::-1]
    rank = truncate_rank(s, eps, method)
    return _finish_factor(s[:rank], vh[:rank], n)


def sketch_factor(y, eps: float = 1e-2, method: str = "mean_trimmed") -> FactorResult:
    """Randomized-sketch solver ("svd" mode); y: (sketch_rank, n)."""
    y64 = _host64(y)
    n = y64.shape[1]
    r_reduced = scipy.linalg.qr(y64, mode="r")[0][: min(y64.shape), :]
    _, s, vh = scipy.linalg.svd(r_reduced, full_matrices=False)
    rank = truncate_rank(s, eps, method)
    return _finish_factor(s[:rank], vh[:rank], n)


def gptq_cholesky_factor(h, actorder: bool = False,
                         damp_percent: float = 0.01) -> FactorResult:
    """Reference-GPTQ solver ("gptq" mode): norm ActOrder + escalating
    damped Cholesky; identity fallback."""
    h64 = _host64(h)
    n = h64.shape[0]
    if actorder:
        perm = np.argsort(np.diagonal(h64))[::-1].copy()
        h64 = h64[perm][:, perm]
    else:
        perm = np.arange(n)

    diag_mean = float(np.diagonal(h64).mean())
    if diag_mean == 0.0:
        diag_mean = 1.0

    u = None
    for damp_exp in range(5):
        damp = 10**damp_exp * damp_percent
        h_damped = h64.copy()
        h_damped[np.diag_indices(n)] += damp * diag_mean
        try:
            low = scipy.linalg.cholesky(h_damped, lower=True)
            h_inv = scipy.linalg.cho_solve((low, True), np.eye(n))
            u = scipy.linalg.cholesky(h_inv, lower=False)
            if damp_exp > 0:
                logger.info("ref-GPTQ required high damping: %s", damp)
            break
        except np.linalg.LinAlgError:
            continue

    if u is None:
        logger.warning("Hessian singular beyond damping ladder; identity fallback")
        u = np.eye(n)

    return FactorResult(r_full=np.ascontiguousarray(u, dtype=np.float32),
                        perm=perm.astype(np.int64), rank=n, r_x=None)
