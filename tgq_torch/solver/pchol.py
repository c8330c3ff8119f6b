"""Blocked pivoted Cholesky — the TruncGPTQ fast path (mirrors
``tgq/solver/pchol.py``).

Two identities replace the reference's eigh + pivoted-QR chain:

1. "energy" truncation keeps the smallest prefix capturing (1-ε) of
   tr(H); greedy pivoted Cholesky decomposes the trace the same way
   (step k removes ‖l_k‖² from the Schur complement's trace).
2. The Businger–Golub pivots of a pivoted QR of any S with SᵀS = H are
   the diagonal pivots of pivoted Cholesky of H.

The sweep runs panels of ``panel`` greedy steps (``pchol_panel``: the
CUDA kernel on the card, its plain version on the CPU) and folds each
finished panel into the Schur complement with one exact-f32 GEMM.  The
factor build then needs only Cholesky factorizations, a Cholesky solve
and GEMMs, run in f32 on the device (``_pchol_factors``; in f64 where the
f32 build breaks down, before the JAX package's failure ladder).  The JAX package's
``blocked_linalg`` exists to bound XLA's temporaries on a 16 GB TPU; here
``torch.linalg`` does the same work directly.
"""
from __future__ import annotations

import logging

import torch

from tgq_torch.kernels.pchol_panel import pchol_panel, pchol_panel_plain
from tgq_torch.solver.factorize import FactorResult

logger = logging.getLogger(__name__)


def _sweep(h: torch.Tensor, panel: int = 128, plain: bool = False):
    """Full-length greedy pivoted Cholesky.

    Returns (lt, perm, dhist, pivhist):
      lt:      (n, n) f32 — row k is the k-th Cholesky vector in original
               column indexing.
      perm:    (n,) int32 pivot order.
      dhist:   (n,) f32 trace captured at each step, ‖l_k‖².
      pivhist: (n,) f32 pivot value at each step.
    Same contract as ``_pivoted_cholesky_jit``/``_pivoted_cholesky_pallas``.
    """
    panel_fn = pchol_panel_plain if plain else pchol_panel
    n = h.shape[0]
    a = h.to(torch.float32, copy=True).contiguous()
    d = torch.diagonal(a).reshape(1, n).contiguous()
    done = torch.zeros((1, n), dtype=torch.float32, device=a.device)
    strips, perms, phs = [], [], []
    num_panels = -(-n // panel)
    for p in range(num_panels):
        steps = min(panel, n - p * panel)
        strip, d, done, perm, ph = panel_fn(a, d, done, panel=panel, steps=steps)
        strip = strip[:steps]
        if p + 1 < num_panels:
            a.addmm_(strip.T, strip, alpha=-1.0)  # exact f32, TF32 off
        strips.append(strip)
        perms.append(perm[0, :steps])
        phs.append(ph[0, :steps])
    lt = torch.cat(strips, dim=0)
    dhist = (lt * lt).sum(dim=1)
    return lt, torch.cat(perms), dhist, torch.cat(phs)


def _pivoted_cholesky_plain(h: torch.Tensor, panel: int = 128):
    """The sweep through the plain panel version on any device (the
    counterpart of ``_pivoted_cholesky_jit``)."""
    return _sweep(h, panel=panel, plain=True)


def _trace_rank(d_hist: torch.Tensor, eps: float) -> torch.Tensor:
    """Smallest prefix capturing (1-eps) of the trace, in f64 on the
    tensor's device (a 0-d tensor; 1 for a zero trace)."""
    d = d_hist.double()
    total = d.sum()
    tr = (torch.cumsum(d, 0) <= (1.0 - eps) * total).sum()
    tr = torch.where(tr < d.numel(), tr + 1, tr)
    tr = torch.clamp(torch.minimum(tr, torch.clamp((d > 0).sum(), min=1)), min=1)
    return torch.where(total > 0, tr, 1)


def trace_rank(d_hist, eps: float) -> int:
    """Smallest prefix capturing (1-eps) of the trace — the "energy" rule
    on the pivoted-Cholesky trace decomposition
    (``tgq/solver/pchol.py::trace_rank``)."""
    return int(_trace_rank(torch.as_tensor(d_hist), eps))


def _rank_f64(dhist: torch.Tensor, pivhist: torch.Tensor, eps: float,
              pivot_rtol: float) -> int:
    """``min(trace_rank(dhist, eps), numerical rank)`` computed in f64 on
    the tensors' device — the same rule as the JAX host path, without the
    f32 cumsum drift of the JAX device path (``tgq/solver/pchol.py:216``)."""
    p = pivhist.double()
    nr = torch.clamp((p > pivot_rtol * p[0]).sum(), min=1)
    return int(torch.minimum(_trace_rank(dhist, eps), nr))


def _pchol_factors(lt: torch.Tensor, perm: torch.Tensor, rank: int,
                   want_rx: bool = True):
    """From Lt (original indexing) and the rank, build (r_full, r_x) in f32
    (``tgq/solver/pchol.py:274-320``).

    With A := rows < rank of lt[:, perm] (Lpᵀ zero-padded to n×n) and
    G := AAᵀ + I_tail, K := G⁻¹A has KᵀK = H⁺_perm exactly rank r, and

        chol_upper(KᵀK + I_tail) = [[R1, R12], [0, I]]

    — the full-width factor the quantization loop wants (identity tail
    rows ⇒ RTN tail).  A failed Cholesky leaves NaN in r_full, as the JAX
    build does, so the caller's failure ladder sees it.
    """
    n = lt.shape[0]
    mask_r = (torch.arange(n, device=lt.device) < rank).to(lt.dtype)
    a = lt[:, perm.long()] * mask_r[:, None]
    tail = torch.diag(1.0 - mask_r)
    cg, info_g = torch.linalg.cholesky_ex(a @ a.T + tail)
    k = torch.cholesky_solve(a, cg)
    del cg
    r_full, info_p = torch.linalg.cholesky_ex(k.T @ k + tail, upper=True)
    r_full = torch.triu(r_full).masked_fill((info_g != 0) | (info_p != 0), torch.nan)
    return r_full, (a if want_rx else None)


def _finite(r_full, r_x) -> bool:
    return bool(torch.isfinite(r_full).all()) and (r_x is None or bool(torch.isfinite(r_x).all()))


def pchol_factor(h, eps: float = 1e-6, panel: int = 128, pivot_rtol: float = None,
                 want_rx: bool = True, force_finite_check: bool = False,
                 backend: str = "kernel") -> FactorResult:
    """TruncGPTQ factorization via pivoted Cholesky.

    Same FactorResult contract as trunc_spectral_factor.  ``backend``
    "kernel" runs the sweep through the CUDA panel kernel for a CUDA
    ``h`` (the plain version for a CPU ``h``); "plain" runs the plain
    version on ``h``'s device.

    ``pivot_rtol``: numerical-rank guard — pivots below rtol × the first
    pivot are unresolvable by the sweep's f32 arithmetic; columns beyond
    it degrade to RTN whatever ``eps`` says.  Default 1e-5 on the kernel
    path and 1e-6 on the plain path (``tgq/solver/pchol.py:347-349``).
    """
    h = torch.as_tensor(h)
    n = h.shape[0]
    use_kernel = backend == "kernel" and h.device.type == "cuda"
    if pivot_rtol is None:
        pivot_rtol = 1e-5 if use_kernel else 1e-6
    lt, perm, dhist, pivhist = _sweep(h.to(torch.float32), panel=panel,
                                      plain=backend == "plain")
    p0 = float(pivhist[0])
    if p0 <= 0.0:
        # degenerate Hessian (zero trace): identity factor, every column RTN
        eye = torch.eye(n, dtype=torch.float32, device=h.device)
        return FactorResult(r_full=eye, perm=torch.arange(n, device=h.device),
                            rank=1, r_x=torch.zeros_like(eye))
    rank = _rank_f64(dhist, pivhist, eps, pivot_rtol)
    r_full, r_x = _pchol_factors(lt, perm, rank, want_rx=want_rx)
    # f32 breakdown guard: on extreme spectra the build can go NaN.  The
    # port first builds the same rank in f64 on h's device (a rung the JAX
    # package lacks); then, as the JAX package does, it escalates the
    # numerical-rank guard once and falls back to the host f64 eigh path
    # (tgq/solver/pchol.py:408-437).
    pivot_ratio = p0 / max(float(pivhist[rank - 1]), 1e-300)
    if force_finite_check or pivot_ratio > 1e4:
        if not _finite(r_full, r_x):
            r64, rx64 = _pchol_factors(lt.double(), perm, rank, want_rx=want_rx)
            r_full, r_x = r64.float(), (None if rx64 is None else rx64.float())
            del r64, rx64
            finite64 = _finite(r_full, r_x)
            logger.warning("pchol f32 factor build not finite at rank %d of n = %d (pivot "
                           "ratio %.3g); the f64 build is %s", rank, n, pivot_ratio,
                           "finite" if finite64 else "not finite either")
            if finite64:
                return FactorResult(r_full=r_full, perm=perm, rank=rank, r_x=r_x)
            logger.warning("pchol factor build not finite at rank %d of n = %d "
                           "(pivot ratio %.3g, pivot_rtol %g); escalating", rank, n,
                           pivot_ratio, pivot_rtol)
            if pivot_rtol < 1e-3:
                return pchol_factor(h, eps=eps, panel=panel, pivot_rtol=1e-3,
                                    want_rx=want_rx, force_finite_check=True,
                                    backend=backend)
            from tgq_torch.solver.factorize import trunc_spectral_factor

            return trunc_spectral_factor(h, eps=eps, method="energy")
    return FactorResult(r_full=r_full, perm=perm, rank=rank, r_x=r_x)
