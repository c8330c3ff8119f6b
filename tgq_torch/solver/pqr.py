"""Rank-revealing pivoted QR (mirrors ``tgq/solver/pqr.py``): f64 LAPACK
``dgeqp3`` through scipy, on the host.  The JAX package's on-device f32
backend has no caller and is not ported."""
from __future__ import annotations

import numpy as np
import scipy.linalg
import torch


def pivoted_qr(a):
    """Economic pivoted QR of an (m, n) matrix with a[:, perm] = q r.
    Returns (r, perm): r is (min(m,n), n) upper-trapezoidal with
    non-increasing |diag|; q is never formed."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    r, perm = scipy.linalg.qr(a.astype(np.float64, copy=False), mode="r", pivoting=True)
    return r[: min(a.shape), :], perm.astype(np.int64)
