"""Plain TruncGPTQ: asymmetric grouped RTN parameters, the layer Gram,
pivoted Cholesky with the "energy" rank rule, the truncated factor and
the GPTQ column sweep.  Every function computes in the dtype it is
given; callers set ``torch.backends.cuda.matmul.allow_tf32``.

The method (the port's ``mode="pchol"``): greedy pivoted Cholesky of the
layer Hessian H keeps the smallest prefix of pivots capturing (1 - eps) of
tr(H), and no pivot below ``pivot_rtol`` of the first; with A the kept
rows of the Cholesky factor in pivot order, the factor R of GPTQ is the
upper Cholesky factor of H_r^+ + I_tail (H_r = A^T A, the identity on the
columns past the rank), so the columns past the rank round to nearest.
GPTQ then quantizes the columns in pivot order, each column's error
divided by R's diagonal and carried into the later columns by R's row.
"""
from __future__ import annotations

import torch


def round_half_up(x):
    return torch.floor(x + 0.5)


def find_params(w, bits: int, group: int):
    """(scale, zero), each (m, n / group), of an (m, n) weight: scale =
    max(max - min, 1e-5) * (1 / (2^bits - 1)), zero = clip(round(-min /
    scale), 0, 2^bits - 1), rounding half up."""
    m, n = w.shape
    wg = w.reshape(m, n // group, group)
    mn, mx = wg.amin(2), wg.amax(2)
    maxq = 2 ** bits - 1
    scale = torch.clamp(mx - mn, min=1e-5) * (1.0 / maxq)
    zero = torch.clamp(round_half_up(-mn / scale), 0, maxq)
    return scale, zero


def expand(p, group: int):
    return p.repeat_interleave(group, dim=1)


def rtn(w, bits: int, group: int):
    """Round-to-nearest: (dequantized weight, codes)."""
    scale, zero = find_params(w, bits, group)
    s, z = expand(scale, group), expand(zero, group)
    q = torch.clamp(round_half_up(w / s + z), 0, 2 ** bits - 1)
    return (q - z) * s, q


def dequantize(codes, scale, zero, group: int):
    return (codes.to(scale.dtype) - expand(zero, group)) * expand(scale, group)


class Gram:
    """H = (1 / N) sum x^T x over the tokens of every update."""

    def __init__(self, n: int, dtype, device):
        self.h = torch.zeros((n, n), dtype=dtype, device=device)
        self.n = 0

    def update(self, x):
        x = x.reshape(-1, x.shape[-1]).to(self.h.dtype)
        self.h += x.T @ x
        self.n += x.shape[0]

    def value(self):
        return self.h / max(self.n, 1)


def pivoted_cholesky(h, order=None, panel: int = 128):
    """Pivoted Cholesky of ``h`` in its dtype.  ``order`` None picks the
    largest remaining diagonal at each step; a given order (a device long
    tensor) is followed instead.  Returns (L, perm, piv, regret): L (n, n)
    row k the k-th Cholesky vector in the original indexing, perm the
    pivots, piv the pivot values, and regret[k] the largest remaining
    diagonal less the chosen one, at step k.  A pivot at or below zero
    (a spent direction) gives a zero row.  No step waits for the host."""
    n = h.shape[0]
    dt, dev = h.dtype, h.device
    a = h.clone()
    d = torch.diagonal(a).clone()
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    big = torch.finfo(dt).max
    L = torch.zeros((n, n), dtype=dt, device=dev)
    perm = torch.zeros(n, dtype=torch.long, device=dev)
    piv = torch.zeros(n, dtype=dt, device=dev)
    regret = torch.zeros(n, dtype=dt, device=dev)
    tiny = torch.finfo(dt).tiny
    for p0 in range(0, n, panel):
        p1 = min(n, p0 + panel)
        for k in range(p0, p1):
            dm = torch.where(done, -big, d)
            best = dm.max()
            p = dm.argmax().view(1) if order is None else order[k:k + 1]
            col = a.index_select(1, p).squeeze(1)
            if k > p0:
                col = col - L[p0:k].T @ L[p0:k].index_select(1, p).squeeze(1)
            pv = col.index_select(0, p)
            regret[k:k + 1] = best - d.index_select(0, p)
            lk = torch.where(done | (pv <= 0), 0.0, col / torch.sqrt(torch.clamp(pv, min=tiny)))
            L[k] = lk
            d = d - lk * lk
            done = done.index_fill(0, p, True)
            d = d.index_fill(0, p, 0.0)
            perm[k:k + 1] = p
            piv[k:k + 1] = pv
        if p1 < n:
            blk = L[p0:p1]
            a -= blk.T @ blk
    return L, perm, piv, regret


def energy_rank(L, piv, trace: float, eps: float, pivot_rtol: float) -> int:
    """The smallest prefix whose captured trace sum(|l_k|^2) exceeds
    (1 - eps) tr(H), and no more than the pivots above pivot_rtol times
    the first (at least 1); none of a zero H (a group fed by no row), whose
    columns then all round to nearest."""
    if trace == 0:
        return 0
    n = L.shape[0]
    captured = torch.cumsum((L.double() * L.double()).sum(1), 0)
    k = int((captured <= (1.0 - eps) * trace).sum())
    k = min(k + 1, n)
    p = piv.double()
    nr = max(int((p > pivot_rtol * p[0]).sum()), 1)
    return max(1, min(k, nr))


def truncated_factor(L, perm, rank: int):
    """R with R^T R = H_r^+ + I_tail in pivot order, H_r = A^T A from the
    first ``rank`` Cholesky vectors A (pivot order); all NaN where a
    Cholesky factorization breaks down."""
    n = L.shape[0]
    a = L[:rank][:, perm]                                  # (r, n)
    cg, info_g = torch.linalg.cholesky_ex(a @ a.T)
    k = torch.cholesky_solve(a, cg)                        # (A A^T)^-1 A
    m = k.T @ k
    tail = torch.arange(n, device=L.device) >= rank
    m = m + torch.diag(tail.to(m.dtype))
    r, info_r = torch.linalg.cholesky_ex(m, upper=True)
    failed = (info_g != 0) | (info_r != 0)
    return torch.triu(r).masked_fill(failed, float("nan"))


def gptq(w, r, perm, scale, zero, bits: int, group: int, block: int):
    """GPTQ codes (m, n) of the weight ``w`` (m, n), in the original column
    order, swept in pivot order ``perm`` with the factor ``r`` (pivot
    order), in ``w``'s dtype; blocks of ``block`` columns carry their
    errors into the later columns with one product."""
    m, n = w.shape
    maxq = 2 ** bits - 1
    s = expand(scale, group)[:, perm].to(w.dtype)
    z = expand(zero, group)[:, perm].to(w.dtype)
    wp = w[:, perm].clone()
    q = torch.empty_like(wp)
    r = r.to(w.dtype)
    for i1 in range(0, n, block):
        i2 = min(n, i1 + block)
        e = torch.empty((m, i2 - i1), dtype=w.dtype, device=w.device)
        for j in range(i1, i2):
            wj, sj, zj = wp[:, j], s[:, j], z[:, j]
            qj = torch.clamp(round_half_up(wj / sj + zj), 0, maxq)
            ej = (wj - (qj - zj) * sj) / r[j, j]
            if j + 1 < i2:
                wp[:, j + 1:i2] -= ej[:, None] * r[j, j + 1:i2][None, :]
            q[:, j] = qj
            e[:, j - i1] = ej
        if i2 < n:
            wp[:, i2:] -= e @ r[i1:i2, i2:]
    return q[:, torch.argsort(perm)]


def unpack_int4(packed, out_features: int, in_features: int, group: int):
    """Codes (out, in) of a K-major (in / 2, out) uint8 array in the split-
    half layout: within each group, byte j holds code j in its low nibble
    and code j + group / 2 in its high nibble."""
    b = packed.T.to(torch.int32).reshape(out_features, in_features // group, group // 2)
    return torch.cat([b & 15, b >> 4], dim=-1).reshape(out_features, in_features)
