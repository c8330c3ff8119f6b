"""One panel of greedy pivoted Cholesky: CUDA kernel and plain version.

Port of ``tgq/kernels/pchol_panel.py::pchol_panel`` (the Pallas kernel
``_pchol_panel_kernel``).  ``pchol_panel`` launches
``csrc/pchol_panel.cu`` for CUDA tensors and runs ``pchol_panel_plain``,
which mirrors the Pallas kernel step by step, for CPU tensors.  The
trailing Schur update ``a -= stripᵀ·strip`` is the caller's
(``tgq_torch.solver.pchol``), as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tgq_torch.kernels import _build

launches = 0  # kernel launches of pchol_panel (CUDA only)
_fits: dict[tuple[int, int, int], int] = {}  # (device, threads, smem) -> blocks/SM
_K1_MAX_THREADS = 1024
_K1_STATIC_SMEM = 64  # the kernel's static shared memory (the step's key), rounded up


class K1Plan(NamedTuple):
    grid: int       # cooperative blocks, at most one an SM
    tile: int       # columns a block (the last block may own fewer)
    threads: int    # threads a block (a multiple of 32, >= tile up to 1024)
    rows_smem: int  # strip rows held in shared memory (the rest in global)
    smem: int       # dynamic shared memory bytes a block


def pchol_panel_plain(a: torch.Tensor, d: torch.Tensor, done: torch.Tensor,
                      panel: int = 128, steps: int | None = None):
    """Plain PyTorch version of the panel kernel — same contract as
    :func:`pchol_panel`.  Runs ``steps`` (default ``panel``) pivot steps;
    strip rows past ``steps`` stay zero."""
    n = a.shape[0]
    steps = panel if steps is None else steps
    dev = a.device
    lane = torch.arange(n, device=dev)
    strip = torch.zeros((panel, n), dtype=torch.float32, device=dev)
    d = d.clone()
    done = done.clone()
    perm = torch.zeros((1, panel), dtype=torch.int32, device=dev)
    ph = torch.zeros((1, panel), dtype=torch.float32, device=dev)
    for k in range(steps):
        dm = torch.where(done > 0, -torch.inf, d)
        m = dm.max()
        piv = torch.where(dm == m, lane, n).min()
        dk = torch.clamp(m, min=0.0)
        onehot = lane == piv
        # deferred Schur-row correction, summed in step order with each
        # product rounded before the add (the kernel's order, so the two
        # agree bit for bit)
        s_col = strip.index_select(1, piv.reshape(1))[:, 0]  # (panel,)
        row_sub = torch.zeros((1, n), dtype=torch.float32, device=dev)
        for t in range(k):
            row_sub = row_sub + s_col[t] * strip[t]
        row = a.index_select(0, piv.reshape(1)) - row_sub
        inv = torch.where(dk > 0, 1.0 / torch.sqrt(torch.clamp(dk, min=1e-30)), 0.0)
        l = row * inv
        l = torch.where(done > 0, 0.0, l)
        l = torch.where(onehot, torch.sqrt(dk), l)
        strip[k] = l[0]
        perm[0, k] = piv.to(torch.int32)
        ph[0, k] = dk
        done = torch.maximum(done, onehot.to(done.dtype))
        d = torch.where(done > 0, 0.0, torch.clamp(d - l * l, min=0.0))
    return strip, d, done, perm, ph


def _check(a, d, done, panel, steps):
    n = a.shape[0]
    if a.dtype != torch.float32 or d.dtype != torch.float32 or done.dtype != torch.float32:
        raise TypeError("pchol_panel takes float32 a, d, done")
    if a.shape != (n, n) or d.shape != (1, n) or done.shape != (1, n):
        raise ValueError(f"pchol_panel shapes: a {tuple(a.shape)}, d "
                         f"{tuple(d.shape)}, done {tuple(done.shape)}")
    if not (a.is_contiguous() and d.is_contiguous() and done.is_contiguous()):
        raise ValueError("pchol_panel takes contiguous tensors")
    if len({a.device, d.device, done.device}) != 1:
        raise ValueError("pchol_panel: tensors on different devices")
    if not (1 <= panel and 0 <= steps <= panel and n >= 1):
        raise ValueError(f"pchol_panel: panel={panel} steps={steps} n={n}")


def _k1_plan(n: int, panel: int, sms: int, smem_limit: int) -> K1Plan:
    """Cooperative grid and column tiles of ``csrc/pchol_panel.cu``.

    At most one block per SM, at least 32 columns a block; block g owns
    columns [g*tile, min(n, (g+1)*tile)).  The tile's strip rows, d, done
    and the pivot's strip column sit in shared memory; strip rows past what
    ``smem_limit`` holds stay in global memory (``rows_smem < panel``)."""
    blocks = max(1, min(sms, -(-n // 32)))
    tile = -(-n // blocks)
    grid = -(-n // tile)
    threads = min(_K1_MAX_THREADS, 32 * -(-tile // 32))
    fixed = 4 * (2 * tile + panel)
    budget = smem_limit - _K1_STATIC_SMEM - fixed
    if budget < 0:
        raise ValueError(f"pchol_panel: n={n} needs {fixed} B of shared memory a block")
    rows_smem = min(panel, budget // (4 * tile))
    return K1Plan(grid=grid, tile=tile, threads=threads, rows_smem=rows_smem,
                  smem=fixed + 4 * rows_smem * tile)


def pchol_panel(a: torch.Tensor, d: torch.Tensor, done: torch.Tensor,
                panel: int = 128, steps: int | None = None):
    """Run ``steps`` (default ``panel``) greedy pivot steps against the
    Schur complement ``a``.

    a:    (n, n) f32, the Schur complement as of the panel start.
    d:    (1, n) f32 conditional variances (0 at spent pivots).
    done: (1, n) f32 spent-pivot mask (1.0 = spent).

    Returns (strip (panel, n), d', done', perm (1, panel) i32,
    pivhist (1, panel) f32).  CUDA tensors launch the kernel; CPU tensors
    run :func:`pchol_panel_plain`.
    """
    global launches
    steps = panel if steps is None else steps
    _check(a, d, done, panel, steps)
    if a.device.type == "cpu":
        return pchol_panel_plain(a, d, done, panel=panel, steps=steps)
    if a.device.type != "cuda":
        raise ValueError(f"pchol_panel: unsupported device {a.device}")
    lib = _build.lib()
    n = a.shape[0]
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    sms, smem_limit = _build.device_limits(lib, dev)
    plan = _k1_plan(n, panel, sms, smem_limit)
    key = (dev, plan.threads, plan.smem)
    if key not in _fits:
        _fits[key] = lib.tgq_pchol_panel_blocks_per_sm(dev, plan.threads, plan.smem)
    if _fits[key] < 1 or plan.grid > sms * _fits[key]:
        raise RuntimeError(f"pchol_panel: plan {plan} is not co-resident on device {dev}")
    strip = torch.empty((panel, n), dtype=torch.float32, device=a.device)
    d_out = torch.empty_like(d)
    done_out = torch.empty_like(done)
    perm = torch.empty((1, panel), dtype=torch.int32, device=a.device)
    ph = torch.empty((1, panel), dtype=torch.float32, device=a.device)
    strip_t = torch.empty((n, panel), dtype=torch.float32, device=a.device)
    # per step: a u64 argmax key, then (after all keys) a u32 arrival count; zero
    slots = max(steps, 1)
    sync = torch.zeros((3 * slots,), dtype=torch.int32, device=a.device)
    err = lib.tgq_pchol_panel(
        a.data_ptr(), d.data_ptr(), done.data_ptr(), strip.data_ptr(),
        d_out.data_ptr(), done_out.data_ptr(), perm.data_ptr(), ph.data_ptr(),
        strip_t.data_ptr(), sync.data_ptr(), sync.data_ptr() + 8 * slots, n, panel, steps,
        plan.grid, plan.tile, plan.threads, plan.rows_smem, plan.smem, dev,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "pchol_panel launch")
    launches += 1
    return strip, d_out, done_out, perm, ph
