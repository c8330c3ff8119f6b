"""In-block sequential GPTQ sweep: CUDA kernel and plain version.

Port of ``tgq/kernels/gptq_block.py::process_block_pallas`` (the Pallas
kernel ``_gptq_block_kernel``).  On the TPU the jnp loop was the default
because one core already vectorises the rows; on a GPU thread blocks
parallelise rows, so ``process_block`` — the kernel in
``csrc/gptq_block.cu`` — is the CUDA main path.  ``process_block_plain``
mirrors ``tgq/solver/gptq_loop.py::_process_block_jnp`` and serves CPU
tensors; both round every operation alike, so their codes agree bit for
bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tgq_torch.kernels import _build

launches = 0  # kernel launches of process_block (CUDA only)
_K2_MAX_COLS = 512  # widest block of the tiled kernel
_K2_TILES = (32, 64, 96, 128)  # rows a block, one sweeping thread each


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a·b + c`` rounded once, as a fused multiply-add.  The product
    of two f32 is exact in f64; the f64 sum is made round-to-odd (TwoSum
    gives its exact error, and an inexact sum with an even last bit moves
    one ulp toward it), so its rounding to f32 is the single rounding of
    the exact value (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    odd = (s.view(torch.int64) & 1) == 1
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & ~odd, torch.nextafter(s, toward), s)
    return s.float()


def process_block_plain(w, s, z, r, min_q: int, max_q: int):
    """Sequential in-block loop.

    w, s, z: (m, b) permuted weight/scale/zero block
    r:       (b, b) upper-triangular propagation block
    Returns (codes (m,b), e_scaled (m,b)) with e_scaled[:,k] = (w-q̂)/r[k,k].
    """
    m, b = w.shape
    w = w.clone()
    q = torch.zeros_like(w)
    e = torch.zeros_like(w)
    for k in range(b):
        wk, sk, zk = w[:, k], s[:, k], z[:, k]
        qk = torch.clamp(torch.floor(wk / sk + zk + 0.5), min_q, max_q)
        ek = _fma(-(qk - zk), sk, wk) / r[k, k]
        w[:, k + 1:] = _fma(-ek[:, None], r[k, k + 1:][None, :], w[:, k + 1:])
        q[:, k] = qk
        e[:, k] = ek
    return q, e


class K2Plan(NamedTuple):
    tm: int    # rows a block (a multiple of 32 up to 128); 0 = the wide kernel (b > 512)
    smem: int  # dynamic shared memory bytes a block of the tiled kernel


def _k2_smem(tm: int, b: int) -> int:
    """Row tile (tm x (B + 4)), two stages of R's 32 rows with the s and z
    tiles (tm x 32 each), and 32 x (tm + 4) errors, with B = b rounded up
    to 32 (``csrc/gptq_block.cu``)."""
    pad = 32 * -(-b // 32)
    return 4 * (tm * (pad + 4) + 2 * (32 * pad + 64 * tm) + 32 * (tm + 4))


def _k2_plan(m: int, b: int, sms: int, smem_limit: int) -> K2Plan:
    """Row tile of ``csrc/gptq_block.cu``: one block an SM, the tile that
    needs the fewest waves of blocks over the SMs, the smaller on a tie (a
    sweeping thread's chain is the same at every tile, the propagation work
    a block grows with it).  Blocks wider than 512 columns take the wide
    kernel."""
    if b > _K2_MAX_COLS:
        return K2Plan(tm=0, smem=0)
    best = None
    for tm in _K2_TILES:
        smem = _k2_smem(tm, b)
        if smem > smem_limit:
            break
        waves = -(-(-(-m // tm)) // sms)
        if best is None or waves < best[0]:
            best = (waves, K2Plan(tm=tm, smem=smem))
    if best is None:
        raise ValueError(f"process_block: b={b} does not fit {smem_limit} B of shared memory")
    return best[1]


def process_block(w, s, z, r, min_q: int, max_q: int):
    """In-block GPTQ sweep with the contract of :func:`process_block_plain`.
    CUDA tensors launch the kernel; CPU tensors run the plain version.
    Takes any m and b."""
    global launches
    m, b = w.shape
    ts = (w, s, z, r)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("process_block takes float32 w, s, z, r")
    if s.shape != (m, b) or z.shape != (m, b) or r.shape != (b, b):
        raise ValueError(f"process_block shapes: w {tuple(w.shape)}, s {tuple(s.shape)}, "
                         f"z {tuple(z.shape)}, r {tuple(r.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("process_block takes contiguous tensors")
    if len({t.device for t in ts}) != 1:
        raise ValueError("process_block: tensors on different devices")
    if w.device.type == "cpu":
        return process_block_plain(w, s, z, r, min_q, max_q)
    if w.device.type != "cuda":
        raise ValueError(f"process_block: unsupported device {w.device}")
    lib = _build.lib()
    q = torch.empty_like(w)
    e = torch.empty_like(w)
    dev = w.device.index if w.device.index is not None else torch.cuda.current_device()
    plan = _k2_plan(m, b, *_build.device_limits(lib, dev))
    err = lib.tgq_gptq_block(
        w.data_ptr(), s.data_ptr(), z.data_ptr(), r.data_ptr(), q.data_ptr(),
        e.data_ptr(), m, b, plan.tm, plan.smem, float(min_q), float(max_q), dev,
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "process_block launch")
    launches += 1
    return q, e
