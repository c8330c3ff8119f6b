"""Blockwise column-sequential GPTQ quantization (mirrors
``tgq/solver/gptq_loop.py``).

- in-block: the sequential column sweep ``process_block`` (the CUDA
  kernel on the card; its plain version on the CPU, or anywhere with
  ``backend="plain"``).
- inter-block: one exact-f32 GEMM ``W[:, i2:] -= E·R[i1:i2, i2:]`` (TF32
  is off; the JAX package leaves the same product to XLA).

The factor's full (n, n) R with identity rows past the rank makes one
pass over all n columns cover the in-rank GPTQ columns and the RTN tail.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tgq_torch.core.quant import QuantSpec, expand_params, find_params
from tgq_torch.kernels.gptq_block import process_block, process_block_plain
from tgq_torch.solver.factorize import FactorResult


@dataclasses.dataclass
class QuantizeResult:
    codes: torch.Tensor      # (m, n) int32 codes, original column order
    w_q: torch.Tensor        # (m, n) f32 dequantized weight, original order
    scale: torch.Tensor      # (m, n_groups) f32
    zero: torch.Tensor       # (m, n_groups) f32
    rel_error: float | torch.Tensor  # ‖(W−Wq)R_xᵀ‖/‖W R_xᵀ‖, nan without R_x


def _quantize_permuted(w_p, s_p, z_p, r_full, spec: QuantSpec, block_size: int,
                       block_fn):
    """Blockwise pass over the permuted weight; returns codes (m, n)."""
    m, n = w_p.shape
    B = block_size
    pad = (-n) % B
    w_cur = torch.nn.functional.pad(w_p, (0, pad))
    if pad:
        s_p = torch.nn.functional.pad(s_p, (0, pad), value=1.0)
        z_p = torch.nn.functional.pad(z_p, (0, pad))
        r_full = torch.nn.functional.pad(r_full, (0, pad, 0, pad))
        idx = torch.arange(n, n + pad, device=r_full.device)
        r_full[idx, idx] = 1.0
    npad = n + pad
    codes = torch.empty((m, npad), dtype=torch.float32, device=w_p.device)
    for i1 in range(0, npad, B):
        i2 = i1 + B
        q1, e1 = block_fn(w_cur[:, i1:i2].contiguous(), s_p[:, i1:i2].contiguous(),
                          z_p[:, i1:i2].contiguous(),
                          r_full[i1:i2, i1:i2].contiguous(), spec.min_q, spec.max_q)
        codes[:, i1:i2] = q1
        if i2 < npad:
            w_cur[:, i2:].addmm_(e1, r_full[i1:i2, i2:], alpha=-1.0)
    return codes[:, :n]


def _as_tensor(x, dtype, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def rel_error(w, w_q, perm, r_x) -> torch.Tensor:
    """‖(W−Wq)R_xᵀ‖/‖W R_xᵀ‖ in permuted order (a device scalar)."""
    w_p = w.float()[:, perm]
    wq_p = w_q[:, perm]
    return torch.linalg.norm((w_p - wq_p) @ r_x.T) / torch.linalg.norm(w_p @ r_x.T)


def quantize_weight(w: torch.Tensor, factor: FactorResult, spec: QuantSpec,
                    block_size: int = 256, backend: str = "kernel",
                    with_error: bool = True) -> QuantizeResult:
    """Quantize an (out, in) weight with GPTQ error propagation.

    ``factor`` comes from any solver in tgq_torch.solver.  ``backend``
    "kernel" sweeps blocks with the CUDA kernel for a CUDA ``w`` (the
    plain version for a CPU ``w``); "plain" uses the plain version."""
    if backend not in ("kernel", "plain"):
        raise ValueError(f"unknown kernel backend {backend!r}")
    block_fn = process_block if backend == "kernel" else process_block_plain
    dev = w.device
    m, n = w.shape
    w = w.float()
    r_full = _as_tensor(factor.r_full, torch.float32, dev)
    perm = _as_tensor(factor.perm, torch.int64, dev)
    params = find_params(w, spec)  # pre-permutation => static groups
    s_full, z_full = expand_params(params, n)
    s_p, z_p = s_full[:, perm], z_full[:, perm]
    codes_p = _quantize_permuted(w[:, perm], s_p, z_p, r_full, spec, block_size,
                                 block_fn)
    wq_p = (codes_p - z_p) * s_p
    inv_perm = torch.argsort(perm)
    codes = codes_p[:, inv_perm].to(torch.int32)
    w_q = wq_p[:, inv_perm]
    rel = float("nan")
    if with_error and factor.r_x is not None:
        rel = rel_error(w, w_q, perm, _as_tensor(factor.r_x, torch.float32, dev))
    return QuantizeResult(codes=codes, w_q=w_q, scale=params.scale,
                          zero=params.zero, rel_error=rel)
