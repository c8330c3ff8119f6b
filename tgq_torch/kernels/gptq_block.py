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

import torch

from tgq_torch.kernels import _build

launches = 0  # kernel launches of process_block (CUDA only)


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
        ek = (wk - (qk - zk) * sk) / r[k, k]
        w[:, k + 1:] -= ek[:, None] * r[k, k + 1:][None, :]
        q[:, k] = qk
        e[:, k] = ek
    return q, e


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
    err = lib.tgq_gptq_block(
        w.data_ptr(), s.data_ptr(), z.data_ptr(), r.data_ptr(), q.data_ptr(),
        e.data_ptr(), m, b, float(min_q), float(max_q), dev,
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "process_block launch")
    launches += 1
    return q, e
