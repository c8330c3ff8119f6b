"""Exact-f32 matmuls and device resolution.

The solver's GEMMs (Schur updates of the pivoted-Cholesky sweep, the
factor build, the GPTQ inter-block propagation) need genuine f32: with
reduced-precision Schur updates the pivot noise floor swallowed the
bulk of an outlier-channel spectrum (pchol rank 735 -> 8, see
``tgq/solver/pchol.py:60-76``).  TF32 keeps about three decimal digits,
so it is switched off for matmuls and convolutions alike — the same
choice the reference makes (gptq_utils.py:474-475).
"""
from __future__ import annotations

import torch


def exact_f32_matmul() -> None:
    """Disable TF32 everywhere; f32 matmuls run in full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks
    for the CPU; raises when CUDA is asked for and absent — there is no
    silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tgq_torch: CUDA is not available; pass device='cpu' to "
                "run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"tgq_torch: unsupported device {device!r}")
    return dev
