"""Parameter trees between numpy and the port's tensors.

``params_from_numpy`` takes the JAX package's parameter tree fetched as
numpy arrays (``jax.tree.map(np.asarray, params)``: bf16 leaves arrive as
the 2-byte ``bfloat16`` numpy dtype, or as raw ``uint16`` bit views) and
returns the same tree of tensors, so both packages compute with the same
weights.  ``numpy_from_params`` goes the other way.  bf16 travels as its
16-bit pattern; no bf16 numpy dtype is needed here.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16"


def tensor_from_numpy(arr, device="cpu", bf16_bits: bool = False) -> torch.Tensor:
    """One leaf: a bfloat16-typed array (or, with ``bf16_bits``, a uint16
    bit view) becomes a bf16 tensor; everything else keeps its dtype."""
    arr = np.asarray(arr)
    if _is_bf16(arr) or (bf16_bits and arr.dtype == np.uint16):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dict/list of numpy arrays -> same structure of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def numpy_from_tensor(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    """bf16 tensors become uint16 bit views, or arrays of ``bf16_dtype``
    when the caller has a numpy bf16 dtype to view them as."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits if bf16_dtype is None else bits.view(bf16_dtype)
    return t.numpy()


def numpy_from_params(tree, bf16_dtype=None):
    """Tree of tensors -> same structure of numpy arrays."""
    if isinstance(tree, dict):
        return {k: numpy_from_params(v, bf16_dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_from_params(v, bf16_dtype) for v in tree]
    return numpy_from_tensor(tree, bf16_dtype)
