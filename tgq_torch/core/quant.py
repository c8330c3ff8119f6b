"""Uniform affine quantization math (mirrors ``tgq/core/quant.py``).

- symmetric:  max_q = 2^(b-1)-1, min_q = -max_q,
              scale = clamp(amax|w|, 1e-5) / max_q, zero = 0
- asymmetric: max_q = 2^b-1, min_q = 0,
              scale = clamp(max-min, 1e-5) / max_q,
              zero  = clip(round(-min/scale), 0, max_q)
- groups of ``group_size`` along the input dimension (-1 = one group per
  output row).  Group params are computed on the unpermuted weight
  ("static groups").

Rounding is floor(x + 0.5) everywhere — round-half-up, not the
half-to-even ``torch.round`` — so codes match the JAX package bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

SCALE_FLOOR = 1e-5


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static quantization configuration."""

    bits: int = 4
    group_size: int = 128  # -1 => one group spanning the whole input dim
    sym: bool = False

    @property
    def max_q(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.sym else 2**self.bits - 1

    @property
    def min_q(self) -> int:
        return -(2 ** (self.bits - 1) - 1) if self.sym else 0

    def groups_for(self, in_features: int) -> int:
        g = self.group_size if self.group_size > 0 else in_features
        if in_features % g != 0:
            raise ValueError(f"in_features={in_features} not divisible by group_size={g}")
        return in_features // g


@dataclasses.dataclass
class QuantParams:
    """Per-group scale/zero, shape (out_features, n_groups)."""

    scale: torch.Tensor
    zero: torch.Tensor


def round_half_up(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x + 0.5)


def find_params(w: torch.Tensor, spec: QuantSpec) -> QuantParams:
    """Per-group scale/zero of an (out, in) weight matrix."""
    m, n = w.shape
    spec.groups_for(n)
    g = spec.group_size if spec.group_size > 0 else n
    wg = w.reshape(m, n // g, g)
    # x * (1/max_q), not x / max_q: XLA rewrites a division by a constant
    # into this product, and the scales must match the JAX package's bits
    inv_max_q = 1.0 / spec.max_q
    if spec.sym:
        amax = torch.clamp(wg.abs().amax(dim=2), min=SCALE_FLOOR)
        scale = amax * inv_max_q
        zero = torch.zeros_like(scale)
    else:
        mn = wg.amin(dim=2)
        mx = wg.amax(dim=2)
        scale = torch.clamp(mx - mn, min=SCALE_FLOOR) * inv_max_q
        zero = torch.clamp(round_half_up(-mn / scale), 0, spec.max_q)
    return QuantParams(scale=scale, zero=zero)


def expand_params(params: QuantParams, in_features: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Repeat per-group params to the full (out, in) width."""
    reps = in_features // params.scale.shape[1]
    return (params.scale.repeat_interleave(reps, dim=1),
            params.zero.repeat_interleave(reps, dim=1))


def quantize(w: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
             spec: QuantSpec) -> torch.Tensor:
    """w -> integer codes (as floats), full-width scale/zero."""
    q = round_half_up(w / scale + zero)
    return torch.clamp(q, spec.min_q, spec.max_q)


def dequantize(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    return (q.to(scale.dtype) - zero) * scale


def fake_quantize(w: torch.Tensor, spec: QuantSpec,
                  params: Optional[QuantParams] = None) -> torch.Tensor:
    """Round-to-nearest quantize-dequantize (the RTN baseline)."""
    if params is None:
        params = find_params(w, spec)
    scale, zero = expand_params(params, w.shape[1])
    return dequantize(quantize(w, scale, zero, spec), scale, zero)
