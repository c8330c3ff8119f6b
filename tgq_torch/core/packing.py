"""Packed sub-byte weight storage (mirrors ``tgq/core/packing.py``).

Byte-identical to the JAX package's layouts, so checkpoints load in both:

- **int8**: raw codes.
- **int4**: split-half — byte ``j`` holds code ``j`` (low nibble) and
  code ``j + n/2`` (high nibble), per quantization group.
- **int2**: split-quarter, the same idea with four codes a byte.
- **int3** ("planes21", pack layout v2): the codes' low two bits
  split-quarter packed, then the high bit split-eighth packed.

``PackedLinear`` is K-major: ``codes`` is (packed_in_bytes, out) uint8,
``scale``/``zero`` are (n_groups, out) f32.  Symmetric codes are stored
biased by ``+max_q`` and the bias is folded into ``zero``, so
dequantization is always ``(code - zero) * scale``.
"""
from __future__ import annotations

import dataclasses

import torch

from tgq_torch.core.quant import QuantSpec


def _split_pack(codes: torch.Tensor, per_byte: int, bits: int) -> torch.Tensor:
    """Pack ``per_byte`` equal contiguous chunks of the last axis into bytes."""
    *lead, n = codes.shape
    assert n % per_byte == 0, (n, per_byte)
    c = codes.to(torch.int32).reshape(*lead, per_byte, n // per_byte)
    shifts = (torch.arange(per_byte, dtype=torch.int32, device=codes.device)
              * bits).reshape(*(1 for _ in lead), per_byte, 1)
    return (c << shifts).sum(dim=-2).to(torch.uint8)


def _split_unpack(packed: torch.Tensor, per_byte: int, bits: int) -> torch.Tensor:
    w = packed.to(torch.int32)
    mask = (1 << bits) - 1
    return torch.cat([(w >> (i * bits)) & mask for i in range(per_byte)], dim=-1)


def _planes21_pack(codes: torch.Tensor) -> torch.Tensor:
    c = codes.to(torch.int32)
    lo = _split_pack(c & 0x3, 4, 2)            # (..., n/4)
    hi = _split_pack((c >> 2) & 0x1, 8, 1)     # (..., n/8)
    return torch.cat([lo, hi], dim=-1)         # (..., 3n/8)


def _planes21_unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    lo = _split_unpack(packed[..., : n // 4], 4, 2)
    hi = _split_unpack(packed[..., n // 4:], 8, 1)
    return lo | (hi << 2)


def _group(n: int, group_size: int | None) -> int:
    return group_size if (group_size and 0 < group_size < n and n % group_size == 0) else n


def pack_rows(codes: torch.Tensor, bits: int, group_size: int | None = None) -> torch.Tensor:
    """Pack non-negative integer codes along the last axis, within each
    quantization group."""
    *lead, n = codes.shape
    g = _group(n, group_size)
    cg = codes.reshape(*lead, n // g, g)
    if bits == 8:
        out = cg.to(torch.uint8)
    elif bits == 4:
        out = _split_pack(cg, 2, 4)
    elif bits == 2:
        out = _split_pack(cg, 4, 2)
    elif bits == 3:
        out = _planes21_pack(cg)
    else:
        raise ValueError(f"unsupported bit width {bits}")
    return out.reshape(*lead, -1)


def unpack_rows(packed: torch.Tensor, bits: int, group_size: int | None = None,
                in_features: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack_rows`; returns int32 codes."""
    *lead, nbytes = packed.shape
    n = in_features if in_features is not None else nbytes * 8 // bits
    g = _group(n, group_size)
    pg = packed.reshape(*lead, n // g, g * bits // 8)
    if bits == 8:
        out = pg.to(torch.int32)
    elif bits == 4:
        out = _split_unpack(pg, 2, 4)
    elif bits == 2:
        out = _split_unpack(pg, 4, 2)
    elif bits == 3:
        out = _planes21_unpack(pg, g)
    else:
        raise ValueError(f"unsupported bit width {bits}")
    return out.reshape(*lead, n)


@dataclasses.dataclass
class PackedLinear:
    """A quantized linear layer: K-major packed codes plus per-group
    scale/zero (see the module docstring), and an optional dense bias."""

    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    group_size: int
    in_features: int
    out_features: int
    bias: torch.Tensor | None = None

    @classmethod
    def from_codes(
        cls, q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
        spec: QuantSpec, bias: torch.Tensor | None = None,
    ) -> "PackedLinear":
        """From signed/unsigned integer codes (out, in) + per-group params."""
        m, n = q.shape
        code_bias = spec.max_q if spec.sym else 0
        stored = (q + code_bias).to(torch.int32)
        g = spec.group_size if spec.group_size > 0 else n
        return cls(
            codes=pack_rows(stored, spec.bits, group_size=g).T.contiguous(),
            scale=scale.float().T.contiguous(),
            zero=(zero + code_bias).float().T.contiguous(),
            bits=spec.bits,
            group_size=g,
            in_features=n,
            out_features=m,
            bias=None if bias is None else bias.float(),
        )

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Full dequantization to (out, in)."""
        q = unpack_rows(self.codes.T, self.bits, group_size=self.group_size,
                        in_features=self.in_features).float()
        reps = self.in_features // self.scale.shape[0]
        scale = self.scale.T.repeat_interleave(reps, dim=1)
        zero = self.zero.T.repeat_interleave(reps, dim=1)
        return ((q - zero) * scale).to(dtype)



def concat_out(parts: list[PackedLinear]) -> PackedLinear:
    """Fuse projections that share an input by concatenating along
    out_features (exact: groups run along in_features)."""
    p0 = parts[0]
    for p in parts[1:]:
        assert (p.bits, p.group_size, p.in_features) == (
            p0.bits, p0.group_size, p0.in_features), (p, p0)
    if any(p.bias is not None for p in parts):
        bias = torch.cat([
            p.bias if p.bias is not None
            else torch.zeros((p.out_features,), dtype=torch.float32,
                             device=p.codes.device)
            for p in parts], dim=-1)
    else:
        bias = None
    return PackedLinear(
        codes=torch.cat([p.codes for p in parts], dim=-1),
        scale=torch.cat([p.scale for p in parts], dim=-1),
        zero=torch.cat([p.zero for p in parts], dim=-1),
        bits=p0.bits,
        group_size=p0.group_size,
        in_features=p0.in_features,
        out_features=sum(p.out_features for p in parts),
        bias=bias,
    )


def pad_out(p: PackedLinear, multiple: int = 512) -> PackedLinear:
    """Zero-pad out_features up to a multiple (pad columns dequantize to
    ~0; callers slice the logits back)."""
    m = p.out_features
    m_pad = -(-m // multiple) * multiple
    if m_pad == m:
        return p
    pc = m_pad - m
    pad2 = lambda t: torch.nn.functional.pad(t, (0, pc))  # noqa: E731
    return PackedLinear(
        codes=pad2(p.codes),
        scale=pad2(p.scale),
        zero=pad2(p.zero),
        bits=p.bits,
        group_size=p.group_size,
        in_features=p.in_features,
        out_features=m_pad,
        bias=None if p.bias is None else pad2(p.bias),
    )
