"""Packed-weight matmul: CUDA kernels K3 / K4 and their plain versions.

Port of ``tgq/kernels/dequant_matmul.py``.  ``quantized_matmul(x, w)``
computes ``x @ Wᵀ (+ bias)`` for a :class:`PackedLinear` ``w``:

- **K3** (``csrc/dequant_matmul.cu``, TPU original
  ``_dequant_matmul_kernel``): bf16 or f32 activations; per group the
  tensor cores take the exact bf16 ``q - z`` (``zero`` is integral)
  against x with an f32 accumulator, and ``acc += s·d`` folds in the
  group's scale, so only the order of the f32 sums differs from the plain
  version.  :func:`_k3_plan` picks the regime (decode t <= 8, prefill),
  the chunking and the split-K count.
  ``glu=True`` takes ``[gate | up]`` of width 2·in and multiplies by
  ``silu(gate)·up``, computed at load and rounded as :func:`glu_act`
  rounds it, so the fused form equals
  ``quantized_matmul(glu_act(gate, up), w)`` bit for bit.
- **K4** (``csrc/a8_matmul.cu``, TPU original ``_a8_matmul_kernel``),
  chosen when ``w.act_bits == 8 and w.bits in (2, 3, 4)``: per-token int8
  activations (:func:`quantize_activations`) times int8 ``q - z`` on the
  int8 tensor cores, an exact int32 dot per group, ``acc += dot·s[g, o]``
  in group order, times the token scale.  :func:`_k4_plan` picks the
  regime and the chunk.

CUDA tensors launch the kernel at every token count (the JAX package's
1024-token switch to dequantize-once is a TPU tuning and is not copied);
CPU tensors run the plain versions, which follow the JAX ``impl="xla"``
branch (dequantize, then an f32 matmul; A8 simulated by fake-quantized
activations) — except :func:`a8_matmul_plain`, which keeps K4's group
order so the two agree bit for bit.  There is no layer-stacked mode: a
per-layer ``PackedLinear`` (or a view ``stacked[li]``) is passed as is.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from tgq_torch.core.packing import PackedLinear
from tgq_torch.kernels import _build

launches = 0     # K3 launches (CUDA only)
launches_a8 = 0  # K4 launches (CUDA only)


def quantize_activations(x: torch.Tensor):
    """(T, K) → (int8 codes, (T, 1) f32 per-token scales): symmetric
    per-token absmax.  ``max|x| · (1/127)`` and not ``/ 127``: XLA folds
    the division by a constant into that product, and the codes and
    scales match the JAX package's bit for bit (``round`` is half to
    even in both)."""
    xf = x.float()
    a = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0), min=1e-10)
    return torch.round(xf / a).to(torch.int8), a


def glu_act(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate)·up rounded as the JAX package's ``jax.nn.silu(gate) * up``
    is on XLA: silu expands to gate · (1 / (1 + exp(-gate))) and, in a bf16
    computation, every step (exp, +1, reciprocal, ·gate, ·up) is computed
    in f32 and rounded back to the activations' dtype.  PyTorch's fused bf16
    silu rounds once, which moves a share of the products by a bf16 ulp and
    the calibration Hessians with them.  K3's GLU staging rounds the same
    steps the same way."""
    dt = gate.dtype
    e = torch.exp(-gate.float()).to(dt)
    sig = (1.0 / (e.float() + 1.0).to(dt).float()).to(dt)
    return ((gate.float() * sig.float()).to(dt).float() * up.float()).to(dt)


def _glu_split(x2: torch.Tensor, n: int) -> torch.Tensor:
    """``[gate | up]`` (..., 2n) → :func:`glu_act` (..., n)."""
    return glu_act(x2[..., :n], x2[..., n:])


def _out_dtype(w: PackedLinear, x: torch.Tensor, out_dtype):
    """The kernel's output dtype: f32 when a bias follows or f32 is asked
    for, else ``out_dtype`` (default: x's dtype)."""
    out_dtype = out_dtype or x.dtype
    return torch.float32 if (w.bias is not None or out_dtype == torch.float32) else out_dtype


def _finish(y: torch.Tensor, w: PackedLinear, out_dtype, lead) -> torch.Tensor:
    if w.bias is not None:
        y = y + w.bias.to(y.dtype)
    return y.to(out_dtype).reshape(*lead, w.out_features)


def dequant_matmul_plain(x2: torch.Tensor, w: PackedLinear, glu: bool = False) -> torch.Tensor:
    """K3's plain version: (t, K) or GLU (t, 2K) → (t, N) f32, before the
    bias.  With ``w.act_bits == 8`` (bits <= 4) the activations are
    fake-quantized per token first, as the JAX xla branch does."""
    xin = (_glu_split(x2, w.in_features) if glu else x2).float()
    if w.act_bits == 8 and w.bits in (2, 3, 4):
        x8, a = quantize_activations(xin)
        xin = x8.float() * a
    return xin @ w.dequantize(torch.float32).T


def a8_matmul_plain(x8: torch.Tensor, a: torch.Tensor, w: PackedLinear) -> torch.Tensor:
    """K4's plain version: (t, K) int8 codes and (t, 1) scales → (t, N)
    f32.  Each group's dot is exact (f64 products and sums of integers),
    and the f32 accumulation over groups rounds the product and the sum
    separately, in group order, as the kernel does."""
    from tgq_torch.core.packing import unpack_rows

    g = w.group_size
    q = unpack_rows(w.codes.T, w.bits, group_size=g, in_features=w.in_features)  # (N, K)
    qz = (q - w.zero.T.repeat_interleave(g, dim=1).to(torch.int32)).T.double()  # (K, N)
    xd = x8.double()
    acc = torch.zeros((x8.shape[0], w.out_features), dtype=torch.float32, device=x8.device)
    for gi in range(w.in_features // g):
        d = (xd[:, gi * g:(gi + 1) * g] @ qz[gi * g:(gi + 1) * g]).float()
        acc = acc + d * w.scale[gi]
    return acc * a


def _check(x2: torch.Tensor, w: PackedLinear) -> None:
    ts = (w.codes, w.scale, w.zero)
    if w.codes.dtype != torch.uint8 or w.scale.dtype != torch.float32 \
            or w.zero.dtype != torch.float32:
        raise TypeError("quantized_matmul: codes u8, scale/zero f32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("quantized_matmul: codes/scale/zero must be contiguous")
    if len({t.device for t in ts + (x2,)}) != 1:
        raise ValueError("quantized_matmul: tensors on different devices")
    g = w.group_size
    if g <= 0 or w.in_features % g:
        raise ValueError(f"quantized_matmul: group {g} does not divide {w.in_features}")


# K3's tiles and pipeline (csrc/dequant_matmul.cu::launch_k3_regime): 128
# output columns a block; per x mode (bf16, f32, bf16 GLU, f32 GLU) the
# token tile and the ring's stages; the blocks an SM holds by registers
# (ptxas on sm_90a: decode about 94 registers x 128 threads, prefill about
# 208 x 256)
_K3_BN = 128
_K3_CS = _K3_BN + 16         # code row stride in shared memory
_K3_MAX_SMEM = 227 * 1024
_K3_SM_SMEM = 228 * 1024     # shared memory of one SM
_K3_SMS = 132                # H100 SXM streaming multiprocessors
_K3_REGIMES = {"decode": dict(tile_t=(8, 8, 8, 8), stages=(4, 4, 4, 4), reg_blocks=5),
               "prefill": dict(tile_t=(128, 64, 64, 64), stages=(3, 3, 3, 2), reg_blocks=1)}


def _k3_smem(bits: int, units: int, tile_t: int, stages: int, x_f32: bool, glu: bool) -> int:
    """Shared memory of K3's ring, as ``k3_layout`` in the .cu lays it out."""
    per = 8 if bits == 3 else 8 // bits
    kc = units * per
    x_row = kc * (4 if x_f32 else 2) * (2 if glu else 1) + 16
    conv_row = kc * 2 * (2 if x_f32 else 1) + 16 if (x_f32 or glu) else 0
    stage = units * (3 if bits == 3 else 1) * _K3_CS + 2 * _K3_BN * 4 + tile_t * x_row
    return stages * (-(-stage // 128) * 128) + tile_t * conv_row


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """How K3 runs one call: the regime and its token tile, ``units`` code
    rows of one group per pipeline chunk (``chunk_k`` inputs), ``n_chunks``
    chunks over K split into ``split`` contiguous ranges (split-K), the
    shared memory a block takes and the f32 workspace the split-K sum
    needs (elements, 0 when ``split == 1``)."""

    regime: str
    tile_t: int
    tile_n: int
    units: int
    chunk_k: int
    n_chunks: int
    split: int
    smem: int
    workspace: int

    def split_bounds(self) -> list[tuple[int, int]]:
        """The chunk range of each split, as the kernel computes it."""
        n, s = self.n_chunks, self.split
        return [(n * i // s, n * (i + 1) // s) for i in range(s)]


def _chunk_units(upg: int, per: int, kc: int) -> int:
    """Code units of one group per chunk: the whole group if it holds at
    most ``kc`` inputs, else the largest multiple of 16 that divides the
    group's ``upg`` units and holds at most ``kc`` inputs (else the whole
    group)."""
    if upg * per <= kc:
        return upg
    fits = [u for u in range(16, kc // per + 1, 16) if upg % u == 0]
    return fits[-1] if fits else upg


@functools.lru_cache(maxsize=1024)
def _k3_plan(t: int, K: int, N: int, g: int, bits: int, x_f32: bool = False,
             glu: bool = False) -> K3Plan:
    """K3's launch plan for t tokens through a (K → N) W``bits`` g``g``
    matmul.  t <= 8 is decode, else prefill; chunks of up to 128 inputs
    (fewer only where the ring would not fit shared memory); split-K where
    the tiles leave part of one wave of resident blocks empty.  Raises
    ``ValueError`` for what the kernel does not take: ``g % 16 != 0`` (the
    mma's k-depth is 16)."""
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"K3: bits {bits} (2, 3, 4 or 8)")
    if g <= 0 or K % g:
        raise ValueError(f"K3: group {g} does not divide in_features {K}")
    if g % 16:
        raise ValueError(f"K3: group size {g} is not a multiple of 16 (the mma k-depth)")
    regime = "decode" if t <= 8 else "prefill"
    cfg = _K3_REGIMES[regime]
    per = 8 if bits == 3 else 8 // bits
    upg = g // per
    # the chunk and the split set the order of the sums: both are picked
    # for every x mode at once, so fused GLU and f32 x sum as bf16 x does
    modes = [(f32, gl) for f32 in (False, True) for gl in (False, True)]
    for kc in (128, 64, 32, 16):
        units = _chunk_units(upg, per, kc)
        chunk_k = units * per
        smems = [_k3_smem(bits, units, cfg["tile_t"][2 * f32 + gl], cfg["stages"][2 * f32 + gl],
                          f32, gl) for f32, gl in modes]
        if max(smems) <= _K3_MAX_SMEM:
            break
    else:
        raise ValueError(f"K3: a chunk of group {g} does not fit shared memory")
    mode = 2 * x_f32 + glu
    n_chunks = (K // g) * (upg // units)
    # split-K: as many splits as one wave of resident blocks holds (bf16 x's
    # tiles), at least 2 chunks a split
    tiles = max(1, -(-t // cfg["tile_t"][0]) * -(-N // _K3_BN))
    resident = _K3_SMS * min(cfg["reg_blocks"], _K3_SM_SMEM // smems[0])
    split = max(1, min(resident // tiles, n_chunks // 2))
    return K3Plan(regime=regime, tile_t=cfg["tile_t"][mode], tile_n=_K3_BN, units=units,
                  chunk_k=chunk_k, n_chunks=n_chunks, split=split, smem=smems[mode],
                  workspace=split * t * N if split > 1 else 0)


# K4's tile configs (csrc/a8_matmul.cu::launch_config, by number): decode,
# 32 columns x 8 tokens, a ring stage of 8 chunks with one warp on each
# (int32 partials summed in shared memory), 2 stages; wide decode, where
# 128-column tiles alone fill the card's SMs, 2 chunks a stage for 4 column
# warps each, 4 stages; prefill, 128 x 128 tiles, 3 stages
_K4_REGIMES = {"decode": dict(config=0, tile_t=8, tile_n=32, stages=2, k_warps=8),
               "prefill": dict(config=1, tile_t=128, tile_n=128, stages=3, k_warps=1),
               "decode_wide": dict(config=2, tile_t=8, tile_n=128, stages=4, k_warps=2)}
_K4_WIDE_MIN_TILES = _K3_SMS   # 128-column decode tiles from this many on


@dataclasses.dataclass(frozen=True)
class K4Plan:
    """How K4 runs one call: the regime, its tile, ``units`` code rows of
    one group per pipeline chunk (``chunk_k`` inputs, a multiple of the
    mma's k-depth 32), ``n_chunks`` chunks over K walked in order by every
    block (no split-K), the warps that take a ring stage's chunks (one
    each) and the shared memory a block takes."""

    regime: str
    config: int
    tile_t: int
    tile_n: int
    units: int
    chunk_k: int
    n_chunks: int
    k_warps: int
    smem: int


def _k4_smem(bits: int, units: int, tile_t: int, tile_n: int, stages: int,
             k_warps: int) -> int:
    """Shared memory of K4's ring (and its int32 reduction buffer), as
    ``k4_layout`` in the .cu lays it out."""
    per = 8 if bits == 3 else 8 // bits
    stage = (units * (3 if bits == 3 else 1) * (tile_n + 16) + 2 * tile_n * 4
             + tile_t * (units * per + 16))
    red = k_warps * tile_n * 8 * 4 if k_warps > 1 else 0   # the int32 partials
    return stages * k_warps * (-(-stage // 128) * 128) + red


@functools.lru_cache(maxsize=1024)
def _k4_plan(t: int, K: int, N: int, g: int, bits: int) -> K4Plan:
    """K4's launch plan for t tokens through a (K → N) W``bits``A8 g``g``
    matmul: t <= 8 is decode (128-column tiles where those alone fill the
    card's SMs), else prefill; chunks of up to 128 inputs.
    Raises ``ValueError`` for what the kernel does not take: bits other
    than 2/3/4 (|q - z| must fit int8 with room), ``g % 32 != 0`` (the
    int8 mma's k-depth)."""
    if bits not in (2, 3, 4):
        raise ValueError(f"K4: bits {bits} (2, 3 or 4)")
    if g <= 0 or K % g:
        raise ValueError(f"K4: group {g} does not divide in_features {K}")
    if g % 32:
        raise ValueError(f"K4: group size {g} is not a multiple of 32 (the int8 mma k-depth)")
    if t > 8:
        regime = "prefill"
    else:
        regime = "decode_wide" if -(-N // 128) >= _K4_WIDE_MIN_TILES else "decode"
    cfg = _K4_REGIMES[regime]
    per = 8 if bits == 3 else 8 // bits
    upg = g // per
    for kc in (128, 64, 32):
        units = _chunk_units(upg, per, kc)
        smem = _k4_smem(bits, units, cfg["tile_t"], cfg["tile_n"], cfg["stages"],
                        cfg["k_warps"])
        if smem <= _K3_MAX_SMEM:
            break
    else:
        raise ValueError(f"K4: a chunk of group {g} does not fit shared memory")
    return K4Plan(regime=regime, config=cfg["config"], tile_t=cfg["tile_t"],
                  tile_n=cfg["tile_n"], units=units,
                  chunk_k=units * per, n_chunks=(K // g) * (upg // units),
                  k_warps=cfg["k_warps"], smem=smem)


def a8_matmul(x8: torch.Tensor, a: torch.Tensor, w: PackedLinear,
              out_dtype=torch.float32) -> torch.Tensor:
    """K4 on activations already quantized by :func:`quantize_activations`:
    (t, K) int8 codes and (t, 1) f32 scales → (t, N) f32 or bf16 (the f32
    result rounded once), before the bias.  CUDA tensors launch the kernel;
    CPU tensors run :func:`a8_matmul_plain`."""
    global launches_a8
    _check(x8, w)
    if x8.dtype != torch.int8 or x8.dim() != 2 or x8.shape[1] != w.in_features:
        raise ValueError("a8_matmul: x8 must be (t, in_features) int8")
    if x8.device.type == "cpu":
        return a8_matmul_plain(x8, a, w).to(out_dtype)
    if x8.device.type != "cuda":
        raise ValueError(f"a8_matmul: unsupported device {x8.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a8_matmul: output dtype {out_dtype} (bf16 or f32)")
    t, n, m = x8.shape[0], w.in_features, w.out_features
    plan = _k4_plan(t, n, m, w.group_size, w.bits)
    x8 = x8.contiguous()
    if x8.data_ptr() % 16:  # the kernel copies x8 in 16-byte pieces
        x8 = x8.clone()
    a = a.float().reshape(t).contiguous()
    y = torch.empty((t, m), dtype=out_dtype, device=x8.device)
    vec = int(m % 16 == 0 and all(p.data_ptr() % 16 == 0 for p in (w.codes, w.scale, w.zero)))
    dev = x8.device.index if x8.device.index is not None else torch.cuda.current_device()
    err = _build.lib().tgq_a8_matmul(
        x8.data_ptr(), a.data_ptr(), w.codes.data_ptr(), w.scale.data_ptr(),
        w.zero.data_ptr(), y.data_ptr(), int(out_dtype == torch.bfloat16), t, n, m,
        w.group_size, w.bits, plan.units, plan.config, vec, dev,
        torch.cuda.current_stream(x8.device).cuda_stream)
    _build.check(err, "a8_matmul launch")
    launches_a8 += 1
    return y


def quantized_matmul(x: torch.Tensor, w: PackedLinear, out_dtype=None,
                     glu: bool = False) -> torch.Tensor:
    """x: (..., in) [GLU: (..., 2·in)] → (..., out) in ``out_dtype``
    (default x's dtype).  The bias, if any, is added in f32 after the
    kernel.  CUDA tensors launch K3 (or K4 for A8 weights); CPU tensors
    run the plain versions."""
    global launches
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    n, m = w.in_features, w.out_features
    k_in = 2 * n if glu else n
    if x.shape[-1] != k_in:
        raise ValueError(f"quantized_matmul: x has {x.shape[-1]} features, expected {k_in}")
    x2 = x.reshape(-1, k_in)
    _check(x2, w)
    a8 = w.act_bits == 8 and w.bits in (2, 3, 4)
    y_dtype = _out_dtype(w, x, out_dtype)
    if a8:  # activations quantized per token outside the kernel, as in the JAX package
        x8, a = quantize_activations(_glu_split(x2, n) if glu else x2)
        return _finish(a8_matmul(x8, a, w, out_dtype=y_dtype), w, out_dtype, lead)
    if x2.device.type == "cpu":
        return _finish(dequant_matmul_plain(x2, w, glu=glu).to(y_dtype), w, out_dtype, lead)
    if x2.device.type != "cuda":
        raise ValueError(f"quantized_matmul: unsupported device {x2.device}")
    if y_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantized_matmul: output dtype {y_dtype} (bf16 or f32)")
    lib = _build.lib()
    t = x2.shape[0]
    y = torch.empty((t, m), dtype=y_dtype, device=x2.device)
    dev = x2.device.index if x2.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    y_bf16 = int(y_dtype == torch.bfloat16)
    vec = int(m % 16 == 0 and all(p.data_ptr() % 16 == 0
                                  for p in (w.codes, w.scale, w.zero)))
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.float()
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:  # the kernel copies x in 16-byte pieces
        x2 = x2.clone()
    x_f32 = x2.dtype == torch.float32
    plan = _k3_plan(t, n, m, w.group_size, w.bits, x_f32=x_f32, glu=glu)
    ws = (torch.empty((plan.workspace,), dtype=torch.float32, device=x2.device)
          if plan.workspace else None)
    err = lib.tgq_dequant_matmul(
        x2.data_ptr(), int(x_f32), x2.shape[1], w.codes.data_ptr(), w.scale.data_ptr(),
        w.zero.data_ptr(), y.data_ptr(), y_bf16, None if ws is None else ws.data_ptr(),
        t, n, m, w.group_size, w.bits, int(glu), plan.units, plan.split,
        int(plan.regime == "prefill"), vec, dev, stream)
    _build.check(err, "dequant_matmul launch")
    launches += 1
    return _finish(y, w, out_dtype, lead)
