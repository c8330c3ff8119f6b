"""Causal flash attention K6: CUDA kernel and plain version.

Port of the attention behind ``tgq/models/causal_lm.py::_flash_causal_attention``
(the upstream Pallas TPU op ``jax.experimental.pallas.ops.tpu.flash_attention``,
forward body ``_flash_attention_kernel_single_batch``).  It is the attention
of every whole-sequence forward: calibration, strided perplexity, KV
equalizer calibration, prefill and the GPT-2 / OPT families.
``flash_causal_attention`` launches ``csrc/causal_attention.cu`` for CUDA
tensors and runs ``causal_attention_plain`` for CPU tensors.

At head_dim 64 and 128 the kernel is built for Hopper: persistent blocks,
one an SM, in which a producer warpgroup loads 128-row tiles by TMA (a 4-D
tensor map of q, k, v and o each, encoded at every launch from their
strides) and two consumer warpgroups run both products on ``wgmma`` and
store o by TMA; head_dim 16 keeps an ``mma.sync`` body.  A layout that
TMA refuses raises; nothing falls back.

Layout (b, s, h, d) for q and (b, s, kv, d) for k and v, h a multiple of
kv (GQA: query head i reads kv head i // (h // kv)).  The kernel rounds the
probabilities to bf16 before P·V, as the TPU body does; the plain version
keeps them in f32.  So the two differ by at most 2^-8 (bf16's relative
rounding) of Σ_j p_ij·|v_j| per element, plus the output's own bf16
rounding: :func:`tolerance` states that bound.

Gradients: :class:`FlashCausalAttention` makes K6 differentiable.  When
grad mode is on and an input requires grad, its forward asks the kernel
for its stats output as well (each row's log2-sum-exp, K6-bwd's input; o's
bits do not change) and saves q, k, v, o and the stats; its backward is
K6-bwd (``causal_attention_bwd.flash_causal_attention_bwd``: two CUDA
kernels on CUDA tensors, the plain backward on CPU tensors).  Under
``torch.no_grad()`` (calibration, PPL, equalizers, prefill) nothing is
saved and no stats are written: the same launch as before.
"""
from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from tgq_torch.kernels import _build
from tgq_torch.kernels.causal_attention_bwd import flash_causal_attention_bwd, lse_plain

launches = 0  # kernel launches of flash_causal_attention (CUDA only)
HEAD_DIMS = (16, 64, 128)  # the kernel's template instances


def causal_attention_plain(q, k, v, sm_scale: float | None = None):
    """Masked softmax attention in f32 (mask value -1e30); output in q's
    dtype.  q: (b, s, h, d); k, v: (b, s, kv, d).  Returns (b, s, h, d)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    logits = logits.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def tolerance(q, k, v, ref, sm_scale: float | None = None):
    """Per-element bound on |K6 - plain| (f32, ref's shape): 2^-8·Σ_j p_ij·|v_j|
    for the bf16 probabilities (relative rounding error at most 2^-8, at
    whatever running max they are taken), a 2^-12 share of the same sum
    for f32 sums in another order, and 2 bf16 ulps of the reference element
    for the two outputs' own roundings."""
    mag = causal_attention_plain(q.float(), k.float(), v.float().abs(), sm_scale)
    ulp = torch.ldexp(torch.ones_like(mag),
                      torch.frexp(ref.float().abs().clamp_min(2.0 ** -126))[1] - 8)
    return (2.0 ** -8 + 2.0 ** -12) * mag + 2 * ulp


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"causal attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or kv == 0 or h % kv != 0:
        raise ValueError(f"causal attention: q {tuple(q.shape)} against k/v {tuple(k.shape)} "
                         f"(b, s, d equal; heads a multiple of kv heads)")
    if d not in HEAD_DIMS:
        raise ValueError(f"causal attention: head_dim {d} (the kernel takes {HEAD_DIMS})")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"causal attention takes bfloat16 q, k, v "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"causal attention: {name} needs a contiguous feature axis and "
                             f"16-byte aligned rows (strides {t.stride()})")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("causal attention: tensors on different devices")


def _launch_error(err: int) -> str:
    """The C entry's code as a message: -(1000·t + r) is TMA's refusal of
    tensor t's layout (1 q, 2 k, 3 v, 4 o) with the driver's CUresult r."""
    if err < 0:
        t, r = divmod(-err, 1000)
        name = {1: "q", 2: "k", 3: "v", 4: "o"}.get(t, "?")
        return f"causal attention: TMA refused the layout of {name} (CUresult {r})"
    return f"causal attention launch: CUDA error {err}"


def _forward(q, k, v, scale: float, stats: bool):
    """(o, stats or None): K6 on CUDA tensors, the plain version on CPU
    tensors; ``stats`` asks for the (b, h, s) f32 log2-sum-exp as well."""
    global launches
    if q.device.type == "cpu":
        out = causal_attention_plain(q, k, v, scale)
        return out, lse_plain(q, k, scale) if stats else None
    if q.device.type != "cuda":
        raise ValueError(f"causal attention: unsupported device {q.device}")
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if stats else None
    lib = _build.lib()
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    err = lib.tgq_causal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, s, h, k.shape[2], d, float(scale), dev,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(_launch_error(err))
    launches += 1
    return out, lse


class FlashCausalAttention(torch.autograd.Function):
    """K6 with K6-bwd as its gradient (the TPU op's custom_vjp): the
    forward saves q, k, v, o and K6's stats; the backward returns bf16 dq,
    dk, dv (dk, dv summed over each GQA group).  Once differentiable, as
    the upstream rule (higher-order gradients raise)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _forward(q, k, v, scale, stats=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_causal_attention_bwd(q, k, v, out, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_causal_attention(q, k, v, sm_scale: float | None = None):
    """Causal attention with the contract of :func:`causal_attention_plain`
    (up to :func:`tolerance`).  CUDA tensors launch the kernel; CPU tensors
    run the plain version.  Takes any sequence length >= 0 and a softmax
    scale > 0 (the kernel takes the running max of the unscaled scores).
    Differentiable (:class:`FlashCausalAttention`) when grad mode is on and
    an input requires grad."""
    _check(q, k, v)
    if sm_scale is not None and not sm_scale > 0:
        raise ValueError(f"causal attention: sm_scale must be > 0 (got {sm_scale})")
    scale = 1.0 / math.sqrt(q.shape[3]) if sm_scale is None else float(sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashCausalAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale, stats=False)[0]
