"""K6-bwd, the gradients of the causal flash attention: CUDA kernels and
plain version.

Port of the two upstream Pallas TPU kernels that ``jax.grad`` runs
through ``tgq/models/causal_lm.py::_flash_causal_attention``
(``jax.experimental.pallas.ops.tpu.flash_attention``: the custom_vjp's
backward rule, ``_flash_attention_bwd_dkv`` and ``_flash_attention_bwd_dq``).
``flash_causal_attention_bwd`` launches ``csrc/causal_attention_bwd.cu``
(a dQ kernel, then a dK / dV kernel) for CUDA tensors and runs
``causal_attention_bwd_plain`` for CPU tensors.  The autograd function
around K6 (``causal_attention.FlashCausalAttention``) calls it.

At head_dim 64 and 128 both kernels are built for Hopper as K6 is:
persistent blocks, one an SM, in which a producer warpgroup loads tiles by
TMA (4-D tensor maps of q, k, v and do, encoded at every launch from their
strides) and two consumer warpgroups run every product on ``wgmma``.  The
dQ kernel walks 128-row query tiles in 64-key steps; the dK / dV kernel
walks 128-key tiles in steps of :data:`DKV_STEP_ROWS` query rows over each
GQA group's heads.  head_dim 16 keeps an ``mma.sync`` body.  A layout that
TMA refuses raises; nothing falls back.

The forward saves its output o and its stats: each row's log2-sum-exp of
the scaled scores, L_i = log2 Σ_j 2^(s_ij·c) with c = sm_scale·log2 e
(K6's stats output, in the kernel's own exponent domain), so that
p_ij = 2^(s_ij·c - L_i) is the forward's probability.  Then, per head,
    di_i  = Σ_d o_id·do_id
    ds_ij = (do_i·v_j - di_i)·p_ij·sm_scale
    dV_j  = Σ_i p_ij·do_i,   dK_j = Σ_i ds_ij·q_i,   dQ_i = Σ_j ds_ij·k_j
with dK and dV summed over each GQA group's query heads.  The kernels
round p and ds to bf16 before their products, as the TPU kernels do; the
plain version keeps them in f32: :func:`bwd_tolerance` states the bound.
"""
from __future__ import annotations

import math

import torch

from tgq_torch.kernels import _build

launches = 0  # launches of flash_causal_attention_bwd's kernel pair (CUDA only)
LOG2E = math.log2(math.e)
# query rows a step of the dK / dV kernel walks, by head_dim (KvPlan::BQ in
# csrc/causal_attention_bwd.cu; head_dim 16's mma.sync body steps 64 rows)
DKV_STEP_ROWS = {16: 64, 64: 64, 128: 32}


def _scores(q, k, scale: float):
    """f32 scores q·k (b, h, s, s) with the kv heads repeated for GQA, and
    the causal mask (s, s)."""
    s = q.shape[1]
    rep = q.shape[2] // k.shape[2]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(rep, dim=2))
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    return sc, mask


def lse_plain(q, k, sm_scale: float | None = None):
    """The stats K6 saves for its backward, in f32 (b, h, s): each row's
    log2-sum-exp of the scaled scores, log2 Σ_{j <= i} 2^(s_ij·c)."""
    scale = 1.0 / math.sqrt(q.shape[3]) if sm_scale is None else sm_scale
    sc, mask = _scores(q, k, scale)
    return torch.logsumexp((sc * scale).masked_fill(~mask, -math.inf), dim=-1) * LOG2E


def _group_sum(x, kv: int):
    """(b, s, h, d) per query head -> (b, s, kv, d) summed over each group."""
    b, s, h, d = x.shape
    return x.reshape(b, s, kv, h // kv, d).sum(dim=3)


def causal_attention_bwd_plain(q, k, v, o, stats, do, sm_scale: float | None = None):
    """The spec of K6-bwd, in f32: (dq, dk, dv) as f32 tensors shaped like
    q, k, v.  q, o, do: (b, s, h, d); k, v: (b, s, kv, d); stats: (b, h, s)
    log2-sum-exp as :func:`lse_plain` gives it (K6's stats output)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    sc, mask = _scores(q, k, scale)
    p = torch.exp2(sc * (scale * LOG2E) - stats.float()[..., None]).masked_fill(~mask, 0.0)
    g = do.float()
    di = (o.float() * g).sum(dim=-1).transpose(1, 2)  # (b, h, s)
    vf = v.float().repeat_interleave(h // kv, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, vf)
    ds = (dp - di[..., None]) * p * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float().repeat_interleave(h // kv, dim=2))
    return dq, _group_sum(dk, kv), _group_sum(dv, kv)


def _ulp(ref):
    """One bf16 ulp of each element of ``ref`` (its binade's spacing)."""
    r = ref.float().abs().clamp_min(2.0 ** -126)
    return torch.ldexp(torch.ones_like(r), torch.frexp(r)[1] - 8)


def bwd_tolerance(q, k, v, do, ref, sm_scale: float | None = None, jax: bool = False):
    """Per-element bounds (f32, shaped like dq, dk, dv) on |K6-bwd - ref|
    for the reference gradients ``ref`` = (dq, dk, dv), derived as
    ``causal_attention.tolerance`` is.  With p the f32 probabilities, dp_ij =
    do_i·v_j, M_id = Σ_j p_ij·|v_jd| (a bound on |o_id|), Dm_i = Σ_d
    M_id·|do_id| (a bound on |di_i|) and A_ij = p_ij·(|dp_ij| + Dm_i)·sm_scale
    (a bound on |ds_ij|), the magnitudes
        dV: Σ_i p_ij·|do_id|,   dK: Σ_i A_ij·|q_id|,   dQ: Σ_j A_ij·|k_jd|
    (dK, dV summed over the group's heads) bound each gradient's terms.
    The kernel rounds p to bf16 before dV and ds before dK and dQ (relative
    error at most 2^-8 of each term), and sums in f32 in another order (a
    2^-12 share covers it with the f32 error of ds itself, whose size
    A_ij bounds): (2^-8 + 2^-12) of the magnitude, plus 2 bf16 ulps of the
    reference element for the two outputs' own roundings.

    ``jax=True`` for a reference from the JAX package's flash attention,
    which adds: its own forward's o in di (another bf16 rounding of the
    probabilities and of o: at most 3·2^-8·Dm_i, so 3·2^-8 of dK's and dQ's
    magnitudes), and the per-head bf16 rounding of dK and dV before the
    GQA sum and that sum's roundings in bf16 (group·2^-8 of dK's and dV's
    magnitudes; the kernel sums the group in f32 and rounds once)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    sc, mask = _scores(q, k, scale)
    p = torch.softmax((sc * scale).masked_fill(~mask, -math.inf), dim=-1)
    vf = v.float().repeat_interleave(rep, dim=2)
    g = do.float().abs()
    m = torch.einsum("bhqk,bkhd->bqhd", p, vf.abs())
    dm = (m * g).sum(dim=-1).transpose(1, 2)  # (b, h, s)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf).abs()
    a = p * (dp + dm[..., None]) * scale
    mag_q = torch.einsum("bhqk,bkhd->bqhd", a, k.float().abs().repeat_interleave(rep, dim=2))
    mag_k = _group_sum(torch.einsum("bhqk,bqhd->bkhd", a, q.float().abs()), kv)
    mag_v = _group_sum(torch.einsum("bhqk,bqhd->bkhd", p, g), kv)
    c = 2.0 ** -8 + 2.0 ** -12
    cq, ck, cv = c, c, c
    if jax:
        cq += 3 * 2.0 ** -8
        ck += (3 + rep) * 2.0 ** -8
        cv += rep * 2.0 ** -8
    return tuple(cc * mag + 2 * _ulp(r)
                 for cc, mag, r in ((cq, mag_q, ref[0]), (ck, mag_k, ref[1]), (cv, mag_v, ref[2])))


def _launch_error(err: int) -> str:
    """The C entry's code as a message: -(1000·t + r) is TMA's refusal of
    tensor t's layout (1 q, 2 k, 3 v, 4 do, 5 dq, 6 dk, 7 dv) with the
    driver's CUresult r."""
    if err < 0:
        t, r = divmod(-err, 1000)
        name = {1: "q", 2: "k", 3: "v", 4: "do", 5: "dq", 6: "dk", 7: "dv"}.get(t, "?")
        return f"causal attention backward: TMA refused the layout of {name} (CUresult {r})"
    return f"causal attention backward launch: CUDA error {err}"


def _rows_ok(t) -> bool:
    return t.stride(3) == 1 and not any(st % 8 for st in t.stride()[:3]) and t.data_ptr() % 16 == 0


def flash_causal_attention_bwd(q, k, v, o, stats, do, sm_scale: float | None = None):
    """(dq, dk, dv) of K6 at the cotangent ``do``, in q's dtype and
    contiguous, from K6's inputs, its output ``o`` and its ``stats``
    ((b, h, s) f32), with the contract of :func:`causal_attention_bwd_plain`
    (up to :func:`bwd_tolerance`).  CUDA tensors launch the kernels; CPU
    tensors run the plain version.  q, k, v as K6 takes them (bf16, strided
    views with a contiguous feature axis and 16-byte aligned rows); o and
    do are copied to contiguous tensors when their rows are not so."""
    global launches
    b, s, h, d = q.shape
    kv = k.shape[2]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    if o.shape != q.shape or do.shape != q.shape or stats.shape != (b, h, s):
        raise ValueError(f"causal attention backward: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, stats {tuple(stats.shape)} against q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return tuple(g.to(q.dtype) for g in causal_attention_bwd_plain(
            q, k, v, o, stats, do, scale))
    if q.device.type != "cuda":
        raise ValueError(f"causal attention backward: unsupported device {q.device}")
    o, do = (t if _rows_ok(t) else t.contiguous() for t in (o.to(q.dtype), do.to(q.dtype)))
    stats = stats.float().contiguous()
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, kv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, s, kv, d), dtype=q.dtype, device=q.device)
    di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.lib()
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    err = lib.tgq_causal_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        stats.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *do.stride()[:3],
        b, s, h, kv, d, float(scale), dev, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(_launch_error(err))
    launches += 1
    return dq, dk, dv
