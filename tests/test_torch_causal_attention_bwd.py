"""K6-bwd, the gradients of the causal flash attention
(``tgq_torch.kernels.causal_attention_bwd`` under
``causal_attention.FlashCausalAttention``), against the JAX package on the
CPU.

The JAX side is ``jax.vjp`` of ``tgq.models.causal_lm._flash_causal_attention``
under ``pltpu.force_tpu_interpret_mode()``: the upstream Pallas TPU
kernels' custom_vjp, whose backward runs ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq`` interpreted (lengths that are multiples of
128), and for ragged lengths ``jax.vjp`` of the JAX naive attention.  The
port's ``causal_attention(impl="flash")`` runs K6's plain version forward
and K6-bwd's plain backward on CPU tensors.  Both get the same
numpy-seeded bf16 q, k, v and cotangent.

Tolerance (``causal_attention_bwd.bwd_tolerance``, per element): (2^-8 +
2^-12) of each gradient's magnitude (Σ p·|do| for dV, Σ |ds|-bounds times
|q| or |k| for dK and dQ) plus 2 bf16 ulps of the reference; against the
JAX package (``jax=True``) also 3·2^-8 for its own forward's o in di and
group·2^-8 of dK / dV for its per-head bf16 gradients summed over each GQA
group after its kernels.  The emulation of the CUDA kernels' walk (tiles,
steps and their order, bf16 p and ds, f32 accumulators, the in-kernel GQA
sum, the masked steps and the skipped ones) is held to the same bound here,
and four planted faults (di dropped, the diagonal mask off by one, a group
summed into the wrong kv head, the masked steps skipped) exceed it tenfold;
the kernels themselves are held to it on the card (``chip_smoke.py`` phase
12a).
"""
import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tgq.models import causal_lm as jcl
from tgq_torch.kernels import causal_attention as K6
from tgq_torch.kernels import causal_attention_bwd as KB
from tgq_torch.models.causal_lm import causal_attention

LOG2E = math.log2(math.e)


def _arrays(seed, b, s, h, kv, d, q_scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, s, h, d)) * q_scale).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, h, d)).astype(np.float32)]


def _torch(arrays):
    return [torch.from_numpy(x).bfloat16() for x in arrays]


def _as_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def _jax_grads(fn, arrays):
    """(dq, dk, dv) of ``fn`` at the bf16 inputs and cotangent, as f32
    tensors.  One jitted program: run op by op, the interpreted kernels'
    callbacks (which dispatch jnp ops themselves) can deadlock behind the
    ops dispatched after them on a loaded host."""
    def grads(q, k, v, do):
        return jax.vjp(fn, q, k, v)[1](do)

    return [_as_torch(g) for g in jax.jit(grads)(
        *(jnp.asarray(x, jnp.bfloat16) for x in arrays))]


@functools.lru_cache(maxsize=None)
def _tpu_case(s, d, group):
    """Inputs and the interpreted TPU backward's gradients (cached: the
    design emulation reuses them)."""
    h, kv = (8, 2) if group == 4 else (2, 2)
    arrays = _arrays(1000 + s + d + group, 1, s, h, kv, d)
    with pltpu.force_tpu_interpret_mode():
        ref = _jax_grads(jcl._flash_causal_attention, arrays)
    return arrays, ref


def _port_grads(q, k, v, do, impl="flash"):
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = causal_attention(q, k, v, impl=impl)
    return torch.autograd.grad(out, (q, k, v), do)


def _ratios(got, ref, tol):
    return [float(((g.float() - r.float()).abs() / t).max()) for g, r, t in zip(got, ref, tol)]


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("group", [1, 4])
def test_matches_tpu_backward_interpreted(s, d, group):
    arrays, ref = _tpu_case(s, d, group)
    q, k, v, do = _torch(arrays)
    before = (K6.launches, KB.launches)
    got = _port_grads(q, k, v, do)
    assert (K6.launches, KB.launches) == before  # CPU tensors: the plain versions
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    ratios = _ratios(got, ref, KB.bwd_tolerance(q, k, v, do, ref, jax=True))
    assert max(ratios) <= 1.0, ratios
    # the TPU kernels' bf16 p and ds do differ from the plain f32 ones
    assert max(float((g.float() - r).abs().max()) for g, r in zip(got, ref)) > 0


@pytest.mark.parametrize("s", [1, 77, 200])
def test_ragged_lengths_match_jax_naive(s):
    arrays = _arrays(s, 2, s, 4, 2, 64, q_scale=2.0)
    ref = _jax_grads(jcl._naive_causal_attention, arrays)
    q, k, v, do = _torch(arrays)
    tol = KB.bwd_tolerance(q, k, v, do, ref, jax=True)
    for impl in ("auto", "flash", "naive"):
        ratios = _ratios(_port_grads(q, k, v, do, impl), ref, tol)
        assert max(ratios) <= 1.0, (impl, ratios)


@pytest.mark.parametrize("b, s, h, kv, d", [(2, 100, 4, 2, 64), (1, 1, 2, 1, 16),
                                            (2, 77, 8, 2, 128), (1, 130, 4, 4, 16)])
def test_plain_backward_equals_autograd_of_plain_forward(b, s, h, kv, d):
    """In f32 the spec is the exact gradient: the plain backward from the
    forward's stats against torch autograd of ``causal_attention_plain``."""
    arrays = _arrays(7 + s, b, s, h, kv, d, q_scale=2.0)
    q, k, v, do = (torch.from_numpy(x) for x in arrays)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = K6.causal_attention_plain(qg, kg, vg)
    auto = torch.autograd.grad(out, (qg, kg, vg), do)
    plain = KB.causal_attention_bwd_plain(q, k, v, out.detach(), KB.lse_plain(q, k), do)
    for a, p in zip(auto, plain):
        assert p.dtype == torch.float32 and p.shape == a.shape
        assert float((a - p).abs().max()) <= 1e-5


def _emulate_bwd(q, k, v, o, lse, do, fault=None):
    """K6-bwd's arithmetic in torch, the walk the CUDA kernels take.  dQ:
    query rows in 64-row groups (at head_dim 64 and 128 a consumer's half of
    a 128-row tile; at 16 a 64-row tile) over the 64-key steps up to the
    group's diagonal step, which alone is masked (the tile's last step,
    every score masked for its first half, is skipped); p = 2^(s·c - L) from
    the forward's stats, ds = (dp - di)·p·sm_scale rounded to bf16, f32
    accumulation.  dK / dV: key tiles of 128 keys (64 at head_dim 16), each
    64-key half walking the group's query heads in order, each in steps of
    ``DKV_STEP_ROWS[d]`` rows from the tile's first key to the end; a step
    whose rows all come before the half's first key is skipped, one that
    overlaps its keys masked; bf16 p and ds, the group summed in f32, one
    rounding at the end.  ``fault`` plants a defect: "no_di" (di dropped),
    "mask_off_by_one" (the diagonal masked too), "wrong_group" (kv head g
    sums the query heads of group g + 1) or "diag_skipped" (the dK / dV
    walk skips the masked steps too)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(d)
    c = scale * LOG2E
    bq = KB.DKV_STEP_ROWS[d]
    tile = 64 if d == 16 else 128  # keys a dK / dV tile
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    di = (o.float() * gf).sum(-1)  # (b, s, h)
    if fault == "no_di":
        di = torch.zeros_like(di)
    lrow = lse.float().transpose(1, 2)  # (b, s, h)

    def bf(x):
        return x.bfloat16().float()

    def masked(p, keys, rows):  # p (..., rows, keys)
        hide = keys[None, :] >= rows[:, None] if fault == "mask_off_by_one" else \
            keys[None, :] > rows[:, None]
        return p.masked_fill(hide, 0.0)

    kx, vx = kf.repeat_interleave(rep, 2), vf.repeat_interleave(rep, 2)
    dq = torch.zeros((b, s, h, d))
    for t0 in range(0, s, 64):
        rows = torch.arange(t0, min(t0 + 64, s))
        for k0 in range(0, t0 + 64, 64):
            keys = torch.arange(k0, min(k0 + 64, s))
            sc = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows], kx[:, keys])
            p = torch.exp2(sc * c - lrow[:, rows].permute(0, 2, 1)[..., None])
            if k0 == t0:
                p = masked(p, keys, rows)
            dp = torch.einsum("bqhd,bkhd->bhqk", gf[:, rows], vx[:, keys])
            ds = (dp - di[:, rows].permute(0, 2, 1)[..., None]) * p * scale
            dq[:, rows] += torch.einsum("bhqk,bkhd->bqhd", bf(ds), kx[:, keys])
    # dK / dV: every kv head's block at once; a step's p and ds for all the
    # group's query heads, summed over the group in f32.  "wrong_group" feeds
    # kv head g the query heads of group g + 1.
    heads = torch.arange(h)
    if fault == "wrong_group":
        heads = (heads // rep + 1) % kv * rep + heads % rep
    qg, gg, lg, dg = qf[:, :, heads], gf[:, :, heads], lrow[:, :, heads], di[:, :, heads]
    dk, dv = torch.zeros((b, s, h, d)), torch.zeros((b, s, h, d))
    for key0 in range(0, s, tile):
        for kc in range(key0, min(key0 + tile, s), 64):  # a consumer's 64 keys
            keys = torch.arange(kc, min(kc + 64, s))
            for r0 in range(key0, s, bq):
                if r0 + bq <= kc or (fault == "diag_skipped" and r0 < kc + 64):
                    continue  # every score of the step is masked
                rows = torch.arange(r0, min(r0 + bq, s))
                st = torch.einsum("bqhd,bkhd->bhqk", qg[:, rows], kx[:, keys])
                p = torch.exp2(st * c - lg[:, rows].permute(0, 2, 1)[..., None])
                if r0 < kc + 64:
                    p = masked(p, keys, rows)
                dpt = torch.einsum("bqhd,bkhd->bhqk", gg[:, rows], vx[:, keys])
                ds = (dpt - dg[:, rows].permute(0, 2, 1)[..., None]) * p * scale
                dv[:, keys] += torch.einsum("bhqk,bqhd->bkhd", bf(p), gg[:, rows])
                dk[:, keys] += torch.einsum("bhqk,bqhd->bkhd", bf(ds), qg[:, rows])
    dk, dv = (x.reshape(b, s, kv, rep, d).sum(dim=3) for x in (dk, dv))
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


FAULTS = ("no_di", "mask_off_by_one", "wrong_group", "diag_skipped")


@pytest.mark.parametrize("d", [16, 64, 128])
def test_kernel_design_matches_tpu_backward_and_faults_caught(d):
    arrays, ref = _tpu_case(256, d, 4)
    q, k, v, do = _torch(arrays)
    o, lse = K6._forward(q, k, v, 1.0 / math.sqrt(d), stats=True)
    tol = KB.bwd_tolerance(q, k, v, do, ref, jax=True)
    good = _ratios(_emulate_bwd(q, k, v, o, lse, do), ref, tol)
    assert max(good) <= 1.0, good
    for fault in FAULTS:
        bad = _ratios(_emulate_bwd(q, k, v, o, lse, do, fault), ref, tol)
        assert max(bad) > 10.0, (fault, bad)


@pytest.mark.parametrize("s", [1, 65, 127, 128, 129, 200, 256, 300])
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_design_within_tolerance_and_faults_caught(s, d):
    """Ragged lengths (the edges of the 64-row groups, the 128-row and
    128-key tiles and the 32-row steps) against the plain backward on K6's
    own forward."""
    q, k, v, do = _torch(_arrays(5 + s + d, 2, s, 8, 2, d, q_scale=3.0))
    o, lse = K6._forward(q, k, v, 1.0 / math.sqrt(d), stats=True)
    ref = KB.causal_attention_bwd_plain(q, k, v, o, lse, do)
    tol = KB.bwd_tolerance(q, k, v, do, ref)
    good = _ratios(_emulate_bwd(q, k, v, o, lse, do), ref, tol)
    assert max(good) <= 1.0, good
    if s > 1:  # one row has no key below the diagonal and one group member alone
        for fault in FAULTS:
            bad = _ratios(_emulate_bwd(q, k, v, o, lse, do, fault), ref, tol)
            assert max(bad) > 10.0, (fault, bad)


def test_step_rows_match_the_kernel_source():
    """The emulation's dK / dV step depth is the CUDA kernels': KvPlan::BQ
    (head_dim 64 and 128) and the mma.sync body's Tiles::BQ (16)."""
    src = (Path(KB.__file__).parent / "csrc" / "causal_attention_bwd.cu").read_text()
    d128, d64 = map(int, re.search(r"static constexpr int BQ = D == 128 \? (\d+) : (\d+);\n",
                                   src).groups())
    assert "static constexpr int BQ = D == 128 ? 32 : 64;  // query rows a dK / dV step" in src
    assert KB.DKV_STEP_ROWS == {16: 64, 64: d64, 128: d128}


def test_grads_through_strided_views_and_head_slices():
    b, s, h, d = 2, 70, 4, 16
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * d)).astype(np.float32)).bfloat16()
    do = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32)).bfloat16()
    fused = qkv.clone().requires_grad_()
    q, k, v = (x.view(b, s, h, d) for x in fused.split(h * d, dim=-1))
    assert q.stride(1) == 3 * h * d  # GPT-2's fused q/k/v: strided views
    causal_attention(q, k, v, impl="flash").backward(do)
    apart = _port_grads(*(x.reshape(b, s, h, d) for x in qkv.split(h * d, dim=-1)), do)
    assert torch.equal(fused.grad, torch.cat([g.reshape(b, s, h * d) for g in apart], dim=-1))
    # a TP head slice (heads 2-3 of 4, kv head 1 of 2): grads land on the slice only
    q4, k2, v2 = (x.clone().requires_grad_() for x in _torch(_arrays(4, b, s, 4, 2, d))[:3])
    causal_attention(q4[:, :, 2:], k2[:, :, 1:], v2[:, :, 1:], impl="flash").backward(
        do[:, :, :2])
    want = _port_grads(q4[:, :, 2:], k2[:, :, 1:], v2[:, :, 1:], do[:, :, :2])
    for full, part, cut in ((q4.grad, want[0], 2), (k2.grad, want[1], 1), (v2.grad, want[2], 1)):
        assert torch.equal(full[:, :, cut:], part)
        assert not full[:, :, :cut].any()


def test_no_grad_computes_no_stats_and_cpu_never_launches(monkeypatch):
    calls = []
    real = K6.lse_plain
    monkeypatch.setattr(K6, "lse_plain", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v, do = (t.requires_grad_() if i < 3 else t
                   for i, t in enumerate(_torch(_arrays(9, 1, 40, 4, 2, 64))))
    before = (K6.launches, KB.launches)
    with torch.no_grad():
        out = causal_attention(q, k, v, impl="flash")
    assert out.grad_fn is None and calls == []
    # the same bits as the differentiable call, which does save the stats
    grad_out = causal_attention(q, k, v, impl="flash")
    assert grad_out.grad_fn is not None and calls == [1]
    assert torch.equal(out, grad_out)
    grad_out.backward(do)
    assert (K6.launches, KB.launches) == before


def test_double_backward_raises():
    q, k, v, do = _torch(_arrays(2, 1, 16, 2, 1, 16))
    q.requires_grad_()
    do.requires_grad_()  # a cotangent that needs a gradient asks for the second order
    out = causal_attention(q, k, v, impl="flash")
    (dq,) = torch.autograd.grad(out, q, do, create_graph=True)
    with pytest.raises(RuntimeError, match="twice"):
        dq.float().sum().backward()


def test_backward_wrapper_checks_raise():
    q, k, v, do = _torch(_arrays(1, 1, 16, 4, 2, 64))
    o, lse = K6._forward(q, k, v, 0.125, stats=True)
    with pytest.raises(ValueError, match="stats"):
        KB.flash_causal_attention_bwd(q, k, v, o, lse[:, :2], do)
    with pytest.raises(ValueError, match="do"):
        KB.flash_causal_attention_bwd(q, k, v, o, lse, do[:, :8])
