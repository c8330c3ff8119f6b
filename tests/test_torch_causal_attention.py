"""K6, the causal flash attention (``tgq_torch.kernels.causal_attention``),
against the JAX package on the CPU.

The JAX side is ``tgq.models.causal_lm._flash_causal_attention``: the
upstream Pallas TPU kernel, run in interpret mode under
``pltpu.force_tpu_interpret_mode()`` (it takes lengths that are multiples
of 128), and for ragged lengths the JAX naive attention.  The port's
``causal_attention(impl="flash")`` runs K6's plain version on CPU tensors.
Both get the same numpy-seeded bf16 q, k, v.

Tolerance (``causal_attention.tolerance``, per element): (2^-8 + 2^-12) of
Σ_j p_ij·|v_j| plus 2 bf16 ulps of the reference.  The TPU kernel rounds
each probability to bf16 (relative error at most 2^-8) before P·V, at
whatever running max it holds; the plain version keeps them in f32; f32
sums in another order add far less than the 2^-12 share; each output is
rounded to bf16 once.  K6's CUDA kernel is held to the same bound on the
card (``chip_smoke.py`` phase 11a).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tgq.models import causal_lm as jcl
from tgq_torch.kernels import causal_attention as K6
from tgq_torch.models.causal_lm import causal_attention


def _inputs(seed, b, s, h, kv, d, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, h, d)) * q_scale).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    tx = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    return jx, tx


def _ratio(out, ref_t, tx):
    """max |out - ref| / tolerance; ``ref_t`` the JAX result as a bf16 tensor."""
    err = (out.float() - ref_t.float()).abs()
    return float((err / K6.tolerance(*tx, ref_t)).max()), float(err.max())


def _as_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("group", [1, 4])
def test_matches_tpu_kernel_interpreted(s, d, group):
    h = 4 if group == 4 else 2
    jx, tx = _inputs(s + d + group, 1, s, h, h // group, d)
    with pltpu.force_tpu_interpret_mode():
        ref = _as_torch(jcl._flash_causal_attention(*jx))
    before = K6.launches
    out = causal_attention(*tx, impl="flash")
    assert K6.launches == before  # CPU tensors: the plain version, no launch
    assert out.dtype == torch.bfloat16 and out.shape == (1, s, h, d)
    ratio, err = _ratio(out, ref, tx)
    assert ratio <= 1.0, (ratio, err)
    assert err > 0  # the TPU kernel's bf16 probabilities do differ from the plain f32 ones


@pytest.mark.parametrize("s", [1, 7, 100])
def test_ragged_lengths_match_jax_naive(s):
    jx, tx = _inputs(s, 2, s, 4, 2, 64, q_scale=2.0)
    ref = _as_torch(jcl._naive_causal_attention(*jx))
    for impl in ("auto", "flash", "naive"):
        out = causal_attention(*tx, impl=impl)
        ratio, err = _ratio(out, ref, tx)
        assert ratio <= 1.0, (impl, ratio, err)
        # both sides are the f32 softmax: at most one bf16 ulp of the output
        assert err <= float(ref.float().abs().max()) * 2.0 ** -7, (impl, err)


def _emulate_k6(q, k, v, skip_diagonal_mask=False):
    """K6's arithmetic in torch (one 64-key tile at a time, log2-domain
    online softmax, probabilities rounded to bf16 before P·V, one division
    at the end) — the design the CUDA kernel implements, here to show that
    the tolerance holds it and catches a planted fault."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    qf = q.float()
    scale = (1.0 / math.sqrt(d)) * math.log2(math.e)
    m = torch.full((b, h, s), -math.inf)
    ell = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    rows = torch.arange(s)
    for t0 in range(0, s, 64):
        keys = torch.arange(t0, min(t0 + 64, s))
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, keys]) * scale
        if not skip_diagonal_mask:
            sc = sc.masked_fill(keys[None, :] > rows[:, None], -math.inf)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new[..., None])
        ell = ell * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, keys])
        m = m_new
    return (acc / ell[..., None]).permute(0, 2, 1, 3).to(q.dtype)


def test_kernel_design_within_tolerance_and_fault_caught():
    _, tx = _inputs(5, 2, 150, 8, 2, 64, q_scale=3.0)
    ref = K6.causal_attention_plain(*tx)
    tol = K6.tolerance(*tx, ref)
    good = ((_emulate_k6(*tx).float() - ref.float()).abs() / tol).max()
    bad = ((_emulate_k6(*tx, skip_diagonal_mask=True).float() - ref.float()).abs() / tol).max()
    assert good <= 1.0, float(good)
    assert bad > 10.0, float(bad)


def test_wrapper_checks_raise():
    _, (q, k, v) = _inputs(0, 1, 16, 4, 2, 64)
    with pytest.raises(ValueError, match="shapes"):
        K6.flash_causal_attention(q, k, v[:, :, :1])
    with pytest.raises(ValueError, match="multiple"):
        K6.flash_causal_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="b, s, d"):
        K6.flash_causal_attention(q[:, :8], k, v)
    with pytest.raises(TypeError, match="bfloat16"):
        K6.flash_causal_attention(q.float(), k.float(), v.float())
    _, (q32, k32, v32) = _inputs(0, 1, 16, 4, 2, 32)
    with pytest.raises(ValueError, match="head_dim 32"):
        K6.flash_causal_attention(q32, k32, v32)
    qt = q.transpose(1, 3).contiguous().transpose(1, 3)  # features not contiguous
    with pytest.raises(ValueError, match="contiguous feature axis"):
        K6.flash_causal_attention(qt, k, v)
    with pytest.raises(ValueError, match="unknown attention impl"):
        causal_attention(q, k, v, impl="sdpa")


def test_auto_on_cpu_never_launches_and_takes_strided_views():
    _, (q, k, v) = _inputs(3, 2, 40, 8, 4, 16)
    before = K6.launches
    full = causal_attention(q, k, v, impl="auto")
    part = causal_attention(q[:, :, 4:8], k[:, :, 2:4], v[:, :, 2:4], impl="auto")
    assert K6.launches == before
    assert torch.equal(part, full[:, :, 4:8])  # a head slice is the same computation

