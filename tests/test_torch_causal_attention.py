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


def _emulate_k6(q, k, v, fault=None):
    """K6's arithmetic at head_dim 64 / 128 in torch, the design the CUDA
    kernel implements: 128-row query tiles in two 64-row halves (one
    consumer warpgroup each), 128-key tiles up to the diagonal, the first
    half's diagonal tile over its first 64 keys only, log2-domain online
    softmax over the running max of the raw scores (p = 2^(s·c - m·c), c =
    sm_scale·log2 e), probabilities rounded to bf16 at the running max
    before P·V, one division at the end.  ``fault`` plants a defect: "skip_second_half"
    (the diagonal skip applied to rows 64-127 too, so they lose keys
    64-127 of their tile) or "no_mask" (the diagonal tile unmasked)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    qf = q.float()
    scale = (1.0 / math.sqrt(d)) * math.log2(math.e)
    out = torch.empty((b, h, s, d))
    for t0 in range(0, s, 128):
        for half in (0, 1):
            if t0 + 64 * half >= s:
                continue
            rows = torch.arange(t0 + 64 * half, min(t0 + 64 * half + 64, s))
            m = torch.full((b, h, len(rows)), -math.inf)
            ell = torch.zeros((b, h, len(rows)))
            acc = torch.zeros((b, h, len(rows), d))
            for k0 in range(0, t0 + 128, 128):
                diag = k0 == t0
                skip = diag and (half == 0 or fault == "skip_second_half")
                keys = torch.arange(k0, min(k0 + (64 if skip else 128), s))
                sc = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows], kf[:, keys])
                if diag and fault != "no_mask":
                    sc = sc.masked_fill(keys[None, :] > rows[:, None], -math.inf)
                m_new = torch.maximum(m, sc.amax(dim=-1))
                alpha = torch.exp2((m - m_new) * scale)
                p = torch.exp2(sc * scale - (m_new * scale)[..., None])
                ell = ell * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, keys])
                m = m_new
            out[:, :, rows] = acc / ell[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("s", [1, 65, 127, 129, 300])
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_design_within_tolerance_and_fault_caught(s, d):
    _, tx = _inputs(5 + s + d, 2, s, 8, 2, d, q_scale=3.0)
    ref = K6.causal_attention_plain(*tx)
    tol = K6.tolerance(*tx, ref)

    def ratio(out):
        return float(((out.float() - ref.float()).abs() / tol).max())

    good = ratio(_emulate_k6(*tx))
    assert good <= 1.0, good
    # each fault changes the result wherever it changes the keys a row sees
    if s > 64:
        bad = ratio(_emulate_k6(*tx, fault="skip_second_half"))
        assert bad > 10.0, bad
    if s > 1:
        bad = ratio(_emulate_k6(*tx, fault="no_mask"))
        assert bad > 10.0, bad


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_design_matches_tpu_kernel_interpreted(s, d):
    jx, tx = _inputs(s + d + 7, 1, s, 4, 1, d)
    with pltpu.force_tpu_interpret_mode():
        ref = _as_torch(jcl._flash_causal_attention(*jx))
    ratio, err = _ratio(_emulate_k6(*tx), ref, tx)
    assert ratio <= 1.0, (ratio, err)


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
    with pytest.raises(ValueError, match="sm_scale must be > 0"):
        K6.flash_causal_attention(q, k, v, sm_scale=-0.125)


def test_auto_on_cpu_never_launches_and_takes_strided_views():
    _, (q, k, v) = _inputs(3, 2, 40, 8, 4, 16)
    before = K6.launches
    full = causal_attention(q, k, v, impl="auto")
    part = causal_attention(q[:, :, 4:8], k[:, :, 2:4], v[:, :, 2:4], impl="auto")
    assert K6.launches == before
    assert torch.equal(part, full[:, :, 4:8])  # a head slice is the same computation

