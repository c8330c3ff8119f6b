"""tgq_torch's pivoted-Cholesky path against tgq's.

The JAX side runs its Pallas panel kernel in interpret mode and its jnp
sweep (``_pivoted_cholesky_jit``) on the CPU; the port runs the plain
panel version.  The two sum the deferred Schur-row correction in a
different order, so strips and histories agree to f32 rounding
(rtol 1e-4) and pivots agree exactly wherever the conditional variances
are not within rounding of each other.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgq.core.quant import QuantSpec as JSpec
from tgq.kernels.pchol_panel import pchol_panel as j_panel
from tgq.solver import pchol as jp
from tgq_torch.core.quant import QuantSpec, fake_quantize
from tgq_torch.kernels import pchol_panel as K1
from tgq_torch.solver import pchol as tp
from tgq_torch.solver.factorize import trunc_spectral_factor
from tgq_torch.solver.gptq_loop import quantize_weight
from tgq_torch.solver.hessian import hessian_from_activations


def make_h(rng, n, decay=0.99, rank=None):
    if rank is None:
        a = rng.normal(size=(4 * n, n)) * (decay ** np.arange(n))[None, :]
    else:
        a = rng.normal(size=(rank, n))
    return a.T @ a / a.shape[0]


def test_plain_panel_matches_pallas_interpret(rng):
    n = 256
    h = (make_h(rng, n, decay=0.97) + 1e-8 * np.eye(n)).astype(np.float32)
    d = np.diagonal(h).reshape(1, n).copy()
    done = np.zeros((1, n), np.float32)
    done[0, [3, 17]] = 1.0
    d[0, [3, 17]] = 0.0
    js, jd, jdone, jperm, jph = j_panel(jnp.asarray(h), jnp.asarray(d), jnp.asarray(done),
                                        panel=128, interpret=True)
    ts, td, tdone, tperm, tph = K1.pchol_panel(torch.from_numpy(h), torch.from_numpy(d),
                                               torch.from_numpy(done), panel=128)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(tph.numpy(), np.asarray(jph), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-3, atol=1e-5)


def test_ragged_panel_zero_rows(rng):
    n = 40
    h = torch.from_numpy(make_h(rng, n).astype(np.float32))
    d = torch.diagonal(h).reshape(1, n).contiguous()
    strip, _, done, perm, ph = K1.pchol_panel(h, d, torch.zeros((1, n)), panel=64, steps=n)
    assert torch.equal(strip[n:], torch.zeros((64 - n, n)))
    assert sorted(perm[0, :n].tolist()) == list(range(n))
    assert torch.equal(perm[0, n:], torch.zeros(64 - n, dtype=torch.int32))
    assert bool((done == 1).all())


@pytest.mark.parametrize("n,panel", [(256, 128), (200, 64)])
def test_plain_sweep_matches_jnp_sweep(rng, n, panel):
    h = (make_h(rng, n, decay=0.97) + 1e-8 * np.eye(n)).astype(np.float32)
    lt_j, perm_j, dh_j, ph_j = jp._pivoted_cholesky_jit(jnp.asarray(h), panel=panel)
    lt_t, perm_t, dh_t, ph_t = tp._pivoted_cholesky_plain(torch.from_numpy(h), panel=panel)
    np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
    np.testing.assert_allclose(dh_t.numpy(), np.asarray(dh_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ph_t.numpy(), np.asarray(ph_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(lt_t.numpy(), np.asarray(lt_j), rtol=1e-3, atol=1e-5)


def test_plain_sweep_rank_deficient(rng):
    n = 256
    h = make_h(rng, n, rank=64).astype(np.float32)  # rank <= 64
    lt_j, perm_j, dh_j, _ = jp._pivoted_cholesky_jit(jnp.asarray(h), panel=128)
    lt_t, perm_t, dh_t, _ = tp._pivoted_cholesky_plain(torch.from_numpy(h), panel=128)
    k = 48  # well inside the numerically resolvable prefix
    np.testing.assert_array_equal(perm_t.numpy()[:k], np.asarray(perm_j)[:k])
    # exhausted-rank entries are arithmetic noise around 1e-6 of the top pivot
    np.testing.assert_allclose(dh_t.numpy(), np.asarray(dh_j), rtol=1e-2, atol=1e-4)
    rec = lt_t.double().numpy()
    np.testing.assert_allclose(rec.T @ rec, h.astype(np.float64), rtol=0, atol=1e-4)


@pytest.mark.parametrize("eps", [1e-12, 1e-6, 1e-3])
def test_pchol_factor_matches_jax(rng, eps):
    n = 96
    h = (make_h(rng, n) + 0.05 * np.eye(n)).astype(np.float32)
    fj = jp.pchol_factor(h, eps=eps)
    ft = tp.pchol_factor(torch.from_numpy(h), eps=eps)
    assert ft.rank == fj.rank
    np.testing.assert_array_equal(ft.perm.numpy(), np.asarray(fj.perm))
    # both build R in f32, with different LAPACK/XLA routines: agree to the f32 build's error
    r_t, r_j = ft.r_full.numpy(), np.asarray(fj.r_full)
    assert np.abs(r_t - r_j).max() <= 1e-4 * np.abs(r_j).max()
    np.testing.assert_allclose(ft.r_x.numpy(), np.asarray(fj.r_x), rtol=1e-3, atol=1e-5)


def test_rank_matches_host_rule(rng):
    h = make_h(rng, 80, rank=20) + 1e-9 * np.eye(80)
    _, _, dh, ph = tp._sweep(torch.from_numpy(h.astype(np.float32)))
    for eps in (1e-2, 1e-5, 1e-7):
        for rtol in (1e-6, 1e-3):
            num = max(int((ph.double().numpy() > rtol * float(ph[0])).sum()), 1)
            assert tp._rank_f64(dh, ph, eps, rtol) == min(tp.trace_rank(dh, eps), num)
            assert tp.trace_rank(dh, eps) == jp.trace_rank(dh.numpy(), eps)


def test_truncated_factor_identity_tail(rng):
    n, k = 80, 20
    h = make_h(rng, n, rank=k) + 1e-9 * np.eye(n)
    f = tp.pchol_factor(torch.from_numpy(h.astype(np.float32)), eps=1e-7)
    assert f.rank <= k + 2
    tail = f.r_full[f.rank:].double().numpy()
    expect = np.zeros_like(tail)
    expect[np.arange(tail.shape[0]), np.arange(f.rank, n)] = 1.0
    np.testing.assert_allclose(tail, expect, atol=1e-6)


def test_outlier_spectrum_quality_matches_eigh():
    """Port of tests/test_pchol.py::test_outlier_spectrum_quality_matches_eigh:
    a few channel variances 1e4x the bulk must not collapse the rank."""
    rng = np.random.default_rng(0)
    n, m, N = 256, 128, 2048
    d = np.concatenate([np.full(4, 1e4), np.logspace(0, -3, n - 4)])
    rng.shuffle(d)
    r_corr = 0.9 ** np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    c = d[:, None] ** 0.5 * np.linalg.cholesky(r_corr + 1e-12 * np.eye(n))
    x = rng.standard_normal((N, n)) @ c.T
    h = x.T @ x / N
    w = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    spec = QuantSpec(bits=4, group_size=64, sym=False)
    fp = tp.pchol_factor(torch.from_numpy(h.astype(np.float32)), eps=1e-6)
    fe = trunc_spectral_factor(h, eps=1e-6, method="energy")
    fj = jp.pchol_factor(jnp.asarray(h, jnp.float32), eps=1e-6)
    assert fp.rank > n // 4 and fp.rank == fj.rank, (fp.rank, fj.rank, fe.rank)
    wq_p = quantize_weight(w, fp, spec, with_error=False).w_q.double().numpy()
    wq_e = quantize_weight(w, fe, spec, with_error=False).w_q.double().numpy()
    w64 = w.double().numpy()
    ep = np.linalg.norm((w64 - wq_p) @ c) / np.linalg.norm(w64 @ c)
    ee = np.linalg.norm((w64 - wq_e) @ c) / np.linalg.norm(w64 @ c)
    assert ep <= ee * 1.05, (ep, ee, fp.rank, fe.rank)


def test_extreme_spectrum_stays_finite(rng):
    d = 256
    u, _ = np.linalg.qr(rng.normal(size=(d, d)))
    s = 10.0 ** (-5 * np.arange(d) / d)
    x = ((rng.normal(size=(4096, d)) * s) @ u.T).astype(np.float32)
    h = hessian_from_activations(torch.from_numpy(x))
    f = tp.pchol_factor(h, eps=1e-6)
    assert torch.isfinite(torch.as_tensor(f.r_full)).all()
    w = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32))
    wq = quantize_weight(w, f, QuantSpec(bits=3, group_size=128), with_error=False).w_q
    assert torch.isfinite(wq).all()


def test_f32_breakdown_builds_in_f64_at_the_same_rank():
    """Where the f32 factor build breaks down, the port builds the rank
    the rule chose in f64 before the JAX package's ladder; the JAX package
    escalates the numerical-rank guard instead, and its truncated solve then
    lands above RTN.  The 5-decade spectrum of
    test_extreme_spectrum_stays_finite, at its first seed."""
    rng = np.random.default_rng(0)
    d = 256
    u, _ = np.linalg.qr(rng.normal(size=(d, d)))
    s = 10.0 ** (-5 * np.arange(d) / d)
    x = ((rng.normal(size=(4096, d)) * s) @ u.T).astype(np.float32)
    h = hessian_from_activations(torch.from_numpy(x))
    lt, perm, dh, ph = tp._sweep(h)
    rule = tp._rank_f64(dh, ph, 1e-6, 1e-6)
    assert not torch.isfinite(tp._pchol_factors(lt, perm, rule)[0]).all()  # f32 breaks down
    f = tp.pchol_factor(h, eps=1e-6)
    fj = jp.pchol_factor(jnp.asarray(h.numpy()), eps=1e-6)
    assert f.rank == rule and torch.isfinite(f.r_full).all() and fj.rank < rule, (f.rank, fj.rank)
    w = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32))
    spec, c, w64 = QuantSpec(bits=3, group_size=128), u * s[None, :], w.double().numpy()

    def err(wq):
        return np.linalg.norm((w64 - wq.double().numpy()) @ c) / np.linalg.norm(w64 @ c)

    e_port = err(quantize_weight(w, f, spec, with_error=False).w_q)
    e_jax = err(quantize_weight(w, fj, spec, with_error=False).w_q)
    e_rtn = err(fake_quantize(w, spec))
    assert e_port < e_rtn < e_jax, (e_port, e_rtn, e_jax)


def test_pchol_zero_hessian_safe():
    f = tp.pchol_factor(torch.zeros((16, 16)), eps=1e-6)
    assert torch.isfinite(f.r_full).all() and f.rank >= 1


def test_quality_beats_rtn(rng):
    m, n = 32, 128
    cov = 0.92 ** np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    x = (rng.normal(size=(8192, n)) @ np.linalg.cholesky(cov + 1e-9 * np.eye(n)).T
         ).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    h = hessian_from_activations(torch.from_numpy(x))
    spec = QuantSpec(bits=3, group_size=-1, sym=False)
    f = tp.pchol_factor(h, eps=1e-6)
    y = x @ w.numpy().T

    def err(wq):
        return np.linalg.norm(y - x @ wq.numpy().T) / np.linalg.norm(y)

    assert err(quantize_weight(w, f, spec).w_q) < 0.75 * err(fake_quantize(w, spec))
    assert JSpec(3, -1, False).max_q == spec.max_q


def test_wrapper_rejects_bad_inputs():
    a = torch.eye(8)
    d = torch.ones((1, 8))
    with pytest.raises(TypeError):
        K1.pchol_panel(a.double(), d, torch.zeros((1, 8)))
    with pytest.raises(ValueError):
        K1.pchol_panel(a, torch.ones((1, 7)), torch.zeros((1, 8)))
    with pytest.raises(ValueError):
        K1.pchol_panel(torch.eye(16)[::2, ::2], d, torch.zeros((1, 8)))
