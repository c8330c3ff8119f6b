"""tgq_torch.solver.{pqr, factorize} against tgq.solver: the host f64
factorizations are copies of the JAX package's numpy/scipy code, so ranks
and pivot orders must be identical and R equal to f32 rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgq.solver import factorize as jf
from tgq.solver import pqr as jq
from tgq_torch.solver import factorize as tf
from tgq_torch.solver import pqr as tq


def _h(seed, n=48, tokens=512, decay=0.9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(tokens, n)) * (decay ** np.arange(n))[None, :]
    return (x.T @ x / tokens).astype(np.float32)


def test_pivoted_qr_host_pivots_identical():
    a = np.random.default_rng(0).normal(size=(40, 32))
    rj, pj = jq.pivoted_qr(a, backend="host")
    rt, pt = tq.pivoted_qr(torch.from_numpy(a))
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_allclose(rt, rj, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method,eps", [("energy", 1e-6), ("energy", 1e-3),
                                        ("mean_trimmed", 1e-2), ("none", 0.0)])
def test_trunc_spectral_factor_matches(method, eps):
    h = _h(2)
    fj = jf.trunc_spectral_factor(h, eps=eps, method=method)
    ft = tf.trunc_spectral_factor(torch.from_numpy(h), eps=eps, method=method)
    assert ft.rank == fj.rank
    np.testing.assert_array_equal(ft.perm, fj.perm)
    np.testing.assert_allclose(ft.r_full, fj.r_full, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ft.r_x, fj.r_x, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("actorder", [False, True])
def test_gptq_cholesky_factor_matches(actorder):
    h = _h(3)
    h[5, :] = h[:, 5] = 0.0  # a dead channel: the damping ladder must cope
    fj = jf.gptq_cholesky_factor(h, actorder=actorder)
    ft = tf.gptq_cholesky_factor(torch.from_numpy(h), actorder=actorder)
    assert ft.rank == fj.rank
    np.testing.assert_array_equal(ft.perm, fj.perm)
    np.testing.assert_allclose(ft.r_full, fj.r_full, rtol=1e-6, atol=1e-6)


def test_sketch_factor_matches():
    y = np.random.default_rng(4).normal(size=(96, 32)) * (0.8 ** np.arange(32))
    fj = jf.sketch_factor(y, eps=1e-4, method="energy")
    ft = tf.sketch_factor(torch.from_numpy(y), eps=1e-4, method="energy")
    assert ft.rank == fj.rank
    np.testing.assert_array_equal(ft.perm, fj.perm)
    np.testing.assert_allclose(ft.r_full, fj.r_full, rtol=1e-6, atol=1e-6)


def test_f32_eigh_precision_runs():
    h = _h(5)
    ft = tf.trunc_spectral_factor(torch.from_numpy(h), eps=1e-6, method="energy",
                                  precision="f32")
    fj = jf.trunc_spectral_factor(h, eps=1e-6, method="energy", precision="f32")
    assert ft.rank == fj.rank
    assert np.isfinite(ft.r_full).all()


def test_truncate_rank_matches():
    s = np.sort(np.random.default_rng(6).uniform(size=64))[::-1] ** 3
    for method in ("energy", "mean_trimmed", "full"):
        for eps in (1e-1, 1e-3, 1e-6):
            assert tf.truncate_rank(s, eps, method) == jf.truncate_rank(s, eps, method)
