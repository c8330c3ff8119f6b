"""tgq_torch.solver.hessian against tgq.solver.hessian.

H is compared at rtol 1e-5: both accumulate exact products in f32 and
differ only in summation order (~√tokens · 2^-24 relative).  The sketch
draws its Gaussian numbers from another generator, so it is held to its
statistics — E[YᵀY] = H and the top singular value against √λ_max(H), the
JAX package's spectral consistency check — not to JAX's bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgq.solver import hessian as jh
from tgq_torch.solver import hessian as th


def _x(seed, tokens=1024, n=64):
    rng = np.random.default_rng(seed)
    cov = 0.8 ** np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    return (rng.normal(size=(tokens, n)) @ np.linalg.cholesky(cov).T).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hessian_matches_jax(dtype):
    x = _x(0)
    xj = jnp.asarray(x, getattr(jnp, dtype)).reshape(4, 256, 64)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).reshape(4, 256, 64)
    # the two packages round f32 -> bf16 identically (round to nearest even)
    np.testing.assert_array_equal(np.asarray(xj.astype(jnp.float32)), xt.float().numpy())
    accj = jh.HessianAccumulator.init(64)
    acct = th.HessianAccumulator.init(64)
    for i in range(4):
        accj = accj.update(xj[i])
        acct = acct.update(xt[i])
    np.testing.assert_allclose(acct.finalize().numpy(), np.asarray(accj.finalize()),
                               rtol=1e-5, atol=1e-6)
    assert acct.n_samples == int(accj.n_samples) == 1024


def test_transposed_update_matches_plain():
    x = torch.from_numpy(_x(1)).bfloat16()
    a = th.HessianAccumulator.init(64).update(x)
    b = th.HessianAccumulator.init(64).update_t(x.T.contiguous())
    np.testing.assert_array_equal(a.finalize().numpy(), b.finalize().numpy())
    np.testing.assert_allclose(
        a.finalize().numpy(),
        th.hessian_from_activations(x.float()).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tokens", [th.GRAM_CHUNK - 1, 2 * th.GRAM_CHUNK + 452])
def test_gram_sums_token_chunks(tokens):
    """The Gram runs in GRAM_CHUNK-token GEMMs summed in f32: every token
    counts once, a ragged last chunk included, and H stays within 1e-6 of
    max|H| of the f64 Gram (each chunk's f32 sum is ~√1024 · 2^-24)."""
    x = torch.from_numpy(_x(3, tokens=tokens)).bfloat16()
    ref = x.double().T @ x.double()
    h = th.gram(x)
    assert float((h.double() - ref).abs().max() / ref.abs().max()) <= 1e-6
    np.testing.assert_array_equal(th.gram_t(x.T.contiguous()).numpy(), h.numpy())


def test_empty_accumulator_is_safe():
    assert torch.equal(th.HessianAccumulator.init(8).finalize(), torch.zeros((8, 8)))


def test_sketch_statistics_match_jax():
    x = _x(2, tokens=2048)
    h = x.astype(np.float64).T @ x / len(x)
    lam_max = np.linalg.eigvalsh(h)[-1]
    rank = 4 * 64
    ys = []
    accj = jh.SketchAccumulator.init(64, rank=rank, seed=0)
    acct = th.SketchAccumulator.init(64, rank=rank, seed=0)
    for i in range(0, 2048, 512):
        accj = accj.update(jnp.asarray(x[i:i + 512]))
        acct = acct.update(torch.from_numpy(x[i:i + 512]))
    ys = {"jax": np.asarray(accj.finalize(), np.float64),
          "torch": acct.finalize().double().numpy()}
    for name, y in ys.items():
        assert y.shape == (rank, 64)
        # E[YᵀY] = H; with 4n sketch rows the spread is ~1/√(4n) ≈ 6 %
        err = np.linalg.norm(y.T @ y - h) / np.linalg.norm(h)
        assert err < 0.3, (name, err)
        ratio = np.sqrt(lam_max) / np.linalg.svd(y, compute_uv=False)[0]
        assert 0.8 < ratio < 1.25, (name, ratio)
