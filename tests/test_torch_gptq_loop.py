"""tgq_torch's GPTQ loop against tgq's.

In-block codes are compared bit for bit.  The scaled errors e agree to
1e-5 of max |e|, not bit for bit: XLA's CPU code contracts
``w - (q - z)·s`` and ``w - e·r`` into FMAs (emulating both contractions
in f64 reproduces JAX's e exactly), while the port rounds each operation
alone, as its CUDA kernel does so that kernel and plain version agree bit
for bit on the card.  The blockwise loop adds an inter-block GEMM whose
summation order differs between XLA and PyTorch; given the same factor,
codes then agree except where a weight lands within rounding of a
quantization tie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgq.core.quant import QuantSpec as JSpec
from tgq.kernels.gptq_block import process_block_pallas
from tgq.solver import gptq_loop as jg
from tgq.solver import trunc_spectral_factor as j_trunc
from tgq_torch.core.quant import QuantSpec
from tgq_torch.kernels import gptq_block as K2
from tgq_torch.solver import gptq_loop as tg


def make_inputs(rng, m, b):
    w = rng.normal(size=(m, b)).astype(np.float32)
    s = (0.01 + rng.uniform(size=(m, b)) * 0.2).astype(np.float32)
    z = rng.integers(0, 15, size=(m, b)).astype(np.float32)
    a = rng.normal(size=(b, b)).astype(np.float64) / np.sqrt(b)
    r = np.linalg.qr(a)[1]
    r *= np.sign(np.diagonal(r))[:, None]
    r += np.eye(b) * 0.5
    return w, s, z, r.astype(np.float32)


@pytest.mark.parametrize("m,b", [(8, 16), (100, 128), (256, 96), (300, 256)])
def test_plain_block_codes_match_jnp(rng, m, b):
    w, s, z, r = make_inputs(rng, m, b)
    q_j, e_j = jg._process_block_jnp(*map(jnp.asarray, (w, s, z, r)), -7, 7)
    q_t, e_t = K2.process_block(*map(torch.from_numpy, (w, s, z, r)), -7, 7)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    e_j = np.asarray(e_j)
    assert np.abs(e_t.numpy() - e_j).max() <= 1e-5 * np.abs(e_j).max()


@pytest.mark.parametrize("m,b", [(70, 64), (130, 100)])
def test_plain_block_matches_pallas_with_padding(rng, m, b):
    """Rows not a multiple of the Pallas tile, columns not a multiple of
    128: the Pallas wrapper pads, the port takes the shape as it is."""
    w, s, z, r = make_inputs(rng, m, b)
    q_p, e_p = process_block_pallas(*map(jnp.asarray, (w, s, z, r)), 0, 15,
                                    rows_per_tile=64, interpret=True)
    q_t, e_t = K2.process_block_plain(*map(torch.from_numpy, (w, s, z, r)), 0, 15)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_p))
    e_p = np.asarray(e_p)
    assert np.abs(e_t.numpy() - e_p).max() <= 1e-5 * np.abs(e_p).max()


@pytest.mark.parametrize("bits,group,sym", [(4, 64, False), (3, -1, False), (4, 32, True)])
def test_quantize_weight_same_factor(rng, bits, group, sym):
    m, n = 48, 128
    x = rng.normal(size=(4096, n)).astype(np.float32)
    x[:, :8] *= 10.0  # a few strong channels
    h = (x.T @ x / len(x)).astype(np.float32)
    f = j_trunc(h, eps=1e-6, method="energy")  # one factor, given to both
    w = rng.normal(size=(m, n)).astype(np.float32)
    rj = jg.quantize_weight(jnp.asarray(w), f, JSpec(bits, group, sym), block_size=32)
    rt = tg.quantize_weight(torch.from_numpy(w), f, QuantSpec(bits, group, sym),
                            block_size=32)
    np.testing.assert_array_equal(rt.scale.numpy(), np.asarray(rj.scale))
    np.testing.assert_array_equal(rt.zero.numpy(), np.asarray(rj.zero))
    diff = np.abs(rt.codes.numpy() - np.asarray(rj.codes))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()
    np.testing.assert_allclose(float(rt.rel_error), float(rj.rel_error), rtol=1e-3)


def test_quantize_weight_backends_agree(rng):
    """``backend="plain"`` and the wrapper (plain on the CPU) are one path."""
    m, n = 16, 96
    x = rng.normal(size=(1024, n)).astype(np.float32)
    f = j_trunc((x.T @ x / len(x)).astype(np.float32), eps=1e-8, method="energy")
    w = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    a = tg.quantize_weight(w, f, QuantSpec(4, 32), block_size=40, backend="kernel")
    b = tg.quantize_weight(w, f, QuantSpec(4, 32), block_size=40, backend="plain")
    assert torch.equal(a.codes, b.codes) and torch.equal(a.w_q, b.w_q)
    with pytest.raises(ValueError):
        tg.quantize_weight(w, f, QuantSpec(4, 32), backend="pallas")


def test_wrapper_rejects_bad_inputs(rng):
    w, s, z, r = map(torch.from_numpy, make_inputs(rng, 8, 16))
    with pytest.raises(TypeError):
        K2.process_block(w.double(), s, z, r, 0, 15)
    with pytest.raises(ValueError):
        K2.process_block(w, s, z, r[:8, :8], 0, 15)
    with pytest.raises(ValueError):
        K2.process_block(w.T.contiguous().T, s, z, r, 0, 15)
