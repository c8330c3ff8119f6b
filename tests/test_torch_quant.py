"""tgq_torch.core.quant against tgq.core.quant: same inputs from a numpy
seed, codes / scale / zero bit for bit (both round half up with
floor(x + 0.5) and divide in f32, so no tolerance is needed)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tgq.core import quant as jq
from tgq_torch.core import quant as tq


def _w(seed, m=16, n=256):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, n)).astype(np.float32)
    w[0, :7] = 0.0  # a near-flat group edge
    w[1] *= 1e-7    # hits the 1e-5 scale floor
    return w


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("group_size", [-1, 128])
def test_quantize_bit_exact(sym, bits, group_size):
    w = _w(bits * 10 + group_size % 7 + sym)
    js = jq.QuantSpec(bits=bits, group_size=group_size, sym=sym)
    ts = tq.QuantSpec(bits=bits, group_size=group_size, sym=sym)
    assert (ts.min_q, ts.max_q) == (js.min_q, js.max_q)
    jp = jq.find_params(jnp.asarray(w), js)
    tp = tq.find_params(torch.from_numpy(w), ts)
    np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))
    np.testing.assert_array_equal(tp.zero.numpy(), np.asarray(jp.zero))
    js_full, jz_full = jq.expand_params(jp, w.shape[1])
    ts_full, tz_full = tq.expand_params(tp, w.shape[1])
    jcodes = jq.quantize(jnp.asarray(w), js_full, jz_full, js)
    tcodes = tq.quantize(torch.from_numpy(w), ts_full, tz_full, ts)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tq.fake_quantize(torch.from_numpy(w), ts).numpy(),
                                  np.asarray(jq.fake_quantize(jnp.asarray(w), js)))


def test_round_half_up_not_half_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5])
    np.testing.assert_array_equal(tq.round_half_up(x).numpy(), [1.0, 2.0, 3.0, 0.0, -1.0])


def test_group_divisibility_error():
    with pytest.raises(ValueError):
        tq.find_params(torch.zeros((2, 100)), tq.QuantSpec(bits=4, group_size=128))
