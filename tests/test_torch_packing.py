"""tgq_torch.core.packing against tgq.core.packing: packed bytes must be
identical (checkpoints are shared between the packages), and unpacking
must invert packing."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tgq.core import packing as jpk
from tgq.core.quant import QuantSpec as JSpec
from tgq_torch.core import packing as tpk
from tgq_torch.core.quant import QuantSpec as TSpec


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("group_size", [None, 64])
def test_pack_bytes_identical_and_roundtrip(bits, group_size):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 2**bits, size=(12, 256)).astype(np.int32)
    jb = np.asarray(jpk.pack_rows(jnp.asarray(codes), bits, group_size=group_size))
    tb = tpk.pack_rows(torch.from_numpy(codes), bits, group_size=group_size)
    assert tb.dtype == torch.uint8
    np.testing.assert_array_equal(tb.numpy(), jb)
    back = tpk.unpack_rows(tb, bits, group_size=group_size, in_features=256)
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("bits", [3, 4])
def test_packed_linear_matches_jax(sym, bits):
    rng = np.random.default_rng(7)
    spec_j, spec_t = JSpec(bits, 64, sym), TSpec(bits, 64, sym)
    q = rng.integers(spec_t.min_q, spec_t.max_q + 1, size=(24, 128)).astype(np.int32)
    scale = rng.uniform(0.01, 0.1, size=(24, 2)).astype(np.float32)
    zero = (np.zeros((24, 2)) if sym else rng.integers(0, 2**bits, size=(24, 2))
            ).astype(np.float32)
    bias = rng.normal(size=(24,)).astype(np.float32)
    jp = jpk.PackedLinear.from_codes(jnp.asarray(q), jnp.asarray(scale),
                                     jnp.asarray(zero), spec_j, bias=jnp.asarray(bias))
    tp = tpk.PackedLinear.from_codes(torch.from_numpy(q), torch.from_numpy(scale),
                                     torch.from_numpy(zero), spec_t,
                                     bias=torch.from_numpy(bias))
    for f in ("codes", "scale", "zero", "bias"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    assert (tp.bits, tp.group_size, tp.in_features, tp.out_features) == (
        jp.bits, jp.group_size, jp.in_features, jp.out_features)
    np.testing.assert_array_equal(tp.dequantize().numpy(), np.asarray(jp.dequantize()))


def test_concat_and_pad_out_match_jax():
    rng = np.random.default_rng(3)
    spec_j, spec_t = JSpec(4, 32, False), TSpec(4, 32, False)
    parts_j, parts_t = [], []
    for m in (16, 8):
        q = rng.integers(0, 16, size=(m, 64)).astype(np.int32)
        s = rng.uniform(0.01, 0.1, size=(m, 2)).astype(np.float32)
        z = rng.integers(0, 16, size=(m, 2)).astype(np.float32)
        b = rng.normal(size=(m,)).astype(np.float32) if m == 16 else None
        parts_j.append(jpk.PackedLinear.from_codes(
            jnp.asarray(q), jnp.asarray(s), jnp.asarray(z), spec_j,
            bias=None if b is None else jnp.asarray(b)))
        parts_t.append(tpk.PackedLinear.from_codes(
            torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(z), spec_t,
            bias=None if b is None else torch.from_numpy(b)))
    jc, tc = jpk.concat_out(parts_j), tpk.concat_out(parts_t)
    jpad, tpad = jpk.pad_out(jc, 64), tpk.pad_out(tc, 64)
    for j, t in ((jc, tc), (jpad, tpad)):
        assert t.out_features == j.out_features
        for f in ("codes", "scale", "zero", "bias"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
