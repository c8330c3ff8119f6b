"""tgq_torch's packed-weight matmul (K3/K4 wrappers; plain versions on the
CPU) against tgq's ``quantized_matmul``: the Pallas kernel run interpreted
on the CPU (``impl="pallas"``) and the dequantize-then-matmul branch
(``impl="xla"``), on the same numpy-seeded packed weights.

Tolerances: f32 outputs within rtol 1e-5 / atol 1e-5 of the xla branch
(both dequantize and run one f32 matmul; only the summation order
differs) and rtol 1e-4 / atol 1e-3 of the interpreted kernel (the JAX
test's own tolerance for kernel vs xla).  ``quantize_activations`` is
held bit for bit against the jitted JAX function.  A8: the port's plain
version keeps K4's group order, the JAX xla branch fake-quantizes the
activations and runs one matmul — both use the same int8 codes, so they
agree to f32 summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgq.core.packing import PackedLinear as JPacked
from tgq.core.quant import QuantSpec as JSpec
from tgq.core.quant import expand_params, find_params, quantize
from tgq.kernels import dequant_matmul as jdm
from tgq_torch.core.packing import PackedLinear
from tgq_torch.kernels import dequant_matmul as KD
from tgq_torch.models.convert import packed_from_numpy


def make_packed(rng, m, n, bits, group_size, sym=False, bias=False):
    spec = JSpec(bits=bits, group_size=group_size, sym=sym)
    w = jnp.asarray(rng.normal(size=(m, n)).astype(np.float32))
    p = find_params(w, spec)
    s, z = expand_params(p, n)
    q = quantize(w, s, z, spec).astype(jnp.int32)
    b = jnp.asarray(rng.normal(size=(m,)).astype(np.float32)) if bias else None
    jw = JPacked.from_codes(q, p.scale, p.zero, spec, bias=b)
    return jw, packed_from_numpy(jax.tree.map(np.asarray, jw))


def run_port(x, tw, **kw):
    return KD.quantized_matmul(torch.from_numpy(np.asarray(x, np.float32)), tw, **kw).numpy()


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_matches_jax_pallas_and_xla(rng, bits):
    jw, tw = make_packed(rng, 256, 512, bits, 128)
    x = rng.normal(size=(16, 512)).astype(np.float32)
    y_xla = np.asarray(jdm.quantized_matmul(jnp.asarray(x), jw, impl="xla"))
    y_pal = np.asarray(jdm.quantized_matmul(jnp.asarray(x), jw, impl="pallas", token_tile=8,
                                            out_tile=128, k_tile=256))
    y = run_port(x, tw)
    np.testing.assert_allclose(y, y_xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, y_pal, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("group", [32, 64, -1])
def test_sym_and_group_sizes(rng, group):
    jw, tw = make_packed(rng, 128, 256, 4, group, sym=True)
    assert tw.group_size == (256 if group == -1 else group)
    x = rng.normal(size=(5, 256)).astype(np.float32)
    y_xla = np.asarray(jdm.quantized_matmul(jnp.asarray(x), jw, impl="xla"))
    np.testing.assert_allclose(run_port(x, tw), y_xla, rtol=1e-5, atol=1e-5)


def test_bias_output_dtype_and_leading_dims(rng):
    jw, tw = make_packed(rng, 128, 256, 4, 64, bias=True)
    xf = rng.normal(size=(2, 3, 256)).astype(np.float32)
    x_bf = jnp.asarray(xf).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(x_bf.astype(jnp.float32))).bfloat16()
    y_j = jdm.quantized_matmul(x_bf, jw, impl="xla")
    y_t = KD.quantized_matmul(xt, tw)
    assert y_t.shape == (2, 3, 128) and y_t.dtype == torch.bfloat16
    # bias added in f32 after an f32 matmul, one rounding to bf16 in both
    np.testing.assert_allclose(y_t.float().numpy(), np.asarray(y_j, np.float32),
                               rtol=1e-2, atol=1e-2)
    y32 = KD.quantized_matmul(xt, tw, out_dtype=torch.float32)
    y32_j = jdm.quantized_matmul(x_bf, jw, impl="xla", out_dtype=jnp.float32)
    np.testing.assert_allclose(y32.numpy(), np.asarray(y32_j), rtol=1e-5, atol=1e-5)


def test_glu_matches_jax(rng):
    jw, tw = make_packed(rng, 128, 256, 4, 128)
    x = rng.normal(size=(6, 512)).astype(np.float32)
    y_pal = np.asarray(jdm.quantized_matmul(jnp.asarray(x), jw, impl="pallas", glu=True,
                                            token_tile=8, out_tile=128, k_tile=256))
    y_xla = np.asarray(jdm.quantized_matmul(jnp.asarray(x), jw, impl="xla", glu=True))
    y = run_port(x, tw, glu=True)
    np.testing.assert_allclose(y, y_xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, y_pal, rtol=1e-4, atol=1e-3)
    # the dense GLU path of apply_linear agrees with the packed one
    from tgq_torch.models.causal_lm import apply_linear

    dense = {"w": tw.dequantize(torch.float32)}
    y_d = apply_linear(dense, torch.from_numpy(x), glu=True).numpy()
    np.testing.assert_allclose(y_d, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act_bits", [16, 8])
def test_glu_fused_equals_split_form(rng, dtype, act_bits):
    """One GLU numerics: the fused form equals ``glu_act`` then the matmul,
    bit for bit, as the decode layer's split form computes it."""
    from tgq_torch.kernels.dequant_matmul import glu_act

    _, tw = make_packed(rng, 64, 128, 4, 64)
    tw = dataclasses.replace(tw, act_bits=act_bits)
    x = torch.from_numpy(rng.normal(size=(5, 256)).astype(np.float32)).to(dtype)
    fused = KD.quantized_matmul(x, tw, glu=True)
    split = KD.quantized_matmul(glu_act(x[:, :128], x[:, 128:]), tw)
    assert fused.dtype == dtype
    assert torch.equal(fused, split)


def test_stacked_view_matches_jax_layer_index(rng):
    """The port has no stacked mode: ``stacked[li]`` is a view, and the
    matmul on it equals JAX's layer-indexed kernel on the stacked tree."""
    layers = [make_packed(rng, 256, 256, 4, 128)[0] for _ in range(3)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *layers)
    tstack = packed_from_numpy(jax.tree.map(np.asarray, jstack))
    x = rng.normal(size=(4, 256)).astype(np.float32)
    for li in range(3):
        y_j = np.asarray(jdm.quantized_matmul(jnp.asarray(x), jstack, impl="pallas",
                                              layer=jnp.int32(li), token_tile=8,
                                              out_tile=128, k_tile=256))
        view = dataclasses.replace(tstack, codes=tstack.codes[li], scale=tstack.scale[li],
                                   zero=tstack.zero[li])
        assert view.codes.data_ptr() == tstack.codes[li].data_ptr()  # no copy
        np.testing.assert_allclose(run_port(x, view), y_j, rtol=1e-4, atol=1e-3)


def test_quantize_activations_bit_exact(rng):
    """Against the jitted JAX function, as the serving path runs it: under
    jit XLA:CPU turns ``max|x| / 127`` into ``max|x| · (1/127)`` (eagerly
    it divides), and the port computes that product."""
    qa = jax.jit(jdm.quantize_activations)
    x = rng.normal(size=(33, 200)).astype(np.float32) * rng.uniform(0.01, 10, (33, 1))
    x[3] = 0.0
    x[5, :7] = [0.5, -0.5, 1.5, 2.5, -2.5, 127.0, -127.0]  # rounding ties
    c_j, a_j = qa(jnp.asarray(x))
    c_t, a_t = KD.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    c_j, a_j = qa(xb)
    c_t, a_t = KD.quantize_activations(torch.from_numpy(np.array(xb, np.float32)).bfloat16())
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))


@pytest.mark.parametrize("bits,sym", [(4, False), (3, False), (2, False), (4, True)])
def test_a8_matches_jax(rng, bits, sym):
    jw, tw = make_packed(rng, 128, 256, bits, 64, sym=sym, bias=sym)
    jw8 = dataclasses.replace(jw, act_bits=8)
    tw8 = dataclasses.replace(tw, act_bits=8)
    x = rng.normal(size=(9, 256)).astype(np.float32)
    y_xla = np.asarray(jdm.quantized_matmul(jnp.asarray(x), jw8, impl="xla"))
    y_pal = np.asarray(jdm.quantized_matmul(jnp.asarray(x), jw8, impl="pallas", token_tile=8,
                                            out_tile=128, k_tile=256))
    y = run_port(x, tw8)
    np.testing.assert_allclose(y, y_xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, y_pal, rtol=1e-5, atol=1e-5)
    # the simulated-A8 plain version (the JAX xla branch's form) agrees too
    y_sim = KD.dequant_matmul_plain(torch.from_numpy(x), tw8).numpy()
    if tw8.bias is not None:
        y_sim = y_sim + tw8.bias.numpy()
    np.testing.assert_allclose(y, y_sim, rtol=1e-5, atol=1e-5)


def test_a8_plain_group_order_is_exact(rng):
    """K4's plain version: exact integer group dots, f32 accumulation in
    group order — reproduced here with numpy, bit for bit."""
    _, tw = make_packed(rng, 64, 256, 4, 64)
    x8 = torch.from_numpy(rng.integers(-127, 128, (5, 256)).astype(np.int8))
    a = torch.from_numpy(rng.uniform(0.01, 0.1, (5, 1)).astype(np.float32))
    y = KD.a8_matmul_plain(x8, a, tw).numpy()
    from tgq_torch.core.packing import unpack_rows

    q = unpack_rows(tw.codes.T, 4, 64, 256).numpy().T.astype(np.int64)  # (K, N)
    z = np.repeat(tw.zero.numpy(), 64, axis=0).astype(np.int64)
    acc = np.zeros((5, 64), np.float32)
    for gi in range(4):
        sl = slice(gi * 64, (gi + 1) * 64)
        d = (x8.numpy()[:, sl].astype(np.int64) @ (q[sl] - z[sl])).astype(np.float32)
        acc = acc + d * tw.scale.numpy()[gi]
    np.testing.assert_array_equal(y, acc * a.numpy())


def test_wrapper_rejects_bad_inputs(rng):
    _, tw = make_packed(rng, 64, 128, 4, 64)
    with pytest.raises(ValueError):
        KD.quantized_matmul(torch.zeros(3, 100), tw)
    with pytest.raises(TypeError):
        KD.quantized_matmul(torch.zeros(3, 128), dataclasses.replace(
            tw, scale=tw.scale.double()))
    with pytest.raises(ValueError):
        KD.quantized_matmul(torch.zeros(3, 128), dataclasses.replace(
            tw, codes=tw.codes.T.contiguous().T))
    with pytest.raises(ValueError):
        KD.quantized_matmul(torch.zeros(3, 128, device="meta"), tw)


def test_packed_from_numpy_keeps_static_fields(rng):
    jw, tw = make_packed(rng, 32, 64, 3, 32, bias=True)
    jw = dataclasses.replace(jw, act_bits=8)
    tw2 = packed_from_numpy(jax.tree.map(np.asarray, jw))
    assert isinstance(tw2, PackedLinear)
    assert (tw2.bits, tw2.group_size, tw2.in_features, tw2.out_features, tw2.act_bits) == (
        3, 32, 64, 32, 8)
    np.testing.assert_array_equal(tw2.codes.numpy(), np.asarray(jw.codes))
    np.testing.assert_array_equal(tw2.bias.numpy(), np.asarray(jw.bias))


# ------------------------------------------------------- K3's launch planner

# (out, in) of the packed matmuls: Qwen3-8B (fused qkv, o, fused gate_up,
# down, the W8 head padded to 512) at g128, tiny-qwen3 at g32
K3_SHAPES = [(6144, 4096, 128, 4), (4096, 4096, 128, 4), (24576, 4096, 128, 4),
             (4096, 12288, 128, 4), (152064, 4096, 128, 8),
             (128, 64, 32, 4), (64, 64, 32, 3), (256, 64, 32, 2), (64, 128, 32, 4),
             (512, 64, 32, 8)]


@pytest.mark.parametrize("t", [1, 8, 64, 1024, 1500])
@pytest.mark.parametrize("N,K,g,bits", K3_SHAPES)
def test_k3_plan_covers_the_matmul(N, K, g, bits, t):
    """Tiles cover every column and every input, the split-K ranges tile
    the chunks in order, the workspace is the splits' f32 partials, and the
    chunk and split (the order of the sums) are the same in every x mode,
    so fused GLU and split GLU, bf16 and f32 outputs sum alike."""
    plan = KD._k3_plan(t, K, N, g, bits)
    assert plan.regime == ("decode" if t <= 8 else "prefill")
    assert plan.tile_n == 128 and -(-N // plan.tile_n) * plan.tile_n >= N
    assert -(-t // plan.tile_t) * plan.tile_t >= t
    per = 8 if bits == 3 else 8 // bits
    assert g % plan.chunk_k == 0 and plan.chunk_k == plan.units * per
    assert plan.chunk_k % 16 == 0 and plan.units % 2 == 0
    assert plan.n_chunks * plan.chunk_k == K
    bounds = plan.split_bounds()
    assert len(bounds) == plan.split >= 1
    assert bounds[0][0] == 0 and bounds[-1][1] == plan.n_chunks
    assert all(b0 < b1 for b0, b1 in bounds)
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(len(bounds) - 1))
    assert plan.workspace == (plan.split * t * N if plan.split > 1 else 0)
    assert plan.smem <= 227 * 1024
    for x_f32 in (False, True):
        for glu in (False, True):
            other = KD._k3_plan(t, K, N, g, bits, x_f32=x_f32, glu=glu)
            assert (other.regime, other.units, other.n_chunks, other.split) == (
                plan.regime, plan.units, plan.n_chunks, plan.split)
            assert other.smem <= 227 * 1024


@pytest.mark.parametrize("g", [8, 24, 40])
def test_k3_plan_rejects_groups_off_the_mma_depth(g):
    with pytest.raises(ValueError, match="multiple of 16"):
        KD._k3_plan(8, 120, 64, g, 4)


# ------------------- the factored design's precondition: integral zero, codes in range

def _check_packed(p, bits):
    from tgq_torch.core.packing import unpack_rows

    z = p.zero
    assert torch.equal(z, torch.round(z)), "zero is not integral"
    assert float(z.min()) >= 0 and float(z.max()) <= 2 ** bits - 1
    q = unpack_rows(p.codes.T, bits, group_size=p.group_size, in_features=p.in_features)
    assert int(q.min()) >= 0 and int(q.max()) <= 2 ** bits - 1


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_rtn_pack_gives_integral_zero(rng, bits, sym):
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.models.hf_import import rtn_pack

    w = torch.from_numpy(rng.normal(size=(48, 128)).astype(np.float32))
    _check_packed(rtn_pack(w, QuantSpec(bits=bits, group_size=32, sym=sym)), bits)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_jax_init_packed_params_give_integral_zero(bits):
    from tgq.core.quant import QuantSpec as JSpec2
    from tgq.models import PRESETS as JPRESETS
    from tgq.models.hf_import import init_packed_params as j_init_packed

    tree = j_init_packed(JPRESETS["tiny-qwen3"], JSpec2(bits=bits, group_size=32), seed=0)
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=lambda n: isinstance(n, JPacked))
    packed = [packed_from_numpy(jax.tree.map(np.asarray, n)) for n in leaves
              if isinstance(n, JPacked)]
    assert len(packed) == 2 * 7
    for p in packed:
        _check_packed(p, bits)


@pytest.mark.parametrize("mode", ["rtn", "pchol"])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_quantize_model_and_checkpoint_give_integral_zero(tmp_path, bits, mode):
    from tgq.models import PRESETS as JPRESETS
    from tgq.models import init_params as j_init_params
    from tgq_torch.calib import QuantizeConfig, quantize_model
    from tgq_torch.calib.data import synthetic_calibration
    from tgq_torch.core.checkpoint import load_quantized, save_quantized
    from tgq_torch.models import PRESETS
    from tgq_torch.models.causal_lm import get_nested
    from tgq_torch.models.convert import params_from_numpy

    cfg = PRESETS["tiny-qwen3"]
    params = params_from_numpy(jax.tree.map(
        np.asarray, j_init_params(JPRESETS["tiny-qwen3"], jax.random.key(0))))
    calib = synthetic_calibration(cfg.vocab_size, n_samples=4, seq_len=32, seed=42)
    qcfg = QuantizeConfig(mode=mode, w_bits=bits, group_size=32, batch_size=4, block_size=32,
                          eps=1e-6, threshold_method="energy", attn_impl="naive")
    params, packed, _ = quantize_model(params, cfg, calib, qcfg, device="cpu")
    assert len(packed) == 2 * 7
    for p in packed.values():
        _check_packed(p, bits)
    save_quantized(str(tmp_path), params, packed, cfg, dataclasses.asdict(qcfg))
    tree, _, _ = load_quantized(str(tmp_path), device="cpu")
    for key in packed:
        li, path = key.split(".", 2)[1:]
        p = get_nested(tree["model"]["layers"][int(li)], path)
        assert isinstance(p, PackedLinear)
        _check_packed(p, bits)
