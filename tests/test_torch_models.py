"""tgq_torch.models against tgq.models: the same weights (shared through
tgq_torch.models.convert) give the same logits.

Tolerance: 2e-2 of max |logit|.  Both packages keep bf16 activations
between ops, but round to bf16 at different places (XLA fuses elementwise
chains; PyTorch rounds after each op), so individual activations differ
by about one bf16 ulp (2^-8 relative) and the difference grows through two
layers; f32 would agree to ~1e-6.  Argmax agreement is stated per test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tgq.models import PRESETS as JPRESETS
from tgq.models import forward as jforward
from tgq.models import init_params as jinit
from tgq_torch.core.packing import PackedLinear
from tgq_torch.core.quant import QuantSpec
from tgq_torch.models import PRESETS as TPRESETS
from tgq_torch.models import forward as tforward
from tgq_torch.models.causal_lm import apply_linear, find_linear_paths, init_params
from tgq_torch.models.convert import numpy_from_params, params_from_numpy


def jax_params(name, seed=0):
    cfg = JPRESETS[name]
    params = jinit(cfg, jax.random.key(seed))
    if cfg.attention_bias:  # non-zero biases so the bias path is exercised
        rng = np.random.default_rng(seed)
        for lp in params["model"]["layers"]:
            for proj in ("q_proj", "k_proj", "v_proj"):
                p = lp["self_attn"][proj]
                p["b"] = jnp.asarray(rng.normal(size=p["b"].shape) * 0.1, jnp.bfloat16)
    return cfg, params


@pytest.mark.parametrize("name", ["tiny-qwen3", "tiny-llama", "tiny-qwen2"])
def test_forward_matches_jax(name):
    cfg, jp = jax_params(name)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 48))
    jl = np.asarray(jforward(jp, cfg, jnp.asarray(ids, jnp.int32), attn_impl="naive"))
    tl = tforward(tp, TPRESETS[name], torch.from_numpy(ids)).numpy()
    assert tl.shape == jl.shape and tl.dtype == np.float32
    scale = np.abs(jl).max()
    assert np.abs(tl - jl).max() <= 2e-2 * scale, (np.abs(tl - jl).max(), scale)
    agree = (tl.argmax(-1) == jl.argmax(-1)).mean()
    assert agree >= 0.95, agree


def test_convert_roundtrip_is_bit_exact():
    _, jp = jax_params("tiny-qwen2")
    np_tree = jax.tree.map(np.asarray, jp)
    back = numpy_from_params(params_from_numpy(np_tree), bf16_dtype=ml_dtypes.bfloat16)
    flat_a = jax.tree_util.tree_leaves_with_path(np_tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("name", ["tiny-qwen3", "tiny-llama", "tiny-qwen2", "qwen3-8b",
                                  "llama3-8b", "qwen2.5-7b"])
def test_presets_copied(name):
    assert dataclasses.asdict(TPRESETS[name]) == dataclasses.asdict(JPRESETS[name])


def test_init_params_tree_matches_jax():
    cfg = TPRESETS["tiny-qwen2"]
    tp = init_params(cfg, seed=0, device="cpu")
    _, jp = jax_params("tiny-qwen2")
    shapes_t = jax.tree.map(lambda t: tuple(t.shape), tp)
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert shapes_t == shapes_j
    assert find_linear_paths(cfg) == [
        "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
        "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"]


def test_packed_linear_forward_is_not_stubbed():
    q = torch.zeros((8, 16), dtype=torch.int32)
    pl = PackedLinear.from_codes(q, torch.ones((8, 1)), torch.zeros((8, 1)),
                                 QuantSpec(4, -1, False))
    with pytest.raises(NotImplementedError, match="K3"):
        apply_linear(pl, torch.zeros((1, 16), dtype=torch.bfloat16))
