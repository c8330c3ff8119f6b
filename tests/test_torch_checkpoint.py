"""Checkpoints cross between the packages: a checkpoint written by one
loads in the other with equal arrays (bit for bit) and equal
PackedLinears; the pack_layout gate refuses exactly what JAX refuses."""
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from tgq.calib import QuantizeConfig as JConfig
from tgq.calib import quantize_model as j_quantize
from tgq.calib.data import synthetic_calibration
from tgq.core import checkpoint as jck
from tgq.core.packing import PackedLinear as JPacked
from tgq.models import PRESETS, init_params
from tgq_torch.calib import QuantizeConfig, quantize_model
from tgq_torch.core import checkpoint as tck
from tgq_torch.core.packing import PackedLinear as TPacked
from tgq_torch.models.convert import numpy_from_tensor, params_from_numpy

CFG = PRESETS["tiny-qwen2"]  # biases: PackedLinear.bias crosses too
KW = dict(mode="rtn", w_bits=4, group_size=32, batch_size=2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return numpy_from_tensor(x, bf16_dtype=ml_dtypes.bfloat16)
    return np.asarray(x)


def _assert_trees_equal(ta, tb):
    la, lb = dict(_leaves(ta)), dict(_leaves(tb))
    assert set(la) == set(lb)
    for name in la:
        a, b = la[name], lb[name]
        if isinstance(a, (JPacked, TPacked)):
            assert isinstance(b, (JPacked, TPacked)), name
            assert (a.bits, a.group_size, a.in_features, a.out_features) == (
                b.bits, b.group_size, b.in_features, b.out_features)
            for f in ("codes", "scale", "zero", "bias"):
                fa, fb = getattr(a, f), getattr(b, f)
                assert (fa is None) == (fb is None), (name, f)
                if fa is not None:
                    np.testing.assert_array_equal(_np(fa), _np(fb), err_msg=f"{name}.{f}")
        else:
            a, b = _np(a), _np(b)
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def quantized():
    jparams = init_params(CFG, jax.random.key(3))
    calib = synthetic_calibration(CFG.vocab_size, 2, 32, seed=1)
    jq, jpacked, _ = j_quantize(jparams, CFG, calib, JConfig(**KW))
    tparams = params_from_numpy(jax.tree.map(np.asarray, init_params(CFG, jax.random.key(3))))
    tq, tpacked, _ = quantize_model(tparams, CFG, calib, QuantizeConfig(**KW), device="cpu")
    return jq, jpacked, tq, tpacked


@pytest.mark.parametrize("shard", [False, True])
def test_jax_checkpoint_loads_in_torch(tmp_path, quantized, shard):
    jq, jpacked, _, _ = quantized
    jck.save_quantized(str(tmp_path), jq, jpacked, CFG, {"w_bits": 4},
                       kv_equalizers=(np.ones(4), np.full(4, 2.0)), shard_layers=shard)
    jtree, jcfg, jmeta = jck.load_quantized(str(tmp_path))
    ttree, tcfg, tmeta = tck.load_quantized(str(tmp_path), device="cpu")
    assert tcfg.name == jcfg.name and tcfg.vocab_size == jcfg.vocab_size
    assert tmeta["w_bits"] == jmeta["w_bits"] == 4
    np.testing.assert_array_equal(tmeta["kv_equalizers"][1], jmeta["kv_equalizers"][1])
    _assert_trees_equal(ttree, jtree)


@pytest.mark.parametrize("shard", [False, True])
def test_torch_checkpoint_loads_in_jax(tmp_path, quantized, shard):
    _, _, tq, tpacked = quantized
    tck.save_quantized(str(tmp_path), tq, tpacked, CFG, {"w_bits": 4},
                       shard_layers=shard)
    assert os.path.exists(tmp_path / "layer_001.npz") == shard
    jtree, _, _ = jck.load_quantized(str(tmp_path))
    ttree, _, _ = tck.load_quantized(str(tmp_path), device="cpu")
    _assert_trees_equal(ttree, jtree)
    assert isinstance(ttree["model"]["layers"][0]["self_attn"]["q_proj"], TPacked)


def test_packages_write_the_same_arrays(tmp_path, quantized):
    """Both packages quantize identically in rtn mode, so their files hold
    the same names and the same bytes."""
    jq, jpacked, tq, tpacked = quantized
    jck.save_quantized(str(tmp_path / "j"), jq, jpacked, CFG)
    tck.save_quantized(str(tmp_path / "t"), tq, tpacked, CFG)
    with np.load(tmp_path / "j" / "weights.npz") as a, np.load(tmp_path / "t" / "weights.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_layer_callback(tmp_path, quantized):
    _, _, tq, tpacked = quantized
    tck.save_quantized(str(tmp_path), tq, tpacked, CFG, shard_layers=True)
    seen = []
    tck.load_quantized(str(tmp_path), device="cpu",
                       layer_callback=lambda li, sub: seen.append(li) or sub)
    assert seen == [0, 1]


@pytest.mark.parametrize("w_bits,layout", [(3, 1), (0, 1), (4, 1), (3, 2)])
def test_pack_layout_gate_matches_jax(tmp_path, quantized, w_bits, layout):
    _, _, tq, tpacked = quantized
    tck.save_quantized(str(tmp_path), tq, tpacked, CFG, {"w_bits": w_bits} if w_bits else {})
    meta_path = tmp_path / "config.json"
    meta = json.loads(meta_path.read_text())
    meta["pack_layout"] = layout
    meta_path.write_text(json.dumps(meta))

    def outcome(load):
        try:
            load()
            return "ok"
        except ValueError:
            return "refused"

    j = outcome(lambda: jck.load_quantized(str(tmp_path)))
    t = outcome(lambda: tck.load_quantized(str(tmp_path), device="cpu"))
    assert t == j
    assert j == ("refused" if layout == 1 and w_bits in (0, 3) else "ok")
