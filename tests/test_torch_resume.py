"""Per-layer resume of the quantization sweep (mirrors ``tests/test_resume.py``)
and the spectral consistency check (``--mode test``) against the JAX
package.

- A sweep stopped after layer 0 and resumed gives every module the codes
  of an uninterrupted run, bit for bit, and layer_stats name each module
  once (tiny-qwen3, tiny-gpt2, tiny-opt).
- The resume directory has the JAX package's layout: a directory the port
  wrote resumes in the JAX package and one the JAX package wrote resumes
  in the port.
- spectral check: ``sqrt_max_eig_H`` (f64 eigenvalues on the host in both)
  within 1e-5 relative of JAX's for groups 0 and 1, whose inputs are the
  same up to the softmax's f32 ``exp`` (measured at most 1.3e-6); within
  1e-3 for groups 2 and 3, which see the attention output after its bf16
  rounding, where a last-bit ``exp`` difference can flip an ulp (measured
  at most 4.6e-4).  The ratio to the sketch's top singular value lies in
  [0.75, 1.25] and within 0.1 of JAX's (different Gaussian draws;
  measured gap at most 0.062).
"""
import copy

import jax
import numpy as np
import pytest
import torch

from tgq.calib import QuantizeConfig as JConfig
from tgq.calib import quantize_model as j_quantize
from tgq.calib.data import synthetic_calibration
from tgq.calib.pipeline import spectral_consistency_check as j_spectral
from tgq.models import PRESETS, init_params
from tgq_torch.calib import QuantizeConfig, quantize_model
from tgq_torch.calib.pipeline import spectral_consistency_check
from tgq_torch.models.convert import params_from_numpy

KW = dict(mode="pchol", w_bits=4, group_size=32, batch_size=2, block_size=32,
          attn_impl="naive", eps=1e-8)


def _model(preset):
    cfg = PRESETS[preset]
    jp = init_params(cfg, jax.random.key(0))
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("preset", ["tiny-qwen3", "tiny-gpt2", "tiny-opt"])
def test_resume_matches_uninterrupted(tmp_path, preset):
    cfg, _, params0 = _model(preset)
    calib = synthetic_calibration(cfg.vocab_size, 4, 32, seed=5)
    qcfg = QuantizeConfig(**KW)
    p_full, packed_full, log_full = quantize_model(copy.deepcopy(params0), cfg, calib, qcfg,
                                                   device="cpu")
    rdir = str(tmp_path / "resume")
    _, packed1, log1 = quantize_model(copy.deepcopy(params0), cfg, calib, qcfg, device="cpu",
                                      resume_dir=rdir, stop_after_layer=0)
    assert {k.split(".")[1] for k in packed1} == {"0"}
    p2, packed2, log2 = quantize_model(copy.deepcopy(params0), cfg, calib, qcfg,
                                       device="cpu", resume_dir=rdir)
    assert set(packed2) == set(packed_full)
    for key in packed_full:
        assert torch.equal(packed2[key].codes, packed_full[key].codes), key
        assert torch.equal(packed2[key].scale, packed_full[key].scale), key
    for lf, lr in zip(p_full["model"]["layers"], p2["model"]["layers"]):
        for (_, a), (_, b) in zip(sorted(_flat(lf).items()), sorted(_flat(lr).items())):
            assert a.dtype == b.dtype and torch.equal(a, b)
    names = [s["name"] for s in log2["layer_stats"]]
    assert names == [s["name"] for s in log_full["layer_stats"]]
    assert len(names) == len(set(names)) == len(packed_full)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_directory_crosses_packages(tmp_path, writer):
    """Layer 0 saved by one package, layer 1 quantized by the other: the
    restored layer-0 codes are the writer's, and the run completes."""
    cfg, jp, tp = _model("tiny-opt")
    calib = synthetic_calibration(cfg.vocab_size, 4, 32, seed=5)
    rdir = str(tmp_path / "r")
    if writer == "port":
        _, first, _ = quantize_model(copy.deepcopy(tp), cfg, calib, QuantizeConfig(**KW),
                                     device="cpu", resume_dir=rdir, stop_after_layer=0)
        _, packed, log = j_quantize(copy.deepcopy(jp), cfg, calib, JConfig(**KW),
                                    resume_dir=rdir)
    else:
        _, first, _ = j_quantize(copy.deepcopy(jp), cfg, calib, JConfig(**KW),
                                 resume_dir=rdir, stop_after_layer=0)
        _, packed, log = quantize_model(copy.deepcopy(tp), cfg, calib, QuantizeConfig(**KW),
                                        device="cpu", resume_dir=rdir)
    assert len(packed) == 12 and len(log["layer_stats"]) == 12
    for key, pl in first.items():
        np.testing.assert_array_equal(np.asarray(packed[key].codes), np.asarray(pl.codes))


@pytest.mark.parametrize("preset", ["tiny-qwen3", "tiny-gpt2", "tiny-opt"])
def test_spectral_check_matches_jax(preset):
    cfg, jp, tp = _model(preset)
    calib = synthetic_calibration(cfg.vocab_size, 8, 64, seed=3)
    want = j_spectral(jp, cfg, calib, JConfig(batch_size=4, attn_impl="naive"))
    got = spectral_consistency_check(tp, cfg, calib,
                                     QuantizeConfig(batch_size=4, attn_impl="naive"),
                                     device="cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for gi, (t, j) in enumerate(zip(got, want)):
        rel = abs(t["sqrt_max_eig_H"] / j["sqrt_max_eig_H"] - 1)
        assert rel <= (1e-5 if gi < 2 else 1e-3), (t, j, rel)
        assert 0.75 <= t["ratio"] <= 1.25 and abs(t["ratio"] - j["ratio"]) <= 0.1, (t, j)
