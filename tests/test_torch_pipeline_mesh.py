"""The calibration sweep under a (data 2 x model 2) mesh of 4 gloo CPU
ranks (one spawn for the module) against the single-rank sweep and
against tgq's mesh sweep, at ``tests/test_pipeline_mesh.py``'s limits:
layer 0's q_proj differs by more than 1e-6 in under 2 % of its weights,
and the strided perplexity is within 2 %; against the single rank layer
0's q/k/v are bit-equal.  Every rank writes back the same weights and the
same packed export."""
import copy

import numpy as np
import pytest
import torch

from tgq_torch.models import PRESETS

CFG = PRESETS["tiny-qwen3"]
QKW = dict(mode="pchol", w_bits=4, group_size=32, batch_size=4, block_size=32,
           attn_impl="naive", eps=1e-8)


def _calib():
    from tgq_torch.calib.data import synthetic_calibration

    return synthetic_calibration(CFG.vocab_size, n_samples=8, seq_len=64, seed=2)


def _ranks(path: str) -> dict:
    from tgq_torch.calib import QuantizeConfig, quantize_model
    from tgq_torch.parallel import make_mesh

    params = torch.load(path, weights_only=False)
    p, packed, log = quantize_model(params, CFG, _calib(), QuantizeConfig(**QKW),
                                    device="cpu", mesh=make_mesh(data=2, model=2))
    lp = p["model"]["layers"]
    return {"q0": lp[0]["self_attn"]["q_proj"]["w"],
            "qkv0": [lp[0]["self_attn"][n]["w"] for n in ("q_proj", "k_proj", "v_proj")],
            "down1": lp[1]["mlp"]["down_proj"]["w"],
            "codes": {k: v.codes for k, v in packed.items()},
            "ranks": [s["rank"] for s in log["layer_stats"]], "params": p}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from tgq.models import PRESETS as JP
    from tgq.models import init_params as j_init
    from tgq_torch.calib import QuantizeConfig, quantize_model
    from tgq_torch.models.convert import params_from_numpy
    from tgq_torch.parallel.launch import spawn

    jp = j_init(JP["tiny-qwen3"], jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    path = str(tmp_path_factory.mktemp("mesh") / "params.pt")
    torch.save(params, path)
    single, _, slog = quantize_model(copy.deepcopy(params), CFG, _calib(),
                                     QuantizeConfig(**QKW), device="cpu")
    mesh = spawn(_ranks, 4, args=(path,), device="cpu", timeout_s=300)
    return jp, single, [s["rank"] for s in slog["layer_stats"]], mesh


def _ppl(params):
    from tgq_torch.calib.data import synthetic_eval_stream
    from tgq_torch.eval.ppl import perplexity_from_token_stream

    eval_ids = synthetic_eval_stream(CFG.vocab_size, 1024, seed=3)
    return perplexity_from_token_stream(params, CFG, eval_ids, max_length=64, stride=32,
                                        attn_impl="naive")


def test_ranks_write_back_the_same_model(runs):
    res = runs[3]
    for r in res[1:]:
        np.testing.assert_array_equal(r["q0"], res[0]["q0"])
        np.testing.assert_array_equal(r["down1"], res[0]["down1"])
        assert r["ranks"] == res[0]["ranks"]
        for k, c in res[0]["codes"].items():
            np.testing.assert_array_equal(r["codes"][k], c, err_msg=k)
    assert len(res[0]["codes"]) == CFG.num_layers * 7


def test_mesh_matches_single_rank(runs):
    """Layer 0's q/k/v see the single-rank Hessian bit for bit (dp_sum adds
    the same batch Grams in the same order), so they equal it exactly;
    later layers' inputs pass TP forwards, held by the limits above."""
    _, single, single_ranks, res = runs
    w1 = single["model"]["layers"][0]["self_attn"]["q_proj"]["w"].float().numpy()
    assert (np.abs(w1 - res[0]["q0"]) > 1e-6).mean() < 0.02
    for name, w in zip(("q_proj", "k_proj", "v_proj"), res[0]["qkv0"]):
        np.testing.assert_array_equal(
            w, single["model"]["layers"][0]["self_attn"][name]["w"].float().numpy())
    assert res[0]["ranks"] == single_ranks
    from tgq_torch.models.convert import params_from_numpy

    ppl1, ppl2 = _ppl(single), _ppl(params_from_numpy(res[0]["params"]))
    assert abs(ppl1 - ppl2) / ppl1 < 0.02, (ppl1, ppl2)


def test_mesh_matches_jax_mesh_sweep(runs):
    import jax

    from tgq.calib import QuantizeConfig as JConfig
    from tgq.calib import quantize_model as j_quantize
    from tgq.models import PRESETS as JP
    from tgq.parallel import make_mesh
    from tgq_torch.models.convert import params_from_numpy

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jp, _, _, res = runs
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    jq, _, _ = j_quantize(copy.deepcopy(jp), JP["tiny-qwen3"], _calib(), JConfig(**QKW),
                          mesh=mesh)
    w1 = np.asarray(jq["model"]["layers"][0]["self_attn"]["q_proj"]["w"], np.float32)
    assert (np.abs(w1 - res[0]["q0"]) > 1e-6).mean() < 0.02
    ppl1 = _ppl(params_from_numpy(jax.tree.map(np.asarray, jq)))
    ppl2 = _ppl(params_from_numpy(res[0]["params"]))
    assert abs(ppl1 - ppl2) / ppl1 < 0.02, (ppl1, ppl2)
