"""GPT-2 and OPT in the port against the JAX package (``tgq/models/gpt2.py``,
``tgq/models/opt.py``), on tiny-gpt2 and tiny-opt with the same
numpy-carried weights.

Tolerances:
- tanh-GELU: bit-equal (rounded to bf16 after every step, as XLA does in
  a bf16 computation);
- LayerNorm: at most 1e-4 of the bf16 outputs differ, by one ulp: XLA:CPU
  sums the row's mean and variance in its own vectorized order (measured:
  0 of 4096 values differ at width 64, 2 and 1 of 65536 at 1024 and 768);
- forward logits: within 5e-3 absolute, about 1.3 bf16 ulps of the
  largest logit (about 0.69): the attention softmax's f32 ``exp`` differs
  between XLA:CPU and torch in the last bit, and bf16 activations carry
  that on (measured with seeded biases: max |difference| 2.19e-3
  tiny-gpt2, 1.83e-3 tiny-opt; zeroing one layer's bias moves the logits
  by 8.3e-3 to 1.7e-2, a LayerNorm eps of 1e-6 by 1.2e-2 to 2.0e-2);
- staged pipeline functions: equal to the decoder layer bit for bit;
- quantization end to end: ranks identical, codes agree at least as
  stated in ``test_quantize_matches_jax``;
- ``greedy_generate``: the same tokens as JAX's up to the first step
  whose top-two logits lie within the attention's noise.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgq.calib import QuantizeConfig as JConfig
from tgq.calib import quantize_model as j_quantize
from tgq.calib.data import synthetic_calibration
from tgq.models import PRESETS, init_params
from tgq.models.causal_lm import forward as j_forward
from tgq_torch.calib import QuantizeConfig, quantize_model
from tgq_torch.core.packing import unpack_rows
from tgq_torch.models.causal_lm import decoder_layer, forward, rope_cache
from tgq_torch.models.convert import params_from_numpy

FAMILIES = ["tiny-gpt2", "tiny-opt"]


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    cfg = PRESETS[request.param]
    jp = init_params(cfg, jax.random.key(0))
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _bf16(x: np.ndarray):
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _j2t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def test_gelu_bit_equal_layer_norm_within_an_ulp():
    from tgq.models.gpt2 import layer_norm as j_ln
    from tgq_torch.models.gpt2 import gelu_tanh, layer_norm

    rng = np.random.default_rng(0)
    xj, xt = _bf16((rng.standard_normal((64, 1024)) * 3).astype(np.float32))
    g = jax.jit(lambda v: jax.nn.gelu(v, approximate=True))(xj)
    assert torch.equal(_j2t(g), gelu_tanh(xt).float())
    wj, wt = _bf16(rng.standard_normal(1024).astype(np.float32))
    bj, bt = _bf16(rng.standard_normal(1024).astype(np.float32))
    want = _j2t(j_ln(xj, wj, bj, 1e-5))
    got = layer_norm(xt, wt, bt, 1e-5).float()
    differ = got != want
    assert differ.float().mean() <= 1e-4, int(differ.sum())
    ulp = torch.finfo(torch.bfloat16).eps * want.abs().clamp(min=1e-30)
    assert ((got - want).abs() <= ulp)[differ].all()


def _with_biases(jp, scale: float = 0.02, seed: int = 2):
    """``jp`` with seeded nonzero linear and LayerNorm biases (the presets
    start them at zero, where a dropped bias would not show), as numpy."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) not in ("b", "bias"):
            return x
        return (x.astype(np.float32) + scale * rng.standard_normal(x.shape, np.float32)
                ).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, jp)


def test_forward_matches_jax(model):
    cfg, jp, _ = model
    tree = _with_biases(jp)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64))
    want = np.asarray(j_forward(jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(ids),
                                attn_impl="naive"))
    got = forward(params_from_numpy(tree), cfg, torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 64, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_position_embeddings_matter(model):
    cfg, _, tp = model
    logits = forward(tp, cfg, torch.tensor([[7, 7, 7, 7]]))
    assert not torch.allclose(logits[0, 0], logits[0, 3], atol=1e-3)


def test_staged_pipeline_matches_layer_forward(model):
    from tgq_torch.calib.pipeline import (_group_input, _layer_forward_staged,
                                          _stage_attn, _stage_out, _stage_resid)

    cfg, _, tp = model
    lp = tp["model"]["layers"][0]
    x = torch.randn((2, 16, cfg.hidden_size), generator=torch.Generator().manual_seed(3))
    x = x.bfloat16()
    cos, sin = rope_cache(cfg, 16)
    want = decoder_layer(lp, cfg, x, cos, sin)
    attn = _stage_attn(lp, cfg, x, cos, sin)
    assert torch.equal(_stage_out(lp, cfg, _stage_resid(lp, cfg, x, attn)), want)
    assert torch.equal(_layer_forward_staged(lp, cfg, x, cos, sin), want)
    if cfg.family == "gpt2":
        from tgq_torch.models.gpt2 import gpt2_decoder_layer

        assert torch.equal(gpt2_decoder_layer(lp, cfg, x), want)
    widths = [cfg.hidden_size, cfg.hidden_size, cfg.hidden_size, cfg.intermediate_size]
    for gi, d in enumerate(widths):
        assert _group_input(lp, cfg, gi, x, cos, sin).shape == (2, 16, d)


def _codes(pl):
    return unpack_rows(torch.as_tensor(np.array(pl.codes)).T, pl.bits, pl.group_size,
                       pl.in_features).numpy()


# Codes agreeing over the whole model, measured on the CPU (W4 g32,
# pchol): 0.8087 (tiny-gpt2) and 0.7913 (tiny-opt); held to 3 points less.
# Layer 0's first group agrees 99.9 % (the LayerNorm's rare one-ulp
# differences); past it the softmax's exp differences reach the Hessians,
# and a Hessian a few ulps off reorders pchol's pivots among near-ties,
# which moves whole columns of codes while the error stays that of an
# equally good solution (rel_error within 3.4 % of JAX's per module).
AGREEMENT = {"tiny-gpt2": 0.78, "tiny-opt": 0.76}
REL_ERROR_FACTOR = 1.10


def test_quantize_matches_jax(model):
    cfg, jp, tp = model
    calib = synthetic_calibration(cfg.vocab_size, n_samples=8, seq_len=64, seed=42)
    kw = dict(mode="pchol", w_bits=4, group_size=32, batch_size=4, block_size=32,
              eps=1e-6, threshold_method="energy", attn_impl="naive")
    _, jpacked, jlog = j_quantize(copy.deepcopy(jp), cfg, calib, JConfig(**kw))
    _, tpacked, tlog = quantize_model(copy.deepcopy(tp), cfg, calib, QuantizeConfig(**kw),
                                      device="cpu")
    assert [(s["name"], s["rank"]) for s in tlog["layer_stats"]] == \
        [(s["name"], s["rank"]) for s in jlog["layer_stats"]]
    assert set(tpacked) == set(jpacked)
    same = total = 0
    for key, pl in tpacked.items():
        tc, jc = _codes(pl), _codes(jpacked[key])
        same += int((tc == jc).sum())
        total += tc.size
    print(f"{cfg.name}: codes agreeing with the JAX package {same / total:.4f}")
    assert same / total >= AGREEMENT[cfg.name], same / total
    for t, j in zip(tlog["layer_stats"], jlog["layer_stats"]):
        assert t["rel_error"] <= t["rtn_rel_error"], t
        assert 1 / REL_ERROR_FACTOR <= t["rel_error"] / j["rel_error"] <= REL_ERROR_FACTOR, (t, j)


def test_greedy_generate_matches_jax():
    """tiny-opt quantized at W8 by the JAX package, then greedy generation
    in both packages from the same weights."""
    from tgq.models.causal_lm import greedy_generate as j_generate
    from tgq_torch.models.causal_lm import greedy_generate

    cfg = PRESETS["tiny-opt"]
    jp = init_params(cfg, jax.random.key(0))
    calib = synthetic_calibration(cfg.vocab_size, n_samples=4, seq_len=32, seed=0)
    jq, _, _ = j_quantize(jp, cfg, calib, JConfig(mode="pchol", w_bits=8, group_size=32,
                                                  batch_size=2, block_size=32,
                                                  attn_impl="naive", eps=1e-6))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq))
    prompt = [1, 5, 9, 200, 3]
    want = j_generate(jq, cfg, prompt, 12, attn_impl="naive")
    got = greedy_generate(tq, cfg, prompt, 12)
    ids = torch.tensor([prompt + want])
    logits = forward(tq, cfg, ids)[0, len(prompt) - 1:-1]
    top2 = torch.topk(logits, 2, dim=-1).values
    ties = torch.nonzero(top2[:, 0] - top2[:, 1] < 1e-2)
    k = int(ties[0]) if len(ties) else len(want)
    assert len(got) == len(want) == 12
    assert k >= 1 and got[:k] == want[:k], (got, want, k)


@pytest.mark.parametrize("preset", FAMILIES)
def test_serving_rejects_family(preset):
    from tgq_torch.models import PRESETS as T_PRESETS
    from tgq_torch.models.causal_lm import init_params as t_init
    from tgq_torch.serve import Engine, ServeConfig

    cfg = T_PRESETS[preset]
    with pytest.raises(NotImplementedError, match="llama-family"):
        Engine(t_init(cfg, device="cpu"), cfg, ServeConfig(max_slots=1), device="cpu")


def test_truncated_solve_above_rtn_in_both_packages():
    """Where the trace rule keeps few columns, the truncated solve lands
    above RTN in its own metric in the JAX package as well as in the
    port: tiny-gpt2 at 4 layers and 512-token sequences, eps 1e-2, makes
    layer 3's attention output nearly rank-deficient (measured: rank 14 /
    13 of 64, rel_error 0.0830 port / 0.0843 JAX against RTN's 0.0676).
    This is why PERF.md holds rel_error to RTN only where pchol keeps at
    least half the columns, and caps it at a ratio below."""
    import dataclasses

    from tgq.calib.data import get_loaders

    cfg = dataclasses.replace(PRESETS["tiny-gpt2"], num_layers=4, max_position_embeddings=512)
    jp = init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    calib = get_loaders("synthetic", None, 4, 512, seed=42, vocab_size=cfg.vocab_size)
    kw = dict(mode="pchol", w_bits=4, group_size=32, batch_size=4, eps=1e-2,
              attn_impl="naive", block_size=32)
    _, _, tlog = quantize_model(copy.deepcopy(tp), cfg, calib, QuantizeConfig(**kw),
                                device="cpu")
    _, _, jlog = j_quantize(copy.deepcopy(jp), cfg, calib, JConfig(**kw))
    name = "layer_3.attn.c_proj"
    t = next(s for s in tlog["layer_stats"] if s["name"] == name)
    j = next(s for s in jlog["layer_stats"] if s["name"] == name)
    assert 4 * t["rank"] < cfg.hidden_size and 4 * j["rank"] < cfg.hidden_size, (t, j)
    assert t["rel_error"] > 1.1 * t["rtn_rel_error"] and j["rel_error"] > 1.1 * t["rtn_rel_error"]
    assert abs(t["rel_error"] / j["rel_error"] - 1) <= 0.1, (t, j)


def test_truncated_solve_above_rtn_at_eps_1e_6():
    """At the eps phase 8 of ``chip_smoke.py`` uses (1e-6), a Hessian of
    low rank puts the truncated solve above RTN in both packages as well:
    tiny-opt calibrated on one 32-token sequence keeps at most 32 columns
    of any group, and layer 0's fc2 (rank 32 of 256) reads rel_error
    1.6265x RTN's in the JAX package and 1.6231x in the port (measured).
    So the rule "at most RTN's" cannot hold below half the rank; phase 8
    caps those modules at the ratio the card read instead (PERF.md)."""
    from tgq.calib.data import get_loaders

    cfg = PRESETS["tiny-opt"]
    jp = init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    calib = get_loaders("synthetic", None, 1, 32, seed=42, vocab_size=cfg.vocab_size)
    kw = dict(mode="pchol", w_bits=4, group_size=32, batch_size=4, eps=1e-6,
              attn_impl="naive", block_size=32)
    _, _, tlog = quantize_model(copy.deepcopy(tp), cfg, calib, QuantizeConfig(**kw),
                                device="cpu")
    _, _, jlog = j_quantize(copy.deepcopy(jp), cfg, calib, JConfig(**kw))
    name = "layer_0.fc2"
    t = next(s for s in tlog["layer_stats"] if s["name"] == name)
    j = next(s for s in jlog["layer_stats"] if s["name"] == name)
    assert t["rank"] == j["rank"] == 32 and 2 * t["rank"] < cfg.intermediate_size, (t, j)
    assert t["rel_error"] > 1.5 * t["rtn_rel_error"] and j["rel_error"] > 1.5 * t["rtn_rel_error"]
    assert abs(t["rel_error"] / j["rel_error"] - 1) <= 0.05, (t, j)


@pytest.mark.parametrize("preset", FAMILIES)
def test_checkpoint_round_trip(tmp_path, preset):
    """``core.checkpoint`` keeps the family and the biased GPT-2/OPT trees
    (LayerNorm biases, packed linears with biases, wpe): the port loads
    its own checkpoint leaf for leaf, and the JAX package loads it too."""
    from tgq.core.checkpoint import load_quantized as j_load_quantized
    from tgq_torch.core.checkpoint import load_quantized, save_quantized
    from tgq_torch.core.packing import PackedLinear
    from tgq_torch.models import PRESETS as T_PRESETS
    from tgq_torch.models.causal_lm import get_nested, linear_weight
    from tgq_torch.models.causal_lm import init_params as t_init

    cfg = T_PRESETS[preset]
    params = t_init(cfg, seed=2, device="cpu")
    for lp in params["model"]["layers"]:  # nonzero biases, to see them kept
        for mod in lp.values():
            for leaf in mod.values():
                if isinstance(leaf, dict) and "b" in leaf:
                    leaf["b"] += torch.linspace(-1, 1, leaf["b"].numel()).bfloat16()
    calib = synthetic_calibration(cfg.vocab_size, n_samples=2, seq_len=16, seed=1)
    params, packed, _ = quantize_model(params, cfg, calib, QuantizeConfig(mode="rtn",
                                                                          group_size=32),
                                       device="cpu")
    save_quantized(str(tmp_path), params, packed, cfg, {"w_bits": 4})
    tree, cfg2, _ = load_quantized(str(tmp_path), device="cpu")
    assert cfg2 == cfg and cfg2.family == cfg.family
    assert torch.equal(tree["model"]["wpe"]["weight"], params["model"]["wpe"]["weight"])
    assert torch.equal(tree["model"]["norm"]["bias"], params["model"]["norm"]["bias"])
    for key, pl in packed.items():
        li, path = key.split(".", 2)[1:]
        got = get_nested(tree["model"]["layers"][int(li)], path)
        assert isinstance(got, PackedLinear) and torch.equal(got.codes, pl.codes), key
        assert torch.equal(got.bias, pl.bias), key
        assert torch.equal(linear_weight(got), pl.dequantize()), key
    w = params["model"]["layers"][0]["attn" if cfg.family == "gpt2" else "self_attn"]
    assert linear_weight(next(iter(w.values()))) is next(iter(w.values()))["w"]
    jtree, jcfg, _ = j_load_quantized(str(tmp_path))
    assert jcfg.family == cfg.family and jcfg.num_layers == cfg.num_layers
    assert len(jtree["model"]["layers"]) == cfg.num_layers
