"""Where the port's quantization departs from the JAX package's on the CPU,
and why: each departure is traced to its cause and the rest is shown to
agree bit for bit.

1. Attention.  With pchol at g32 (actorder set), codes agree 82.1 % (W4)
   and 96.6 % (W8) over tiny-qwen3 with this file's 4 x 32 calibration
   tokens (an earlier measurement with other tokens: 90.4 % / 92.0 %).
   The cause is ``exp``: XLA:CPU's f32 ``exp`` and torch's differ in the
   last bit for about one value in ten, in the attention's softmax and in
   silu.  Given the JAX package's attention output for layer 0
   (``quantize_layer(attn=...)``), the o_proj and gate/up Hessians, every
   rank and the codes of q/k/v/o/gate/up are bit-equal.  down_proj's
   input, silu(gate)·up, still differs in about one value in 10^4 (silu's
   ``exp``), and its Gram, which both packages take from the transposed
   (ff, tokens) operand, sums in another order on XLA:CPU: its Hessian is
   within 1e-6 of max|H| (measured 3.4e-7 / 9.0e-8) and its codes agree at
   least 99 % (measured 99.60 % / 99.96 %).  End to end the agreement is
   pinned at the measured value less 3 points, and every module's
   rel_error within 5 % of JAX's (measured at most 3.4 %).  On CUDA the
   port's attention is SDPA, so all of this is a property of the CPU path.
2. svd mode.  Its Gaussian sketch comes from a ``torch.Generator``, not
   from ``jax.random``, so the two agree in distribution only (codes 62.8 %
   / 64.1 % in the earlier measurement).  Given JAX's finalized sketch, the
   port's factorization (scipy in f64 on the host in both) and GPTQ give
   JAX's rank, pivots, factor and codes bit for bit; end to end, per-module
   rel_error is within 10 % of JAX's (measured at most 5.7 % at W4 and
   7.1 % at W8 here; 4.9 % / 6.4 % in the earlier measurement).
3. Temperature sampling.  Given the same uniform noise the port's sampler
   (``serve.decode._sample_tokens``) picks JAX's tokens.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgq.calib import QuantizeConfig as JConfig
from tgq.calib import quantize_model as j_quantize
from tgq.calib import pipeline as jpipe
from tgq.calib.data import synthetic_calibration
from tgq.models import PRESETS, init_params
from tgq.models.causal_lm import rope_cache as j_rope_cache
from tgq.solver.hessian import HessianAccumulator as JHessian
from tgq_torch.calib import QuantizeConfig
from tgq_torch.calib import pipeline as tpipe
from tgq_torch.calib import quantize_model
from tgq_torch.core.packing import unpack_rows
from tgq_torch.models.causal_lm import rope_cache, tree_to
from tgq_torch.models.convert import params_from_numpy, tensor_from_numpy
from tgq_torch.solver.hessian import HessianAccumulator

CFG = PRESETS["tiny-qwen3"]
BS = 2


def _kw(w_bits, mode="pchol"):
    return dict(mode=mode, w_bits=w_bits, group_size=32, actorder=True, batch_size=BS,
                block_size=32, eps=1e-6, threshold_method="energy", attn_impl="naive")


@pytest.fixture(scope="module")
def model():
    jp = init_params(CFG, jax.random.key(0))
    calib = synthetic_calibration(CFG.vocab_size, n_samples=4, seq_len=32, seed=42)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp)), calib


def _codes(pl):
    return unpack_rows(torch.as_tensor(np.array(pl.codes)).T, pl.bits, pl.group_size,
                       pl.in_features).numpy()


def _f32_bits(h):
    return np.asarray(h, np.float32).view(np.int32)


@pytest.mark.parametrize("w_bits", [4, 8])
def test_layer0_bit_equal_given_jax_attention(model, w_bits):
    jp, tp, calib = model
    jq, jpacked, jlog = j_quantize(copy.deepcopy(jp), CFG, calib, JConfig(**_kw(w_bits)),
                                   stop_after_layer=0)
    jlp = jax.device_put(jq["model"]["layers"][0])
    seq = calib.shape[1]
    jcos, jsin = j_rope_cache(CFG, seq)
    jx = jnp.asarray(tp["model"]["embed_tokens"]["weight"][torch.from_numpy(
        calib.astype(np.int64))].view(torch.int16).numpy()).view(jnp.bfloat16)
    jattn = [jpipe._stage_attn(jlp, CFG, jx[j:j + BS], jcos, jsin, attn_impl="naive")
             for j in range(0, len(calib), BS)]
    attn = [tensor_from_numpy(np.asarray(a)) for a in jattn]

    x = tpipe._embed_batches(tp, CFG, calib, BS, "cpu")
    cos, sin = rope_cache(CFG, seq)
    lp, _, stats, packed = tpipe.quantize_layer(
        tree_to(tp["model"]["layers"][0], "cpu"), CFG, x, cos, sin,
        QuantizeConfig(**_kw(w_bits)), name_prefix="layer_0.", attn=attn)
    # the Hessians of groups 1-3, each package through its own pipeline
    # functions on its own quantized layer
    h_t, h_j = [HessianAccumulator.init(d) for d in (64, 64, 128)], \
        [JHessian.init(d) for d in (64, 64, 128)]
    for jj, j in enumerate(range(0, len(calib), BS)):
        x2 = tpipe._stage_resid(lp, CFG, x[j:j + BS], attn[jj])
        h_t[0].update(attn[jj])
        h_t[1].update(tpipe.mlp_input(lp, CFG, x2))
        h_t[2].update_t(tpipe._stage_act_t(lp, CFG, x2))
        jx2 = jpipe._stage_resid(jlp, CFG, jx[j:j + BS], jattn[jj])
        h_j[0] = h_j[0].update(jattn[jj])
        h_j[1] = h_j[1].update(jpipe._stage_mlp_in(jlp, CFG, jx2))
        h_j[2] = JHessian(h=jpipe._accum_act_gram_t(h_j[2].h, jlp, CFG, jx2),
                          n_samples=h_j[2].n_samples + BS * seq)
    for name, a, b in zip(("o_proj", "gate/up"), h_t, h_j):
        np.testing.assert_array_equal(_f32_bits(a.finalize()), _f32_bits(b.finalize()),
                                      err_msg=name)
    h3_t, h3_j = h_t[2].finalize().numpy(), np.asarray(h_j[2].finalize())
    h3_err = np.abs(h3_t - h3_j).max() / np.abs(h3_j).max()
    assert [(s["name"], s["rank"]) for s in stats] == \
        [(s["name"], s["rank"]) for s in jlog["layer_stats"]]
    down = 0.0
    for name, pl in packed.items():
        tc, jc = _codes(pl), _codes(jpacked[f"layers.0.{name}"])
        if name == "mlp.down_proj":
            down = float((tc == jc).mean())
        else:
            np.testing.assert_array_equal(tc, jc, err_msg=name)
    print(f"W{w_bits}: down_proj Hessian max|dH|/max|H| {h3_err:.2e}, codes agreeing {down:.4f}")
    assert h3_err <= 1e-6 and down >= 0.99, (h3_err, down)


# measured here: 0.8210 (W4) and 0.9661 (W8) of the codes agree
AGREEMENT = {4: 0.791, 8: 0.936}


@pytest.mark.parametrize("w_bits", [4, 8])
def test_code_agreement_pinned(model, w_bits):
    jp, tp, calib = model
    _, jpacked, jlog = j_quantize(copy.deepcopy(jp), CFG, calib, JConfig(**_kw(w_bits)))
    _, tpacked, tlog = quantize_model(copy.deepcopy(tp), CFG, calib,
                                      QuantizeConfig(**_kw(w_bits)), device="cpu")
    same = sum(int((_codes(pl) == _codes(jpacked[k])).sum()) for k, pl in tpacked.items())
    total = sum(_codes(pl).size for pl in tpacked.values())
    print(f"W{w_bits} g32 actorder: codes agreeing {same / total:.4f}")
    assert same / total >= AGREEMENT[w_bits], same / total
    for t, j in zip(tlog["layer_stats"], jlog["layer_stats"]):
        assert t["name"] == j["name"]
        assert abs(t["rel_error"] / j["rel_error"] - 1) <= 0.05, (t, j)


def test_svd_bit_equal_given_jax_sketch(model):
    """Layer 0's q/k/v sketch as the JAX package finalizes it, into both
    packages' ``sketch_factor`` and GPTQ loop for q_proj."""
    from tgq.core.quant import QuantSpec as JSpec
    from tgq.solver.factorize import sketch_factor as j_sketch_factor
    from tgq.solver.gptq_loop import quantize_weight as j_quantize_weight
    from tgq.solver.hessian import SketchAccumulator
    from tgq_torch.core.quant import QuantSpec
    from tgq_torch.solver.factorize import sketch_factor
    from tgq_torch.solver.gptq_loop import quantize_weight

    jp, tp, calib = model
    jlp = jax.device_put(jp["model"]["layers"][0])
    jx = jnp.asarray(np.asarray(jp["model"]["embed_tokens"]["weight"]))[calib]
    acc = SketchAccumulator.init(CFG.hidden_size, rank=4 * CFG.hidden_size, seed=42)
    for j in range(0, len(calib), BS):
        acc = acc.update(jpipe._group_input(jlp, CFG, 0, jx[j:j + BS], None, None))
    y = np.asarray(acc.finalize())
    fj = j_sketch_factor(y, eps=1e-2, method="mean_trimmed")
    ft = sketch_factor(y, eps=1e-2, method="mean_trimmed")
    assert ft.rank == fj.rank
    np.testing.assert_array_equal(np.asarray(ft.perm), np.asarray(fj.perm))
    np.testing.assert_array_equal(_f32_bits(ft.r_full), _f32_bits(fj.r_full))
    w = tp["model"]["layers"][0]["self_attn"]["q_proj"]["w"].float()
    for bits in (4, 8):
        rt = quantize_weight(w, ft, QuantSpec(bits=bits, group_size=32), block_size=32)
        rj = j_quantize_weight(jnp.asarray(w.numpy()), fj, JSpec(bits=bits, group_size=32),
                               block_size=32)
        np.testing.assert_array_equal(rt.codes.numpy(), np.asarray(rj.codes))


@pytest.mark.parametrize("w_bits", [4, 8])
def test_svd_rel_error_within_ten_percent(model, w_bits):
    jp, tp, calib = model
    kw = _kw(w_bits, mode="svd")
    _, _, jlog = j_quantize(copy.deepcopy(jp), CFG, calib, JConfig(**kw))
    _, _, tlog = quantize_model(copy.deepcopy(tp), CFG, calib, QuantizeConfig(**kw),
                                device="cpu")
    gaps = [abs(t["rel_error"] / j["rel_error"] - 1)
            for t, j in zip(tlog["layer_stats"], jlog["layer_stats"])]
    print(f"svd W{w_bits}: most rel_error gap {max(gaps):.4f}")
    assert len(gaps) == 14 and max(gaps) <= 0.10, gaps


def test_sampler_same_tokens_given_same_noise(monkeypatch):
    from tgq.serve.decode import _sample_tokens as j_sample
    from tgq_torch.serve import decode

    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((8, 512)) * 3).astype(np.float32)
    temps = np.asarray([0.0, 0.5, 1.0, 2.0, 0.0, 0.7, 1.3, 10.0], np.float32)
    key = jax.random.key(7)
    want, _ = j_sample(jnp.asarray(logits), jnp.asarray(temps), key)
    _, sub = jax.random.split(key)
    u = jax.random.uniform(sub, logits.shape, jnp.float32,
                           minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
    monkeypatch.setattr(decode, "_uniform",
                        lambda shape, gen, device: torch.from_numpy(np.array(u)))
    got = decode._sample_tokens(torch.from_numpy(logits), torch.from_numpy(temps),
                                torch.Generator())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got[1:4].tolist())) > 1  # the noise, not the argmax, chose
