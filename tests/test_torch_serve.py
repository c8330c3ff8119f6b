"""The port's serving path on the CPU (the kernels' plain versions): paged
decode against full-recompute greedy, the continuous-batching engine's
lifecycle, and the port's Engine against the JAX package's Engine on the
same packed weights.

Mirrors ``tests/test_serve.py``.  Greedy decode through the paged cache
must equal full-recompute ``forward`` token for token (bf16 KV).  Against
the JAX Engine (its Pallas attention kernel interpreted on the CPU, f32
like the port's plain K5) the teacher-forced logits of the two packages
differ by at most 0.0075 (measured 0.0071, logits of magnitude 0.55),
and greedy traces must agree before the first step whose top-2 logit
margin is below twice that, 0.015 — the margin rule of
``__graft_entry__._margins``.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tgq.models import PRESETS as J_PRESETS
from tgq.models import init_params as j_init_params
from tgq_torch.core.quant import QuantSpec
from tgq_torch.models import PRESETS
from tgq_torch.models.causal_lm import forward
from tgq_torch.models.convert import params_from_numpy
from tgq_torch.models.hf_import import init_packed_params
from tgq_torch.serve import Engine, ServeConfig
from tgq_torch.serve.decode import decode_step, fuse_packed_projections, prefill
from tgq_torch.serve.kv_cache import PagedKVCache

CFG = PRESETS["tiny-qwen3"]
MARGIN_TOL = 0.015


@pytest.fixture(scope="module")
def params():
    """tiny-qwen3 from the JAX package's init, as the JAX serve tests use."""
    return params_from_numpy(jax.tree.map(np.asarray, j_init_params(
        J_PRESETS["tiny-qwen3"], jax.random.key(0))))


@pytest.fixture(scope="module")
def packed():
    return init_packed_params(CFG, QuantSpec(bits=4, group_size=32), seed=0, device="cpu")


def greedy_reference(params, ids, n_new):
    ids, out = list(ids), []
    for _ in range(n_new):
        tok = int(forward(params, CFG, torch.tensor([ids]))[0, -1].argmax())
        out.append(tok)
        ids.append(tok)
    return out


def engine(params, **kw):
    base = dict(max_slots=2, page_size=8, num_pages=64, max_pages_per_slot=8,
                max_new_tokens=6)
    return Engine(copy.deepcopy(params), CFG, ServeConfig(**{**base, **kw}), device="cpu")


@pytest.mark.parametrize("which", ["dense", "packed"])
def test_paged_decode_matches_full_forward(params, packed, which):
    p = params if which == "dense" else packed
    eng = engine(p)
    prompt = [5, 17, 42, 100, 7]
    req = eng.submit(prompt)
    eng.run()
    assert req.output == greedy_reference(p, prompt, 6)


def test_continuous_batching_multiple_requests(packed):
    eng = engine(packed, max_new_tokens=4)
    prompts = [[1, 2, 3], [10, 20, 30, 40, 50], [99, 98], [7] * 9]
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    for r, p in zip(reqs, prompts):
        assert r.done and r.output == greedy_reference(packed, p, 4), p
    assert eng.pt.num_free == 63  # page 0 reserved, every other page returned


def test_chunked_decode_matches_stepwise(packed):
    prompt = [5, 17, 42, 100, 7]
    outs = []
    for chunk in (1, 8):
        eng = engine(packed, max_new_tokens=11, decode_chunk=chunk)
        req = eng.submit(prompt)
        eng.run()
        outs.append(req.output)
    assert outs[0] == outs[1] == greedy_reference(packed, prompt, 11)


def test_eos_mid_chunk_truncates(packed):
    prompt = [3, 1, 4]
    ref = greedy_reference(packed, prompt, 8)
    eng = engine(packed, max_slots=1, max_new_tokens=8, eos_id=ref[3], decode_chunk=8)
    req = eng.submit(prompt)
    eng.run()
    assert req.output == ref[: ref.index(ref[3]) + 1]


@pytest.mark.parametrize("with_eos", [False, True])
def test_overlap_host_token_identical(packed, with_eos):
    """Pipelined decode (chunk N+1 dispatched from chunk N's tokens on the
    device) emits the same tokens as synchronous ticks; with an EOS
    mid-chunk and a tiny page pool, every page still returns."""
    prompts = [[5, 17, 42], [7, 9], [3, 1, 4, 1, 5], [2, 6], [11, 13]]
    budgets = [7, 9, 8, 6, 7]
    eos = None
    if with_eos:
        probe = engine(packed, decode_chunk=4, overlap_host=False)
        preqs = [probe.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
        probe.run()
        eos = int(preqs[0].output[2])

    def run(overlap):
        kw = dict(num_pages=8, max_pages_per_slot=3) if with_eos else {}
        eng = engine(packed, decode_chunk=4, overlap_host=overlap, eos_id=eos, **kw)
        reqs = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
        eng.run()
        assert eng.pt.num_free == eng.scfg.num_pages - 1
        return [r.output for r in reqs]

    out = run(True)
    assert out == run(False)
    if with_eos:
        assert any(o and o[-1] == eos and len(o) < b for o, b in zip(out, budgets))


def test_engine_step_mid_flight_submit(packed):
    p1, p2 = [5, 17, 42, 100, 7], [9, 3, 3, 21]
    ref = engine(packed, decode_chunk=2)
    r1_ref, r2_ref = ref.submit(p1), ref.submit(p2)
    ref.run()
    eng = engine(packed, decode_chunk=2)
    r1 = eng.submit(p1)
    for _ in range(100):
        eng.step()
        if r1.output and not r1.done:
            break
    assert r1.output and not r1.done
    r2 = eng.submit(p2)
    for _ in range(200):
        if eng.idle:
            break
        eng.step()
    assert eng.idle and r1.done and r2.done
    assert (r1.output, r2.output) == (r1_ref.output, r2_ref.output)
    assert r2.first_token_t >= r2.submit_t > 0


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_quantized_kv_tracks_greedy(params, kv_bits):
    """As tests/test_serve.py: on the tiny model the margins dwarf the
    absmax KV noise, so int8 and int4 KV give the bf16 greedy tokens."""
    eng = engine(params, kv_bits=kv_bits, max_new_tokens=5)
    prompt = [5, 17, 42]
    req = eng.submit(prompt)
    eng.run()
    assert req.output == greedy_reference(params, prompt, 5)


def test_engine_a8_runs_and_tracks_a16(packed):
    prompts = [[5, 17, 42], [7, 9, 3, 1]]
    outs = {}
    for a_bits in (16, 8):
        eng = engine(packed, kv_bits=8, decode_chunk=2, a_bits=a_bits)
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        outs[a_bits] = [r.output for r in reqs]
        assert eng.a8_active == (a_bits == 8)
    agree = sum(a == b for o16, o8 in zip(outs[16], outs[8]) for a, b in zip(o16, o8))
    assert agree >= 6, outs


def test_sampling_uses_the_generator(packed):
    """Temperature sampling draws from the engine's torch.Generator: the
    same seed gives the same tokens (it cannot reproduce JAX's stream)."""
    runs = []
    for _ in range(2):
        eng = engine(packed, temperature=1.0, seed=3, max_new_tokens=8)
        req = eng.submit([5, 17, 42])
        eng.run()
        runs.append(req.output)
    assert runs[0] == runs[1] and len(runs[0]) == 8


def test_fused_projections_match_unfused(packed):
    fused = fuse_packed_projections(packed)
    lp = fused["model"]["layers"][0]
    assert "qkv_proj" in lp["self_attn"] and "gate_up_proj" in lp["mlp"]
    ids = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]])
    outs = []
    for p in (packed, fused):
        cache = PagedKVCache.init(CFG, 4, 8)
        logits, cache = prefill(p, cache, CFG, torch.tensor([1]), ids, 8)
        table = torch.tensor([[1, 2]], dtype=torch.int32)
        lens = torch.tensor([9], dtype=torch.int32)
        step, _ = decode_step(p, cache, CFG, table, lens, torch.tensor([7], dtype=torch.int32),
                              lens - 1)
        outs.append((logits, step))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-5, atol=1e-5)


def test_port_engine_matches_jax_engine_by_margin():
    """Same packed tiny-qwen3-kv128 weights (the JAX package's
    init_packed_params) through both engines, int8 KV.  Teacher-forced
    along the JAX trace, the two packages' logits differ by at most
    MARGIN_TOL / 2; the traces must agree up to the first step whose top-2
    margin is below MARGIN_TOL."""
    import jax.numpy as jnp
    from jax._src.pallas.mosaic.interpret.interpret_pallas_call import (
        InterpretParams,
        force_tpu_interpret_mode,
    )
    from tgq.core.quant import QuantSpec as JSpec
    from tgq.models.hf_import import init_packed_params as j_init_packed
    from tgq.serve import Engine as JEngine
    from tgq.serve import ServeConfig as JServeConfig
    from tgq.serve import decode as jd
    from tgq.serve.kv_cache import PagedKVCache as JCache

    cfg, jcfg = PRESETS["tiny-qwen3-kv128"], J_PRESETS["tiny-qwen3-kv128"]
    jparams = j_init_packed(jcfg, JSpec(bits=4, group_size=32), seed=0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    kw = dict(max_slots=2, page_size=8, num_pages=32, max_pages_per_slot=4,
              max_new_tokens=6, decode_chunk=4, kv_bits=8)
    prompts = [[5, 17, 42], [7, 9, 3, 1, 4]]

    def interpret():
        return force_tpu_interpret_mode(InterpretParams(detect_races=False))

    with interpret():
        jeng = JEngine(jparams, jcfg, JServeConfig(attn_impl="kernel", **kw))
        jreqs = [jeng.submit(p) for p in prompts]
        jeng.run()
    teng = Engine(tparams, cfg, ServeConfig(**kw), device="cpu")
    treqs = [teng.submit(p) for p in prompts]
    teng.run()
    tfused, jfused = fuse_packed_projections(tparams), jd.fuse_packed_projections(jparams)
    table = np.array([[1, 2]], np.int32)
    for prompt, jr, tr in zip(prompts, jreqs, treqs):
        ids = np.zeros((1, 8), np.int32)
        ids[0, :len(prompt)] = prompt
        tcache, jcache = PagedKVCache.init(cfg, 8, 8, kv_bits=8), JCache.init(jcfg, 8, 8, kv_bits=8)
        tl, tcache = prefill(tfused, tcache, cfg, torch.tensor([1]), torch.from_numpy(ids).long(),
                             len(prompt))
        with interpret():
            jl, jcache = jd.prefill(jfused, jcache, jcfg, jnp.array([1]), jnp.asarray(ids),
                                    jnp.int32(len(prompt)))
        steps = [(tl, np.asarray(jl))]
        for i, tok in enumerate(jr.output[:-1]):
            ln = np.array([len(prompt) + 1 + i], np.int32)
            tok = np.array([tok], np.int32)
            tl, tcache = decode_step(tfused, tcache, cfg, torch.from_numpy(table),
                                     torch.from_numpy(ln), torch.from_numpy(tok),
                                     torch.from_numpy(ln - 1))
            with interpret():
                jl, jcache = jd.decode_step(jfused, jcache, jcfg, jnp.asarray(table),
                                            jnp.asarray(ln), jnp.asarray(tok),
                                            jnp.asarray(ln - 1), attn_impl="kernel")
            steps.append((tl[0], np.asarray(jl)[0]))
        t_logits = torch.stack([t for t, _ in steps]).numpy()
        j_logits = np.stack([j for _, j in steps])
        assert np.abs(t_logits - j_logits).max() <= MARGIN_TOL / 2
        top2 = -np.sort(-j_logits, axis=-1)[:, :2]
        ties = np.nonzero(top2[:, 0] - top2[:, 1] < MARGIN_TOL)[0]
        k = int(ties[0]) if len(ties) else len(jr.output)
        assert k >= 1 and tr.output[:k] == jr.output[:k], (tr.output, jr.output, k)
        assert len(tr.output) == len(jr.output) == 6


def test_engine_rejects_mesh(packed):
    """A mesh of one rank serves the tokens of no mesh; a mesh whose model
    axis does not split the heads is rejected (the TP engine on more ranks:
    tests/test_torch_serve_tp.py)."""
    from tgq_torch.parallel import Mesh, make_mesh

    prompt = [5, 17, 42, 100, 7]
    outs = []
    for mesh in (None, make_mesh()):
        eng = Engine(packed, CFG, ServeConfig(max_new_tokens=5), mesh=mesh, device="cpu")
        req = eng.submit(prompt)
        eng.run()
        outs.append(req.output)
    assert outs[0] == outs[1] == greedy_reference(packed, prompt, 5)
    with pytest.raises(ValueError, match="split"):
        Engine(packed, CFG, ServeConfig(), mesh=Mesh(data=1, model=3), device="cpu")


def test_mark_act_bits_skips_head_and_wide_codes():
    from tgq_torch.serve.engine import _mark_act_bits

    p = init_packed_params(dataclasses.replace(CFG, tie_word_embeddings=False),
                           QuantSpec(bits=4, group_size=32), lm_head_bits=8, device="cpu")
    out, n = _mark_act_bits(p, 8)
    assert n == CFG.num_layers * 7
    assert out["lm_head"].act_bits == 16
    assert out["model"]["layers"][0]["mlp"]["down_proj"].act_bits == 8
    assert p["model"]["layers"][0]["mlp"]["down_proj"].act_bits == 16  # input untouched
