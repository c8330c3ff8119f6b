"""Tensor-parallel serving of the port on 2 gloo CPU ranks (one spawn for
the module) against the JAX package:

- the port's TP engine (each rank its kv heads, chunk-window decode with
  K5's plain version) against tgq's TP ``"kernel"`` engine run in TPU
  interpret mode, at ``tests/test_serve_tp.py``'s configuration
  (tiny-qwen3-kv128, 2 slots, decode chunk 2), for kv 8 and 4, by the dry
  run's rule: tokens equal up to and including the first step whose
  single-rank top-2 margin is below 0.05 (XLA's ``exp`` differs from
  torch's in the last bit, ROADMAP.md queue 3), and the ranks' tokens
  identical.  That rule alone compares few decode steps on this random
  model (k = 2 and 1 steps for the two prompts at kv 8, 3 and 1 at kv 4),
  so every step is also teacher-forced on the port's tokens through both
  TP paths, the chunk of two in window mode and the step after its flush:
  the logits agree within 0.02 (the dry run's ``LOGIT_TOL``; measured
  0.0069 at kv 8 and 0.0149 at kv 4, logits of magnitude 0.65, against
  0.22-0.51 when the window's first row is dropped from the attention);
- ``quantized_matmul_tp`` for bits 4/3/2, column- and row-parallel,
  against the single-rank packed matmul and against tgq's
  ``quantized_matmul_tp`` (atol 1e-4, the tolerance of
  ``tests/test_serve_tp.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from tgq_torch.models import PRESETS

CFG = PRESETS["tiny-qwen3-kv128"]
PROMPTS = [[5, 17, 42, 100], [7, 7, 9]]
BITS = (4, 3, 2)


def _matmul_case(bits: int):
    """(x, int codes, scale, zero) of a (96, 64) weight at group 32."""
    rng = np.random.default_rng(bits)
    n, m, t = 64, 96, 8
    w = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal((t, n)).astype(np.float32)
    qmax = 2 ** bits - 1
    wg = w.reshape(m, n // 32, 32)
    lo, hi = wg.min(-1), wg.max(-1)
    scale = ((hi - lo) / qmax).astype(np.float32)
    zero = np.round(-lo / scale).astype(np.float32)
    q = np.clip(np.round(wg / scale[..., None]) + zero[..., None], 0, qmax).reshape(m, n)
    return x, q.astype(np.int32), scale, zero


def _packed(bits: int, kind=None):
    from tgq_torch.core.packing import PackedLinear
    from tgq_torch.core.quant import QuantSpec

    _, q, scale, zero = _matmul_case(bits)
    p = PackedLinear.from_codes(torch.from_numpy(q), torch.from_numpy(scale),
                                torch.from_numpy(zero), QuantSpec(bits, 32, sym=False))
    return dataclasses.replace(p, tp_kind=kind)


def _ranks(path: str) -> dict:
    """One of 2 ranks: the TP engine for kv 8 and 4, then the TP matmuls."""
    from tgq_torch.kernels.dequant_matmul import quantized_matmul
    from tgq_torch.parallel import make_mesh, quantized_matmul_tp, shard_params
    from tgq_torch.parallel.dryrun import engine_tokens, teacher_forced

    params = torch.load(path, weights_only=False)
    mesh = make_mesh(data=1, model=2)
    out = {kv: engine_tokens(params, CFG, kv, PROMPTS, mesh, "cpu") for kv in (8, 4)}
    # the TP decode path (chunk-window mode) teacher-forced on its own tokens
    forced = {kv: [teacher_forced(params, CFG, kv, p, t, mesh, "cpu", chunk=2)
                   for p, t in zip(PROMPTS, out[kv])] for kv in (8, 4)}
    mm = {}
    for bits in BITS:
        x = torch.from_numpy(_matmul_case(bits)[0])
        for kind in ("col", "row"):
            w = _packed(bits, kind)
            spec = {"col": "q_proj", "row": "o_proj"}[kind]
            local = shard_params({spec: w}, mesh)[spec]
            h = x.shape[1] // 2
            xl = x if kind == "col" else x[:, mesh.model_rank * h:(mesh.model_rank + 1) * h]
            y = quantized_matmul_tp(xl, local, mesh)
            mm[(bits, kind)] = (y, quantized_matmul(x, dataclasses.replace(w, tp_kind=None)))
    return {"tokens": out, "forced": forced, "matmul": mm}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax

    from tgq.models import PRESETS as JP
    from tgq.models import init_params as j_init
    from tgq_torch.models.convert import params_from_numpy
    from tgq_torch.parallel.launch import spawn

    jp = j_init(JP["tiny-qwen3-kv128"], jax.random.key(3))
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    path = str(tmp_path_factory.mktemp("serve_tp") / "params.pt")
    torch.save(params, path)
    return jp, params, spawn(_ranks, 2, args=(path,), device="cpu", timeout_s=300)


@functools.lru_cache(maxsize=None)
def _jax_decode_core():
    """JAX's ``_decode_core`` under one jit for every teacher-forced call."""
    import jax

    from tgq.serve.decode import _decode_core

    return jax.jit(_decode_core, static_argnames=("cfg", "attn_impl"))


def _jax_teacher_forced(eng, mesh, toks, chunk: int = 2) -> list:
    """JAX's TP kernel path teacher-forced on ``toks`` (one list a prompt
    of PROMPTS, each prompt in its own slot) in a TP engine's sharded
    params and pools: prefill, then decode chunks of up to ``chunk`` steps
    as ``tgq.serve.decode.decode_steps`` runs them (window mode for a
    chunk of more than one step, then one flush).  Returns each prompt's
    (steps, vocab) logits."""
    import jax.numpy as jnp

    from tgq.parallel.mesh import serving_mesh_scope
    from tgq.serve.decode import prefill
    from tgq.serve.kv_cache import window_flush, window_init, window_write_step

    cfg, core = eng.cfg, _jax_decode_core()
    i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    table = i32([[1, 2, 3, 4], [5, 6, 7, 8]])
    cache = eng.cache   # positions past a prompt's length are never read
    out = [[] for _ in PROMPTS]
    for s, prompt in enumerate(PROMPTS):
        ids = i32([list(prompt) + [0] * (32 - len(prompt))])
        logits, cache = prefill(eng.params, cache, cfg, table[s], ids, jnp.int32(len(prompt)),
                                mesh=mesh)
        out[s].append(np.asarray(logits))
    steps = [list(t[:-1]) for t in toks]
    with serving_mesh_scope(mesh):
        for c0 in range(0, len(steps[0]), chunk):
            n = min(chunk, len(steps[0]) - c0)
            win = window_init(cache, len(PROMPTS), n) if n > 1 else None
            for j in range(n):
                ln = [len(p) + 1 + c0 + j for p in PROMPTS]
                args = (eng.params, cache, cfg, table, i32(ln), i32([t[c0 + j] for t in steps]),
                        i32(ln) - 1)
                if win is None:
                    logits, cache, _ = core(*args, attn_impl=eng.attn_impl)
                else:
                    logits, _, rows = core(*args, attn_impl=eng.attn_impl, win=win,
                                           w_live=i32(j))
                    win = window_write_step(win, i32(j), rows[0], rows[1])
                for s in range(len(PROMPTS)):
                    out[s].append(np.asarray(logits[s]))
            if win is not None:
                cache = window_flush(cache, win, table, i32([len(p) + c0 for p in PROMPTS]), n)
    return [np.stack(o).astype(np.float32) for o in out]


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_tp_engine_matches_jax_tp_kernel_engine(ranks, kv_bits):
    import copy

    import jax
    from jax._src.pallas.mosaic.interpret.interpret_pallas_call import (
        InterpretParams,
        force_tpu_interpret_mode,
    )

    from tgq.models import PRESETS as JP
    from tgq.parallel import make_mesh
    from tgq.serve import Engine, ServeConfig
    from tgq_torch.parallel.dryrun import LOGIT_TOL, teacher_forced, tie_free_prefix

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jp, params, res = ranks
    mesh = make_mesh(data=4, devices=jax.devices()[:8])   # model axis 2
    scfg = ServeConfig(max_slots=2, page_size=8, num_pages=32, max_pages_per_slot=4,
                       max_new_tokens=4, decode_chunk=2, kv_bits=kv_bits, attn_impl="kernel")
    with force_tpu_interpret_mode(InterpretParams(detect_races=False)):
        eng = Engine(copy.deepcopy(jp), JP["tiny-qwen3-kv128"], scfg, mesh=mesh)
        assert kv_bits != 4 or eng.cache.pack_segments == 2
        reqs = [eng.submit(p) for p in PROMPTS]
        eng.run()
    tp = [r["tokens"][kv_bits] for r in res]
    assert tp[0] == tp[1]   # every rank holds the same tokens
    for prompt, want, got in zip(PROMPTS, [r.output for r in reqs], tp[0]):
        k = tie_free_prefix(teacher_forced(params, CFG, kv_bits, prompt, want))
        assert got[:k] == want[:k], (kv_bits, got, want, k)
        assert len(got) == len(want) == 4
    # teacher-forced on the port's tokens, every decode step (the window
    # chunk and the single step after it) against JAX's TP kernel path
    with force_tpu_interpret_mode(InterpretParams(detect_races=False)):
        forced = _jax_teacher_forced(eng, mesh, tp[0])
    for pi, want_lg in enumerate(forced):
        lg = [r["forced"][kv_bits][pi] for r in res]
        np.testing.assert_array_equal(lg[0], lg[1])
        assert lg[0].shape == want_lg.shape == (4, CFG.vocab_size)
        np.testing.assert_allclose(lg[0], want_lg, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("bits", BITS)
def test_tp_matmul_matches_single_rank_and_jax(ranks, bits):
    import jax
    import jax.numpy as jnp

    from tgq.core.packing import PackedLinear as JPacked
    from tgq.core.quant import QuantSpec as JSpec
    from tgq.parallel import make_mesh
    from tgq.parallel.mesh import quantized_matmul_tp as j_tp

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    x, q, scale, zero = _matmul_case(bits)
    mesh = make_mesh(data=4, devices=jax.devices()[:8])
    for kind in ("col", "row"):
        jw = dataclasses.replace(
            JPacked.from_codes(jnp.asarray(q), jnp.asarray(scale), jnp.asarray(zero),
                               JSpec(bits=bits, group_size=32, sym=False)), tp_kind=kind)
        with mesh:
            want = np.asarray(j_tp(jnp.asarray(x), jw, mesh))
        ys = [r["matmul"][(bits, kind)] for r in ranks[2]]
        y = np.concatenate([a for a, _ in ys], axis=-1) if kind == "col" else ys[0][0]
        if kind == "row":
            np.testing.assert_array_equal(ys[0][0], ys[1][0])
        np.testing.assert_allclose(y, ys[0][1], rtol=0, atol=1e-4)
        np.testing.assert_allclose(y, want, rtol=0, atol=1e-4)
