"""K5's chunk-window mode (``w_live``, ``return_stats``) and the window
path of tensor-parallel decode, on the CPU against the JAX package:

- the plain version against tgq's Pallas kernel, run interpreted as
  ``tests/test_paged_attention.py::test_kernel_chunk_window_matches_oracle``
  runs it, for bf16, int8 and int4 pools;
- each rank's K5 on its own kv heads against tgq's ``_kernel_attention_tp``
  (the kernel under ``shard_map`` on the 8-device CPU mesh), the int4
  pools packed with one segment a rank against tgq's ``pack_segments ==
  tp`` pools sliced by shard;
- ``_window_partial`` and ``_merge_partials`` against tgq's;
- ``window_flush``'s codes and scales bit for bit, with equalizers and a
  dead slot;
- K5's split emulation with the pools' range shrunk by the window.

Tolerances: attention and partials rtol = atol = 1e-5 (the port's K5
tests); the emulation against the plain version 1e-6; pools bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgq.kernels.paged_attention import paged_decode_attention as j_attn
from tgq_torch.kernels import paged_attention as K5
from tgq_torch.serve import decode as tdec
from tgq_torch.serve import kv_cache as tkv

from test_torch_k5_split import KVH, LENS, emulate_k5, make_case

TOL = dict(rtol=1e-5, atol=1e-5)
W = 8


@pytest.fixture
def interpret():
    from jax._src.pallas.mosaic.interpret.interpret_pallas_call import (
        InterpretParams,
        force_tpu_interpret_mode,
    )

    with force_tpu_interpret_mode(InterpretParams(detect_races=False)):
        yield


def jx(t):
    """A port tensor as one layer of tgq's layer-stacked pools."""
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)[None]
    return jnp.asarray(t.numpy())[None]


@pytest.mark.parametrize("kv_bits,w_live", [(16, 0), (8, W - 1), (4, 1), (16, W)])
def test_window_kernel_matches_jax(rng, interpret, kv_bits, w_live):
    slots = len(LENS)
    q, k, v, ks, vs, table, kc, vc = make_case(rng, kv_bits, slots)
    lens = torch.tensor(LENS, dtype=torch.int32)
    tq, tt = torch.from_numpy(q), torch.from_numpy(table)
    cur = (torch.from_numpy(kc), torch.from_numpy(vc))
    jargs = (jnp.asarray(q), jx(k), jx(v), jx(ks), jx(vs), jnp.int32(0),
             jnp.asarray(np.array(LENS, np.int32)), jnp.asarray(table), jnp.asarray(kc),
             jnp.asarray(vc), jnp.int32(w_live))
    o, m, l = K5.paged_decode_attention(tq, k, v, ks, vs, lens, tt, *cur, num_kv_heads=KVH,
                                        w_live=w_live, return_stats=True)
    jo, jm, jl = j_attn(*jargs, num_kv_heads=KVH, return_stats=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)
    idle = np.array(LENS) == 0   # the idle slot: (0, mask, 0), finite
    assert np.all(o.numpy()[idle] == 0) and np.all(l.numpy()[idle] == 0)
    assert np.all(m.numpy()[idle] == K5.DEFAULT_MASK_VALUE)
    # without the stats: the same softmax, normalised
    out = K5.paged_decode_attention(tq, k, v, ks, vs, lens, tt, *cur, num_kv_heads=KVH,
                                    w_live=w_live)
    busy = ~idle
    np.testing.assert_allclose(out.numpy()[busy], (o / l).numpy()[busy], **TOL)
    assert np.all(out.numpy()[idle] == 0)


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_split_emulation_with_window(rng, kv_bits):
    """K5's split and merge over the shrunk range [0, len-1-w_live) against
    the plain version, stats and normalised output alike."""
    slots = len(LENS)
    q, k, v, ks, vs, table, kc, vc = make_case(rng, kv_bits, slots)
    lens = torch.tensor(LENS, dtype=torch.int32)
    for w_live, splits in ((1, 3), (W - 1, 16), (W, 2)):
        got = emulate_k5(q, k, v, ks, vs, lens, table, kc, vc, KVH, splits, w_live=w_live,
                         stats=True)
        plain = K5.paged_decode_attention_plain(
            torch.from_numpy(q), k, v, ks, vs, lens, torch.from_numpy(table),
            torch.from_numpy(kc), torch.from_numpy(vc), num_kv_heads=KVH, w_live=w_live,
            return_stats=True)
        # the sums are held normalised (their scale grows with l)
        busy = np.array(LENS) > 0
        for (o, m, l), tol in ((got, 1e-6), (plain, 1e-6)):
            assert np.all(o.numpy()[~busy] == 0) and np.all(l.numpy()[~busy] == 0)
        np.testing.assert_allclose((got[0] / got[2]).numpy()[busy],
                                   (plain[0] / plain[2]).numpy()[busy], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), plain[1].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[2].numpy(), plain[2].numpy(), rtol=1e-6, atol=1e-6)
        # the ranges K5 derives on the device, from the shrunk pool length
        for n in LENS:
            pool_len = max(n - 1 - w_live, 0)
            covered = [t for b, e in K5._k5_ranges(pool_len, splits) for t in range(b, e)]
            assert covered == list(range(pool_len))


# the TP case at tgq's own small geometry (tests/test_paged_attention.py::
# _tp_case): interpret mode simulates the kernel once a shard
TP_P, TP_PG, TP_KVH, TP_D, TP_MPPS = 10, 8, 4, 32, 2
TP_LENS = [5, 0, 14, 3]


def _tp_pools(rng, kv_bits, tp):
    """One layer's rows stored by tgq (int4 with ``pack_segments = tp``)
    as a tgq cache, and each rank's pools: its kv heads' bytes and scales."""
    from tgq.serve.kv_cache import PagedKVCache as JCache
    from tgq.serve.kv_cache import _absmax_quantize, _absmax_quantize4

    shape = (TP_P, TP_PG, TP_KVH, TP_D)
    rows_k = rng.standard_normal(shape).astype(np.float32)
    rows_v = rng.standard_normal(shape).astype(np.float32)
    if kv_bits == 16:
        jk, jv = (jnp.asarray(r.reshape(1, TP_P, TP_PG, -1), jnp.bfloat16)
                  for r in (rows_k, rows_v))
        cache = JCache(k=jk, v=jv, num_kv_heads=TP_KVH)
        jks = jvs = None
    else:
        def quant(rows):
            codes, s = (_absmax_quantize(jnp.asarray(rows)) if kv_bits == 8
                        else _absmax_quantize4(jnp.asarray(rows), segments=tp))
            sc = np.zeros((TP_P, TP_KVH, tkv.scale_pad(TP_PG)), np.float32)
            sc[:, :, :TP_PG] = np.asarray(s).transpose(0, 2, 1)
            return jnp.asarray(codes).reshape(1, TP_P, TP_PG, -1), jnp.asarray(sc)[None]
        (jk, jks), (jv, jvs) = quant(rows_k), quant(rows_v)
        cache = JCache(k=jk, v=jv, ks=jks, vs=jvs, num_kv_heads=TP_KVH,
                       pack_segments=tp if kv_bits == 4 else 1)

    def local(r):
        n = TP_KVH // tp

        def pool(a):
            a = np.asarray(a[0].astype(jnp.float32) if kv_bits == 16 else a[0])
            t = torch.from_numpy(a.reshape(TP_P, TP_PG, tp, -1)[:, :, r].copy())
            return t.bfloat16() if kv_bits == 16 else t

        def sc(a):
            return None if a is None else torch.from_numpy(
                np.asarray(a[0])[:, r * n:(r + 1) * n].copy())
        return pool(jk), pool(jv), sc(jks), sc(jvs)

    return cache, local


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_rank_local_kernel_matches_jax_tp(interpret, kv_bits):
    """A rank's K5 on its own kv heads (int4: one segment) equals its heads
    of tgq's TP kernel in window mode with stats."""
    from tgq.parallel import make_mesh
    from tgq.serve.decode import _kernel_attention_tp

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(7)
    tp = 2
    mesh = make_mesh(data=4, devices=jax.devices()[:8])
    cache, local = _tp_pools(rng, kv_bits, tp)
    slots, H, F = len(TP_LENS), 2 * TP_KVH, TP_KVH * TP_D
    q = (rng.standard_normal((slots, H, TP_D)) * 0.3).astype(np.float32)
    table = (rng.permutation(TP_P - 1)[: slots * TP_MPPS].reshape(slots, TP_MPPS)
             + 1).astype(np.int32)
    kc = (rng.standard_normal((slots, F)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((slots, F)) * 0.5).astype(np.float32)
    lens = np.array(TP_LENS, np.int32)
    w_live = 3  # slot 3 (length 3) has an empty pool range
    want = _kernel_attention_tp(
        TP_KVH, jnp.asarray(q), cache, jnp.int32(0), jnp.asarray(lens), jnp.asarray(table),
        jnp.asarray(kc), jnp.asarray(vc), mesh, w_live=w_live, return_stats=True)
    hq, fl = H // tp, F // tp
    for r in range(tp):
        got = K5.paged_decode_attention(
            torch.from_numpy(q[:, r * hq:(r + 1) * hq].copy()), *local(r),
            torch.from_numpy(lens), torch.from_numpy(table),
            torch.from_numpy(kc[:, r * fl:(r + 1) * fl].copy()),
            torch.from_numpy(vc[:, r * fl:(r + 1) * fl].copy()),
            num_kv_heads=TP_KVH // tp, w_live=w_live, return_stats=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, r * hq:(r + 1) * hq], **TOL)


def test_window_partial_and_merge_match_jax(rng):
    from tgq.serve.decode import _merge_partials as j_merge
    from tgq.serve.decode import _window_partial as j_window

    L, slots, kvh, H, d = 2, 5, 2, 8, 32
    wk = rng.standard_normal((L, slots, kvh, W, d)).astype(np.float32)
    wv = rng.standard_normal((L, slots, kvh, W, d)).astype(np.float32)
    q = (rng.standard_normal((slots, H, d)) / np.sqrt(d)).astype(np.float32)
    jwin = (jnp.asarray(wk, jnp.bfloat16), jnp.asarray(wv, jnp.bfloat16))
    twin = (torch.from_numpy(wk).bfloat16(), torch.from_numpy(wv).bfloat16())
    other = (rng.standard_normal((slots, H, d)).astype(np.float32),
             rng.standard_normal((slots, H, 1)).astype(np.float32),
             rng.random((slots, H, 1)).astype(np.float32) + 0.5)
    for w_live in (0, 2, W):
        got = tdec._window_partial(torch.from_numpy(q), twin, 1, w_live, kvh)
        want = j_window(jnp.asarray(q), jwin, 1, w_live, kvh)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        merged = tdec._merge_partials(tuple(torch.from_numpy(a) for a in other), got)
        jmerged = j_merge(tuple(jnp.asarray(a) for a in other), want)
        np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged), **TOL)


@pytest.mark.parametrize("kv_bits,segments", [(16, 1), (8, 1), (4, 1), (4, 2)])
def test_window_flush_matches_jax(rng, kv_bits, segments):
    """Codes and scales bit for bit, with equalizers and a dead slot
    (flushed to the scratch page 0, which is left out of the comparison)."""
    from tgq.models.config import ModelConfig
    from tgq.serve.kv_cache import PagedKVCache as JCache
    from tgq.serve.kv_cache import window_flush as j_flush

    L, kvh, d, page, n_pages, slots, n = 2, 4, 16, 8, 24, 3, 5
    cfg = ModelConfig(name="w", vocab_size=8, hidden_size=16, intermediate_size=16,
                      num_layers=L, num_heads=kvh, num_kv_heads=kvh, head_dim=d)
    eq = (rng.random((2, L, kvh * d)) + 0.5).astype(np.float32) if kv_bits < 16 else (None,) * 2
    jc = JCache.init(cfg, n_pages, page, kv_bits=kv_bits, k_eq=eq[0], v_eq=eq[1],
                     pack_segments=segments)
    tc = tkv.PagedKVCache.init(cfg, n_pages, page, kv_bits=kv_bits, k_eq=eq[0], v_eq=eq[1],
                               pack_segments=segments)
    wk = rng.standard_normal((L, slots, kvh, W, d)).astype(np.float32)
    wv = rng.standard_normal((L, slots, kvh, W, d)).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    pos0 = np.array([3, 9, 0], np.int32)
    live = np.array([1, 1, 0], np.int32)
    # jitted, as decode_steps runs it (XLA folds the quantizer's constant
    # divisions into products, which the port's quantizers do too)
    jc = jax.jit(j_flush, static_argnums=(4,))(
        jc, (jnp.asarray(wk, jnp.bfloat16), jnp.asarray(wv, jnp.bfloat16)),
        jnp.asarray(table), jnp.asarray(pos0), n, live=jnp.asarray(live))
    tkv.window_flush(tc, (torch.from_numpy(wk).bfloat16(), torch.from_numpy(wv).bfloat16()),
                     torch.from_numpy(table), torch.from_numpy(pos0), n,
                     live=torch.from_numpy(live))
    for name in ("k", "v", "ks", "vs"):
        j, t = getattr(jc, name), getattr(tc, name)
        if j is None:
            assert t is None
            continue
        j = np.asarray(j.astype(jnp.float32) if j.dtype == jnp.bfloat16 else j)
        t = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        np.testing.assert_array_equal(t[:, 1:], j[:, 1:], err_msg=name)
    assert np.any(tc.k[:, 1:].float().numpy() != 0)   # the live slots landed


def test_window_write_step_layouts():
    """A step's rows of one layer land in their column, raw bf16, and
    nothing else moves."""
    rows = torch.randn(3, 2, 4, 16)
    win = (torch.zeros(3, 2, 4, W, 16, dtype=torch.bfloat16),
           torch.zeros(3, 2, 4, W, 16, dtype=torch.bfloat16))
    for li in range(3):
        tkv.window_write_step(win, 5, li, rows[li], -rows[li])
    assert torch.equal(win[0][:, :, :, 5], rows.bfloat16())
    assert torch.equal(win[1][:, :, :, 5], (-rows).bfloat16())
    win[0][:, :, :, 5] = 0
    assert not win[0].any()
