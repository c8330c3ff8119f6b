"""tgq_torch's paged KV cache against tgq's: the page allocator step for
step, and the int8 / int4 / bf16 pool writes byte for byte (codes and
scales), on the same numpy-seeded rows.

The JAX writes are jitted, as the serving path runs them: under jit
XLA:CPU computes ``absmax / 127`` as ``absmax · (1/127)``, which the port
computes too (eagerly JAX divides, and scales can differ by an ulp).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgq.models.config import ModelConfig as JConfig
from tgq.serve import kv_cache as jkv
from tgq_torch.models.config import ModelConfig
from tgq_torch.serve import kv_cache as tkv

GEOM = dict(name="kv-test", vocab_size=8, hidden_size=64, intermediate_size=8, num_layers=2,
            num_heads=8, num_kv_heads=4, head_dim=16)
JCFG, TCFG = JConfig(**GEOM), ModelConfig(**GEOM)
PAGES, PAGE = 12, 8


def to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def jnp_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same(tc, jc):
    for name in ("k", "v", "ks", "vs"):
        a, b = getattr(tc, name), getattr(jc, name)
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(to_np(a), jnp_bits(b), err_msg=name)


def test_page_allocator():
    pt = tkv.PageTable(num_pages=16, page_size=4, max_slots=2, max_pages_per_slot=4)
    assert pt.can_alloc(12)
    pages = pt.alloc_slot(0, 10)
    assert pt.lens[0] == 10 and len(pages) == 3 == len(pt.slot_pages(0))
    pt.extend(0, 1)
    assert len(pt.slot_pages(0)) == 3
    pt.extend(0, 1)
    pt.extend(0, 1)
    assert len(pt.slot_pages(0)) == 4
    pt.free_slot(0)
    assert pt.num_free == 15


def test_page_allocator_matches_jax(rng):
    """Randomized op sequence: the port's allocator and the JAX package's
    Python backend stay in lockstep on every observable."""
    kw = dict(num_pages=32, page_size=4, max_slots=4, max_pages_per_slot=8)
    a = jkv.PageTable(backend="python", **kw)
    b = tkv.PageTable(**kw)
    active: set[int] = set()
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0:
            free = [s for s in range(4) if s not in active]
            n = int(rng.integers(1, 20))
            if free and a.can_alloc(n):
                assert b.can_alloc(n)
                assert a.alloc_slot(free[0], n) == b.alloc_slot(free[0], n)
                active.add(free[0])
        elif op == 1 and active:
            s = sorted(active)[int(rng.integers(0, len(active)))]
            need = a.pages_needed(a.lens[s] + 1) - a.pages_needed(a.lens[s])
            if a.pages_needed(a.lens[s] + 1) <= 8 and need <= a.num_free:
                a.extend(s, 1)
                b.extend(s, 1)
        elif op == 2 and active:
            s = sorted(active)[int(rng.integers(0, len(active)))]
            if rng.integers(0, 2):
                a.free_slot(s)
                b.free_slot(s)
            else:
                pa, pb = a.detach_slot(s), b.detach_slot(s)
                assert pa == pb
                a.release_pages(pa)
                b.release_pages(pb)
            active.discard(s)
        assert a.lens == b.lens and a.num_free == b.num_free
        ta, la = a.device_tables()
        tb, lb = b.device_tables()
        np.testing.assert_array_equal(np.asarray(ta), tb.numpy())
        np.testing.assert_array_equal(np.asarray(la), lb.numpy())


def test_device_tables_are_copies():
    pt = tkv.PageTable(num_pages=8, page_size=4, max_slots=2, max_pages_per_slot=2)
    pt.alloc_slot(0, 5)
    table, _ = pt.device_tables()
    before = table.clone()
    pt.free_slot(0)
    assert torch.equal(table, before)


def test_quantizers_bit_exact(rng):
    x = (rng.normal(size=(5, 7, 4, 16)) * rng.uniform(0.01, 5, (5, 7, 4, 1))).astype(np.float32)
    x[0, 0, 1] = 0.0
    q_j, s_j = jax.jit(jkv._absmax_quantize)(jnp.asarray(x))
    q_t, s_t = tkv._absmax_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    q_j, s_j = jax.jit(jkv._absmax_quantize4)(jnp.asarray(x))
    q_t, s_t = tkv._absmax_quantize4(torch.from_numpy(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(tkv.kv_unpack4(q_t).numpy(),
                                  np.asarray(jkv.kv_unpack4(q_j)))
    assert tkv.scale_pad(64) == jkv.scale_pad(64) == 128
    assert tkv.scale_pad(200) == jkv.scale_pad(200) == 256


@pytest.mark.parametrize("kv_bits,eq", [(16, False), (8, False), (4, False), (8, True),
                                         (4, True)])
def test_writes_and_gather_match_jax(rng, kv_bits, eq):
    fused = JCFG.num_kv_heads * JCFG.head_dim
    k_eq = v_eq = None
    if eq:
        k_eq = rng.uniform(0.5, 2.0, (JCFG.num_layers, fused)).astype(np.float32)
        v_eq = rng.uniform(0.5, 2.0, (JCFG.num_layers, fused)).astype(np.float32)
    jc = jkv.PagedKVCache.init(JCFG, PAGES, PAGE, kv_bits=kv_bits, k_eq=k_eq, v_eq=v_eq)
    tc = tkv.PagedKVCache.init(TCFG, PAGES, PAGE, kv_bits=kv_bits, k_eq=k_eq, v_eq=v_eq)
    assert tc.kv_bits == kv_bits and tc.fused_dim == fused and tc.head_dim == 16
    assert_same(tc, jc)
    kvh, d = JCFG.num_kv_heads, JCFG.head_dim
    # prefill: 2 prompts of 2 pages each into layer 1
    slot_pages = np.array([[3, 7], [5, 2]], np.int32)
    kp = rng.normal(size=(2, 2 * PAGE, kvh, d)).astype(np.float32)
    vp = rng.normal(size=(2, 2 * PAGE, kvh, d)).astype(np.float32)
    kp_b = jnp.asarray(kp).astype(jnp.bfloat16)
    vp_b = jnp.asarray(vp).astype(jnp.bfloat16)
    jc = jax.jit(jkv.kv_write_pages)(jc, 1, jnp.asarray(slot_pages), kp_b, vp_b)
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()  # noqa: E731
    tkv.kv_write_pages(tc, 1, torch.from_numpy(slot_pages), bf(kp_b), bf(vp_b))
    assert_same(tc, jc)
    # decode: one token per slot into layer 0 and layer 1
    for layer in (0, 1):
        pages = np.array([7, 2], np.int32)
        offs = np.array([3, 6], np.int32)
        kt = rng.normal(size=(2, kvh, d)).astype(np.float32)
        vt = rng.normal(size=(2, kvh, d)).astype(np.float32)
        jc = jax.jit(jkv.kv_write_token)(jc, layer, jnp.asarray(pages), jnp.asarray(offs),
                                         jnp.asarray(kt), jnp.asarray(vt))
        tkv.kv_write_token(tc, layer, torch.from_numpy(pages), torch.from_numpy(offs),
                           torch.from_numpy(kt), torch.from_numpy(vt))
        assert_same(tc, jc)
    table = np.array([[3, 7, 0], [5, 2, 0]], np.int32)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        kg_j, vg_j = jax.jit(jkv.kv_gather, static_argnames=("dtype",))(
            jc, 1, jnp.asarray(table), dtype=jdt)
        kg_t, vg_t = tkv.kv_gather(tc, 1, torch.from_numpy(table), dtype=dtype)
        assert kg_t.shape == (2, 3 * PAGE, kvh, d)
        np.testing.assert_array_equal(kg_t.float().numpy(), np.asarray(kg_j, np.float32))
        np.testing.assert_array_equal(vg_t.float().numpy(), np.asarray(vg_j, np.float32))


def test_int4_round_trip_and_layout(rng):
    """Split-half over the whole fused row: byte j holds features j and
    j + F/2, biased by 8; unpacking recovers clip(round(x/s), ±7)."""
    x = rng.normal(size=(3, 4, 16)).astype(np.float32)
    q, s = tkv._absmax_quantize4(torch.from_numpy(x))
    assert q.shape == (3, 32) and q.dtype == torch.uint8
    codes = tkv.kv_unpack4(q).numpy().reshape(3, 4, 16)
    ref = np.clip(np.round(x / s.numpy()[..., None]), -7, 7)
    np.testing.assert_array_equal(codes, ref)
    lo = (q.numpy() & 0xF).astype(np.int32) - 8
    np.testing.assert_array_equal(lo, ref.reshape(3, 64)[:, :32])


def test_cache_rejects_tp_layout():
    """The TP layout (int4 packed in segments) is taken and round-trips;
    a kv-head count that does not divide the fused row is rejected."""
    k = torch.zeros((1, 2, 4, 32), dtype=torch.uint8)
    seg = tkv.PagedKVCache(k=k.clone(), v=k.clone(), ks=torch.zeros(1, 2, 2, 128),
                           vs=torch.zeros(1, 2, 2, 128), num_kv_heads=2, pack_segments=2)
    rows = torch.randn(1, 2, 32)
    tkv.kv_write_token(seg, 0, torch.tensor([1]), torch.tensor([3]), rows, rows)
    kg, _ = tkv.kv_gather(seg, 0, torch.tensor([[1]]), torch.float32)
    codes, s = tkv._absmax_quantize4(rows)
    np.testing.assert_array_equal(kg[0, 3].numpy(), (tkv.kv_unpack4(codes).reshape(
        2, 32) * s[0, :, None]).numpy())
    with pytest.raises(ValueError):
        tkv.PagedKVCache(k=k, v=k, num_kv_heads=5)
    c = tkv.PagedKVCache(k=k, v=k, ks=torch.zeros(1), vs=torch.zeros(1), num_kv_heads=2)
    assert dataclasses.replace(c).kv_bits == 4
