"""K5's split-context arithmetic on the CPU: the planner's token ranges,
and a torch emulation of what the kernel computes (per-split partials
over 32-token tiles with one max and one sum a tile, the merge of the
splits in order, the current token folded in last) against
``paged_decode_attention_plain`` and against tgq's Pallas kernel, run
interpreted as ``tests/test_torch_paged_attention.py`` runs it.

The emulation sums in another order than the plain version's softmax, in
f32 on values of order 1: within 1e-6.  Against the JAX kernel the file's
tolerance of the port's K5 tests, rtol = atol = 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgq.kernels.paged_attention import paged_decode_attention as j_attn
from tgq_torch.kernels import paged_attention as K5
from tgq_torch.serve.kv_cache import scale_pad

KVH, D, PG, MPPS = 2, 32, 8, 12
P = 10 * MPPS + 1
# with the current token; 70 and 96 span several 32-token tiles and splits
LENS = [0, 1, 2, PG - 1, PG, PG + 1, 2 * PG + 1, 3 * PG + 2, 70, MPPS * PG]


@pytest.fixture
def interpret():
    from jax._src.pallas.mosaic.interpret.interpret_pallas_call import (
        InterpretParams,
        force_tpu_interpret_mode,
    )

    with force_tpu_interpret_mode(InterpretParams(detect_races=False)):
        yield


@pytest.mark.parametrize("splits", range(1, 17))
def test_k5_ranges_cover_each_token_once(splits):
    for pool_len in range(0, 2 * 64 + 2):
        ranges = K5._k5_ranges(pool_len, splits)
        assert len(ranges) == splits
        covered = [t for b, e in ranges for t in range(b, e)]
        assert covered == list(range(pool_len)), (pool_len, splits, ranges)
        chunk = ranges[0][1] - ranges[0][0]
        assert pool_len == 0 or chunk % K5._K5_TILE == 0 or chunk == pool_len
        # the non-empty splits come first; the kernel merges max(1, their number)
        busy = [e > b for b, e in ranges]
        assert busy == sorted(busy, reverse=True)


@pytest.mark.parametrize("slots,kvh,mpps,page", [(8, 8, 4, 64), (8, 8, 32, 64), (64, 8, 32, 64),
                                                 (1, 1, 1, 8), (512, 8, 32, 64), (5, 2, 4, 8)])
def test_k5_plan_fills_the_card_within_the_table(slots, kvh, mpps, page):
    plan = K5._k5_plan(slots, kvh, mpps, page)
    assert 1 <= plan.splits <= K5._K5_MAX_SPLITS and plan.tile == 32
    assert plan.splits <= -(-(mpps * page) // plan.tile)
    blocks = slots * kvh * plan.splits
    tiles = -(-(mpps * page) // plan.tile)
    if plan.splits < min(K5._K5_MAX_SPLITS, tiles):
        assert blocks >= K5._K5_TARGET_BLOCKS   # a wave, unless the table caps it
        # and no split of the longest context takes more than 8 tiles
        assert -(-tiles // plan.splits) <= K5._K5_TILES_PER_SPLIT
    assert K5._k5_plan(slots, kvh, mpps, page) is plan   # cached: no work per layer


def make_case(rng, kv_bits, slots):
    F = KVH * D
    q = (rng.standard_normal((slots, 4 * KVH, D)) * 0.3 / np.sqrt(D)).astype(np.float32)
    table = (rng.permutation(P - 1)[: slots * MPPS].reshape(slots, MPPS) + 1).astype(np.int32)
    kc = rng.standard_normal((slots, F)).astype(np.float32)
    vc = rng.standard_normal((slots, F)).astype(np.float32)
    if kv_bits == 16:
        k = torch.from_numpy(rng.standard_normal((P, PG, F)).astype(np.float32)).bfloat16()
        v = torch.from_numpy(rng.standard_normal((P, PG, F)).astype(np.float32)).bfloat16()
        return q, k, v, None, None, table, kc, vc
    if kv_bits == 4:
        k = torch.from_numpy(rng.integers(0, 256, (P, PG, F // 2)).astype(np.uint8))
        v = torch.from_numpy(rng.integers(0, 256, (P, PG, F // 2)).astype(np.uint8))
    else:
        k = torch.from_numpy(rng.integers(-127, 128, (P, PG, F)).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, (P, PG, F)).astype(np.int8))
    ks = np.zeros((P, KVH, scale_pad(PG)), np.float32)
    vs = np.zeros_like(ks)
    ks[..., :PG] = rng.random((P, KVH, PG)) * 0.02 + 1e-3
    vs[..., :PG] = rng.random((P, KVH, PG)) * 0.02 + 1e-3
    return q, k, v, torch.from_numpy(ks), torch.from_numpy(vs), table, kc, vc


def stored_rows(pool, kvh):
    """(P, page, kvh, d) f32 of the stored values (codes for int8/int4)."""
    if pool.dtype == torch.uint8:   # byte j: features j (low) and j + F/2 (high)
        p = pool.to(torch.int32)
        rows = torch.cat([(p & 0xF) - 8, (p >> 4) - 8], dim=-1).float()
    else:
        rows = pool.float()
    return rows.reshape(*pool.shape[:2], kvh, -1)


def emulate_k5(q, k_pool, v_pool, ks, vs, lengths, table, kc, vc, kvh, splits,
               soft_cap=None, w_live=0, stats=False):
    """K5's arithmetic in f32: splits of 32-token tiles, an online softmax a
    tile (one max and one sum), partials (m, l, acc) merged in split order,
    the current row folded in last.  ``w_live``: the chunk window's rows,
    which shrink the pools' range; ``stats``: return (acc, m, l) un-normalised."""
    slots, H, d = q.shape
    group = H // kvh
    page = k_pool.shape[1]
    K, V = stored_rows(k_pool, kvh), stored_rows(v_pool, kvh)
    cap = (lambda x: torch.tanh(x / soft_cap) * soft_cap) if soft_cap else (lambda x: x)
    out = torch.zeros((slots, H, d))
    m_out = torch.full((slots, H, 1), K5.DEFAULT_MASK_VALUE)
    l_out = torch.zeros((slots, H, 1))
    tile = K5._K5_TILE
    for b in range(slots):
        n = int(lengths[b])
        if n <= 0:
            continue
        pool_len = max(n - (1 if kc is not None else 0) - w_live, 0)
        ranges = K5._k5_ranges(pool_len, splits)
        n_merge = max(1, sum(e > s for s, e in ranges))
        for g in range(kvh):
            qg = torch.from_numpy(q[b, g * group:(g + 1) * group])       # (group, d)
            parts = []
            for s0, s1 in ranges[:n_merge]:
                m = torch.full((group,), -0.7 * torch.finfo(torch.float32).max)
                l, acc = torch.zeros(group), torch.zeros(group, d)
                for t0 in range(s0, s1, tile):
                    t = torch.arange(t0, min(t0 + tile, s1))
                    pg = torch.from_numpy(table[b])[t // page].long()
                    off = t % page
                    logit = K[pg, off, g] @ qg.T                             # (tokens, group)
                    p_scale = torch.ones(len(t))
                    if ks is not None:
                        logit = logit * ks[pg, g, off][:, None]
                        p_scale = vs[pg, g, off]
                    logit = cap(logit)
                    m_new = torch.maximum(m, logit.max(0).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(logit - m_new)
                    l = l * alpha + p.sum(0)
                    acc = acc * alpha[:, None] + (p * p_scale[:, None]).T @ V[pg, off, g]
                    m = m_new
                parts.append((m, l, acc))
            M = torch.stack([pm for pm, _, _ in parts]).max(0).values
            L, A = torch.zeros(group), torch.zeros(group, d)
            for pm, pl, pa in parts:                                       # in split order
                c = torch.exp(pm - M)
                L, A = L + pl * c, A + pa * c[:, None]
            if kc is not None:
                qc = cap(qg @ torch.from_numpy(kc[b, g * d:(g + 1) * d]))
                m_next = torch.maximum(M, qc)
                alpha, p = torch.exp(M - m_next), torch.exp(qc - m_next)
                L = L * alpha + p
                A = A * alpha[:, None] + p[:, None] * torch.from_numpy(vc[b, g * d:(g + 1) * d])
                M = m_next
            hs = slice(g * group, (g + 1) * group)
            out[b, hs] = A if stats else A / L[:, None]
            m_out[b, hs, 0], l_out[b, hs, 0] = M, L
    return (out, m_out, l_out) if stats else out


CASES = [(16, 1, None), (16, 3, None), (16, 16, None), (8, 2, None), (8, 7, None),
         (4, 2, None), (4, 5, None), (16, 4, 5.0), (8, 16, None)]


@pytest.mark.parametrize("kv_bits,splits,soft_cap", CASES)
@pytest.mark.parametrize("current", [True, False])
def test_emulation_matches_plain_and_jax(rng, interpret, kv_bits, splits, soft_cap, current):
    slots = len(LENS)
    q, k, v, ks, vs, table, kc, vc = make_case(rng, kv_bits, slots)
    if soft_cap:
        q = q * 40.0       # logits well into the cap
    if not current:
        kc = vc = None
    lens = torch.tensor(LENS, dtype=torch.int32)
    got = emulate_k5(q, k, v, ks, vs, lens, table, kc, vc, KVH, splits, soft_cap)
    cur = (None, None) if kc is None else (torch.from_numpy(kc), torch.from_numpy(vc))
    plain = K5.paged_decode_attention_plain(
        torch.from_numpy(q), k, v, ks, vs, lens, torch.from_numpy(table), *cur,
        num_kv_heads=KVH, attn_logits_soft_cap=soft_cap)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)
    assert np.all(got.numpy()[np.array(LENS) == 0] == 0)

    def jx(t):
        if t is None:
            return None
        a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        a = jnp.asarray(a, jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(a)
        return a[None]     # the layer-stacked pools of one layer

    jcur = (None, None) if kc is None else (jnp.asarray(kc), jnp.asarray(vc))
    want = j_attn(jnp.asarray(q), jx(k), jx(v), jx(ks), jx(vs), jnp.int32(0),
                  jnp.asarray(np.array(LENS, np.int32)), jnp.asarray(table), *jcur,
                  num_kv_heads=KVH, attn_logits_soft_cap=soft_cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=1e-5, atol=1e-5)
