"""K1's and K2's schedules on the CPU.

- ``_k1_plan`` and ``_k2_plan`` at every hidden and intermediate width of
  the presets (H100 limits: 132 SMs, 232448 B of shared memory a block).
- K1's packed argmax key (``csrc/pchol_panel.cu::cand_key``): an
  order-preserving encoding of d over the inverted column index, maxed per
  warp and then over all warps, picks the plain rule's pivot on random d,
  heavy ties, ±0.0 and done (−inf) columns, the all-done case included;
  then a whole panel emulated over the plan's blocks, warps and shared /
  global strip rows, bit for bit against ``pchol_panel_plain``.
- K2's tiled sweep (``csrc/gptq_block.cu::gptq_block_kernel``): row tiles,
  32-column sub-blocks swept one row a thread in registers, R's rows from
  the two-stage ring at their absolute columns, -e k-major, and the 8 x 4
  update tiles in the kernel's thread order (each element once a
  sub-block), bit for bit against ``process_block_plain``.
"""
import numpy as np
import pytest
import torch

from tgq_torch.kernels import gptq_block as K2
from tgq_torch.kernels import pchol_panel as K1
from tgq_torch.models.config import PRESETS

H100_SMS, H100_SMEM = 132, 232448
WIDTHS = sorted({w for c in PRESETS.values()
                 for w in (c.hidden_size, c.intermediate_size) if w <= 28672})


# ------------------------------------------------------------------ plans


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("panel", [128, 64])
def test_k1_plan_covers_every_column_once(n, panel):
    plan = K1._k1_plan(n, panel, H100_SMS, H100_SMEM)
    assert plan.grid <= H100_SMS  # one cooperative wave, one block an SM
    owners = np.zeros(n, np.int64)
    for g in range(plan.grid):
        owners[g * plan.tile:min(n, (g + 1) * plan.tile)] += 1
    assert (owners == 1).all()
    assert (plan.grid - 1) * plan.tile < n  # no empty block
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.threads >= min(plan.tile, 1024)
    assert plan.smem == 4 * (2 * plan.tile + panel + plan.rows_smem * plan.tile)
    assert plan.smem + K1._K1_STATIC_SMEM <= H100_SMEM
    assert plan.rows_smem == panel  # every preset width keeps its strip on chip


def test_k1_plan_keeps_what_does_not_fit_in_global_memory():
    plan = K1._k1_plan(65536, 128, H100_SMS, H100_SMEM)
    assert 0 < plan.rows_smem < 128
    assert plan.smem + K1._K1_STATIC_SMEM <= H100_SMEM


@pytest.mark.parametrize("m", WIDTHS + [1000])
@pytest.mark.parametrize("b", [7, 128, 200, 256, 512])
def test_k2_plan_covers_every_row_once(m, b):
    plan = K2._k2_plan(m, b, H100_SMS, H100_SMEM)
    assert plan.tm in K2._K2_TILES
    assert plan.smem == K2._k2_smem(plan.tm, b) <= H100_SMEM
    blocks = -(-m // plan.tm)
    rows = np.zeros(blocks * plan.tm, np.int64)
    for blk in range(blocks):
        rows[blk * plan.tm:(blk + 1) * plan.tm] += 1
    assert (rows[:m] == 1).all() and (blocks - 1) * plan.tm < m
    # no other tile that fits needs fewer waves of one block an SM
    waves = -(-blocks // H100_SMS)
    for tm in K2._K2_TILES:
        if K2._k2_smem(tm, b) <= H100_SMEM:
            assert -(-(-(-m // tm)) // H100_SMS) >= waves


def test_k2_plan_qwen3_8b_tiles():
    tiles = {m: K2._k2_plan(m, 256, H100_SMS, H100_SMEM).tm for m in (1024, 4096, 12288, 28672)}
    assert tiles == {1024: 32, 4096: 32, 12288: 96, 28672: 96}
    assert K2._k2_plan(4096, 1024, H100_SMS, H100_SMEM).tm == 0  # the wide kernel


# ------------------------------------------------------------ K1's argmax


def cand_key(v: np.ndarray, j: np.ndarray) -> np.ndarray:
    """csrc/pchol_panel.cu::cand_key on f32 values and int columns."""
    v = np.where(v == 0, np.float32(0), v).astype(np.float32)
    u = v.view(np.uint32).astype(np.uint64)
    e = np.where(u & 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)
    return (e << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - j.astype(np.uint64))


def key_index(key) -> int:
    return int(0xFFFFFFFF - (int(key) & 0xFFFFFFFF))


def key_value(key) -> np.float32:
    e = np.uint32(int(key) >> 32)
    u = e & np.uint32(0x7FFFFFFF) if e & np.uint32(0x80000000) else ~e
    return np.array([u], np.uint32).view(np.float32)[0]


def grid_argmax(v: np.ndarray, plan) -> int:
    """Key 0 for idle threads, a max per thread over its columns, per warp,
    then one atomicMax over every warp of every block."""
    n = v.size
    best = np.uint64(0)
    for g in range(plan.grid):
        j0 = g * plan.tile
        cols = np.arange(j0, min(n, j0 + plan.tile))
        keys = cand_key(v[cols], cols)
        thread = (cols - j0) % plan.threads
        for warp in range(plan.threads // 32):
            mine = keys[thread // 32 == warp]
            if mine.size:
                best = max(best, mine.max())
    return best


def plain_pivot(d: np.ndarray, done: np.ndarray) -> tuple[int, float]:
    dm = np.where(done > 0, -np.inf, d).astype(np.float32)
    m = dm.max()
    return int(np.flatnonzero(dm == m).min()), float(max(m, 0.0))


def k1_cases():
    rng = np.random.default_rng(0)
    n = 1000
    yield "random", rng.random(n, dtype=np.float32), (rng.random(n) < 0.2).astype(np.float32)
    ties = rng.choice(np.float32([0.5, 0.25, 1.0]), n).astype(np.float32)
    yield "ties", ties, np.zeros(n, np.float32)
    yield "ties, top done", ties, (ties == 1.0).astype(np.float32)
    zeros = np.where(rng.random(n) < 0.5, np.float32(-0.0), np.float32(0.0))
    zeros[:5] = -1.0
    yield "signed zeros", zeros.astype(np.float32), np.zeros(n, np.float32)
    neg = -rng.random(n, dtype=np.float32)
    neg[[7, 400]] = -0.0
    yield "negatives and -0", neg, np.zeros(n, np.float32)
    yield "all done", rng.random(n, dtype=np.float32), np.ones(n, np.float32)
    inf = rng.random(n, dtype=np.float32)
    inf[[3, 900]] = np.inf
    yield "inf", inf, np.zeros(n, np.float32)


@pytest.mark.parametrize("case", list(k1_cases()), ids=lambda c: c[0])
@pytest.mark.parametrize("sms", [132, 8])
def test_k1_key_picks_the_plain_pivot(case, sms):
    _, d, done = case
    plan = K1._k1_plan(d.size, 128, sms, H100_SMEM)
    key = grid_argmax(np.where(done > 0, -np.inf, d).astype(np.float32), plan)
    piv, dk = plain_pivot(d, done)
    assert key_index(key) == piv
    assert max(float(key_value(key)), 0.0) == dk


def emulate_panel(a, d, done, panel, steps, plan):
    """csrc/pchol_panel.cu step by step in numpy f32: the argmax by keys
    over the plan's blocks, the pivot's strip column from the transposed
    copy, the correction over shared then global rows."""
    n = a.shape[0]
    f32 = np.float32
    strip = np.zeros((panel, n), f32)
    strip_t = np.full((n, panel), np.nan, f32)  # scratch: only rows < k are read
    d, done = d.copy(), done.copy()
    perm = np.zeros(panel, np.int32)
    ph = np.zeros(panel, f32)
    for k in range(steps):
        key = grid_argmax(np.where(done > 0, -np.inf, d).astype(f32), plan)
        piv = key_index(key)
        dk = f32(max(key_value(key), f32(0)))
        s_col = strip_t[piv, :k].copy()
        acc = np.zeros(n, f32)
        for t in range(min(k, plan.rows_smem)):
            acc = (acc + (s_col[t] * strip[t]).astype(f32)).astype(f32)
        for t in range(min(k, plan.rows_smem), k):
            acc = (acc + (s_col[t] * strip[t]).astype(f32)).astype(f32)
        inv = f32(1) / np.sqrt(max(dk, f32(1e-30))) if dk > 0 else f32(0)
        l = ((a[piv] - acc).astype(f32) * inv).astype(f32)
        l = np.where(done > 0, f32(0), l)
        l[piv] = np.sqrt(dk)
        strip[k] = l
        strip_t[:, k] = l
        done[piv] = max(done[piv], f32(1))
        d = np.where(done > 0, f32(0), np.maximum((d - (l * l).astype(f32)).astype(f32), 0))
        perm[k], ph[k] = piv, dk
    return strip, d, done, perm, ph


@pytest.mark.parametrize("steps", [24, 17])
def test_k1_panel_emulation_matches_plain(rng, steps):
    n, panel = 300, 24
    x = rng.normal(size=(2 * n, n)) * (0.99 ** np.arange(n))[None, :]
    a = (x.T @ x / (2 * n)).astype(np.float32)
    d = np.diagonal(a).copy()
    done = np.zeros(n, np.float32)
    done[[5, 77]] = 1.0
    d[[5, 77]] = 0.0
    # 8 SMs and room for 10 strip rows: 8 blocks of 38 columns, the last
    # 14 rows of each step's correction from global memory
    plan = K1._k1_plan(n, panel, 8, K1._K1_STATIC_SMEM + 4 * (2 * 38 + panel + 10 * 38))
    assert (plan.grid, plan.tile, plan.threads, plan.rows_smem) == (8, 38, 64, 10)
    got = emulate_panel(a, d, done, panel, steps, plan)
    want = K1.pchol_panel_plain(torch.from_numpy(a), torch.from_numpy(d[None]),
                                torch.from_numpy(done[None]), panel=panel, steps=steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.reshape(-1), w.numpy().reshape(-1))


# ----------------------------------------------------------- K2's sweep


def emulate_k2(w, s, z, r, min_q, max_q, tm):
    """csrc/gptq_block.cu::gptq_block_kernel on torch f32 tensors, FMAs
    single-rounded as the plain version emulates them."""
    fma = K2._fma
    m, b = w.shape
    J = -(-b // 32)
    B = 32 * J
    q = torch.full((m, b), torch.nan)
    e = torch.full((m, b), torch.nan)
    for row0 in range(0, m, tm):
        rows = torch.arange(row0, row0 + tm)
        live = rows < m
        ws = torch.zeros((tm, B + 4))
        ws[:live.sum(), :b] = w[row0:row0 + tm]
        stages = torch.full((2, 32, B), torch.nan)  # stale until loaded

        def load_stage(c):
            cb = 32 * c
            blk = torch.zeros((32, B - cb))
            part = r[cb:cb + 32, cb:]
            blk[:part.shape[0], :part.shape[1]] = part
            stages[c & 1, :, cb:] = blk

        def load_sz(cb):
            # the stage's zero-filled s and z tiles; s = 1 past row m and column b
            tiles = torch.zeros((tm, 32)), torch.zeros((tm, 32))
            for tile, src in zip(tiles, (s, z)):
                part = src[row0:row0 + tm, cb:cb + 32]
                tile[:part.shape[0], :part.shape[1]] = part
            ok = live[:, None] & (torch.arange(cb, cb + 32) < b)[None, :]
            return torch.where(ok, tiles[0], 1.0), tiles[1]

        load_stage(0)
        sr, zr = load_sz(0)
        for c in range(J):
            cb = 32 * c
            rc = stages[c & 1].clone()
            if c + 1 < J:
                load_stage(c + 1)
            wr = ws[:, cb:cb + 32].clone()
            for l in range(32):
                rrow = rc[l, cb:cb + 32]
                wk, sk, zk = wr[:, l], sr[:, l], zr[:, l]
                ok = live & (cb + l < b)  # else 1 / 1, never stored
                qk = torch.clamp(torch.floor(torch.where(ok, wk, 1.0) / sk + zk + 0.5),
                                 min_q, max_q)
                rkk = rrow[l] if cb + l < b else torch.tensor(1.0)
                ek = torch.where(ok, fma(-(qk - zk), sk, wk), 1.0) / rkk
                sr[:, l], zr[:, l] = qk, ek
                wr[:, l + 1:] = fma(-ek[:, None], rrow[None, l + 1:], wr[:, l + 1:])
            et = torch.zeros((32, tm + 4))  # -e, k-major
            et[:, :tm] = (-zr).T
            ws[:, cb:cb + 32] = sr  # q into the spent columns
            n_live, n_col = int(live.sum()), min(32, b - cb)
            q[row0:row0 + n_live, cb:cb + n_col] = ws[:n_live, cb:cb + n_col]
            e[row0:row0 + n_live, cb:cb + n_col] = -et[:n_col, :n_live].T
            if c + 1 < J:
                sr, zr = load_sz(cb + 32)
            # the update tiles in the kernel's order: thread tid takes tiles
            # tid, tid + 256, ...; tile t is rows (t // nq)*8.. and quad t % nq
            nq = (B - cb - 32) // 4
            hits = torch.zeros((tm, B + 4), dtype=torch.int64)
            ri, ci = [], []
            for tid in range(256):
                for t in range(tid, (tm // 8) * nq, 256):
                    rg, col = (t // nq) * 8, cb + 32 + 4 * (t % nq)
                    hits[rg:rg + 8, col:col + 4] += 1
                    ri.append(torch.arange(rg, rg + 8)[:, None].expand(8, 4))
                    ci.append(torch.arange(col, col + 4)[None, :].expand(8, 4))
            assert (hits[:, cb + 32:B] == 1).all() and hits[:, :cb + 32].sum() == 0
            if ri:
                ri, ci = torch.stack(ri), torch.stack(ci)
                acc = ws[ri, ci]
                for kk in range(32):
                    acc = fma(et[kk][ri], rc[kk][ci], acc)
                ws[ri, ci] = acc
    return q, e


@pytest.mark.parametrize("b,m,tm", [(7, 40, 32), (128, 70, 64), (256, 100, 32),
                                    (200, 33, 32), (512, 40, 32), (256, 130, 128)])
def test_k2_emulation_matches_plain(rng, b, m, tm):
    from tgq_torch.core.quant import QuantSpec, expand_params, find_params

    spec = QuantSpec(bits=4, group_size=-1 if b % 32 else 32, sym=False)
    w = torch.from_numpy(rng.normal(size=(m, b)).astype(np.float32))
    s, z = (t.contiguous() for t in expand_params(find_params(w, spec), b))
    x = rng.normal(size=(b, b)) / np.sqrt(b)
    rr = np.linalg.qr(x)[1]
    rr = rr * np.sign(np.diagonal(rr))[:, None] + 0.5 * np.eye(b)
    r = torch.from_numpy(rr.astype(np.float32))
    q_k, e_k = emulate_k2(w, s, z, r, spec.min_q, spec.max_q, tm)
    q_p, e_p = K2.process_block_plain(w, s, z, r, spec.min_q, spec.max_q)
    assert torch.equal(q_k, q_p)
    assert torch.equal(e_k, e_p)
