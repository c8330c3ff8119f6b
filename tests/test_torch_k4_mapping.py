"""K4's mapping on the CPU: ``_k4_plan`` on the serving shapes, and a
lane-level numpy emulation of ``csrc/a8_matmul.cu`` — the padded code rows
and the chunk-order x8 rows of each ring chunk, the byte-permute
construction of the int8 ``q - z`` A fragments, the ldmatrix x8 B
fragments, the m16n8k32 s8 fragment layouts, the decode warps' int32
partials as the fold threads read them and the f32 group fold — held bit for bit against
``a8_matmul_plain`` for bits 2/3/4, symmetric and asymmetric.
"""
import numpy as np
import pytest
import torch

from tgq_torch.core.quant import QuantSpec
from tgq_torch.kernels import dequant_matmul as KD
from tgq_torch.models.hf_import import rtn_pack

# (out, in) of Qwen3-8B's packed matmuls: fused qkv, o, fused gate_up, down
QWEN3_8B = [(6144, 4096), (4096, 4096), (24576, 4096), (4096, 12288)]


@pytest.mark.parametrize("t", [1, 8, 64, 1024, 1500])
@pytest.mark.parametrize("N,K", QWEN3_8B)
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_k4_plan_covers_the_serving_shapes(N, K, bits, t):
    plan = KD._k4_plan(t, K, N, 128, bits)
    per = 8 if bits == 3 else 8 // bits
    wide = N // 128 >= 132   # gate_up: 128-column tiles alone fill the card
    assert plan.regime == ("prefill" if t > 8 else "decode_wide" if wide else "decode")
    assert (plan.tile_t, plan.tile_n, plan.k_warps) == (
        (128, 128, 1) if t > 8 else (8, 128, 2) if wide else (8, 32, 8))
    assert plan.chunk_k == plan.units * per == 128 and plan.chunk_k % 32 == 0
    assert plan.units % 4 == 0 and plan.n_chunks * plan.chunk_k == K
    assert plan.smem <= 227 * 1024


@pytest.mark.parametrize("bits,g", [(5, 128), (8, 128), (4, 16), (4, 48), (3, 80)])
def test_k4_plan_rejects_what_the_kernel_does_not_take(bits, g):
    with pytest.raises(ValueError):
        KD._k4_plan(8, 4 * g, 64, g, bits)


# ------------------------------------------------------------ emulation

U32 = np.uint32


def byte_perm(x, y, sel):
    """__byte_perm on uint32 arrays: byte n of the result is byte
    ((sel >> 4n) & 7) of the 8 bytes [x, y]."""
    b = [(x >> U32(8 * i)) & U32(0xFF) for i in range(4)] + \
        [(y >> U32(8 * i)) & U32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= b[(sel >> (4 * n)) & 7] << U32(8 * n)
    return out


def lds32(mem, addr):
    """Little-endian 32-bit words of the byte array at the addresses."""
    addr = np.asarray(addr)
    return (mem[addr].astype(U32) | (mem[addr + 1].astype(U32) << U32(8))
            | (mem[addr + 2].astype(U32) << U32(16)) | (mem[addr + 3].astype(U32) << U32(24)))


def field4(st, cs, bits, w, e, uc):
    """The 4 columns' codes of field e of the unit whose row word is at w."""
    if bits == 3:
        lo = lds32(st, w + (e & 1) * uc * cs)
        hi = lds32(st, w + 2 * uc * cs)
        return ((lo >> U32(2 * (e >> 1))) & U32(0x03030303)) | (
            ((hi >> U32(e)) & U32(0x01010101)) << U32(2))
    m = U32(0x0F0F0F0F if bits == 4 else 0x03030303)
    return (lds32(st, w) >> U32(bits * e)) & m


def quad(st, cs, bits, byte, kappa, uc, kz):
    """Per lane: the 4 A registers (columns byte..byte+3) at chunk positions
    kappa..kappa+3; kappa is an array over lanes."""
    e, v = kappa // uc, kappa % uc
    t = [np.array([field4(st, cs, bits, byte[i] + (v[i] + j) * cs, e[i], uc)
                   for i in range(32)], dtype=U32) for j in range(4)]
    a = byte_perm(t[0], t[1], 0x5140)
    b = byte_perm(t[0], t[1], 0x7362)
    c = byte_perm(t[2], t[3], 0x5140)
    d = byte_perm(t[2], t[3], 0x7362)
    outs = [byte_perm(a, c, 0x5410), byte_perm(a, c, 0x7632),
            byte_perm(b, d, 0x5410), byte_perm(b, d, 0x7632)]
    return [((o + kz[i]) & U32(0xFFFFFFFF)) ^ U32(0x80808080) for i, o in enumerate(outs)]


def s8(reg):
    """(32,) uint32 registers -> (32, 4) signed bytes, byte 0 first."""
    return np.stack([((reg >> U32(8 * i)) & U32(0xFF)).astype(np.int64) for i in range(4)],
                    axis=1).astype(np.uint8).view(np.int8).astype(np.int64)


def mma_s8(A, b0, b1):
    """m16n8k32 s8 x s8 -> s32 from the lanes' registers (PTX fragment
    layouts); returns (32, 4) c registers."""
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    Am = np.zeros((16, 32), np.int64)
    Bm = np.zeros((32, 8), np.int64)
    for r, (row_off, k_off) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        vals = s8(A[r])
        for i in range(4):
            Am[gid + row_off, 4 * tig + k_off + i] = vals[:, i]
    for r, b in enumerate((b0, b1)):
        vals = s8(b)
        for i in range(4):
            Bm[4 * tig + 16 * r + i, gid] = vals[:, i]
    D = Am @ Bm
    return np.stack([D[gid, 2 * tig], D[gid, 2 * tig + 1], D[gid + 8, 2 * tig],
                     D[gid + 8, 2 * tig + 1]], axis=1)


def emulate_k4(x8, a, w):
    """y (t, N) f32 as the kernel computes it, block by block."""
    t, K = x8.shape
    N, g, bits = w.out_features, w.group_size, w.bits
    plan = KD._k4_plan(t, K, N, g, bits)
    bn, tt_ = plan.tile_n, plan.tile_t
    nwk = plan.k_warps
    wcn = bn // 32
    ntt = 8 if plan.regime == "prefill" else 1
    wnn = tt_ // (8 * ntt)
    per = 8 if bits == 3 else 8 // bits
    upg, uc = g // per, plan.units
    cpg, kc = upg // uc, plan.chunk_k
    rows = uc * (3 if bits == 3 else 1)
    cs = bn + 16
    xrb = kc + 16
    codes, scale, zero = w.codes.numpy(), w.scale.numpy(), w.zero.numpy()
    xb = x8.view(np.uint8)
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    y = np.zeros((t, N), np.float32)
    for tok0 in range(0, t, tt_):
        for col0 in range(0, N, bn):
            acc = np.zeros((tt_, bn), np.float32)
            s_grp = np.zeros(bn, np.float32)
            dsum = np.zeros((tt_, bn), np.int64)
            ncol = min(bn, N - col0)
            for c in range(plan.n_chunks):
                gi, u = divmod(c, cpg)
                u0 = u * uc
                st = np.zeros(rows * cs, np.uint8)
                for r in range(rows):
                    plane, v = divmod(r, uc)
                    st[r * cs:r * cs + ncol] = codes[
                        gi * (g * bits // 8) + u0 + plane * (g // 8) + v, col0:col0 + ncol]
                xs = np.zeros(tt_ * xrb, np.uint8)
                runs = 1 if uc == upg else per
                run_len = kc // runs
                for tt in range(min(tt_, t - tok0)):
                    for e in range(runs):
                        src = xb[tok0 + tt, gi * g + u0 + e * upg:][:run_len]
                        xs[tt * xrb + e * run_len:][:run_len] = src
                if u == 0 or nwk > 1:   # decode: every chunk carries its group's
                    s_grp[:] = 0
                    s_grp[:ncol] = scale[gi, col0:col0 + ncol]
                    z_grp = np.zeros(bn, np.int64)
                    z_grp[:ncol] = zero[gi, col0:col0 + ncol].astype(np.int64)
                partial = np.zeros((wcn, 8, 32), np.int64)   # decode: red[w][wc][4m + c][lane]
                # decode: the column warps of k warp c % nwk take the whole chunk
                for warp in ([c % nwk + nwk * wc for wc in range(wcn)] if nwk > 1
                             else range(wcn * wnn)):
                    wk, wc, wn = warp % nwk, (warp // nwk) % wcn, warp // (nwk * wcn)
                    wcol = 32 * wc + 4 * gid
                    kz = [((128 - z_grp[wcol + i]) * 0x01010101).astype(U32) for i in range(4)]
                    xm_off = (wn * ntt * 8 + (lane >> 4) * 8 + (lane & 7)) * xrb + \
                        ((lane >> 3) & 1) * 16
                    d = np.zeros((2, ntt, 32, 4), np.int64)
                    for s in range(kc // 32):
                        q0 = quad(st, cs, bits, wcol, 32 * s + 4 * tig, uc, kz)
                        q1 = quad(st, cs, bits, wcol, 32 * s + 16 + 4 * tig, uc, kz)
                        A0, A1 = [q0[0], q0[1], q1[0], q1[1]], [q0[2], q0[3], q1[2], q1[3]]
                        for n in range(ntt):   # ldmatrix: matrix j from lanes 8j..8j+7
                            addr = xm_off + 32 * s + (n // 2) * 16 * xrb
                            mats = [lds32(xs, addr[8 * j + gid] + 4 * tig)    # x2 at decode
                                    for j in range(2 if ntt == 1 else 4)]
                            b0, b1 = (mats[0], mats[1]) if n % 2 == 0 else (mats[2], mats[3])
                            d[0, n] += mma_s8(A0, b0, b1)
                            d[1, n] += mma_s8(A1, b0, b1)
                    if nwk > 1:
                        for m in range(2):
                            for cc in range(4):
                                partial[wc, 4 * m + cc] = d[m, 0, :, cc]
                    else:
                        for m in range(2):
                            for n in range(ntt):
                                for cc in range(4):
                                    toks = wn * ntt * 8 + n * 8 + 2 * tig + (cc & 1)
                                    dsum[toks, wcol + 2 * m + (cc >> 1)] += d[m, n, :, cc]
                if nwk > 1:   # the fold threads' view of red
                    for o in range(256 * wcn):
                        i, ln = (o & 255) >> 5, o & 31
                        col = 32 * (o >> 8) + 4 * (ln >> 2) + 2 * (i >> 2) + ((i & 3) >> 1)
                        tok = 2 * (ln & 3) + (i & 1)
                        dsum[tok, col] += partial[o >> 8, i, ln]
                if u == cpg - 1:   # f32 fold: product and sum rounded apart
                    acc = (acc + (dsum.astype(np.float32) * s_grp[None, :]).astype(np.float32)
                           ).astype(np.float32)
                    dsum[:] = 0
            nt = min(tt_, t - tok0)
            y[tok0:tok0 + nt, col0:col0 + ncol] = (
                acc[:nt, :ncol] * a[tok0:tok0 + nt]).astype(np.float32)
    return y


@pytest.fixture
def tiles(request, monkeypatch):
    """Decode on 32-column tiles, or on the 128-column tiles the planner
    gives matmuls with many columns (forced here at a small N); prefill."""
    if request.param == "decode_wide":
        monkeypatch.setattr(KD, "_K4_WIDE_MIN_TILES", 1)
    KD._k4_plan.cache_clear()
    yield request.param
    KD._k4_plan.cache_clear()


@pytest.mark.parametrize("t,tiles", [(5, "decode"), (5, "decode_wide"), (20, "prefill")],
                         indirect=["tiles"])
@pytest.mark.parametrize("bits,g,sym", [(4, 128, False), (4, 256, True), (4, 64, False),
                                        (3, 64, False), (3, 128, True), (2, 64, True),
                                        (2, 128, False)])
def test_lane_emulation_is_bit_exact(rng, tiles, bits, g, sym, t):
    K, N = 256, 160           # a ragged last tile in both regimes
    w = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32))
    pw = rtn_pack(w, QuantSpec(bits=bits, group_size=g, sym=sym))
    x = torch.from_numpy(rng.normal(size=(t, K)).astype(np.float32))
    x8, a = KD.quantize_activations(x)
    want = KD.a8_matmul_plain(x8, a, pw).numpy()
    assert KD._k4_plan(t, K, N, g, bits).regime == tiles
    got = emulate_k4(x8.numpy(), a.numpy(), pw)
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 0


def test_a8_matmul_wrapper_on_the_cpu(rng):
    """K4's entry point on pre-quantized activations: on a CPU tensor the
    plain version (bf16 output: the f32 result rounded once); the wrapper
    rejects activations that are not (t, in_features) int8."""
    w = rtn_pack(torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32)),
                 QuantSpec(bits=4, group_size=64))
    x8, a = KD.quantize_activations(torch.from_numpy(rng.normal(size=(3, 256)).astype(np.float32)))
    want = KD.a8_matmul_plain(x8, a, w)
    assert torch.equal(KD.a8_matmul(x8, a, w), want)
    assert torch.equal(KD.a8_matmul(x8, a, w, out_dtype=torch.bfloat16), want.bfloat16())
    with pytest.raises(ValueError):
        KD.a8_matmul(x8.float(), a, w)
    with pytest.raises(ValueError):
        KD.a8_matmul(x8[:, :128], a, w)
