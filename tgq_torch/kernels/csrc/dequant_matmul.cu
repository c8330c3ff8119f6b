// Packed-weight matmul for Hopper (sm_90a): y = x · Wᵀ with W stored as
// K-major packed integer codes plus per-group f32 scale and zero.
//
// Replaces the TPU kernel K3 `_dequant_matmul_kernel` of
// tgq/kernels/dequant_matmul.py (bf16/f32 activations, optional GLU input
// silu(gate)·up computed at load).  K4 (W4A8) is a8_matmul.cu, which shares
// this file's load path through common.cuh.
//
// Layout (tgq_torch/core/packing.py): codes (K·bits/8, N) u8, packed along K
// within each group of g inputs: int8 raw; int4 split-half (byte j of a group
// holds codes j and j + g/2); int2 split-quarter; int3 "planes21" (a 2-bit
// plane of g/4 bytes, then a 1-bit plane of g/8 bytes).  scale/zero are
// (K/g, N) f32; symmetric codes arrive biased, so w = (q - zero) · scale.
//
// K3: what bounds it on this card.  At decode (t <= 8 tokens) the packed
// weight bytes: W4 gate_up moves 50 MB, 15 us at 3.35 TB/s, against 0.4
// GFLOP.  At prefill (t ~ 1000) the products: 2·t·N·K bf16 operations on the
// tensor cores (gate_up at t = 1024: 0.21 ms at 989 TFLOP/s); weights and x
// cross from L2 into shared memory once per 128 x 128 tile.
//
// K3 design.
// - The group scale is factored out, so no weight is rounded: zero is an
//   integer, so q - z (|q - z| <= 255) is exact in bf16.  Per group the
//   tensor cores compute d = Σ_k x·(q - z) with mma.sync.m16n8k16 (bf16 in,
//   f32 accumulate), and the CUDA cores fold acc += s · d at the group's end.
//   Against the plain version (dequantize, f32 matmul) only the order of the
//   f32 sums differs.  Sub-byte codes become bf16 by the exponent trick
//   (byte 0x43 over the code gives 128 + q exactly), then one bf16x2
//   subtraction of 128 + z; 8-bit codes through f32.
// - f32 activations are split x = hi + lo (two bf16) and both halves go
//   through the same mma with the same weight fragment (residual ~2^-17 |x|).
// - Weights are the A operand (16 output columns x 16 k), tokens the N = 8
//   operand.  A thread's two A rows of both m16 tiles are 4 adjacent output
//   columns, so one 32-bit shared-memory word of a code row feeds all four.
// - Codes are paired with x in the order they are stored: a group's dot is
//   order-free, so its inputs are taken in "chunk order" κ = e·uc + v, where
//   unit v (a byte row; int3: a row of each plane) of the chunk yields the
//   code of input u0 + v + e·(g/PER), e = 0..PER-1.  Pairs (κ, κ+1) are the
//   same field of two adjacent rows.  A chunk is uc units of one group (all
//   of a group when it is small), so x for it is PER runs of uc inputs (one
//   run of g when uc = g/PER), each copied as is; no staging pass.
// - Pipeline: cp.async (16 bytes, zero-filled past t and N) of codes, the
//   group's scale and zero and the raw x (GLU: gate and up) of a chunk into a
//   ring of STAGES slots in shared memory, one barrier a chunk.  GLU and f32
//   x are converted once a chunk (glu_act's rounding chain; hi and lo halves)
//   into a bf16 buffer behind a second barrier; all x fragments go through
//   ldmatrix.
// - Decode: 4 warps x 32 columns, 8 tokens; prefill: 8 warps, 128 columns x
//   128 tokens, each warp 32 x 64 (the dequantized A fragment feeds 16 mma;
//   x fragments by ldmatrix).  Copy offsets are fixed per thread, so a chunk's
//   copies cost a few adds.  Where the tiles are too few to fill the card's
//   SMs in one wave, the chunks are split over blockIdx.y (split-K): each
//   split writes an f32 partial into a workspace, and a second launch sums
//   the partials in split order (deterministic: the same input gives the same
//   bits, and a bf16 output is the f32 one rounded once).  The host's planner
//   (kernels/dequant_matmul.py::_k3_plan) picks the regime, uc and the split.
//
#include "common.cuh"

namespace {

using namespace tgq;

// bytes of one token's raw x row of a chunk in shared memory (XM bit 0:
// f32, bit 1: GLU [gate | up]), and of its bf16 conversion for the mma (hi,
// then lo for f32; none for bf16 x, read raw); 16 bytes of padding put the 8
// rows an ldmatrix reads on distinct banks
__host__ __device__ inline int x_row_bytes(int kc, int xm) {
  return kc * ((xm & 1) ? 4 : 2) * ((xm & 2) ? 2 : 1) + 16;
}
__host__ __device__ inline int conv_row_bytes(int kc, int xm) {
  return xm == 0 ? 0 : kc * 2 * ((xm & 1) ? 2 : 1) + 16;
}

struct Layout {
  int sz, x, stage;  // offsets in a stage: codes at 0, then scale|zero, then x
};

__host__ __device__ inline Layout k3_layout(int bits, int uc, int tt, int xm, int bn) {
  const int per = bits == 3 ? 8 : 8 / bits;
  Layout l;
  l.sz = uc * (bits == 3 ? 3 : 1) * code_stride(bn);
  l.x = l.sz + 2 * bn * 4;
  l.stage = (l.x + tt * x_row_bytes(uc * per, xm) + 127) & ~127;
  return l;
}

struct K3Args {
  const void* x;
  long ldx;
  const uint8_t* codes;
  const float* scale;
  const float* zero;
  void* y;
  float* ws;
  int y_bf16, t, K, N, g, uc, split, vec;
};

__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}
// v rounded to bf16 (the activations' dtype), or kept (f32 activations)
template <bool F32>
__device__ __forceinline__ float rt(float v) {
  return F32 ? v : __bfloat162float(__float2bfloat16_rn(v));
}
// silu(gate)·up rounded as glu_act (kernels/dequant_matmul.py) rounds it:
// gate · (1 / (1 + exp(-gate))) · up, each step in f32 and rounded to x's dtype
template <bool F32>
__device__ __forceinline__ float glu1(float v, float u) {
  const float e = rt<F32>(expf(-v));
  const float sig = rt<F32>(__fdiv_rn(1.f, rt<F32>(__fadd_rn(e, 1.f))));
  return rt<F32>(__fmul_rn(rt<F32>(__fmul_rn(v, sig)), u));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A values of chunk positions (κ, κ+1) = field e of code rows v, v+1,
// for the thread's 4 columns (bytes 0..3 of the row word at `cw`): r[i] =
// bf16x2(q - z) of column i.  zz[i]: bf16x2(128 + z) (BITS < 8) or
// 2^23 + z as f32 bits (BITS == 8).
template <int BITS, int CS>
__device__ __forceinline__ void weights(uint32_t (&r)[4], const uint8_t* cw, int e, int v,
                                        int uc, const uint32_t (&zz)[4]) {
  if (BITS == 8) {
    const uint32_t wa = lds32(cw + v * CS), wb = lds32(cw + (v + 1) * CS);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // 0x4B0000qq is 2^23 + q; minus 2^23 + z leaves q - z exactly
      const float fa = __uint_as_float(__byte_perm(wa, 0x4B000000u, 0x7440 | i)) -
                       __uint_as_float(zz[i]);
      const float fb = __uint_as_float(__byte_perm(wb, 0x4B000000u, 0x7440 | i)) -
                       __uint_as_float(zz[i]);
      r[i] = pack_bf16x2(fa, fb);
    }
    return;
  }
  uint32_t ta, tb;
  if (BITS == 3) {
    const uint8_t* lo = cw + ((e & 1) * uc + v) * CS;
    const uint8_t* hi = cw + (2 * uc + v) * CS;
    const int sl = 2 * (e >> 1);
    ta = ((lds32(lo) >> sl) & 0x03030303u) | (((lds32(hi) >> e) & 0x01010101u) << 2);
    tb = ((lds32(lo + CS) >> sl) & 0x03030303u) | (((lds32(hi + CS) >> e) & 0x01010101u) << 2);
  } else {
    constexpr uint32_t M = BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u;
    const int sh = BITS * e;
    ta = (lds32(cw + v * CS) >> sh) & M;
    tb = (lds32(cw + (v + 1) * CS) >> sh) & M;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t p = __byte_perm(ta, tb, i | ((i + 4) << 4));  // [qa_i, qb_i, ., .]
    r[i] = bsub2(__byte_perm(p, 0x43434343u, 0x4140), zz[i]);   // [qa, 0x43, qb, 0x43]
  }
}

// x at chunk positions (κ, κ+1) of one token row converted for the mma:
// glu_act folded in (GLU), split into bf16 hi and lo halves (f32 x), written
// as bf16 pairs at conv (hi) and conv + 2·kc bytes (lo).
template <int XM>
__device__ __forceinline__ void x_convert(const uint8_t* raw, uint8_t* conv, int kap, int kc) {
  constexpr bool F32 = XM & 1, GLU = XM & 2;
  if (!F32) {
    const uint32_t g2 = lds32(raw + kap * 2), u2 = lds32(raw + (kc + kap) * 2);
    *reinterpret_cast<uint32_t*>(conv + kap * 2) =
        pack_bf16x2(glu1<false>(bf_lo(g2), bf_lo(u2)), glu1<false>(bf_hi(g2), bf_hi(u2)));
  } else {
    float2 v = *reinterpret_cast<const float2*>(raw + kap * 4);
    if (GLU) {
      const float2 u = *reinterpret_cast<const float2*>(raw + (kc + kap) * 4);
      v = make_float2(glu1<true>(v.x, u.x), glu1<true>(v.y, u.y));
    }
    const uint32_t hi = pack_bf16x2(v.x, v.y);
    *reinterpret_cast<uint32_t*>(conv + kap * 2) = hi;
    *reinterpret_cast<uint32_t*>(conv + (kc + kap) * 2) =
        pack_bf16x2(v.x - bf_lo(hi), v.y - bf_hi(hi));
  }
}

// One (32·WC)-column x (8·NTT·WN)-token tile of y over the chunks of
// split blockIdx.y.  Warp (wc, wn) owns columns 32·wc.. and tokens
// 8·NTT·wn..; lane (gid, tig) owns columns 4·gid..4·gid+3 of them: row gid of
// m16 tile m is column 4·gid + 2m, row gid + 8 column 4·gid + 2m + 1.
template <int BITS, int XM, int WC, int WN, int NTT, int STAGES, int UCF>
__global__ void __launch_bounds__(32 * WC * WN)
dequant_matmul_kernel(const K3Args a) {
  constexpr int NTH = 32 * WC * WN;
  constexpr int BN = 32 * WC, CS = code_stride(BN);
  constexpr int PER = Fmt<BITS>::PER;
  constexpr bool F32 = XM & 1, GLU = XM & 2;
  constexpr int ELT = F32 ? 4 : 2;
  constexpr int TILE_T = 8 * NTT * WN;
  static_assert(NTT == 1 || NTT % 2 == 0, "n-tiles are read in pairs");
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wc = warp % WC, wn = warp / WC;
  const int n_tok_tiles = (a.t + TILE_T - 1) / TILE_T;
  const int tok0 = (blockIdx.x % n_tok_tiles) * TILE_T;
  const int col0 = (blockIdx.x / n_tok_tiles) * BN;
  const int g = a.g, uc = UCF ? UCF : a.uc;  // UCF: uc known when compiled
  const int upg = g / PER, cpg = upg / uc, kc = uc * PER;
  const int n_chunks = (a.K / g) * cpg;
  const int c_begin = (int)((long)n_chunks * blockIdx.y / a.split);
  const int c_end = (int)((long)n_chunks * (blockIdx.y + 1) / a.split);
  const Layout L = k3_layout(BITS, uc, TILE_T, XM, BN);
  const int xrb = x_row_bytes(kc, XM), crb = conv_row_bytes(kc, XM);
  uint8_t* conv = smem + STAGES * L.stage;  // converted x of the current chunk

  // Per-thread copy assignments, the same for every chunk: code row pieces
  // (c_ch, rows c_r, c_r + CROWS, ...; (plane, v) of row r tracked as r
  // grows), one scale or zero piece, x pieces x_j of token rows x_t, ...
  constexpr int CPR = BN / 16, CROWS = NTH / CPR;
  const int rows = uc * (BITS == 3 ? 3 : 1);
  const int c_ch = tid % CPR, c_r = tid / CPR;
  int c_plane = 0, c_v = c_r;
  wrap(c_plane, c_v, uc);
  const int runs = uc == upg ? 1 : PER;  // x: one run of g inputs or PER runs of uc
  const int run_len = kc / runs, pieces = run_len * ELT / 16;
  const int per_tok = runs * pieces * (GLU ? 2 : 1);  // GLU: gate, then up
  const bool x_even = NTH % per_tok == 0;
  auto x_piece = [&](int j, int& src, int& dst) {  // offsets in a token row
    const int h = j / (runs * pieces), rem = j - h * runs * pieces;
    const int e = rem / pieces, p = rem - e * pieces;
    src = h * a.K + e * upg + p * (16 / ELT);  // elements past input gi·g + u0
    dst = (h * kc + e * run_len) * ELT + p * 16;  // bytes
  };
  int x_src = 0, x_dst = 0;
  x_piece(tid % per_tok, x_src, x_dst);
  const int x_t = tid / per_tok, x_step = NTH / per_tok;
  const uint8_t* xb = static_cast<const uint8_t*>(a.x);

  // copy chunk c (codes, the group's scale and zero, raw x) into ring slot
  auto load_chunk = [&](int c, int slot) {
    uint8_t* base = smem + slot * L.stage;
    const int gi = c / cpg, u0 = (c - gi * cpg) * uc;
    const long row0 = (long)gi * (g * BITS / 8) + u0;
    const int col = col0 + c_ch * 16;
    int plane = c_plane, v = c_v;  // int3: lo rows, lo rows + g/8, hi rows
    for (int r = c_r; r < rows; r += CROWS) {
      uint8_t* dst = base + r * CS + c_ch * 16;
      const uint8_t* src = a.codes + (row0 + (long)plane * (g / 8) + v) * a.N + col;
      if (a.vec) {
        cp_async16(dst, col < a.N ? src : a.codes, col < a.N ? 16 : 0);
      } else {
        for (int b = 0; b < 16; ++b) dst[b] = col + b < a.N ? src[b] : 0;
      }
      v += CROWS;
      wrap(plane, v, uc);
    }
    if ((u0 == 0 || c == c_begin) && tid < BN / 2) {  // the group's scale and zero
      const int which = tid / (BN / 4), cc = (tid % (BN / 4)) * 4;
      float* dst = reinterpret_cast<float*>(base + L.sz) + which * BN + cc;
      const float* src = (which ? a.zero : a.scale) + (long)gi * a.N + col0 + cc;
      if (a.vec) {
        cp_async16(dst, col0 + cc < a.N ? src : a.scale, col0 + cc < a.N ? 16 : 0);
      } else {
        for (int j = 0; j < 4; ++j) dst[j] = col0 + cc + j < a.N ? src[j] : 0.f;
      }
    }
    const long xk = (long)gi * g + u0;
    auto copy_x = [&](int tt, int src_off, int dst_off) {
      const int tok = tok0 + tt;
      cp_async16(base + L.x + tt * xrb + dst_off,
                 xb + ((long)(tok < a.t ? tok : 0) * a.ldx + xk + src_off) * ELT,
                 tok < a.t ? 16 : 0);
    };
    if (x_even) {
      for (int tt = x_t; tt < TILE_T; tt += x_step) copy_x(tt, x_src, x_dst);
    } else {
      for (int i = tid; i < TILE_T * per_tok; i += NTH) {
        int src_off, dst_off;
        x_piece(i % per_tok, src_off, dst_off);
        copy_x(i / per_tok, src_off, dst_off);
      }
    }
  };

  float acc[2][NTT][4], d[2][NTT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NTT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][n][c] = d[m][n][c] = 0.f;
  float s_col[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t zz[4] = {0u, 0u, 0u, 0u};
  auto flush = [&]() {  // acc += s · d for the finished group
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NTT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[m][n][c] = fmaf(s_col[2 * m + (c >> 1)], d[m][n][c], acc[m][n][c]);
          d[m][n][c] = 0.f;
        }
  };

  const int nc = c_end - c_begin;
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nc) load_chunk(c_begin + j, j);
    cp_async_commit();
  }
  int cur_g = -1;
  const int wcol = 32 * wc + 4 * gid;  // the thread's first column in the tile
  // ldmatrix row address of this lane: token row 8·(l/16) + l%8 of the warp's
  // tile, inputs 8·((l/8) % 2).. of the k16 step (bf16 x)
  const int xstride = XM == 0 ? xrb : crb;
  const int xm_off =
      (wn * NTT * 8 + (lane >> 4) * 8 + (lane & 7)) * xstride + ((lane >> 3) & 1) * 16;
  for (int j = 0; j < nc; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < nc) load_chunk(c_begin + j + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint8_t* base = smem + (j % STAGES) * L.stage;
    const int gi = (c_begin + j) / cpg;
    if (gi != cur_g) {
      if (cur_g >= 0) flush();
      cur_g = gi;
      const float4 sv = *reinterpret_cast<const float4*>(base + L.sz + wcol * 4);
      const float4 zv = *reinterpret_cast<const float4*>(base + L.sz + (BN + wcol) * 4);
      s_col[0] = sv.x, s_col[1] = sv.y, s_col[2] = sv.z, s_col[3] = sv.w;
      const float z[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        zz[i] = BITS == 8 ? __float_as_uint(8388608.f + z[i]) : pack_bf16x2(128.f + z[i],
                                                                            128.f + z[i]);
    }
    const uint8_t* cw = base + wcol;
    if constexpr (XM != 0) {  // GLU or f32 x: convert once for all warps
      for (int p = tid; p < TILE_T * (kc / 2); p += NTH) {
        const int tt = p / (kc / 2);
        x_convert<XM>(base + L.x + tt * xrb, conv + tt * crb, 2 * (p - tt * (kc / 2)), kc);
      }
      __syncthreads();
    }
    const uint8_t* xm = (XM == 0 ? base + L.x : conv) + xm_off;
    int e0 = 0, v0 = 2 * tig, e1 = 0, v1 = 2 * tig + 8;
    wrap(e0, v0, uc);
    wrap(e1, v1, uc);
    constexpr int UNROLL = UCF ? 8 : 2;
#pragma unroll UNROLL
    for (int s = 0; s < kc / 16; ++s) {
      uint32_t w0[4], w1[4];
      weights<BITS, CS>(w0, cw, e0, v0, uc, zz);
      weights<BITS, CS>(w1, cw, e1, v1, uc, zz);
      const uint32_t A0[4] = {w0[0], w0[1], w1[0], w1[1]};
      const uint32_t A1[4] = {w0[2], w0[3], w1[2], w1[3]};
      // B fragments by ldmatrix; f32 x: the hi, then the lo half
#pragma unroll
      for (int h = 0; h < (F32 ? 2 : 1); ++h) {
        const uint8_t* xh = xm + h * 2 * kc + 32 * s;
        if constexpr (NTT == 1) {
          uint32_t b[2];
          ldsm_x2(b, xh);
          mma16816(d[0][0], A0, b[0], b[1]);
          mma16816(d[1][0], A1, b[0], b[1]);
        } else {
#pragma unroll
          for (int n = 0; n < NTT; n += 2) {
            uint32_t b[4];
            ldsm_x4(b, xh + n * 8 * xstride);
            mma16816(d[0][n], A0, b[0], b[1]);
            mma16816(d[1][n], A1, b[0], b[1]);
            mma16816(d[0][n + 1], A0, b[2], b[3]);
            mma16816(d[1][n + 1], A1, b[2], b[3]);
          }
        }
      }
      v0 += 16;
      v1 += 16;
      wrap(e0, v0, uc);
      wrap(e1, v1, uc);
    }
  }
  cp_async_wait<0>();
  flush();

  const int col = col0 + wcol;
  if (col >= a.N) return;
  const bool vec_out = (a.N & 3) == 0;
#pragma unroll
  for (int n = 0; n < NTT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = tok0 + wn * NTT * 8 + n * 8 + 2 * tig + h;
      if (tok >= a.t) continue;
      const float v[4] = {acc[0][n][h], acc[0][n][2 + h], acc[1][n][h], acc[1][n][2 + h]};
      if (a.split > 1 || !a.y_bf16) {
        float* p = a.split > 1 ? a.ws + ((long)blockIdx.y * a.t + tok) * a.N + col
                               : static_cast<float*>(a.y) + (long)tok * a.N + col;
        if (vec_out) {
          *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
          for (int i = 0; i < 4; ++i)
            if (col + i < a.N) p[i] = v[i];
        }
      } else {
        __nv_bfloat16* p = static_cast<__nv_bfloat16*>(a.y) + (long)tok * a.N + col;
        if (vec_out) {
          *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v[0], v[1]),
                                                    pack_bf16x2(v[2], v[3]));
        } else {
          for (int i = 0; i < 4; ++i)
            if (col + i < a.N) p[i] = __float2bfloat16_rn(v[i]);
        }
      }
    }
}

// Split-K: y = Σ_s ws[s], summed in split order, then rounded once.
__global__ void dequant_matmul_reduce(const float* __restrict__ ws, void* y, int y_bf16,
                                      long total, int split) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = ws[i];
  for (int k = 1; k < split; ++k) s = __fadd_rn(s, ws[k * total + i]);
  if (y_bf16)
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(s);
  else
    static_cast<float*>(y)[i] = s;
}

template <int BITS, int XM, int WC, int WN, int NTT, int STAGES, int UCF>
int launch_k3(const K3Args& a, int device, cudaStream_t stream) {
  constexpr int TILE_T = 8 * NTT * WN, BN = 32 * WC;
  const int smem = STAGES * k3_layout(BITS, a.uc, TILE_T, XM, BN).stage +
                   TILE_T * conv_row_bytes(a.uc * Fmt<BITS>::PER, XM);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = dequant_matmul_kernel<BITS, XM, WC, WN, NTT, STAGES, UCF>;
  static bool opted_in[64] = {};
  const cudaError_t opt = allow_smem(kern, smem, device, opted_in);
  if (opt != cudaSuccess) return (int)opt;
  const dim3 grid(((a.t + TILE_T - 1) / TILE_T) * ((a.N + BN - 1) / BN), a.split);
  kern<<<grid, 32 * WC * WN, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.split == 1) return (int)e;
  const long total = (long)a.t * a.N;
  dequant_matmul_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(a.ws, a.y, a.y_bf16,
                                                                             total, a.split);
  return (int)cudaGetLastError();
}

// regime 0: decode: 4 warps x 32 columns, 8 tokens, 4 stages.  1: prefill:
// 8 warps as 4 (columns) x 2 (tokens), each 32 columns x 64 tokens (128-token
// tiles) for bf16 x; 64-token tiles for f32 or GLU x, whose x rows are 2-4x
// wider (2 stages for f32 GLU).  Tiles and stages do not change the order of
// the sums; the chunk (uc) and the split do, and the planner picks both
// independently of the x mode, so the fused GLU equals the split form.
// 128-input chunks (every group size that 128 divides) run a build with uc
// fixed and the chunk's 8 k16 steps unrolled; other chunks read uc at run time.
template <int BITS, int XM, int UCF>
int launch_k3_tiles(const K3Args& a, int prefill, int device, cudaStream_t s) {
  if (!prefill) return launch_k3<BITS, XM, 4, 1, 1, 4, UCF>(a, device, s);
  if (XM == 0) return launch_k3<BITS, XM, 4, 2, 8, 3, UCF>(a, device, s);
  return launch_k3<BITS, XM, 4, 2, 4, XM == 3 ? 2 : 3, UCF>(a, device, s);
}

template <int BITS, int XM>
int launch_k3_regime(const K3Args& a, int prefill, int device, cudaStream_t s) {
  constexpr int UC128 = 128 / Fmt<BITS>::PER;
  return a.uc == UC128 ? launch_k3_tiles<BITS, XM, UC128>(a, prefill, device, s)
                       : launch_k3_tiles<BITS, XM, 0>(a, prefill, device, s);
}

template <int BITS>
int launch_k3_x(const K3Args& a, int xm, int prefill, int device, cudaStream_t s) {
  switch (xm) {
    case 0: return launch_k3_regime<BITS, 0>(a, prefill, device, s);
    case 1: return launch_k3_regime<BITS, 1>(a, prefill, device, s);
    case 2: return launch_k3_regime<BITS, 2>(a, prefill, device, s);
    case 3: return launch_k3_regime<BITS, 3>(a, prefill, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int t, int K, int N, int g, int bits) {
  const int per = bits == 3 ? 8 : 8 / bits;
  return t < 0 || K <= 0 || N <= 0 || g <= 0 || K % g != 0 || g % per != 0 ||
         (bits == 3 && g % 8 != 0);
}

}  // namespace

extern "C" {

// K3.  x (t, ldx) bf16 or f32, rows 16-byte aligned (GLU: ldx >= 2K,
// [gate | up]); y (t, N) bf16 or f32; ws: split·t·N f32 when split > 1.
// uc (code units per chunk), split and the regime come from the host's
// planner.  `vec`: code, scale and zero rows are 16-byte aligned (N % 16 == 0,
// aligned bases).  Launches the matmul (and the split-K sum) on `stream`;
// returns the CUDA error code (0 = launched).
int tgq_dequant_matmul(const void* x, int x_f32, long ldx, const uint8_t* codes,
                       const float* scale, const float* zero, void* y, int y_bf16, float* ws,
                       int t, int K, int N, int g, int bits, int glu, int uc, int split,
                       int prefill, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int per = bits == 3 ? 8 : (bits > 0 && bits <= 8 ? 8 / bits : 1);
  if (bad_shape(t, K, N, g, bits) || g % 16 != 0 || uc <= 0 || uc % 2 != 0 ||
      (g / per) % uc != 0 || (uc != g / per && uc % 16 != 0) || split < 1 ||
      (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (t == 0) return 0;
  const K3Args a{x, ldx, codes, scale, zero, y, ws, y_bf16, t, K, N, g, uc, split, vec};
  const int xm = (x_f32 ? 1 : 0) | (glu ? 2 : 0);
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 2: return launch_k3_x<2>(a, xm, prefill, device, s);
    case 3: return launch_k3_x<3>(a, xm, prefill, device, s);
    case 4: return launch_k3_x<4>(a, xm, prefill, device, s);
    case 8: return launch_k3_x<8>(a, xm, prefill, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
