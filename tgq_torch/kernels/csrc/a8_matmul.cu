// W4A8 packed-weight matmul for Hopper (sm_90a) on the int8 tensor cores:
// y = a_t · Σ_g s[g, o] · (x8_g · (q - z)_g) for int8 activations x8 (one
// f32 scale a_t per token) and K-major packed 2/3/4-bit codes with per-group
// f32 scale and integral zero.
//
// Replaces the TPU kernel K4 `_a8_matmul_kernel` of
// tgq/kernels/dequant_matmul.py.  Arithmetic, as the JAX kernel and the
// plain version (kernels/dequant_matmul.py::a8_matmul_plain) do it: per
// group an exact int32 dot d of x8 with q - z (|q - z| <= 15 for bits <= 4,
// since zero is an integer in [0, 2^bits - 1]); then acc = acc + float(d)·s
// with the product and the sum rounded separately, in group order; then one
// multiply by a_t.  Every order-dependent step is an integer one, so the
// output equals the plain version's bit for bit (bf16 output: the f32
// result rounded once).  No split-K over blocks: it would reorder the f32
// group sums.
//
// What bounds it on this card: at decode (t <= 8) the packed weight bytes
// (W4 gate_up: 50 MB + 3 MB of scales, 16 us at 3.35 TB/s); at prefill the
// int8 products, 2·t·N·K at 1979 TOP/s (gate_up at t = 1024: 0.10 ms).
//
// Design.  The load path is K3's (dequant_matmul.cu): a cp.async ring of
// chunks (a chunk is uc code units of one group, with the group's scale and
// zero and the x8 of the chunk's inputs), copy offsets fixed per thread, and
// codes paired with x in the order they are stored (chunk order κ = e·uc + v
// is field e of unit v); an integer dot is order-free, so pairing both
// operands in chunk order is exact.  The product is mma.sync.m16n8k32
// s8·s8 -> s32: weights on the M side (output columns), tokens on N.  A
// lane's A fragment is 4 consecutive chunk positions of one column, so the
// lane reads one 32-bit code word (4 columns) of 4 unit rows, extracts the
// field, transposes the 4x4 bytes with byte permutes and subtracts the
// zero from all four bytes at once ((q + 128 - z) ^ 128 per byte: no
// borrow crosses a byte).  x8 fragments come by ldmatrix.  Code rows sit in
// shared memory BN + 16 bytes apart, as K3's do.
// - Decode: a block takes 32 output columns x 8 tokens (narrow tiles: o and
//   down have 4096 columns, 128 blocks; 128 columns where the columns alone
//   fill the card, as gate_up's).  A ring stage holds NWK chunks and
//   warp w takes chunk w of it whole (at g = 128 a chunk is one group), so
//   the warps work on consecutive groups at once; each writes its int32
//   partial dot to shared memory, and one barrier later the partials are
//   summed (exact in any order) and folded into f32 once per group, in
//   group order.
// - Prefill (t > 8): 128 columns x 128 tokens a block, 8 warps of 32
//   columns x 64 tokens, an int32 group accumulator beside the f32 one;
//   each code tile crosses from L2 once per 128 tokens.
// The host's planner (kernels/dequant_matmul.py::_k4_plan) picks the regime
// and the chunk.

#include "common.cuh"

namespace {

using namespace tgq;

struct Layout {
  int sz, x, stage;  // offsets in a stage: codes at 0, then scale|zero, then x8
};

__host__ __device__ inline Layout k4_layout(int bits, int uc, int tt, int bn) {
  const int per = bits == 3 ? 8 : 8 / bits;
  Layout l;
  l.sz = uc * (bits == 3 ? 3 : 1) * code_stride(bn);
  l.x = l.sz + 2 * bn * 4;
  l.stage = (l.x + tt * (uc * per + 16) + 127) & ~127;
  return l;
}

struct K4Args {
  const int8_t* x8;
  const float* ascale;
  const uint8_t* codes;
  const float* scale;
  const float* zero;
  void* y;
  int y_bf16, t, K, N, g, uc, vec;
};

// the 4 columns' codes (bytes 0..3) of field e of code unit v, whose row
// word (int3: lo-plane row word) is at `w`
template <int BITS, int CS>
__device__ __forceinline__ uint32_t field4(const uint8_t* w, int e, int uc) {
  if (BITS == 3) {
    const uint32_t lo = lds32(w + (e & 1) * uc * CS);
    const uint32_t hi = lds32(w + 2 * uc * CS);
    return ((lo >> (2 * (e >> 1))) & 0x03030303u) | (((hi >> e) & 0x01010101u) << 2);
  }
  constexpr uint32_t M = BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u;
  return (lds32(w) >> (BITS * e)) & M;
}

// q - z as int8 at chunk positions κ..κ+3 (field e of units v..v+3) for the
// thread's 4 columns (bytes 0..3 of the row words at cw): r[i] = column
// i's 4 values, κ ascending in the bytes.  kz[i] = 128 - z of column i in
// every byte.
template <int BITS, int CS>
__device__ __forceinline__ void quad(uint32_t (&r)[4], const uint8_t* cw, int e, int v, int uc,
                                     const uint32_t (&kz)[4]) {
  const uint8_t* w = cw + v * CS;
  const uint32_t t0 = field4<BITS, CS>(w, e, uc);
  const uint32_t t1 = field4<BITS, CS>(w + CS, e, uc);
  const uint32_t t2 = field4<BITS, CS>(w + 2 * CS, e, uc);
  const uint32_t t3 = field4<BITS, CS>(w + 3 * CS, e, uc);
  const uint32_t a = __byte_perm(t0, t1, 0x5140);  // [t0.0, t1.0, t0.1, t1.1]
  const uint32_t b = __byte_perm(t0, t1, 0x7362);  // [t0.2, t1.2, t0.3, t1.3]
  const uint32_t c = __byte_perm(t2, t3, 0x5140);
  const uint32_t d = __byte_perm(t2, t3, 0x7362);
  r[0] = (__byte_perm(a, c, 0x5410) + kz[0]) ^ 0x80808080u;  // [t0.0, t1.0, t2.0, t3.0] - z
  r[1] = (__byte_perm(a, c, 0x7632) + kz[1]) ^ 0x80808080u;
  r[2] = (__byte_perm(b, d, 0x5410) + kz[2]) ^ 0x80808080u;
  r[3] = (__byte_perm(b, d, 0x7632) + kz[3]) ^ 0x80808080u;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fold(float acc, int d, float s) {
  return __fadd_rn(acc, __fmul_rn(__int2float_rn(d), s));
}

// One (32·WC)-column x (8·NTT·WN)-token tile of y.  Warp (wk, wc, wn): at
// decode (NWK > 1) k warp wk takes chunk wk of each ring stage; (wc, wn)
// own columns 32·wc.. and tokens 8·NTT·wn..; lane (gid, tig) holds columns
// 4·gid..4·gid+3 of them (row gid of m16 tile m is column 4·gid + 2m, row
// gid + 8 column 4·gid + 2m + 1).
template <int BITS, int WC, int WN, int NTT, int NWK, int STAGES, int UCF>
__global__ void __launch_bounds__(32 * WC * WN * NWK) a8_matmul_kernel(const K4Args a) {
  constexpr int NTH = 32 * WC * WN * NWK;
  constexpr int BN = 32 * WC, CS = code_stride(BN);
  constexpr int PER = Fmt<BITS>::PER;
  constexpr int TILE_T = 8 * NTT * WN;
  static_assert(NTT == 1 || NTT % 2 == 0, "n-tiles are read in pairs");
  static_assert(NWK == 1 || (WN == 1 && NTT == 1), "k warps at decode only");
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wk = warp % NWK, wc = (warp / NWK) % WC, wn = warp / (NWK * WC);
  const int n_tok_tiles = (a.t + TILE_T - 1) / TILE_T;
  const int tok0 = (blockIdx.x % n_tok_tiles) * TILE_T;
  const int col0 = (blockIdx.x / n_tok_tiles) * BN;
  const int g = a.g, uc = UCF ? UCF : a.uc;  // UCF: uc known when compiled
  const int upg = g / PER, cpg = upg / uc, kc = uc * PER;
  const int n_chunks = (a.K / g) * cpg;
  const int n_stages = (n_chunks + NWK - 1) / NWK;  // a ring stage holds NWK chunks
  const Layout L = k4_layout(BITS, uc, TILE_T, BN);
  const int xrb = kc + 16;  // x8 row bytes: 16 of padding put ldmatrix rows on distinct banks

  // per-thread copy assignments, the same for every chunk (as K3's)
  constexpr int CPR = BN / 16, CROWS = NTH / CPR;
  const int rows = uc * (BITS == 3 ? 3 : 1);
  const int c_ch = tid % CPR, c_r = tid / CPR;
  int c_plane = 0, c_v = c_r;
  wrap(c_plane, c_v, uc);
  const int runs = uc == upg ? 1 : PER;  // x: one run of g inputs or PER runs of uc
  const int run_len = kc / runs, pieces = run_len / 16;
  const int per_tok = runs * pieces;
  const bool x_even = NTH % per_tok == 0;
  auto x_piece = [&](int j, int& src, int& dst) {  // offsets in a token row
    const int e = j / pieces, p = j - e * pieces;
    src = e * upg + p * 16;
    dst = e * run_len + p * 16;
  };
  int x_src = 0, x_dst = 0;
  x_piece(tid % per_tok, x_src, x_dst);
  const int x_t = tid / per_tok, x_step = NTH / per_tok;

  // copy chunk c into chunk slot `slot` (NWK slots a ring stage)
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
    // the group's scale and zero: with its first chunk (every chunk at decode,
    // where each warp reads its own chunk's)
    if ((u0 == 0 || NWK > 1) && tid < BN / 2) {
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
                 a.x8 + (long)(tok < a.t ? tok : 0) * a.K + xk + src_off, tok < a.t ? 16 : 0);
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
  auto load_stage = [&](int j, int slot) {
#pragma unroll
    for (int w = 0; w < NWK; ++w)
      if (j * NWK + w < n_chunks) load_chunk(j * NWK + w, slot * NWK + w);
  };

  int d[2][NTT][4];
  float acc[2][NTT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NTT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) d[m][n][c] = 0, acc[m][n][c] = 0.f;
  float s_col[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t kz[4] = {0u, 0u, 0u, 0u};

  // decode: the outputs each thread folds (BN columns x 8 tokens over the
  // block), value i = 4m + c of lane ln of column warp wc's partials
  constexpr int OWN = NWK > 1 ? 8 / NWK : 1;
  int* red = reinterpret_cast<int*>(smem + STAGES * NWK * L.stage);  // [NWK][WC][8][32]
  float acc_own[OWN] = {};
  int own_col[OWN], own_tok[OWN], own_idx[OWN], run[OWN] = {};
#pragma unroll
  for (int k = 0; k < OWN; ++k) {
    const int o = tid + NTH * k, i = (o & 255) >> 5, ln = o & 31;
    own_idx[k] = o;
    own_col[k] = 32 * (o >> 8) + 4 * (ln >> 2) + 2 * (i >> 2) + ((i & 3) >> 1);
    own_tok[k] = 2 * (ln & 3) + (i & 1);
  }

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_stages) load_stage(j, j);
    cp_async_commit();
  }
  const int wcol = 32 * wc + 4 * gid;  // the thread's first column in the tile
  // ldmatrix row address of this lane: token row 8·(l/16) + l%8 of the
  // warp's tile, bytes 16·((l/8) % 2).. of the k32 step
  const int xm_off = (wn * NTT * 8 + (lane >> 4) * 8 + (lane & 7)) * xrb + ((lane >> 3) & 1) * 16;
  for (int j = 0; j < n_stages; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (j + STAGES - 1 < n_stages) load_stage(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    const int c = j * NWK + wk;  // this warp's chunk
    const uint8_t* base = smem + ((j % STAGES) * NWK + wk) * L.stage;
    const int u = c % cpg;
    if (c < n_chunks) {
      if (u == 0 || NWK > 1) {  // the chunk's zeros (and, at a group's start, scales)
        const float* sz = reinterpret_cast<const float*>(base + L.sz);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kz[i] = (128u - (uint32_t)(int)sz[BN + wcol + i]) * 0x01010101u;
          s_col[i] = sz[wcol + i];
        }
      }
      const uint8_t* cw = base + wcol;
      const uint8_t* xm = base + L.x + xm_off;
      // k32 step s: quads at chunk positions 32·s + 4·tig and + 16
      auto kstep = [&](int s, int e0, int v0, int e1, int v1) {
        uint32_t q0[4], q1[4];
        quad<BITS, CS>(q0, cw, e0, v0, uc, kz);
        quad<BITS, CS>(q1, cw, e1, v1, uc, kz);
        const uint32_t A0[4] = {q0[0], q0[1], q1[0], q1[1]};
        const uint32_t A1[4] = {q0[2], q0[3], q1[2], q1[3]};
        const uint8_t* xs = xm + 32 * s;
        if constexpr (NTT == 1) {
          uint32_t b[2];
          ldsm_x2(b, xs);
          mma_s8(d[0][0], A0, b[0], b[1]);
          mma_s8(d[1][0], A1, b[0], b[1]);
        } else {
#pragma unroll
          for (int n = 0; n < NTT; n += 2) {
            uint32_t b[4];
            ldsm_x4(b, xs + n * 8 * xrb);
            mma_s8(d[0][n], A0, b[0], b[1]);
            mma_s8(d[1][n], A1, b[0], b[1]);
            mma_s8(d[0][n + 1], A0, b[2], b[3]);
            mma_s8(d[1][n + 1], A1, b[2], b[3]);
          }
        }
      };
      if constexpr (UCF > 0) {
        // the chunk's k32 steps unrolled: with uc a multiple of 16 known when
        // compiled, every quad's field and row offset is a constant
        static_assert(UCF % 16 == 0, "quads must not straddle a field");
#pragma unroll
        for (int s = 0; s < UCF * PER / 32; ++s)
          kstep(s, (32 * s) / UCF, (32 * s) % UCF + 4 * tig, (32 * s + 16) / UCF,
                (32 * s + 16) % UCF + 4 * tig);
      } else {
        int e0 = 0, v0 = 4 * tig, e1 = 0, v1 = v0 + 16;
        wrap(e0, v0, uc);
        wrap(e1, v1, uc);
        for (int s = 0; s < kc / 32; ++s) {
          kstep(s, e0, v0, e1, v1);
          v0 += 32;
          v1 += 32;
          wrap(e0, v0, uc);
          wrap(e1, v1, uc);
        }
      }
    }
    if constexpr (NWK > 1) {
      // every warp's exact int32 partial, then the f32 folds of the groups
      // that end in this stage, in group order
      if (c < n_chunks) {
        int* mine = red + (wk * WC + wc) * 256 + lane;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) mine[(4 * m + cc) * 32] = d[m][0][cc], d[m][0][cc] = 0;
      }
      __syncthreads();
      for (int w = 0; w < NWK && j * NWK + w < n_chunks; ++w) {
        const bool ends = (j * NWK + w) % cpg == cpg - 1;
        const float* sc = reinterpret_cast<const float*>(
            smem + ((j % STAGES) * NWK + w) * L.stage + L.sz);
#pragma unroll
        for (int k = 0; k < OWN; ++k) {
          run[k] += red[w * WC * 256 + own_idx[k]];
          if (ends) {
            acc_own[k] = fold(acc_own[k], run[k], sc[own_col[k]]);
            run[k] = 0;
          }
        }
      }
    } else if (u == cpg - 1) {  // the group ends: fold its exact int32 dots
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NTT; ++n)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            acc[m][n][cc] = fold(acc[m][n][cc], d[m][n][cc], s_col[2 * m + (cc >> 1)]);
            d[m][n][cc] = 0;
          }
    }
  }
  cp_async_wait<0>();

  if constexpr (NWK > 1) {
#pragma unroll
    for (int k = 0; k < OWN; ++k) {
      const int tok = tok0 + own_tok[k], col = col0 + own_col[k];
      if (tok >= a.t || col >= a.N) continue;
      const float v = __fmul_rn(acc_own[k], a.ascale[tok]);
      if (a.y_bf16)
        static_cast<__nv_bfloat16*>(a.y)[(long)tok * a.N + col] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(a.y)[(long)tok * a.N + col] = v;
    }
    return;
  }

  const int col = col0 + wcol;
  if (col >= a.N) return;
  const bool vec_out = (a.N & 3) == 0;
#pragma unroll
  for (int n = 0; n < NTT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = tok0 + wn * NTT * 8 + n * 8 + 2 * tig + h;
      if (tok >= a.t) continue;
      const float at = a.ascale[tok];
      const float v[4] = {__fmul_rn(acc[0][n][h], at), __fmul_rn(acc[0][n][2 + h], at),
                          __fmul_rn(acc[1][n][h], at), __fmul_rn(acc[1][n][2 + h], at)};
      if (!a.y_bf16) {
        float* p = static_cast<float*>(a.y) + (long)tok * a.N + col;
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

template <int BITS, int WC, int WN, int NTT, int NWK, int STAGES, int UCF>
int launch_k4(const K4Args& a, int device, cudaStream_t stream) {
  constexpr int TILE_T = 8 * NTT * WN, BN = 32 * WC;
  const int smem = STAGES * NWK * k4_layout(BITS, a.uc, TILE_T, BN).stage +
                   (NWK > 1 ? NWK * WC * 256 * 4 : 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  static bool opted_in[64] = {};
  auto kern = a8_matmul_kernel<BITS, WC, WN, NTT, NWK, STAGES, UCF>;
  const cudaError_t e = allow_smem(kern, smem, device, opted_in);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((a.t + TILE_T - 1) / TILE_T) * ((a.N + BN - 1) / BN));
  kern<<<grid, 32 * WC * WN * NWK, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// config 0: decode, 32 columns x 8 tokens, 8 warps on the 8 chunks of a
// stage, 2 stages; 1: prefill, 128 columns x 128 tokens, 8 warps of 32 x 64,
// 3 stages; 2: wide decode (many columns), 128 columns x 8 tokens, 2 chunks
// a stage for 4 column warps each, 4 stages.  128-input chunks run a build
// with uc fixed and the k32 steps unrolled; other chunks read uc at run time.
template <int BITS, int UCF>
int launch_config(const K4Args& a, int config, int device, cudaStream_t s) {
  switch (config) {
    case 0: return launch_k4<BITS, 1, 1, 1, 8, 2, UCF>(a, device, s);
    case 1: return launch_k4<BITS, 4, 2, 8, 1, 3, UCF>(a, device, s);
    case 2: return launch_k4<BITS, 4, 1, 1, 2, 4, UCF>(a, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int BITS>
int launch_regime(const K4Args& a, int config, int device, cudaStream_t s) {
  constexpr int UC128 = 128 / Fmt<BITS>::PER;
  return a.uc == UC128 ? launch_config<BITS, UC128>(a, config, device, s)
                       : launch_config<BITS, 0>(a, config, device, s);
}

}  // namespace

extern "C" {

// K4.  x8 (t, K) int8, rows 16-byte aligned; a (t,) f32 per-token scales;
// y (t, N) bf16 or f32.  uc (code units per chunk) and the tile config (0
// decode, 1 prefill, 2 wide decode) come from the host's planner.  `vec`:
// code, scale and zero rows are 16-byte aligned.
// Launches on `stream`; returns the CUDA error code (0 = launched).
int tgq_a8_matmul(const int8_t* x8, const float* a, const uint8_t* codes, const float* scale,
                  const float* zero, void* y, int y_bf16, int t, int K, int N, int g, int bits,
                  int uc, int config, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bits < 2 || bits > 4) return (int)cudaErrorInvalidValue;
  const int per = bits == 3 ? 8 : 8 / bits;
  if (t < 0 || K <= 0 || N <= 0 || g <= 0 || g % 32 != 0 || K % g != 0 || uc <= 0 ||
      uc % 4 != 0 || (g / per) % uc != 0 || (uc != g / per && uc % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (t == 0) return 0;
  const K4Args args{x8, a, codes, scale, zero, y, y_bf16, t, K, N, g, uc, vec};
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 2: return launch_regime<2>(args, config, device, s);
    case 3: return launch_regime<3>(args, config, device, s);
    case 4: return launch_regime<4>(args, config, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
