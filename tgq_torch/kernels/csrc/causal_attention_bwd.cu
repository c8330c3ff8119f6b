// K6-bwd: the gradients of K6, the causal flash attention
// (causal_attention.cu), for Hopper (sm_90a).
//
// Replaces the two TPU kernels that jax.grad runs through
// tgq/models/causal_lm.py::_flash_causal_attention: the upstream Pallas op
// jax/experimental/pallas/ops/tpu/flash_attention.py, its custom_vjp's
// backward rule _flash_attention_bwd, i.e. _flash_attention_bwd_dkv (body
// _flash_attention_dkv_kernel) and _flash_attention_bwd_dq (body
// _flash_attention_dq_kernel).  Same arithmetic, in the port's (b, s, h, d)
// layout, for each batch b, query head h (kv head g = h / (H / KV)), row i
// and key j <= i:
//   p_ij  = 2^(s_ij·c - L_i),  s_ij = q_i·k_j, c = sm_scale·log2 e, L_i the
//           forward's log2-sum-exp in K6's own exponent domain (so p is the
//           forward's probability, recomputed from K6's stats output)
//   di_i  = Σ_d o_id·do_id (f32, from the bf16 forward output o)
//   ds_ij = (do_i·v_j - di_i)·p_ij·sm_scale
//   dV_j  = Σ_{h in g's group} Σ_i bf16(p_ij)·do_i
//   dK_j  = Σ_{h in g's group} Σ_i bf16(ds_ij)·q_i
//   dQ_i  = Σ_j bf16(ds_ij)·k_j
// every product of bf16 operands summed in f32, each gradient rounded to
// bf16 once.  The TPU path repeats K / V for GQA and sums the repeated
// heads' bf16 gradients after its kernels; here a dK / dV block sums its
// group's heads in f32 registers, so nothing is repeated in memory.
//
// What bounds it on this card: bf16 tensor-core operations.  Both kernels
// recompute S = Q·Kᵀ and dP = dO·Vᵀ, dQ adds dS·K, dK / dV add dSᵀ·Q and
// Pᵀ·dO: 2.5x the forward's operations, 5·d·H·s(s+1) a sequence, against
// (4H + 4KV)·s·d bf16 values of q, k, v, o, dO in and dQ, dK, dV out (and
// H·s f32 stats); at the calibration batch (8, 2048, 32 / 8 heads, 128)
// 6.9e11 operations, 0.695 ms at 989 TFLOP/s, against 0.67 GB (0.20 ms at
// 3.35 TB/s).
//
// Design (the first, simple one: mma.sync m16n8k16 bf16 with f32
// accumulators, tiles by cp.async, as K6's head_dim 16 body; wgmma and TMA
// are later work):
// - dQ: a block of 4 warps owns a 64-row query tile of one q head; each
//   warp 16 rows.  Its prologue computes di for the tile's rows (two
//   threads a row) and writes it out for the dK / dV kernel.  It walks the
//   64-key tiles 0 .. the diagonal, K and V double-buffered: S and dP from
//   Q and dO fragments (ldmatrix from shared memory), p, ds in registers,
//   ds rounded to bf16 and repacked in place as the A fragments of dS·K
//   (K's B fragments by a transposed ldmatrix).  Only the diagonal tile is
//   masked.
// - dK / dV: a block of 4 warps owns a 64-key tile of one kv head; each
//   warp 16 keys.  It walks the group's query heads and, for each, the
//   query rows from the tile's first key to the end in steps of BQ rows
//   (32 at d 128, 64 below), Q, dO, L and di double-buffered: Sᵀ = K·Qᵀ and
//   dPᵀ = V·dOᵀ, then pᵀ and dsᵀ rounded to bf16 as the A fragments of
//   Pᵀ·dO and dSᵀ·Q (dO's and Q's B fragments by a transposed ldmatrix).
//   dK and dV stay in f32 registers across the whole walk: the in-kernel
//   GQA sum.  Only the steps that overlap the tile's keys are masked.
// - No float atomics and no split over the reduced axis: every gradient
//   element is one thread's f32 sum in a fixed order, so the bits depend on
//   its own sequence and head group alone (two launches, a batch and each
//   sequence alone, a head slice and the full launch agree bit for bit).
// - The dQ kernel runs first (it writes di), then the dK / dV kernel, on
//   the caller's stream.

#include <math.h>

#include "common.cuh"

namespace {

using namespace tgq;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 128;  // threads a block: 4 warps of 16 rows (dQ) or keys (dK / dV)
constexpr int BT = 64;   // rows of a dQ tile, keys of a dK / dV tile, keys of a dQ step

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // (B, H, S): m·c + log2 l of each row
  float* di;         // (B, H, S): written by the dQ kernel
  bf16* dq;          // (B, S, H, D) contiguous
  bf16* dk;          // (B, S, KV, D) contiguous
  bf16* dv;
  long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sob, sos, soh, sdb, sds, sdh;
  int S, H, KV;
  float scale, scale_log2;  // sm_scale and sm_scale·log2 e
};

template <int D>
struct Tiles {
  static constexpr int STR = D + 8;  // rows padded by 16 bytes: ldmatrix's 8 on distinct banks
  static constexpr int BQ = D == 128 ? 32 : 64;  // query rows a dK / dV step
  static constexpr int T = BT * STR;             // elements of a 64-row tile
  static constexpr int TQ = BQ * STR;            // elements of a dK / dV query step's tile
  // dynamic shared memory only (allow_smem opts a kernel into all 227 KB of
  // it, which leaves no room for static arrays): bf16 tiles, then f32 L, di
  static constexpr int SMEM_DQ = 6 * T * 2 + 2 * BT * 4;  // Q, dO, K[2], V[2]; L, di
  // K, V, Q[2], dO[2]; L[2], di[2]
  static constexpr int SMEM_DKV = (2 * T + 4 * TQ) * 2 + 4 * BQ * 4;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices, transposed: lane (gid, tig) receives column gid,
// rows 2·tig and 2·tig + 1 of matrix i in r[i]
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// the A fragment of rows r0 .. r0 + 15, features 16kk .. 16kk + 15 of a
// row-major tile
template <int STR>
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const bf16* tile, int r0, int kk,
                                       int lane) {
  ldsm_x4(r, reinterpret_cast<const uint8_t*>(tile + (r0 + (lane & 15)) * STR + kk * 16 +
                                              (lane >> 4) * 8));
}
// the B fragments (n-tiles 2np and 2np + 1) of a product whose n runs over
// rows 16np .. 16np + 15 of a row-major tile and k over its features
// 16kk .. 16kk + 15: {b0, b1} of the first n-tile, then of the second
template <int STR>
__device__ __forceinline__ void frag_b_rows(uint32_t (&r)[4], const bf16* tile, int np, int kk,
                                            int lane) {
  ldsm_x4(r, reinterpret_cast<const uint8_t*>(
                 tile + (np * 16 + (lane & 7) + (lane >> 4) * 8) * STR + kk * 16 +
                 ((lane >> 3) & 1) * 8));
}
// the B fragments of a product whose k runs over rows 16kk .. 16kk + 15 of
// a row-major tile and n over its features 16dp .. 16dp + 15 (transposed)
template <int STR>
__device__ __forceinline__ void frag_b_cols(uint32_t (&r)[4], const bf16* tile, int kk, int dp,
                                            int lane) {
  ldsm_x4_t(r, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + dp * 16 +
                   (lane >> 4) * 8);
}

// rows row0 .. row0 + R - 1 of one (batch, head) into a padded shared
// tile; rows at or past S are zero-filled (no bytes read)
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long row_stride, int row0,
                                          int S, int tid) {
  constexpr int CPR = D / 8;  // 16-byte pieces a row
#pragma unroll
  for (int i = tid; i < R * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < S;
    const bf16* p = ok ? src + (long)(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + r * Tiles<D>::STR + c * 8, p, ok ? 16 : 0);
  }
}

// ------------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(NT) attention_bwd_dq(const Args a) {
  using TL = Tiles<D>;
  constexpr int STR = TL::STR, T = TL::T;
  constexpr int KS = D / 16;  // k-steps over the features
  constexpr int NF = D / 8;   // 8-feature tiles of dQ
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + T;
  bf16* sk = sdo + T;      // two K tiles
  bf16* sv = sk + 2 * T;   // two V tiles
  float* s_l = reinterpret_cast<float*>(sv + 2 * T);
  float* s_di = s_l + BT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const int row0 = qt * BT;
  const bf16* qb = a.q + b * a.sqb + h * a.sqh;
  const bf16* dob = a.dout + b * a.sdb + h * a.sdh;
  const bf16* kb = a.k + b * a.skb + g * a.skh;
  const bf16* vb = a.v + b * a.svb + g * a.svh;
  const long stat = ((long)b * a.H + h) * a.S;  // this (batch, head)'s row 0 in lse and di

  load_rows<D, BT>(sq, qb, a.sqs, row0, a.S, tid);
  load_rows<D, BT>(sdo, dob, a.sds, row0, a.S, tid);
  load_rows<D, BT>(sk, kb, a.sks, 0, a.S, tid);
  load_rows<D, BT>(sv, vb, a.svs, 0, a.S, tid);
  cp_async_commit();

  // di of the tile's rows, two threads a row (each half the features, one
  // f32 FMA chain, then the pair's sum), and the rows' L; rows past the end
  // get p = 0 (L = +inf) and di = 0
  {
    const int r = tid >> 1, half = tid & 1, row = row0 + r;
    float acc = 0.f;
    if (row < a.S) {
      const bf16* op = a.o + b * a.sob + h * a.soh + (long)row * a.sos + half * (D / 2);
      const bf16* gp = dob + (long)row * a.sds + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(op + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(gp + c);
        const uint32_t ou[4] = {ov.x, ov.y, ov.z, ov.w}, gu[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc = fmaf(bf_lo(ou[e]), bf_lo(gu[e]), acc);
          acc = fmaf(bf_hi(ou[e]), bf_hi(gu[e]), acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      s_di[r] = acc;
      s_l[r] = row < a.S ? a.lse[stat + row] : INFINITY;
      if (row < a.S) a.di[stat + row] = acc;
    }
  }

  __syncthreads();
  const int wr = warp * 16 + gid;  // this thread's first row in the tile (and wr + 8)
  const int r0 = row0 + wr;
  const float lr[2] = {s_l[wr], s_l[wr + 8]}, dr[2] = {s_di[wr], s_di[wr + 8]};
  float acc[NF][4];
#pragma unroll
  for (int n = 0; n < NF; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    if (kt < qt) {
      load_rows<D, BT>(sk + (buf ^ 1) * T, kb, a.sks, (kt + 1) * BT, a.S, tid);
      load_rows<D, BT>(sv + (buf ^ 1) * T, vb, a.svs, (kt + 1) * BT, a.S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks_ = sk + buf * T;
    const bf16* vs_ = sv + buf * T;

    // S = Q·Kᵀ and dP = dO·Vᵀ: 8 tiles of 8 keys each; s[n] holds (row
    // wr, keys 8n + 2tig, +1) and (row wr + 8, the same keys)
    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], ga[4];
      frag_a<STR>(qa, sq, warp * 16, kk, lane);
      frag_a<STR>(ga, sdo, warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < BT / 16; ++np) {
        uint32_t bk[4], bv[4];
        frag_b_rows<STR>(bk, ks_, np, kk, lane);
        mma16816(s[2 * np], qa, bk[0], bk[1]);
        mma16816(s[2 * np + 1], qa, bk[2], bk[3]);
        frag_b_rows<STR>(bv, vs_, np, kk, lane);
        mma16816(dp[2 * np], ga, bv[0], bv[1]);
        mma16816(dp[2 * np + 1], ga, bv[2], bv[3]);
      }
    }

    // p from the forward's stats, the diagonal tile masked; ds in bf16 as
    // the A fragments of dS·K
    uint32_t da[BT / 16][4];
#pragma unroll
    for (int n = 0; n < BT / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[n][e], a.scale_log2, -lr[e >> 1]));
        if (kt == qt && kt * BT + 8 * n + 2 * tig + (e & 1) > r0 + (e >> 1) * 8) p = 0.f;
        ds[e] = (dp[n][e] - dr[e >> 1]) * p * a.scale;
      }
      da[n / 2][(n & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
      da[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
    }

    // dQ += dS·K
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bk[4];
        frag_b_cols<STR>(bk, ks_, kk, dp2, lane);
        mma16816(acc[2 * dp2], da[kk], bk[0], bk[1]);
        mma16816(acc[2 * dp2 + 1], da[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // the next iteration refills the other buffer
  }

  const long orow = (long)a.H * D;  // dQ's row stride
  bf16* ob = a.dq + ((long)b * a.S * a.H + h) * D + 2 * tig;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + half * 8;
    if (row >= a.S) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(ob + row * orow);
#pragma unroll
    for (int n = 0; n < NF; ++n) dst[n * 4] = pack_bf16x2(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// ----------------------------------------------------------------- dK, dV

template <int D>
__global__ void __launch_bounds__(NT) attention_bwd_dkv(const Args a) {
  using TL = Tiles<D>;
  constexpr int STR = TL::STR, T = TL::T, TQ = TL::TQ, BQ = TL::BQ;
  constexpr int KS = D / 16;  // k-steps over the features
  constexpr int NF = D / 8;   // 8-feature tiles of dK and dV
  constexpr int NQ = BQ / 8;  // 8-row tiles of a query step
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + T;
  bf16* sq = sv + T;         // two Q tiles
  bf16* sdo = sq + 2 * TQ;   // two dO tiles
  float (*s_l)[BQ] = reinterpret_cast<float (*)[BQ]>(sdo + 2 * TQ);  // [2][BQ]
  float (*s_di)[BQ] = s_l + 2;                                      // [2][BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int kt = blockIdx.x;  // key tile 0 sees every row: the longest first
  const int g = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.KV;
  const int key0 = kt * BT;
  const int steps = (a.S - key0 + BQ - 1) / BQ;  // query steps a head: rows key0 .. S - 1
  const int total = rep * steps;

  load_rows<D, BT>(sk, a.k + b * a.skb + g * a.skh, a.sks, key0, a.S, tid);
  load_rows<D, BT>(sv, a.v + b * a.svb + g * a.svh, a.svs, key0, a.S, tid);

  // step i: query head g·rep + i / steps, rows key0 + (i % steps)·BQ ..;
  // its Q and dO by cp.async, its L and di through registers
  auto prefetch = [&](int i, int buf) {
    const int h = g * rep + i / steps, r0 = key0 + (i % steps) * BQ;
    load_rows<D, BQ>(sq + buf * TQ, a.q + b * a.sqb + h * a.sqh, a.sqs, r0, a.S, tid);
    load_rows<D, BQ>(sdo + buf * TQ, a.dout + b * a.sdb + h * a.sdh, a.sds, r0, a.S, tid);
    cp_async_commit();
  };
  auto stats = [&](int i, float& l, float& d) {
    const int h = g * rep + i / steps, row = key0 + (i % steps) * BQ + tid;
    const long at = ((long)b * a.H + h) * a.S + row;
    l = INFINITY;  // rows past the end: p = 0
    d = 0.f;
    if (tid < BQ && row < a.S) {
      l = a.lse[at];
      d = a.di[at];
    }
  };
  prefetch(0, 0);
  {
    float l, d;
    stats(0, l, d);
    if (tid < BQ) {
      s_l[0][tid] = l;
      s_di[0][tid] = d;
    }
  }

  float dk[NF][4], dv[NF][4];
#pragma unroll
  for (int n = 0; n < NF; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  const int j0 = key0 + warp * 16 + gid;  // this thread's first key (and j0 + 8)

  for (int i = 0; i < total; ++i) {
    const int buf = i & 1;
    float nl = INFINITY, nd = 0.f;
    if (i + 1 < total) {
      prefetch(i + 1, buf ^ 1);
      stats(i + 1, nl, nd);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = key0 + (i % steps) * BQ;
    const bool diag = r0 < key0 + BT;  // the step overlaps the tile's keys
    const bf16* qs_ = sq + buf * TQ;
    const bf16* gs_ = sdo + buf * TQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: st[n] holds (key j0, rows r0 + 8n + 2tig,
    // +1) and (key j0 + 8, the same rows)
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = dpt[n][0] = dpt[n][1] = dpt[n][2] =
          dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<STR>(ka, sk, warp * 16, kk, lane);
      frag_a<STR>(va, sv, warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t bq[4], bg[4];
        frag_b_rows<STR>(bq, qs_, np, kk, lane);
        mma16816(st[2 * np], ka, bq[0], bq[1]);
        mma16816(st[2 * np + 1], ka, bq[2], bq[3]);
        frag_b_rows<STR>(bg, gs_, np, kk, lane);
        mma16816(dpt[2 * np], va, bg[0], bg[1]);
        mma16816(dpt[2 * np + 1], va, bg[2], bg[3]);
      }
    }

    // pᵀ and dsᵀ in bf16 as the A fragments of Pᵀ·dO and dSᵀ·Q
    uint32_t pa[NQ / 2][4], da[NQ / 2][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(&s_l[buf][8 * n + 2 * tig]);
      const float2 d2 = *reinterpret_cast<const float2*>(&s_di[buf][8 * n + 2 * tig]);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? l2.y : l2.x, d = (e & 1) ? d2.y : d2.x;
        p[e] = ex2(fmaf(st[n][e], a.scale_log2, -l));
        if (diag && j0 + (e >> 1) * 8 > r0 + 8 * n + 2 * tig + (e & 1)) p[e] = 0.f;
        ds[e] = (dpt[n][e] - d) * p[e] * a.scale;
      }
      pa[n / 2][(n & 1) * 2] = pack_bf16x2(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
      da[n / 2][(n & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
      da[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bg[4], bq[4];
        frag_b_cols<STR>(bg, gs_, kk, dp2, lane);
        mma16816(dv[2 * dp2], pa[kk], bg[0], bg[1]);
        mma16816(dv[2 * dp2 + 1], pa[kk], bg[2], bg[3]);
        frag_b_cols<STR>(bq, qs_, kk, dp2, lane);
        mma16816(dk[2 * dp2], da[kk], bq[0], bq[1]);
        mma16816(dk[2 * dp2 + 1], da[kk], bq[2], bq[3]);
      }
    }
    __syncthreads();  // the buffers are free: the next step's stats go in
    if (tid < BQ) {
      s_l[buf ^ 1][tid] = nl;
      s_di[buf ^ 1][tid] = nd;
    }
  }

  const long orow = (long)a.KV * D;  // dK's and dV's row stride
  const long off = ((long)b * a.S * a.KV + g) * D + 2 * tig;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = j0 + half * 8;
    if (key >= a.S) continue;
    uint32_t* dkp = reinterpret_cast<uint32_t*>(a.dk + off + key * orow);
    uint32_t* dvp = reinterpret_cast<uint32_t*>(a.dv + off + key * orow);
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      dkp[n * 4] = pack_bf16x2(dk[n][2 * half], dk[n][2 * half + 1]);
      dvp[n * 4] = pack_bf16x2(dv[n][2 * half], dv[n][2 * half + 1]);
    }
  }
}

template <int D>
int launch(const Args& a, int B, int device, cudaStream_t stream) {
  using TL = Tiles<D>;
  static bool opted_dq[64] = {}, opted_dkv[64] = {};
  auto kdq = attention_bwd_dq<D>;
  auto kdkv = attention_bwd_dkv<D>;
  cudaError_t e = allow_smem(kdq, TL::SMEM_DQ, device, opted_dq);
  if (e == cudaSuccess) e = allow_smem(kdkv, TL::SMEM_DKV, device, opted_dkv);
  if (e != cudaSuccess) return (int)e;
  const int nt = (a.S + BT - 1) / BT;
  kdq<<<dim3(nt, a.H, B), NT, TL::SMEM_DQ, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdkv<<<dim3(nt, a.KV, B), NT, TL::SMEM_DKV, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K6-bwd.  q, o, dout (B, S, H, D) and k, v (B, S, KV, D) bf16 with
// element strides (batch, position, head), a contiguous feature axis and
// 16-byte aligned rows; lse (B, H, S) f32 from K6's stats output; di (B,
// H, S) f32 scratch (written); dq (B, S, H, D), dk and dv (B, S, KV, D)
// bf16 contiguous (written).  D is 16, 64 or 128; H a multiple of KV;
// sm_scale > 0.  Launches the dQ kernel, then the dK / dV kernel, on
// `stream`; returns the CUDA error code (0 = launched).
int tgq_causal_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* di, void* dq, void* dk,
                             void* dv, long sqb, long sqs, long sqh, long skb, long sks, long skh,
                             long svb, long svs, long svh, long sob, long sos, long soh,
                             long sdb, long sds, long sdh, int B, int S, int H, int KV, int D,
                             float sm_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || S < 0 || H <= 0 || KV <= 0 || H % KV != 0 || H > 65535 || B > 65535 ||
      !(sm_scale > 0.f))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(o),
               static_cast<const bf16*>(dout), static_cast<const float*>(lse),
               static_cast<float*>(di), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
               static_cast<bf16*>(dv), sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sob, sos,
               soh, sdb, sds, sdh, S, H, KV, sm_scale, sm_scale * LOG2E};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(a, B, device, s);
    case 64: return launch<64>(a, B, device, s);
    case 128: return launch<128>(a, B, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
