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
// What bounds it on this card: bf16 tensor-core operations.  The gradients
// need five products (S = Q·Kᵀ, dP = dO·Vᵀ, dS·K, dSᵀ·Q, Pᵀ·dO): 2.5x the
// forward's operations, 5·d·H·s(s+1) a sequence (the two kernels run seven:
// both recompute S and dP, so that neither needs float atomics), against
// (4H + 4KV)·s·d bf16 values of q, k, v, o, dO in and dQ, dK, dV out (and
// H·s f32 stats); at the calibration batch (8, 2048, 32 / 8 heads, 128)
// 6.9e11 operations, 0.695 ms at 989 TFLOP/s, against 0.67 GB (0.20 ms at
// 3.35 TB/s).
//
// Design at head_dim 64 and 128 (as K6's, causal_attention.cu), each part
// against that bound:
// - wgmma, the only route to the full tensor-core rate.  Two kernels, each
//   with blocks of 384 threads: a producer warpgroup that loads tiles by TMA
//   (4-D tensor maps of q, k, v and dO, encoded at each launch from the
//   callers' strides, 128-byte swizzle), and two consumer warpgroups whose
//   products are all wgmma.  Persistent: one block an SM walks work items of
//   a list ordered longest first, one item a block a round, each round in
//   the reverse order of the one before (a snake), and its rings and
//   barriers run on from one item to the next.  setmaxnreg moves registers
//   from the producer (24) to the consumers (240).
// - dQ kernel: a work item is a 128-row query tile of one q head; consumer c
//   owns its rows 64c .. 64c + 63.  Q and dO load into one of two buffers an
//   item (the next item's load overlaps this one), K and V in 64-key steps
//   through rings of 3 and 2 stages at d 128 (4 and 4 at d 64).  A step:
//   S = Q·Kᵀ and dP = dO·Vᵀ (m64n64k16, K-major), p and ds in f32
//   registers, ds rounded to bf16 and repacked in place as the register A
//   operand of dQ += dS·K (m64n{d}k16, K MN-major: the transpose bit).  Q,
//   and at d 64 dO, is a register A operand too, read from its tile once an
//   item (ldmatrix): with both operands in shared memory an m64n64k16
//   product reads them at about the SM's shared-memory rate.  V is released
//   once dP is done, K once dS·K is.  di of the consumer's rows (two threads
//   a row) is computed in the item's first turn while its S and dP run, from
//   o (loaded into registers before the previous item's last turn) and the
//   dO tile, and written out for the dK / dV kernel: computed ahead of the
//   turns, its loads stalled both consumers at every item (9 % of the whole
//   at the calibration batch).  dQ goes out through the consumer's rows of
//   the Q buffer by a TMA store.
// - dK / dV kernel: a work item is a 128-key tile of one kv head; consumer c
//   owns its keys 64c .. 64c + 63.  K and V load into one of two buffers an
//   item; the producer warp streams Q and dO in steps of BQ query rows (64,
//   32 at d 128; the rows from the tile's first key to the end, for each
//   query head of the group in turn) through a ring of stages, and with each
//   step the rows' L and di (cp.async, zero past the end: those rows' Q and
//   dO are zero too, so they add nothing).  A step: Sᵀ = K·Qᵀ and dPᵀ =
//   V·dOᵀ (m64n{BQ}k16, K-major; K, and at d 64 V, a register A operand read
//   once an item), pᵀ and dsᵀ in f32 registers, rounded to bf16 and
//   repacked in place as the register A operands of dV += Pᵀ·dO and dK +=
//   dSᵀ·Q (m64n{d}k16, dO and Q MN-major).  dK and dV stay in f32 registers
//   across the walk of every head of the group: the in-kernel GQA sum.  They
//   go out through the consumer's rows of the K and V buffers by TMA stores.
// - Overlap: the two consumers take turns to issue their products (named
//   barriers), so one warpgroup's exp2 and ds arithmetic runs under the
//   other's wgmmas; and inside a warpgroup, turn j issues step j's S and dP
//   and then step j - 1's register-A products, waits for S and dP alone and
//   computes p and ds while those run.
// - The causal walk: only the steps that overlap the diagonal are masked,
//   and a step whose every score is masked is not computed (dQ: consumer 0's
//   last 64 keys of the diagonal tile; dK / dV: consumer 1's first query
//   step), as K6 skips the diagonal tile's masked quarter.  Such a step's
//   turn only releases its stage, so both consumers take the same turns.
// - No float atomics and no split over the reduced axis: every gradient
//   element is one thread's f32 sum in a fixed order that depends on its own
//   sequence and head group alone, not on the grid or the schedule (two
//   launches, a batch and each sequence alone, a head slice and the full
//   launch agree bit for bit).
// - The dQ kernel runs first (it writes di), then the dK / dV kernel, on
//   the caller's stream.
//
// head_dim 16 (tiny test models only) keeps the first design: mma.sync
// m16n8k16 with f32 accumulators, tiles by cp.async, one block of 4 warps a
// 64-row query tile (dQ) or a 64-key tile (dK / dV, query steps of 64 rows).

#include <math.h>

#include <limits.h>

#include "common.cuh"
#include "hopper.cuh"

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

// one f32 store from the threads whose `pred` is true (predicated inside the
// asm, so the caller's control flow stays uniform)
__device__ __forceinline__ void st_global_if(float* p, float v, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(v), "r"((int)pred)
      : "memory");
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

// ------------------------- head_dim 16: mma.sync, the first design: dQ

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

// --------------------------------------- head_dim 16, the first design: dK, dV

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
int launch_mma(const Args& a, int B, int device, cudaStream_t stream) {
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

// ------------------------------------------------ head_dim 64 and 128: wgmma

constexpr int THREADS = 384;       // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 24;  // setmaxnreg: 128 x 24 + 256 x 240 = 384 x 168
constexpr int CONSUMER_REGS = 240;
constexpr int LAUNCH_REGS = 168;   // what __launch_bounds__(384, 1) allows
constexpr int QM = 128;            // query rows a dQ work item, 64 a consumer
constexpr int KN = 128;            // keys a dK / dV work item, 64 a consumer
constexpr int KSTEP = 64;          // keys a dQ step
constexpr int ROW = 128;           // bytes of a swizzled tile row: 64 bf16 features

// dQ kernel's shared memory, offsets from the 1024-aligned base: two Q / dO
// buffers (Q, then dO, 128 rows each), the K ring, the V ring (64 keys a
// stage), di of the consumers' rows, the mbarriers
template <int D>
struct DqPlan {
  static constexpr int BOXES = D / 64;        // 64-feature boxes a row
  static constexpr int QBOX = QM * ROW;       // bytes of a box of a Q / dO tile
  static constexpr int QTILE = BOXES * QBOX;
  static constexpr int KBOX = KSTEP * ROW;    // of a box of a K / V step
  static constexpr int KTILE = BOXES * KBOX;
  static constexpr int KS = D == 64 ? 4 : 3;  // K ring stages
  static constexpr int VS = D == 64 ? 4 : 2;  // V ring stages
  // dO as the register A operand of dP, as Q is of S (at d 128 it spills)
  static constexpr bool DO_REGS = D == 64;
  static constexpr int K0 = 4 * QTILE, V0 = K0 + KS * KTILE, DI = V0 + VS * KTILE,
                       BAR = DI + 2 * 64 * 4;
  // mbarriers from BAR, 8 bytes each: q_full[2], q_empty[2], then a full and
  // an empty one a stage of each ring
  static constexpr int QF = 0, QE = 16, KF = 32, KE = KF + 8 * KS, VF = KE + 8 * KS,
                       VE = VF + 8 * VS;
  static constexpr int SMEM = BAR + VE + 8 * VS + 1024;  // + alignment slack
  static_assert(SMEM <= MAX_SMEM, "dQ kernel's shared memory");
};

// dK / dV kernel's shared memory: two K / V buffers (K, then V, 128 keys
// each), the ring of Q / dO steps (BQ rows each), each step's L and di, the
// mbarriers; as many stages as fit, up to 8
template <int D>
struct KvPlan {
  static constexpr int BOXES = D / 64;
  // query rows a step: at d 128 with 64, dK, dV, Sᵀ, dPᵀ and the bf16 Pᵀ,
  // dSᵀ are 224 registers a thread, and ptxas spills
  static constexpr int BQ = D == 128 ? 32 : 64;
  static constexpr int KBOX = KN * ROW;
  static constexpr int KTILE = BOXES * KBOX;
  static constexpr int QBOX = BQ * ROW;
  static constexpr int QSTEP = BOXES * QBOX;  // Q (or dO) of a step
  static constexpr int STAGE = 2 * QSTEP;
  static constexpr int STATS = 2 * BQ * 4;    // L, then di
  // V as the register A operand of dPᵀ, as K is of Sᵀ (at d 128 it spills)
  static constexpr bool V_REGS = D == 64;
  static constexpr int Q0 = 4 * KTILE;
  static constexpr int FIT = (MAX_SMEM - 1024 - Q0 - 256) / (STAGE + STATS);
  static constexpr int NS = FIT < 8 ? FIT : 8;  // ring stages
  static constexpr int ST0 = Q0 + NS * STAGE, BAR = ST0 + NS * STATS;
  // kv_full[2], kv_empty[2], then q_full and q_empty a stage
  static constexpr int KF = 0, KE = 16, QF = 32, QE = QF + 8 * NS;
  static constexpr int SMEM = BAR + QE + 8 * NS + 1024;
  static_assert(NS >= 3, "a step is read until the next one's turn: the ring needs a third stage");
  static_assert(SMEM <= MAX_SMEM, "dK / dV kernel's shared memory");
};

// the launch's sizes, as the wgmma kernels read them
struct Dims {
  Args a;
  int B;
  int nt;  // 128-row query tiles (dQ) or 128-key tiles (dK / dV) a sequence
};

// the block's r-th work item: rounds of one item a block, each round's
// order the reverse of the one before (a snake through the list, which is
// ordered longest first: round robin left the dK / dV kernel's busiest block
// 9 % above the mean at the calibration batch, the snake 3 %)
__device__ __forceinline__ int item_index(int r) {
  return r * (int)gridDim.x + ((r & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// what a turn's first products compute for its step: nothing (the walk's
// last turn), nothing but release the step's stage (every score masked),
// the step masked, or the step whole
enum { S_NONE, S_SKIP, S_MASK, S_FULL };

// ---------------------------------------------------------- dQ, consumers

// one consumer warpgroup of the dQ kernel: dQ, S, dP and dS in registers,
// L and di of its two rows a thread, the shared-memory tiles it reads
template <int D>
struct DqConsumer {
  using P = DqPlan<D>;
  int c, t, tig, r;          // warpgroup, thread in it, column pair, row in its 64 (and r + 8)
  uint32_t sq, sdo, sk, sv, sdi, bar;  // this item's Q and dO, the rings, di, the mbarriers
  float scale, scale_log2;
  float acc[D / 2];          // dQ
  float s[32], dp[32];       // S, dP of a step; S becomes ds in place
  uint32_t da[4][4];         // bf16 dS: the A fragments of the 4 k-steps of dS·K
  float lr[2], dr[2];        // L, di of rows r and r + 8
  uint32_t qf[D / 16][4], gf[D / 16][4];  // Q, dO of its rows: the A fragments of S, dP
  uint4 ov[D / 16];          // o of the thread's half row, loaded ahead of an item's first turn
  float* di_at;              // where its row's di goes
  bool di_ok;                // whether the row is before the end

  __device__ __forceinline__ DqConsumer(int c_, uint32_t base, float sc, float sc2)
      : c(c_), scale(sc), scale_log2(sc2) {
    t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    tig = lane % 4;
    r = 16 * warp + lane / 4;
    sq = sdo = base;
    sk = base + P::K0;
    sv = base + P::V0;
    sdi = base + P::DI + c * 64 * 4;
    bar = base + P::BAR;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) da[ks][0] = da[ks][1] = da[ks][2] = da[ks][3] = 0u;
  }

  __device__ __forceinline__ void fence_all() {
    fence_regs(acc);
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) fence_regs(da[ks]);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      fence_regs(qf[kk]);
      if constexpr (P::DO_REGS) fence_regs(gf[kk]);
    }
  }

  // this item's register A operands, once its Q / dO tile is in
  __device__ __forceinline__ void load_frags() {
    const int lane = t % 32, row0 = 64 * c + 16 * (t / 32);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldsm_a_sw128(qf[kk], sq, P::QBOX, row0, kk, lane);
      if constexpr (P::DO_REGS) ldsm_a_sw128(gf[kk], sdo, P::QBOX, row0, kk, lane);
    }
  }

  // the loads of an item's di and stats, issued before the last turn of
  // the item ahead of it (its last grads are done): o of the thread's half
  // of its row (two threads a row), L of rows r and r + 8 (+inf past the
  // end: p = 0).  Branch-free: loads from a clamped row, selects.
  __device__ __forceinline__ void load_stats(const Args& a, int b, int h, int qt) {
    const int row0 = qt * QM + 64 * c;
    const long stat = ((long)b * a.H + h) * a.S;  // this (batch, head)'s row 0 in lse and di
    const int row = row0 + (t >> 1);
    di_ok = row < a.S;
    const int rc = di_ok ? row : a.S - 1;
    const bf16* op = a.o + b * a.sob + h * a.soh + (long)rc * a.sos + (t & 1) * (D / 2);
#pragma unroll
    for (int m = 0; m < D / 16; ++m) ov[m] = *reinterpret_cast<const uint4*>(op + 8 * m);
    di_at = a.di + stat + rc;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int rx = row0 + r + 8 * x;
      const float l = a.lse[stat + (rx < a.S ? rx : a.S - 1)];
      lr[x] = rx < a.S ? l : INFINITY;
    }
  }

  // di of this consumer's 64 rows, in the item's first turn while its S and
  // dP run: each thread an f32 FMA chain over half its row's features (o
  // from registers, dO from the item's tile), then the pair's sum; written
  // out for the dK / dV kernel and shared with the threads that hold the row
  __device__ __forceinline__ void finish_di() {
    const int rr = t >> 1, half = t & 1, rt = 64 * c + rr;  // row in the consumer, in the tile
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      const int f = half * (D / 2) + 8 * m;  // first feature of the 16-byte chunk
      const uint4 gv = lds_u32x4(sdo + (f / 64) * P::QBOX + rt * ROW +
                                 ((((f % 64) / 8) ^ (rt % 8)) * 16));
      const uint32_t ou[4] = {ov[m].x, ov[m].y, ov[m].z, ov[m].w}, gu[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sum = fmaf(bf_lo(ou[e]), bf_lo(gu[e]), sum);
        sum = fmaf(bf_hi(ou[e]), bf_hi(gu[e]), sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);  // both threads of the pair hold the sum
    sum = di_ok ? sum : 0.f;
    sts_f32(sdi + rr * 4, sum);
    st_global_if(di_at, sum, di_ok && half == 0);
    bar_sync(3 + c, 128);
    dr[0] = lds_f32(sdi + r * 4);
    dr[1] = lds_f32(sdi + (r + 8) * 4);
  }

  // p = 2^(s·c - L), zero above the diagonal of a masked step, and ds =
  // (dp - di)·p·sm_scale in place of s
  template <bool MASK>
  __device__ __forceinline__ void grads() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[4 * i + e], scale_log2, -lr[e >> 1]));
        if (MASK && 8 * i + 2 * tig + (e & 1) > r + 8 * (e >> 1)) p = 0.f;
        s[4 * i + e] = (dp[4 * i + e] - dr[e >> 1]) * p * scale;
      }
    }
  }

  // turn n of the block's walk, for its K / V step n: wait for the step's
  // tiles, take this warpgroup's turn on the tensor cores (named barriers 1
  // and 2, one a consumer), issue S_n and dP_n and then dS_{n-1}·K_{n-1}
  // (if RS), hand the turn over (unless `pass` is false), di (an item's
  // FIRST turn), release V_n once S and dP are done, ds_n while dS·K runs,
  // then release K_{n-1} and pack bf16 dS_n.  A skipped step only releases
  // K_n and V_n.
  template <int SM, bool RS, bool FIRST = false>
  __device__ __forceinline__ void turn(int n, bool pass) {
    constexpr bool MMA = SM == S_FULL || SM == S_MASK;
    const int ks = n % P::KS, vs = n % P::VS, kp = (n + P::KS - 1) % P::KS;
    if constexpr (SM != S_NONE) {
      mbar_wait(bar + P::KF + 8 * ks, (n / P::KS) & 1);
      mbar_wait(bar + P::VF + 8 * vs, (n / P::VS) & 1);
    }
    bar_sync(1 + c, 256);
    fence_all();
    wgmma_fence();
    if constexpr (MMA) {
      const uint32_t ga = sdo + c * 64 * ROW;
      const uint32_t kb = sk + ks * P::KTILE, vb = sv + vs * P::KTILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs_kb(s, qf[kk], sw128_desc(kb + (kk / 4) * P::KBOX + (kk % 4) * 32, 16, 1024),
                    kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = (kk / 4) * P::QBOX + (kk % 4) * 32, ob = (kk / 4) * P::KBOX + (kk % 4) * 32;
        if constexpr (P::DO_REGS)
          wgmma_rs_kb(dp, gf[kk], sw128_desc(vb + ob, 16, 1024), kk > 0);
        else
          wgmma_ss_n64(dp, sw128_desc(ga + oa, 16, 1024), sw128_desc(vb + ob, 16, 1024), kk > 0);
      }
    }
    wgmma_commit();
    if constexpr (RS) {
      const uint32_t kb = sk + kp * P::KTILE;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t dk = sw128_desc(kb + j * 16 * ROW, P::KBOX, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128(acc, da[j], dk, 1);
        else
          wgmma_rs_n64(acc, da[j], dk, 1);
      }
    }
    wgmma_commit();
    fence_all();
    if (pass) bar_arrive(2 - c, 256);
    if constexpr (FIRST) finish_di();

    if constexpr (MMA) {
      wgmma_wait<1>();  // S_n and dP_n are done; dS_{n-1}·K_{n-1} may still run
      fence_regs(s);
      fence_regs(dp);
      mbar_arrive_if(bar + P::VE + 8 * vs, t == 0);  // this warpgroup is done with V_n
      grads<SM == S_MASK>();
    }
    wgmma_wait<0>();
    fence_all();
    if constexpr (RS) mbar_arrive_if(bar + P::KE + 8 * kp, t == 0);  // and with K_{n-1}
    if constexpr (SM == S_SKIP) {
      mbar_arrive_if(bar + P::KE + 8 * ks, t == 0);
      mbar_arrive_if(bar + P::VE + 8 * vs, t == 0);
    }
    if constexpr (MMA) {
      // bf16 dS in the A fragment layout: chunks 2ks and 2ks + 1 of S are
      // keys 16ks .. 16ks + 15, rows r and r + 8
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        da[j][0] = pack_bf16x2(s[8 * j], s[8 * j + 1]);
        da[j][1] = pack_bf16x2(s[8 * j + 2], s[8 * j + 3]);
        da[j][2] = pack_bf16x2(s[8 * j + 4], s[8 * j + 5]);
        da[j][3] = pack_bf16x2(s[8 * j + 6], s[8 * j + 7]);
      }
    }
  }

  // a turn whose kind is known at run time (uniform across the warpgroup);
  // an item's first (never skipped, nothing before it) also finishes di
  __device__ __forceinline__ void step(int sm, bool rs, int n, bool pass, bool first = false) {
    if (first) {
      if (sm == S_FULL) turn<S_FULL, false, true>(n, pass); else turn<S_MASK, false, true>(n, pass);
    } else if (sm == S_FULL) {
      if (rs) turn<S_FULL, true>(n, pass); else turn<S_FULL, false>(n, pass);
    } else if (sm == S_MASK) {
      if (rs) turn<S_MASK, true>(n, pass); else turn<S_MASK, false>(n, pass);
    } else if (sm == S_SKIP) {
      if (rs) turn<S_SKIP, true>(n, pass); else turn<S_SKIP, false>(n, pass);
    } else {
      if (rs) turn<S_NONE, true>(n, pass); else turn<S_NONE, false>(n, pass);
    }
  }

  // bf16 dQ into this warpgroup's 64 rows of the Q buffer (free after its
  // last S) in the 128-byte swizzle, then stored by TMA, which drops rows
  // past the end; once TMA has read them, the Q / dO buffer `qb` is released
  __device__ __forceinline__ void store(const CUtensorMap* to, int b, int h, int qt, int S,
                                        int qb) {
    const uint32_t ob = sq + c * 64 * ROW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r + 8 * half;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        sts32(ob + (i / 8) * P::QBOX + row * ROW + (((i % 8) ^ (row % 8)) * 16) + tig * 4,
              pack_bf16x2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]));
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;  // the next item's dQ starts afresh
    fence_proxy_async();
    bar_sync(3 + c, 128);
    const int row0 = qt * QM + 64 * c;
    if (t == 0 && row0 < S) {
#pragma unroll
      for (int x = 0; x < P::BOXES; ++x) tma_store_4d(to, ob + x * P::QBOX, 64 * x, h, row0, b);
      tma_store_wait();
    }
    mbar_arrive_if(bar + P::QE + 8 * qb, t == 0);
  }
};

// item i of the dQ walk: query tile qt of head h, batch b, the longest rows
// first (every head and batch of the last query tile, then the one before, ...)
__device__ __forceinline__ void dq_item(int i, const Dims& d, int& qt, int& h, int& b) {
  const int hb = d.a.H * d.B;
  qt = d.nt - 1 - i / hb;
  h = i % hb % d.a.H;
  b = i % hb / d.a.H;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    attention_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdq, const Dims d) {
  using P = DqPlan<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's atom alignment
  const uint32_t bar = base + P::BAR;
  const int n_items = d.nt * d.a.H * d.B;
  // the warpgroup index through a shuffle: provably uniform to the compiler,
  // which otherwise treats branches on it as divergent and serialises the wgmmas
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    tma_prefetch(&tq);
    tma_prefetch(&tdo);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    tma_prefetch(&tdq);
    // a "full" barrier counts the producer's arrival and its TMA bytes, an
    // "empty" one an arrival from each consumer warpgroup
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar + P::QF + 8 * i, 1);
      mbar_init(bar + P::QE + 8 * i, 2);
    }
    for (int i = 0; i < P::KS; ++i) {
      mbar_init(bar + P::KF + 8 * i, 1);
      mbar_init(bar + P::KE + 8 * i, 2);
    }
    for (int i = 0; i < P::VS; ++i) {
      mbar_init(bar + P::VF + 8 * i, 1);
      mbar_init(bar + P::VE + 8 * i, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Persistent: the block walks items blockIdx.x, + gridDim.x, ...; item
  // `it` of the walk uses Q / dO buffer it % 2, and the rings and the
  // barriers' phases run on across items.  Item (qt, h, b) takes the 64-key
  // steps 0 .. 2qt + 1.
  if (wg == 0) {  // producer: one thread keeps the rings full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int rep = d.a.H / d.a.KV;
      int n = 0;  // K / V steps loaded
      for (int it = 0, i = item_index(0); i < n_items; i = item_index(++it)) {
        int qt, h, b;
        dq_item(i, d, qt, h, b);
        const int g = h / rep, qb = it % 2;
        const uint32_t qs = base + qb * 2 * P::QTILE;
        // buffer qb last held item it - 2, whose dQ both consumers have stored
        if (it >= 2) mbar_wait(bar + P::QE + 8 * qb, (it / 2 - 1) & 1);
        mbar_arrive_expect_tx(bar + P::QF + 8 * qb, 2 * P::QTILE);
#pragma unroll
        for (int x = 0; x < P::BOXES; ++x) {
          tma_load_4d(qs + x * P::QBOX, &tq, bar + P::QF + 8 * qb, 64 * x, h, qt * QM, b);
          tma_load_4d(qs + P::QTILE + x * P::QBOX, &tdo, bar + P::QF + 8 * qb, 64 * x, h,
                      qt * QM, b);
        }
        for (int j = 0; j < 2 * qt + 2; ++j, ++n) {
          const int ks = n % P::KS, vs = n % P::VS;
          if (n >= P::KS) mbar_wait(bar + P::KE + 8 * ks, (n / P::KS - 1) & 1);
          mbar_arrive_expect_tx(bar + P::KF + 8 * ks, P::KTILE);
#pragma unroll
          for (int x = 0; x < P::BOXES; ++x)
            tma_load_4d(base + P::K0 + ks * P::KTILE + x * P::KBOX, &tk, bar + P::KF + 8 * ks,
                        64 * x, g, j * KSTEP, b);
          if (n >= P::VS) mbar_wait(bar + P::VE + 8 * vs, (n / P::VS - 1) & 1);
          mbar_arrive_expect_tx(bar + P::VF + 8 * vs, P::KTILE);
#pragma unroll
          for (int x = 0; x < P::BOXES; ++x)
            tma_load_4d(base + P::V0 + vs * P::KTILE + x * P::KBOX, &tv, bar + P::VF + 8 * vs,
                        64 * x, g, j * KSTEP, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64c .. 64c + 63 of each query tile
  setmaxnreg_inc<CONSUMER_REGS>();
  DqConsumer<D> w(wg - 1, base, d.a.scale, d.a.scale_log2);
  if (w.c == 1) bar_arrive(1, 256);  // consumer 0 takes the first turn
  int n = 0;  // K / V steps consumed
#pragma unroll
  for (int i = 0; i < D / 2; ++i) w.acc[i] = 0.f;
  {
    int qt, h, b;
    dq_item(item_index(0), d, qt, h, b);  // every block has an item
    w.load_stats(d.a, b, h, qt);
  }
  for (int it = 0, i = item_index(0); i < n_items; i = item_index(++it)) {
    int qt, h, b;
    dq_item(i, d, qt, h, b);
    const int qb = it % 2;
    w.sq = base + qb * 2 * P::QTILE;
    w.sdo = w.sq + P::QTILE;
    mbar_wait(bar + P::QF + 8 * qb, (it / 2) & 1);
    w.load_frags();
    // steps before the consumer's diagonal step 2qt + c whole, that one
    // masked; consumer 0 skips step 2qt + 1 (keys past all of its rows).
    // One turn more than steps: the last issues the last step's dS·K only.
    const int steps = 2 * qt + 2, diag = 2 * qt + w.c;
    bool rs = false;
    for (int j = 0; j < steps; ++j) {
      const int sm = j < diag ? S_FULL : j == diag ? S_MASK : S_SKIP;
      w.step(sm, rs, n + j, true, j == 0);
      rs = sm != S_SKIP;
    }
    const int next = item_index(it + 1);
    const bool more = next < n_items;
    if (more) {
      int qt2, h2, b2;
      dq_item(next, d, qt2, h2, b2);
      w.load_stats(d.a, b2, h2, qt2);
    }
    // consumer 1's very last turn has no successor
    w.step(S_NONE, rs, n + steps, w.c == 0 || more);
    n += steps;
    w.store(&tdq, b, h, qt, d.a.S, qb);
  }
}

// ------------------------------------------------------- dK, dV, consumers

// one consumer warpgroup of the dK / dV kernel: dK, dV, Sᵀ, dPᵀ and the
// bf16 Pᵀ, dSᵀ in registers, the shared-memory tiles it reads
template <int D>
struct KvConsumer {
  using P = KvPlan<D>;
  static constexpr int BQ = P::BQ;
  static constexpr int NK = BQ / 16;  // k-steps of the register-A products
  int c, t, tig, r;              // warpgroup, thread in it, column pair, key in its 64 (and r + 8)
  uint32_t sk, sv, sq0, sst0, bar;  // this item's K and V, the ring, its stats, the mbarriers
  float scale, scale_log2;
  float dk[D / 2], dv[D / 2];
  float st[BQ / 2], dpt[BQ / 2];  // Sᵀ, dPᵀ of a step; they become pᵀ and dsᵀ in place
  uint32_t pa[NK][4], da[NK][4];  // bf16 Pᵀ and dSᵀ: the A fragments of Pᵀ·dO and dSᵀ·Q
  uint32_t kf[D / 16][4], vf[D / 16][4];  // K, V of its keys: the A fragments of Sᵀ, dPᵀ

  __device__ __forceinline__ KvConsumer(int c_, uint32_t base, float sc, float sc2)
      : c(c_), scale(sc), scale_log2(sc2) {
    t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    tig = lane % 4;
    r = 16 * warp + lane / 4;
    sk = sv = base;
    sq0 = base + P::Q0;
    sst0 = base + P::ST0;
    bar = base + P::BAR;
#pragma unroll
    for (int j = 0; j < NK; ++j)
      pa[j][0] = pa[j][1] = pa[j][2] = pa[j][3] = da[j][0] = da[j][1] = da[j][2] = da[j][3] = 0u;
  }

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  }

  __device__ __forceinline__ void fence_all() {
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(st);
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      fence_regs(pa[j]);
      fence_regs(da[j]);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      fence_regs(kf[kk]);
      if constexpr (P::V_REGS) fence_regs(vf[kk]);
    }
  }

  // this item's register A operands, once its K / V tile is in
  __device__ __forceinline__ void load_frags() {
    const int lane = t % 32, row0 = 64 * c + 16 * (t / 32);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldsm_a_sw128(kf[kk], sk, P::KBOX, row0, kk, lane);
      if constexpr (P::V_REGS) ldsm_a_sw128(vf[kk], sv, P::KBOX, row0, kk, lane);
    }
  }

  // pᵀ = 2^(sᵀ·c - L) and dsᵀ = (dpᵀ - di)·pᵀ·sm_scale in place, L and di of
  // the step's rows from its stage; in a masked step p is zero where the key
  // (kc + r, kc + r + 8) is past the row (r0 + the column): d0 = kc - r0
  template <bool MASK>
  __device__ __forceinline__ void grads(int sn, int d0) {
    const uint32_t sl = sst0 + sn * P::STATS, sd = sl + BQ * 4;
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const float2 l2 = lds_f32x2(sl + (8 * i + 2 * tig) * 4);
      const float2 d2 = lds_f32x2(sd + (8 * i + 2 * tig) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? l2.y : l2.x, di = (e & 1) ? d2.y : d2.x;
        float p = ex2(fmaf(st[4 * i + e], scale_log2, -l));
        if (MASK && d0 + r + 8 * (e >> 1) > 8 * i + 2 * tig + (e & 1)) p = 0.f;
        dpt[4 * i + e] = (dpt[4 * i + e] - di) * p * scale;
        st[4 * i + e] = p;
      }
    }
  }

  // turn n of the block's walk, for its Q / dO step n: wait for the step's
  // stage, take this warpgroup's turn on the tensor cores, issue Sᵀ_n and
  // dPᵀ_n and then step n - 1's Pᵀ·dO and dSᵀ·Q (if RS), hand the turn over
  // (unless `pass` is false), pᵀ and dsᵀ of step n while the latter run,
  // release stage n - 1 and pack bf16 Pᵀ_n, dSᵀ_n.  A skipped step only
  // releases its stage.
  template <int SM, bool RS>
  __device__ __forceinline__ void turn(int n, int d0, bool pass) {
    constexpr bool MMA = SM == S_FULL || SM == S_MASK;
    const int sn = n % P::NS, sp = (n + P::NS - 1) % P::NS;
    if constexpr (SM != S_NONE) mbar_wait(bar + P::QF + 8 * sn, (n / P::NS) & 1);
    bar_sync(1 + c, 256);
    fence_all();
    wgmma_fence();
    if constexpr (MMA) {
      const uint32_t q = sq0 + sn * P::STAGE, g = q + P::QSTEP;
      const uint32_t va = sv + c * 64 * ROW;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs_kb(st, kf[kk], sw128_desc(q + (kk / 4) * P::QBOX + (kk % 4) * 32, 16, 1024),
                    kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t oa = (kk / 4) * P::KBOX + (kk % 4) * 32, ob = (kk / 4) * P::QBOX + (kk % 4) * 32;
        const uint64_t da_ = sw128_desc(va + oa, 16, 1024), db = sw128_desc(g + ob, 16, 1024);
        if constexpr (P::V_REGS)
          wgmma_rs_kb(dpt, vf[kk], db, kk > 0);
        else if constexpr (BQ == 64)
          wgmma_ss_n64(dpt, da_, db, kk > 0);
        else
          wgmma_ss_n32(dpt, da_, db, kk > 0);
      }
    }
    wgmma_commit();
    if constexpr (RS) {
      const uint32_t q = sq0 + sp * P::STAGE, g = q + P::QSTEP;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const uint64_t dg = sw128_desc(g + j * 16 * ROW, P::QBOX, 1024);
        const uint64_t dq = sw128_desc(q + j * 16 * ROW, P::QBOX, 1024);
        if constexpr (D == 128) {
          wgmma_rs_n128(dv, pa[j], dg, 1);
          wgmma_rs_n128(dk, da[j], dq, 1);
        } else {
          wgmma_rs_n64(dv, pa[j], dg, 1);
          wgmma_rs_n64(dk, da[j], dq, 1);
        }
      }
    }
    wgmma_commit();
    fence_all();
    if (pass) bar_arrive(2 - c, 256);

    if constexpr (MMA) {
      wgmma_wait<1>();  // Sᵀ_n and dPᵀ_n are done; step n - 1's products may still run
      fence_regs(st);
      fence_regs(dpt);
      grads<SM == S_MASK>(sn, d0);
    }
    wgmma_wait<0>();
    fence_all();
    if constexpr (RS) mbar_arrive_if(bar + P::QE + 8 * sp, t == 0);  // done with stage n - 1
    if constexpr (SM == S_SKIP) mbar_arrive_if(bar + P::QE + 8 * sn, t == 0);
    if constexpr (MMA) {
      // bf16 Pᵀ and dSᵀ in the A fragment layout: chunks 2j and 2j + 1 are
      // rows 16j .. 16j + 15 of the step, keys r and r + 8
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        pa[j][0] = pack_bf16x2(st[8 * j], st[8 * j + 1]);
        pa[j][1] = pack_bf16x2(st[8 * j + 2], st[8 * j + 3]);
        pa[j][2] = pack_bf16x2(st[8 * j + 4], st[8 * j + 5]);
        pa[j][3] = pack_bf16x2(st[8 * j + 6], st[8 * j + 7]);
        da[j][0] = pack_bf16x2(dpt[8 * j], dpt[8 * j + 1]);
        da[j][1] = pack_bf16x2(dpt[8 * j + 2], dpt[8 * j + 3]);
        da[j][2] = pack_bf16x2(dpt[8 * j + 4], dpt[8 * j + 5]);
        da[j][3] = pack_bf16x2(dpt[8 * j + 6], dpt[8 * j + 7]);
      }
    }
  }

  __device__ __forceinline__ void step(int sm, bool rs, int n, int d0, bool pass) {
    if (sm == S_FULL) {
      if (rs) turn<S_FULL, true>(n, d0, pass); else turn<S_FULL, false>(n, d0, pass);
    } else if (sm == S_MASK) {
      if (rs) turn<S_MASK, true>(n, d0, pass); else turn<S_MASK, false>(n, d0, pass);
    } else if (sm == S_SKIP) {
      if (rs) turn<S_SKIP, true>(n, d0, pass); else turn<S_SKIP, false>(n, d0, pass);
    } else {
      if (rs) turn<S_NONE, true>(n, d0, pass); else turn<S_NONE, false>(n, d0, pass);
    }
  }

  // bf16 dK and dV into this warpgroup's 64 rows of the K and V buffers
  // (free after its last Sᵀ and dPᵀ), then stored by TMA, which drops keys
  // past the end; once TMA has read them, K / V buffer `kb` is released
  __device__ __forceinline__ void store(const CUtensorMap* tdk, const CUtensorMap* tdv, int b,
                                        int g, int kt, int S, int kb) {
    const uint32_t okb = sk + c * 64 * ROW, ovb = sv + c * 64 * ROW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r + 8 * half;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const uint32_t off = (i / 8) * P::KBOX + row * ROW + (((i % 8) ^ (row % 8)) * 16) + tig * 4;
        sts32(okb + off, pack_bf16x2(dk[4 * i + 2 * half], dk[4 * i + 2 * half + 1]));
        sts32(ovb + off, pack_bf16x2(dv[4 * i + 2 * half], dv[4 * i + 2 * half + 1]));
      }
    }
    fence_proxy_async();
    bar_sync(3 + c, 128);
    const int key0 = kt * KN + 64 * c;
    if (t == 0 && key0 < S) {
#pragma unroll
      for (int x = 0; x < P::BOXES; ++x) {
        tma_store_4d(tdk, okb + x * P::KBOX, 64 * x, g, key0, b);
        tma_store_4d(tdv, ovb + x * P::KBOX, 64 * x, g, key0, b);
      }
      tma_store_wait();
    }
    mbar_arrive_if(bar + P::KE + 8 * kb, t == 0);
  }
};

// item i of the dK / dV walk: key tile kt of kv head g, batch b, the longest
// walks first (key tile 0 sees every query row)
__device__ __forceinline__ void kv_item(int i, const Dims& d, int& kt, int& g, int& b) {
  const int gb = d.a.KV * d.B;
  kt = i / gb;
  g = i % gb % d.a.KV;
  b = i % gb / d.a.KV;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    attention_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdk,
                            const __grid_constant__ CUtensorMap tdv, const Dims d) {
  using P = KvPlan<D>;
  constexpr int BQ = P::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + P::BAR;
  const int n_items = d.nt * d.a.KV * d.B;
  const int rep = d.a.H / d.a.KV;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    tma_prefetch(&tq);
    tma_prefetch(&tdo);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    tma_prefetch(&tdk);
    tma_prefetch(&tdv);
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar + P::KF + 8 * i, 1);
      mbar_init(bar + P::KE + 8 * i, 2);
    }
    // a step's "full" barrier also counts the 32 producer lanes' stats copies
    for (int i = 0; i < P::NS; ++i) {
      mbar_init(bar + P::QF + 8 * i, 33);
      mbar_init(bar + P::QE + 8 * i, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Persistent, as the dQ kernel: item `it` of the walk uses K / V buffer
  // it % 2, and the ring of Q / dO steps runs on across heads and items.
  // Item (kt, g, b) takes, for each query head of the group in turn, the
  // steps of BQ rows from the tile's first key to the end.
  if (wg == 0) {  // producer: one warp keeps the ring full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int n = 0;  // steps loaded
      for (int it = 0, i = item_index(0); i < n_items; i = item_index(++it)) {
        int kt, g, b;
        kv_item(i, d, kt, g, b);
        const int kb = it % 2, key0 = kt * KN;
        const uint32_t kvs = base + kb * 2 * P::KTILE;
        if (it >= 2) mbar_wait(bar + P::KE + 8 * kb, (it / 2 - 1) & 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(bar + P::KF + 8 * kb, 2 * P::KTILE);
#pragma unroll
          for (int x = 0; x < P::BOXES; ++x) {
            tma_load_4d(kvs + x * P::KBOX, &tk, bar + P::KF + 8 * kb, 64 * x, g, key0, b);
            tma_load_4d(kvs + P::KTILE + x * P::KBOX, &tv, bar + P::KF + 8 * kb, 64 * x, g,
                        key0, b);
          }
        }
        const int steps = (d.a.S - key0 + BQ - 1) / BQ;
        for (int hh = 0; hh < rep; ++hh) {
          const int h = g * rep + hh;
          const long stat = ((long)b * d.a.H + h) * d.a.S;
          for (int j = 0; j < steps; ++j, ++n) {
            const int sn = n % P::NS, r0 = key0 + j * BQ;
            const uint32_t full = bar + P::QF + 8 * sn, qs = base + P::Q0 + sn * P::STAGE;
            if (n >= P::NS) mbar_wait(bar + P::QE + 8 * sn, (n / P::NS - 1) & 1);
            if (lane == 0) {
              mbar_arrive_expect_tx(full, 2 * P::QSTEP);
#pragma unroll
              for (int x = 0; x < P::BOXES; ++x) {
                tma_load_4d(qs + x * P::QBOX, &tq, full, 64 * x, h, r0, b);
                tma_load_4d(qs + P::QSTEP + x * P::QBOX, &tdo, full, 64 * x, h, r0, b);
              }
            }
            const uint32_t sl = base + P::ST0 + sn * P::STATS;
#pragma unroll
            for (int e = lane; e < BQ; e += 32) {
              const int row = r0 + e;
              const bool ok = row < d.a.S;
              cp_async4(sl + e * 4, d.a.lse + stat + (ok ? row : 0), ok ? 4 : 0);
              cp_async4(sl + (BQ + e) * 4, d.a.di + stat + (ok ? row : 0), ok ? 4 : 0);
            }
            cp_async_mbar_arrive(full);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns keys 64c .. 64c + 63 of each key tile
  setmaxnreg_inc<CONSUMER_REGS>();
  KvConsumer<D> w(wg - 1, base, d.a.scale, d.a.scale_log2);
  if (w.c == 1) bar_arrive(1, 256);  // consumer 0 takes the first turn
  int n = 0;  // steps consumed
  for (int it = 0, i = item_index(0); i < n_items; i = item_index(++it)) {
    int kt, g, b;
    kv_item(i, d, kt, g, b);
    const int kb = it % 2, key0 = kt * KN, kc = key0 + 64 * w.c;
    w.sk = base + kb * 2 * P::KTILE;
    w.sv = w.sk + P::KTILE;
    w.reset();
    mbar_wait(bar + P::KF + 8 * kb, (it / 2) & 1);
    w.load_frags();
    // a step whose rows all come before the consumer's first key is skipped,
    // one that overlaps its keys masked.  One turn more than steps: the last
    // issues the last step's register-A products only.
    const int steps = (d.a.S - key0 + BQ - 1) / BQ, total = rep * steps;
    const bool last = w.c == 1 && item_index(it + 1) >= n_items;  // no turn follows the item's
    bool rs = false;
    for (int j = 0, r0 = key0; j < total; ++j) {
      const int sm = r0 + BQ <= kc ? S_SKIP : r0 < kc + 64 ? S_MASK : S_FULL;
      w.step(sm, rs, n + j, kc - r0, true);
      rs = sm != S_SKIP;
      r0 += BQ;
      if (r0 >= key0 + steps * BQ) r0 = key0;  // the group's next query head
    }
    w.step(S_NONE, rs, n + total, 0, !last);
    n += total;
    w.store(&tdk, &tdv, b, g, kt, d.a.S, kb);
  }
}

template <int D>
int launch_wgmma(const Args& a, int B, int device, cudaStream_t stream) {
  using PQ = DqPlan<D>;
  using PK = KvPlan<D>;
  static bool opted_dq[64] = {}, opted_dkv[64] = {};
  static int regs_dq[64] = {}, regs_dkv[64] = {}, sms[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  auto kdq = attention_bwd_dq_wgmma<D>;
  auto kdkv = attention_bwd_dkv_wgmma<D>;
  cudaError_t e = allow_smem(kdq, PQ::SMEM, device, opted_dq);
  if (e == cudaSuccess) e = allow_smem(kdkv, PK::SMEM, device, opted_dkv);
  if (e != cudaSuccess) return (int)e;
  if (regs_dq[device] == 0) {
    cudaFuncAttributes at{}, at2{};
    e = cudaFuncGetAttributes(&at, kdq);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&at2, kdkv);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    regs_dq[device] = at.numRegs;
    regs_dkv[device] = at2.numRegs;
  }
  // setmaxnreg hands the producer's registers to the consumers: with fewer
  // than LAUNCH_REGS a thread at launch, the consumers would wait for ever
  if (regs_dq[device] != LAUNCH_REGS || regs_dkv[device] != LAUNCH_REGS)
    return (int)cudaErrorInvalidConfiguration;
  const long nq = (a.S + QM - 1) / QM, nk = (a.S + KN - 1) / KN;
  const long n_dq = nq * a.H * B, n_dkv = nk * a.KV * B;
  if (n_dq > INT_MAX || n_dkv > INT_MAX) return (int)cudaErrorInvalidValue;
  // TMA maps: -(1000·t + r) when the driver refuses tensor t's layout
  // (1 q, 2 k, 3 v, 4 dO, 5 dQ, 6 dK, 7 dV) with CUresult r
  CUtensorMap mq, mdo, mk, mv, mdq, nq_, ndo, nk_, nv, mdk, mdv;
  int r = encode_bshd(&mq, a.q, B, a.S, a.H, D, a.sqb, a.sqs, a.sqh, QM);
  if (r == 0) r = encode_bshd(&nq_, a.q, B, a.S, a.H, D, a.sqb, a.sqs, a.sqh, PK::BQ);
  if (r != 0) return -(1000 + r);
  r = encode_bshd(&mk, a.k, B, a.S, a.KV, D, a.skb, a.sks, a.skh, KSTEP);
  if (r == 0) r = encode_bshd(&nk_, a.k, B, a.S, a.KV, D, a.skb, a.sks, a.skh, KN);
  if (r != 0) return -(2000 + r);
  r = encode_bshd(&mv, a.v, B, a.S, a.KV, D, a.svb, a.svs, a.svh, KSTEP);
  if (r == 0) r = encode_bshd(&nv, a.v, B, a.S, a.KV, D, a.svb, a.svs, a.svh, KN);
  if (r != 0) return -(3000 + r);
  r = encode_bshd(&mdo, a.dout, B, a.S, a.H, D, a.sdb, a.sds, a.sdh, QM);
  if (r == 0) r = encode_bshd(&ndo, a.dout, B, a.S, a.H, D, a.sdb, a.sds, a.sdh, PK::BQ);
  if (r != 0) return -(4000 + r);
  r = encode_bshd(&mdq, a.dq, B, a.S, a.H, D, (long)a.S * a.H * D, (long)a.H * D, D, 64);
  if (r != 0) return -(5000 + r);
  r = encode_bshd(&mdk, a.dk, B, a.S, a.KV, D, (long)a.S * a.KV * D, (long)a.KV * D, D, 64);
  if (r != 0) return -(6000 + r);
  r = encode_bshd(&mdv, a.dv, B, a.S, a.KV, D, (long)a.S * a.KV * D, (long)a.KV * D, D, 64);
  if (r != 0) return -(7000 + r);
  // one block an SM (its shared memory and registers), each walking items
  const int gq = (int)(n_dq < sms[device] ? n_dq : sms[device]);
  const int gk = (int)(n_dkv < sms[device] ? n_dkv : sms[device]);
  kdq<<<gq, THREADS, PQ::SMEM, stream>>>(mq, mdo, mk, mv, mdq, Dims{a, B, (int)nq});
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdkv<<<gk, THREADS, PK::SMEM, stream>>>(nq_, ndo, nk_, nv, mdk, mdv, Dims{a, B, (int)nk});
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
// `stream`; returns the CUDA error code (0 = launched), or -(1000·t + r)
// when TMA refuses the layout of tensor t (1 q, 2 k, 3 v, 4 dout, 5 dq,
// 6 dk, 7 dv) with the driver's CUresult r.
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
    case 16: return launch_mma<16>(a, B, device, s);
    case 64: return launch_wgmma<64>(a, B, device, s);
    case 128: return launch_wgmma<128>(a, B, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
