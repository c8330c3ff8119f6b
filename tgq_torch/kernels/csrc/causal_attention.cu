// Causal flash attention for Hopper (sm_90a): softmax attention of whole
// sequences, as in the calibration forwards, strided perplexity, KV
// equalizer calibration and prefill.
//
// Replaces the TPU kernel behind tgq/models/causal_lm.py::
// _flash_causal_attention: the upstream Pallas op
// jax/experimental/pallas/ops/tpu/flash_attention.py, whose forward body is
// _flash_attention_kernel_single_batch.  Same contract, in the port's
// (b, s, h, d) layout: for each batch b, query head h and row i,
//   o[b, i, h] = Σ_{j <= i} softmax_j(sm_scale · q[b, i, h] · k[b, j, g]) · v[b, j, g]
// with g = h / (H / KV) (GQA by a kv head index; the TPU path's repeat of
// the K/V heads is not materialised).  Scores are f32 products of bf16
// operands, the row max and sum are f32, the probabilities are rounded to
// bf16 before the P·V product (the TPU body's p.astype(v.dtype)), the
// accumulator is f32 and the output bf16.  q, k and v are read with their
// strides (the feature axis contiguous, rows 16-byte aligned); o is a
// contiguous (b, s, h, d) tensor.
//
// What bounds it on this card: bf16 tensor-core operations.  A sequence of
// s tokens and H heads does 4·d·H·s(s+1)/2 operations on 2·(2H + 2KV)·s·d
// bytes; at the calibration batch (8, 2048, 32 / 8 heads, 128) that is
// 2.75e11 operations (0.278 ms at 989 TFLOP/s) against 0.34 GB (0.10 ms at
// 3.35 TB/s).
//
// Design: one block of 4 warps per (64-row query tile, head, batch); a warp
// owns 16 query rows.  Q's fragments stay in registers for the whole
// block; 64-key K and V tiles are copied into shared memory by 16-byte
// cp.async, double-buffered, and only the tiles up to the diagonal are
// visited (the causal mask is applied in the diagonal tile, which also
// covers a ragged last tile: a key past the end is past every valid row).
// S = Q·Kᵀ and O += P·V run on mma.sync.m16n8k16 (bf16 in, f32 out); the
// S accumulator's fragment is the A fragment of P·V, so P never leaves
// registers.  Online softmax in the log2 domain (scores times
// sm_scale·log2 e, exp2), the accumulator rescaled when the row max moves,
// one division by the row sum at the end.  No split over keys, so a row's
// result depends on its own q, k and v alone: not on the batch size, the
// head count or the grid (two launches, a batch and its sequences alone, a
// head slice and the full launch give the same bits).  Blocks are issued
// longest-first (the last query tiles visit the most key tiles).
// wgmma, TMA and warp specialisation are not used.

#include <float.h>
#include <math.h>

#include "common.cuh"

namespace {

using namespace tgq;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;   // query rows a block, 16 a warp
constexpr int BN = 64;   // keys a tile
constexpr int NT = 128;  // threads a block
constexpr float LOG2E = 1.4426950408889634f;

// one 64-row tile in shared memory: rows of D bf16 padded by 16 bytes, so
// the 8 rows an ldmatrix reads at once fall on distinct banks
template <int D>
struct Tile {
  static constexpr int STRIDE = D + 8;          // elements a row
  static constexpr int ELEMS = BM * STRIDE;     // elements a tile
  static constexpr int SMEM = 5 * ELEMS * 2;    // Q, K[2], V[2] in bytes
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;  // element strides
  int S, H, KV;
  float scale_log2;  // sm_scale · log2(e)
};

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

// rows row0 .. row0 + 63 of one (batch, head) into a shared tile; rows at
// or past S are zero-filled (no bytes read)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long row_stride, int row0,
                                          int S, int tid) {
  constexpr int CPR = D / 8;  // 16-byte pieces a row
#pragma unroll
  for (int i = tid; i < BM * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < S;
    const bf16* p = ok ? src + (long)(row0 + r) * row_stride + c * 8 : src;
    cp_async16(dst + r * Tile<D>::STRIDE + c * 8, p, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(NT) causal_attention_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + Tile<D>::ELEMS;      // two K tiles
  bf16* sv = sk + 2 * Tile<D>::ELEMS;  // two V tiles
  constexpr int STR = Tile<D>::STRIDE;
  constexpr int KS = D / 16;  // k-steps over the features
  constexpr int NF = D / 8;   // 8-feature tiles of the output

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.KV);
  const bf16* qb = a.q + b * a.sqb + h * a.sqh;
  const bf16* kb = a.k + b * a.skb + g * a.skh;
  const bf16* vb = a.v + b * a.svb + g * a.svh;
  const int row0 = qt * BM;

  load_tile<D>(sq, qb, a.sqs, row0, a.S, tid);
  load_tile<D>(sk, kb, a.sks, 0, a.S, tid);
  load_tile<D>(sv, vb, a.svs, 0, a.S, tid);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[NF][4];
#pragma unroll
  for (int n = 0; n < NF; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows gid, gid + 8
  const int r0 = row0 + warp * 16 + gid;                     // this thread's first row

  for (int kt = 0; kt <= qt; ++kt) {
    const int buf = kt & 1;
    if (kt < qt) {
      load_tile<D>(sk + (buf ^ 1) * Tile<D>::ELEMS, kb, a.sks, (kt + 1) * BN, a.S, tid);
      load_tile<D>(sv + (buf ^ 1) * Tile<D>::ELEMS, vb, a.svs, (kt + 1) * BN, a.S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], reinterpret_cast<const uint8_t*>(
                            sq + (warp * 16 + (lane & 15)) * STR + kk * 16 + (lane >> 4) * 8));
    }
    const bf16* kt_s = sk + buf * Tile<D>::ELEMS;
    const bf16* vt_s = sv + buf * Tile<D>::ELEMS;

    // S = Q·Kᵀ: 8 tiles of 8 keys; s[n] holds (row gid, keys 8n + 2tig, +1)
    // and (row gid + 8, the same keys)
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, reinterpret_cast<const uint8_t*>(
                        kt_s + (np * 16 + (lane & 7) + (lane >> 4) * 8) * STR + kk * 16 +
                        ((lane >> 3) & 1) * 8));
        mma16816(s[2 * np], qf[kk], bk[0], bk[1]);
        mma16816(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale into the log2 domain, mask the diagonal tile, row max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = s[n][e] * a.scale_log2;
        if (kt == qt) {
          const int key = kt * BN + n * 8 + 2 * tig + (e & 1);
          const int row = r0 + (e >> 1) * 8;
          if (key > row) t = -INFINITY;
        }
        s[n][e] = t;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every row sees key 0 in the first tile, so the max is finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp2(t - max): f32 row sums, bf16 A fragments for P·V
    uint32_t pa[BN / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float p0 = exp2f(s[n][0] - mn0), p1 = exp2f(s[n][1] - mn0);
      const float p2 = exp2f(s[n][2] - mn1), p3 = exp2f(s[n][3] - mn1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[n / 2][(n & 1) * 2] = pack_bf16x2(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P·V: V's B fragments by a transposed ldmatrix of the key-major tile
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vt_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + dp * 16 +
                          (lane >> 4) * 8);
        mma16816(acc[2 * dp], pa[kk], bv[0], bv[1]);
        mma16816(acc[2 * dp + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // the next iteration refills the other buffer
  }

  // the quad's partial row sums, one division, bf16 out
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const long orow = (long)a.H * D;  // o's row stride
  bf16* ob = a.o + ((long)b * a.S * a.H + h) * D + 2 * tig;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + half * 8;
    if (row >= a.S) continue;
    const float l = half ? l1 : l0;
    uint32_t* dst = reinterpret_cast<uint32_t*>(ob + row * orow);
#pragma unroll
    for (int n = 0; n < NF; ++n)
      dst[n * 4] = pack_bf16x2(__fdiv_rn(acc[n][2 * half], l), __fdiv_rn(acc[n][2 * half + 1], l));
  }
}

template <int D>
int launch(const Args& a, int B, int device, cudaStream_t stream) {
  static bool opted_in[64] = {};
  auto kern = causal_attention_kernel<D>;
  const cudaError_t e = allow_smem(kern, Tile<D>::SMEM, device, opted_in);
  if (e != cudaSuccess) return (int)e;
  const int nq = (a.S + BM - 1) / BM;
  kern<<<dim3(nq, a.H, B), NT, Tile<D>::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K6.  q (B, S, H, D), k and v (B, S, KV, D) bf16 with element strides
// (batch, position, head) and a contiguous feature axis, every row 16-byte
// aligned; o (B, S, H, D) bf16 contiguous.  D is 16, 64 or 128; H a
// multiple of KV.  Launches on `stream`; returns the CUDA error code
// (0 = launched).
int tgq_causal_attention(const void* q, const void* k, const void* v, void* o, long sqb,
                         long sqs, long sqh, long skb, long sks, long skh, long svb, long svs,
                         long svh, int B, int S, int H, int KV, int D, float sm_scale,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || S < 0 || H <= 0 || KV <= 0 || H % KV != 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(o), sqb, sqs, sqh, skb, sks,
               skh, svb, svs, svh, S, H, KV, sm_scale * LOG2E};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(a, B, device, s);
    case 64: return launch<64>(a, B, device, s);
    case 128: return launch<128>(a, B, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
