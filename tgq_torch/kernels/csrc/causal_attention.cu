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
// Design at head_dim 64 and 128, each part against that bound:
// - wgmma, the only route to the full tensor-core rate: S = Q·Kᵀ is
//   m64n128k16 with Q and K from shared memory (both K-major), O += P·V is
//   m64n{d}k16 with P from registers (the S accumulator's fragment, rounded
//   to bf16 and repacked in place: P never leaves registers) and V from
//   shared memory (MN-major, the transpose bit).
// - Blocks of 384 threads: a producer warpgroup whose one thread issues TMA
//   loads, and two consumer warpgroups of 64 query rows each.  One block an
//   SM (shared memory and registers allow no more), persistent: block k
//   takes tiles k, k + grid, ... of the (128-row query tile, head, batch)
//   list ordered longest first, and its rings and barriers run on from
//   one tile to the next, so the next tile's loads overlap this one's end.
//   setmaxnreg moves registers from the producer (24) to the consumers
//   (240), which hold S (64 f32), O (d / 2 f32) and P (32 bf16 pairs) a
//   thread without spilling.
// - TMA: Q into one of two buffers a tile (the next tile's Q loads while
//   this one runs), 128-key K and V tiles through rings of 3 and 2 stages
//   at d = 128 (224 KB in all), 4 and 4 at d = 64, each stage with a "full"
//   and an "empty" mbarrier: K is released once S is done, V once P·V is.
//   O goes out through its tile's Q buffer by a TMA store.  Each of q, k, v
//   and o has a 4-D tensor map (d, heads, s, b), boxes of 64 features x
//   128 rows (64 for o) in the 128-byte swizzle that the wgmma descriptors
//   read; the maps take the callers' strides (GPT-2's fused q/k/v chunks,
//   TP head slices), zero-fill rows past the end on loads and drop them on
//   stores, so a ragged last tile and s < 128 need no special case.
// - Overlap: the two consumers take turns to issue their products (named
//   barriers), so one warpgroup's softmax runs under the other's wgmmas; and
//   inside a warpgroup, turn j issues S_j and then P_{j-1}·V_{j-1}, waits
//   for S_j alone and computes softmax_j while P·V runs on the tensor cores.
// - The causal walk: query tile qt visits key tiles 0 .. qt and only the
//   diagonal tile is masked.  There the first consumer (the tile's first 64
//   rows) issues S over the first 64 keys only (m64n64) and P·V over their
//   4 k-steps: the quarter of the tile whose every score is masked is not
//   computed.
// - Online softmax in the log2 domain: the running max of the raw scores,
//   probabilities 2^(s·c - m·c) with c = sm_scale·log2 e (one FMA and one
//   SFU exp2 a score), the accumulator rescaled when the row max moves, one
//   division by the row sum at the end.  No split over keys, so a row's
//   bits depend on its own q, k, v and s alone: not on the batch, the head
//   count, the grid or the schedule (two launches, a batch and its
//   sequences alone, a head slice and the full launch give the same bits).
//
// head_dim 16 (tiny test models only) keeps the first design: one block of
// 4 mma.sync warps per 64-row query tile, K and V by cp.async, no wgmma.

#include <float.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace tgq;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // (B, H, S) stats output or null: each row's m·c + log2 l
  long sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;  // element strides
  int S, H, KV;
  float scale_log2;  // sm_scale · log2(e)
};

// ------------------------------------------------ head_dim 64 and 128: wgmma

constexpr int QM = 128;                // query rows a block, 64 a consumer warpgroup
constexpr int KN = 128;                // keys a K / V tile
constexpr int THREADS = 384;           // producer warpgroup + two consumers
constexpr int BOX = 128 * 128;         // bytes of one TMA box: 128 rows x 64 features
constexpr int PRODUCER_REGS = 24;      // setmaxnreg: 128 x 24 + 256 x 240 = 384 x 168
constexpr int CONSUMER_REGS = 240;
constexpr int LAUNCH_REGS = 168;       // what __launch_bounds__(384, 1) allows

template <int D>
struct Plan {
  static constexpr int BOXES = D / 64;      // boxes a 128-row tile
  static constexpr int TILE = BOXES * BOX;  // bytes of a tile
  static constexpr int KS = D == 64 ? 4 : 3;  // K ring stages
  static constexpr int VS = D == 64 ? 4 : 2;  // V ring stages
  // offsets from the 1024-aligned base: two Q tiles, the K ring, the V ring
  static constexpr int K0 = 2 * TILE, V0 = K0 + KS * TILE, BAR = V0 + VS * TILE;
  // mbarriers from BAR, 8 bytes each: q_full[2], q_empty[2], then a full
  // and an empty one a stage of each ring
  static constexpr int QF = 0, QE = 16, KF = 32, KE = KF + 8 * KS, VF = KE + 8 * KS,
                       VE = VF + 8 * VS;
  static constexpr int SMEM = BAR + VE + 8 * VS + 1024;  // + alignment slack
};

// the launch's sizes, as the wgmma kernel reads them
struct Dims {
  int S, H, KV, B;
  int nq;  // 128-row query tiles a sequence
  float scale_log2;
  float* lse;  // the stats output or null
};

// tile i of the block's walk: query tile qt of head h, batch b, the longest
// rows first (every head and batch of the last query tile, then the one
// before, ...)
__device__ __forceinline__ void tile_of(int i, const Dims& a, int& qt, int& h, int& b) {
  const int hb = a.H * a.B;
  qt = a.nq - 1 - i / hb;
  h = i % hb % a.H;
  b = i % hb / a.H;
}

// 2^x by the SFU (ex2.approx.ftz: results below 2^-126 flush to zero,
// far below the bf16 probabilities' rounding)
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

// softmax of one S tile of N / 4 8-key chunks (the first 2N keys) in place:
// the diagonal tile masked, the running max m (of raw scores) and sum l of
// rows r and r + 8 updated (l a thread's partial sum over its columns);
// the probabilities are 2^(s·c - m·c), c = sm_scale·log2 e > 0, one FMA a
// score; s ends as them in f32, al as the factor that rescales the
// accumulator
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], bool diag, int r, int tig,
                                             float scale_log2, float (&m)[2], float (&l)[2],
                                             float (&al)[2]) {
  constexpr int NC = N / 4;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (diag && 8 * i + 2 * tig + (e & 1) > r + (e >> 1) * 8) s[4 * i + e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * i + e]);
    }
  }
  float ms[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
    mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
    // every row sees key 0 in the first tile, so the max is finite
    const float mn = fmaxf(m[x], mx[x]);
    al[x] = ex2((m[x] - mn) * scale_log2);
    m[x] = mn;
    ms[x] = mn * scale_log2;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * i + e], scale_log2, -ms[e >> 1]));
      ps[e >> 1] += p;
      s[4 * i + e] = p;
    }
  }
  l[0] = l[0] * al[0] + ps[0];
  l[1] = l[1] * al[1] + ps[1];
}

// what a turn's first product computes: nothing, S over the whole key
// tile, the diagonal tile masked, or its first 64 keys masked (the first
// consumer's diagonal tile: the other 64 keys are past all of its rows)
enum { S_NONE, S_FULL, S_DIAG, S_HALF };
// and its second: nothing, P·V over 128 keys, or over the first 64
enum { PV_NONE, PV_FULL, PV_HALF };

// one consumer warpgroup's state: S, O and P in registers, the running max
// and sum of its two rows a thread, and the shared-memory tiles it reads
template <int D>
struct Consumer {
  using P = Plan<D>;
  int c, t, tig, r;  // warpgroup, thread in it, column pair, first row in the tile (and r + 8)
  uint32_t sq, sk, sv, bar;  // this query tile's Q buffer, the rings, the mbarriers
  float scale_log2;
  float acc[D / 2];
  float s[64];
  uint32_t pa[8][4];  // P: the A fragments of the 8 k-steps of P·V
  float m[2], l[2], al[2];

  __device__ __forceinline__ Consumer(int c_, uint32_t sk_, uint32_t sv_, uint32_t bar_,
                                      float scale)
      : c(c_), sq(0), sk(sk_), sv(sv_), bar(bar_), scale_log2(scale) {
    t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    tig = lane % 4;
    r = 64 * c + 16 * warp + lane / 4;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) pa[ks][0] = pa[ks][1] = pa[ks][2] = pa[ks][3] = 0u;
    reset();
  }

  // a new query tile: O, the running max and the sum start afresh
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  template <int N>
  __device__ __forceinline__ void fence_all(float (&sc)[N]) {
    fence_regs(acc);
    fence_regs(sc);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) fence_regs(pa[ks]);
  }

  // turn j of a query tile, the block's K / V tile n = n0 + j: wait for its
  // tiles (S_j reads K_n, P·V reads V_{n-1}), take this warpgroup's turn on
  // the tensor cores (named barriers 1 and 2, one a consumer), issue S_j
  // and then P_{j-1}·V_{j-1}, hand the turn over (unless `pass` is false),
  // release K_n once S_j is done, the softmax of S_j while P·V runs, then
  // release V_{n-1}, the rescale and bf16 P.  The first 64 keys' S has an
  // accumulator of its own: sharing half of the 128-key one leaves ptxas
  // short of registers for the wgmma pipeline.
  template <int SM, int PM>
  __device__ __forceinline__ void turn(int n, bool pass) {
    if constexpr (SM == S_HALF) {
      float sh[32];
      turn_into<SM, PM>(sh, n, pass);
    } else {
      turn_into<SM, PM>(s, n, pass);
    }
  }

  // the turns of query tile qt, whose K / V tiles are the block's n0 .. n0 + qt;
  // `pass_last`: whether the last turn hands the tensor cores on
  __device__ __forceinline__ void tile(int qt, int n0, bool pass_last) {
    if (qt == 0) {
      if (c == 0)
        turn<S_HALF, PV_NONE>(n0, true);
      else
        turn<S_DIAG, PV_NONE>(n0, true);
    } else {
      turn<S_FULL, PV_NONE>(n0, true);
      for (int j = 1; j < qt; ++j) turn<S_FULL, PV_FULL>(n0 + j, true);
      if (c == 0)
        turn<S_HALF, PV_FULL>(n0 + qt, true);
      else
        turn<S_DIAG, PV_FULL>(n0 + qt, true);
    }
    if (c == 0)
      turn<S_NONE, PV_HALF>(n0 + qt + 1, true);
    else
      turn<S_NONE, PV_FULL>(n0 + qt + 1, pass_last);
  }

  template <int SM, int PM, int N>
  __device__ __forceinline__ void turn_into(float (&sc)[N], int n, bool pass) {
    const int ks = n % P::KS, vs = (n + P::VS - 1) % P::VS;  // K_n's and V_{n-1}'s stages
    if constexpr (SM != S_NONE) mbar_wait(bar + P::KF + 8 * ks, (n / P::KS) & 1);
    if constexpr (PM != PV_NONE) mbar_wait(bar + P::VF + 8 * vs, ((n - 1) / P::VS) & 1);
    bar_sync(1 + c, 256);
    fence_all(sc);
    wgmma_fence();
    if constexpr (SM != S_NONE) {
      const uint32_t qa = sq + c * 64 * 128, ka = sk + ks * P::TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        const uint64_t da = sw128_desc(qa + off, 16, 1024), db = sw128_desc(ka + off, 16, 1024);
        if constexpr (N == 32)
          wgmma_ss_n64(sc, da, db, kk > 0);
        else
          wgmma_ss_n128(sc, da, db, kk > 0);
      }
    }
    wgmma_commit();
    if constexpr (PM != PV_NONE) {
      const uint32_t va = sv + vs * P::TILE;
#pragma unroll
      for (int ks = 0; ks < (PM == PV_HALF ? 4 : 8); ++ks) {
        const uint64_t dv = sw128_desc(va + ks * 16 * 128, BOX, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128(acc, pa[ks], dv, 1);
        else
          wgmma_rs_n64(acc, pa[ks], dv, 1);
      }
    }
    wgmma_commit();
    fence_all(sc);
    if (pass) bar_arrive(2 - c, 256);

    if constexpr (SM != S_NONE) {
      wgmma_wait<1>();  // S_j is done; P_{j-1}·V_{j-1} may still run
      fence_regs(sc);
      mbar_arrive_if(bar + P::KE + 8 * ks, t == 0);  // this warpgroup is done with K_n
      softmax_tile(sc, SM != S_FULL, r, tig, scale_log2, m, l, al);
    }
    wgmma_wait<0>();
    fence_all(sc);
    if constexpr (PM != PV_NONE)
      mbar_arrive_if(bar + P::VE + 8 * vs, t == 0);  // and with V_{n-1}
    if constexpr (SM != S_NONE) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= al[0];
        acc[4 * i + 1] *= al[0];
        acc[4 * i + 2] *= al[1];
        acc[4 * i + 3] *= al[1];
      }
      // bf16 P in the A fragment layout: chunks 2ks and 2ks + 1 of S are
      // columns 16ks .. 16ks + 15, rows r and r + 8
#pragma unroll
      for (int ks = 0; ks < N / 8; ++ks) {
        pa[ks][0] = pack_bf16x2(sc[8 * ks], sc[8 * ks + 1]);
        pa[ks][1] = pack_bf16x2(sc[8 * ks + 2], sc[8 * ks + 3]);
        pa[ks][2] = pack_bf16x2(sc[8 * ks + 4], sc[8 * ks + 5]);
        pa[ks][3] = pack_bf16x2(sc[8 * ks + 6], sc[8 * ks + 7]);
      }
    }
  }

  // the quad's partial row sums, one division, bf16 out: written into this
  // warpgroup's 64 rows of the Q tile (free after its last S) in the
  // 128-byte swizzle, then stored by TMA, which drops rows past the end;
  // once TMA has read them, the Q buffer `qb` is released to the producer
  __device__ __forceinline__ void store(const CUtensorMap* to, int b, int h, int qt, int S,
                                        int qb) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
      l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    }
    const uint32_t ob = sq + c * 64 * 128;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r - 64 * c + 8 * half;  // in this warpgroup's 64
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        sts32(ob + (i / 8) * BOX + row * 128 + (((i % 8) ^ (row % 8)) * 16) + tig * 4,
              pack_bf16x2(__fdiv_rn(acc[4 * i + 2 * half], l[half]),
                          __fdiv_rn(acc[4 * i + 2 * half + 1], l[half])));
    }
    fence_proxy_async();
    bar_sync(3 + c, 128);
    const int row0 = qt * QM + 64 * c;
    if (t == 0 && row0 < S) {
#pragma unroll
      for (int x = 0; x < P::BOXES; ++x) tma_store_4d(to, ob + x * BOX, 64 * x, h, row0, b);
      tma_store_wait();
    }
    mbar_arrive_if(bar + P::QE + 8 * qb, t == 0);
  }

  // the stats output (K6-bwd recomputes the probabilities from it): each
  // row's log2-sum-exp in the exponent's own domain, m·c + log2 l, after
  // store's shuffles, from the first lane of each quad by a predicated
  // store (no branch between the wgmmas of one tile and the next's)
  __device__ __forceinline__ void stats(const Dims& a, int b, int h, int qt) {
    if (a.lse == nullptr) return;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int row = qt * QM + r + 8 * x;
      st_global_if(a.lse + ((long)b * a.H + h) * a.S + row, m[x] * scale_log2 + log2f(l[x]),
                   tig == 0 && row < a.S);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    causal_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, const Dims a) {
  using P = Plan<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's atom alignment
  const uint32_t sq = base, sk = base + P::K0, sv = base + P::V0, bar = base + P::BAR;

  const int n_tiles = a.nq * a.H * a.B;
  // the warpgroup index through a shuffle: provably uniform to the compiler,
  // which otherwise treats branches on it as divergent and serialises the wgmmas
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    tma_prefetch(&tq);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    tma_prefetch(&to);
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

  // Persistent: the block walks tiles blockIdx.x, + gridDim.x, ...; query
  // tile `it` of the walk uses Q buffer it % 2, so the next tile's Q loads
  // while this one runs, and the rings and the barriers' phases run on
  // across tiles
  if (wg == 0) {  // producer: one thread keeps the rings full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int n = 0;  // K / V tiles loaded
      for (int i = blockIdx.x, it = 0; i < n_tiles; i += gridDim.x, ++it) {
        int qt, h, b;
        tile_of(i, a, qt, h, b);
        const int g = h / (a.H / a.KV), qb = it % 2;
        // buffer qb last held tile it - 2, whose O both consumers have stored
        if (it >= 2) mbar_wait(bar + P::QE + 8 * qb, (it / 2 - 1) & 1);
        mbar_arrive_expect_tx(bar + P::QF + 8 * qb, P::TILE);
#pragma unroll
        for (int x = 0; x < P::BOXES; ++x)
          tma_load_4d(sq + qb * P::TILE + x * BOX, &tq, bar + P::QF + 8 * qb, 64 * x, h,
                      qt * QM, b);
        for (int j = 0; j <= qt; ++j, ++n) {
          const int ks = n % P::KS, vs = n % P::VS;
          if (n >= P::KS) mbar_wait(bar + P::KE + 8 * ks, (n / P::KS - 1) & 1);
          mbar_arrive_expect_tx(bar + P::KF + 8 * ks, P::TILE);
#pragma unroll
          for (int x = 0; x < P::BOXES; ++x)
            tma_load_4d(sk + ks * P::TILE + x * BOX, &tk, bar + P::KF + 8 * ks, 64 * x, g,
                        j * KN, b);
          if (n >= P::VS) mbar_wait(bar + P::VE + 8 * vs, (n / P::VS - 1) & 1);
          mbar_arrive_expect_tx(bar + P::VF + 8 * vs, P::TILE);
#pragma unroll
          for (int x = 0; x < P::BOXES; ++x)
            tma_load_4d(sv + vs * P::TILE + x * BOX, &tv, bar + P::VF + 8 * vs, 64 * x, g,
                        j * KN, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows 64c .. 64c + 63 of each query tile
  setmaxnreg_inc<CONSUMER_REGS>();
  Consumer<D> w(wg - 1, sk, sv, bar, a.scale_log2);
  if (w.c == 1) bar_arrive(1, 256);  // consumer 0 takes the first turn
  int n = 0;  // K / V tiles consumed
  for (int i = blockIdx.x, it = 0; i < n_tiles; i += gridDim.x, ++it) {
    int qt, h, b;
    tile_of(i, a, qt, h, b);
    const int qb = it % 2;
    w.sq = sq + qb * P::TILE;
    mbar_wait(bar + P::QF + 8 * qb, (it / 2) & 1);
    // turn j issues S_j = Q·K_jᵀ (j <= qt) and P_{j-1}·V_{j-1} (j >= 1); the
    // diagonal tile qt is masked, and its first 64 rows see only its first
    // 64 keys.  Consumer 1's very last turn has no successor.
    w.tile(qt, n, i + (int)gridDim.x < n_tiles);
    n += qt + 1;
    w.store(&to, b, h, qt, a.S, qb);
    w.stats(a, b, h, qt);
    w.reset();
  }
}

template <int D>
int launch_wgmma(const Args& a, int B, int device, cudaStream_t stream) {
  using P = Plan<D>;
  static bool opted_in[64] = {};
  static int regs[64] = {}, sms[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  auto kern = causal_attention_wgmma<D>;
  cudaError_t e = allow_smem(kern, P::SMEM, device, opted_in);
  if (e != cudaSuccess) return (int)e;
  if (regs[device] == 0) {
    cudaFuncAttributes at{};
    e = cudaFuncGetAttributes(&at, kern);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    regs[device] = at.numRegs;
  }
  // setmaxnreg hands the producer's registers to the consumers: with fewer
  // than LAUNCH_REGS a thread at launch, the consumers would wait for ever
  if (regs[device] != LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  const long nq = (a.S + QM - 1) / QM, n_tiles = nq * a.H * B;
  if (n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  // one block an SM (its shared memory and registers), each walking tiles
  const int grid = (int)(n_tiles < sms[device] ? n_tiles : sms[device]);
  CUtensorMap tq, tk, tv, to;
  int r = encode_bshd(&tq, a.q, B, a.S, a.H, D, a.sqb, a.sqs, a.sqh, QM);
  if (r != 0) return -(1000 + r);
  r = encode_bshd(&tk, a.k, B, a.S, a.KV, D, a.skb, a.sks, a.skh, KN);
  if (r != 0) return -(2000 + r);
  r = encode_bshd(&tv, a.v, B, a.S, a.KV, D, a.svb, a.svs, a.svh, KN);
  if (r != 0) return -(3000 + r);
  r = encode_bshd(&to, a.o, B, a.S, a.H, D, (long)a.S * a.H * D, (long)a.H * D, D, QM / 2);
  if (r != 0) return -(4000 + r);
  const Dims dims{a.S, a.H, a.KV, B, (int)nq, a.scale_log2, a.lse};
  kern<<<grid, THREADS, P::SMEM, stream>>>(tq, tk, tv, to, dims);
  return (int)cudaGetLastError();
}

// ------------------------------------ head_dim 16: mma.sync, the first design

constexpr int BM = 64;   // query rows a block, 16 a warp
constexpr int BN = 64;   // keys a tile
constexpr int NT = 128;  // threads a block

// one 64-row tile in shared memory: rows of D bf16 padded by 16 bytes, so
// the 8 rows an ldmatrix reads at once fall on distinct banks
template <int D>
struct Tile {
  static constexpr int STRIDE = D + 8;          // elements a row
  static constexpr int ELEMS = BM * STRIDE;     // elements a tile
  static constexpr int SMEM = 5 * ELEMS * 2;    // Q, K[2], V[2] in bytes
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
    if (a.lse != nullptr && tig == 0)  // stats: the scores were scaled, so m is m·c here
      a.lse[((long)b * a.H + h) * a.S + row] = (half ? m1 : m0) + log2f(l);
    uint32_t* dst = reinterpret_cast<uint32_t*>(ob + row * orow);
#pragma unroll
    for (int n = 0; n < NF; ++n)
      dst[n * 4] = pack_bf16x2(__fdiv_rn(acc[n][2 * half], l), __fdiv_rn(acc[n][2 * half + 1], l));
  }
}

template <int D>
int launch_mma(const Args& a, int B, int device, cudaStream_t stream) {
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
// aligned; o (B, S, H, D) bf16 contiguous; lse null, or (B, H, S) f32
// contiguous for the stats output (each row's log2-sum-exp of the scaled
// scores, m·c + log2 l, c = sm_scale·log2 e: K6-bwd's input; o's bits are
// the same either way).  D is 16, 64 or 128; H a multiple of KV; sm_scale > 0.
// Launches on `stream`; returns the CUDA error code
// (0 = launched), or -(1000·t + r) when TMA refuses the layout of tensor t
// (1 q, 2 k, 3 v, 4 o) with the driver's CUresult r.
int tgq_causal_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                         long sqb, long sqs, long sqh, long skb, long sks, long skh, long svb,
                         long svs, long svh, int B, int S, int H, int KV, int D, float sm_scale,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || S < 0 || H <= 0 || KV <= 0 || H % KV != 0 || H > 65535 || B > 65535 ||
      !(sm_scale > 0.f))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
               sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, S, H, KV, sm_scale * LOG2E};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_mma<16>(a, B, device, s);
    case 64: return launch_wgmma<64>(a, B, device, s);
    case 128: return launch_wgmma<128>(a, B, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
