// Paged decode attention for Hopper (sm_90a): one query token per slot over
// one layer's paged KV pools, with GQA, a softmax in f32, and the current
// token folded in last.
//
// Replaces the TPU kernel `_kernel` of tgq/kernels/paged_attention.py
// (`paged_decode_attention`, with its `_BlockCopy` DMA helper).  Same
// contract, on one layer's views of the pools:
//   q (slots, H, d) f32, pre-scaled by 1/sqrt(d) (and by k_eq, outside);
//   pools (P, page, F) bf16 | (P, page, F) int8 | (P, page, F/2) uint8 int4
//   (F = kvh·d; int4 rows split-half over the whole fused row: byte j holds
//   features j and j + F/2, codes biased by 8); scales (P, kvh, spad) f32,
//   only the first `page` entries read, applied to logits and probabilities;
//   lengths (slots,) including the current token; page_indices (slots, mpps).
// With k_cur/v_cur the pools cover [0, len-1) and the current row is folded
// in last, unquantized; len == 0 gives zeros.  An optional soft cap
// tanh(x/c)·c applies to pool and current logits alike.
//
// Chunk-window mode (tensor-parallel decode): w_live > 0 shrinks the pools'
// coverage to [0, len - 1 - w_live) (the chunk's last w_live rows live in a
// raw window the caller attends), and with m_out/l_out the kernel returns
// the flash partials instead of the normalised output: out gets the
// un-normalised accumulator, m_out/l_out (slots, H) the running max and sum
// after the current row.  An idle slot gives out = 0, m = -0.7·FLT_MAX (finite,
// so a merge never forms -inf - -inf) and l = 0.  Only the last block of the
// in-launch merge writes differently; nothing else changes.
//
// write_current: split 0 of a (slot, kv head) also stores the current row at
// position len-1 of the slot's pages, quantized exactly as
// tgq_torch/serve/kv_cache.py's _absmax_quantize[4] (absmax · (1/127) or
// · (1/7), floored at 1e-10, round half to even, int4 clipped to ±7 and
// biased by 8), gated on len > 0 and live[b] > 0 (no live array: every slot
// with len > 0 writes).  In int4, heads g and g + kvh/2 share every byte, so
// the block of head g < kvh/2 writes both heads' bytes and scales and the
// other half writes nothing.  The write cannot race the reads: pools are
// read only below len-1.
//
// What bounds it on this card: the KV bytes of the live pages (memory).  At
// GQA group 4 the work is about 4 f32 operations per KV byte, within the
// CUDA cores' rate only if the loop is mostly FMAs.
//
// Design (split context, "flash-decoding"): grid (S, kv_heads, slots).  The
// host picks S from slots, kv heads and the page table's width (never from
// the lengths, which stay on the device): kernels/paged_attention.py::
// _k5_plan.  Block s takes tokens [s·c, min((s+1)·c, pool_len)) with
// c = ceil(pool_len / S) rounded up to the 32-token tile; splits past the
// end return at once.  A block copies tiles of 32 K and V rows (one kv
// head's d features, 16-byte cp.async, double-buffered) into shared memory;
// the logit pass puts the token on the lane and the q head on the warp (one
// dot over d per (token, head), q read from shared memory), then takes one
// max and one sum per tile and head; the P·V pass gives each thread a
// fixed feature pair of fixed heads and reads 4 tokens' probabilities at
// once.  Each split writes its (m, l, acc) to an f32
// workspace; the last block of a (slot, kv head) to finish (an atomic
// counter behind __threadfence) merges the splits in order 0..n-1, folds in
// the current token, writes out and resets the counter, so one launch does
// it all and two launches give the same bits.

#include <float.h>

#include "common.cuh"

namespace {

using namespace tgq;

constexpr int GMAX = 8;     // q heads per kv head, at most
constexpr int NT = 128;     // threads a block
constexpr int NW = NT / 32;
constexpr int TILE = 32;    // tokens a tile: one per lane in the logit pass
constexpr float MASK = -0.7f * FLT_MAX;

template <int KVB>
struct Pool;
template <>
struct Pool<16> { using T = __nv_bfloat16; };
template <>
struct Pool<8> { using T = int8_t; };
template <>
struct Pool<4> { using T = uint8_t; };

// one kv head's row of a pool in shared memory: its bytes, padded by 16 so
// the rows the lanes of a quarter-warp read fall on distinct banks
template <int KVB, int D>
struct Row {
  static constexpr int BYTES = KVB == 16 ? 2 * D : D;
  static constexpr int PIECES = BYTES / 16;
  static constexpr int STRIDE = BYTES + 16;
};

// (head, feature) outputs of a thread in the P·V pass and the merge: the
// feature pair 2·(tid % (D/2)), +1 of heads tid / (D/2) + i·HS (i < HPT)
template <int D>
struct Own {
  static constexpr int HS = NT / (D / 2);
  static constexpr int HPT = GMAX / HS;
};

__device__ __forceinline__ float cap(float x, float c) { return c > 0.f ? tanhf(x / c) * c : x; }

__host__ __device__ inline int split_chunk(int pool_len, int S) {
  const int c = (pool_len + S - 1) / S;
  return ((c + TILE - 1) / TILE) * TILE;
}

// q · k over one stored row in shared memory (features of one kv head)
template <int KVB, int D>
__device__ __forceinline__ float row_dot(const uint8_t* row, const float* qh, int sh) {
  constexpr int EPP = KVB == 16 ? 8 : 16;  // elements a 16-byte piece
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int c = 0; c < Row<KVB, D>::PIECES; ++c) {
    const uint4 w = *reinterpret_cast<const uint4*>(row + c * 16);
    const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
    float kf[EPP];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (KVB == 16) {
        kf[2 * i] = bf_lo(wv[i]);
        kf[2 * i + 1] = bf_hi(wv[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kf[4 * i + j] = KVB == 8 ? (float)(int8_t)(wv[i] >> (8 * j))
                                   : (float)((int)((wv[i] >> (8 * j + sh)) & 0xF) - 8);
      }
    }
    const float4* qv = reinterpret_cast<const float4*>(qh + c * EPP);
#pragma unroll
    for (int i = 0; i < EPP / 4; ++i) {
      const float4 qq = qv[i];
      a0 = fmaf(qq.x, kf[4 * i], a0);
      a1 = fmaf(qq.y, kf[4 * i + 1], a1);
      a0 = fmaf(qq.z, kf[4 * i + 2], a0);
      a1 = fmaf(qq.w, kf[4 * i + 3], a1);
    }
  }
  return a0 + a1;
}

// the stored values of features f, f + 1 (f even) of a row in shared memory
template <int KVB>
__device__ __forceinline__ float2 stored2(const uint8_t* row, int f, int sh) {
  if (KVB == 16) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 2 * f);
    return make_float2(bf_lo(w), bf_hi(w));
  }
  const uint32_t w = *reinterpret_cast<const uint16_t*>(row + f);
  if (KVB == 8) return make_float2((float)(int8_t)w, (float)(int8_t)(w >> 8));
  return make_float2((float)((int)((w >> sh) & 0xF) - 8),
                     (float)((int)((w >> (8 + sh)) & 0xF) - 8));
}

// store the current row at position len-1 (warp 0 of split 0)
template <int KVB, int D>
__device__ void write_row(typename Pool<KVB>::T* k_pool, typename Pool<KVB>::T* v_pool,
                          float* k_scales, float* v_scales, const float* k_cur,
                          const float* v_cur, const int* pages, int b, int g, int kvh, int len,
                          int page, int spad, int lane) {
  constexpr int FPL = D / 32;
  const int F = kvh * D, f0 = g * D + lane * FPL;
  const int last = len - 1;
  const int pg = pages[last / page], off = last % page;
  const long r = (long)pg * page + off;
  if (KVB == 16) {
    __nv_bfloat16* kp = reinterpret_cast<__nv_bfloat16*>(k_pool) + r * F + f0;
    __nv_bfloat16* vp = reinterpret_cast<__nv_bfloat16*>(v_pool) + r * F + f0;
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      kp[i] = __float2bfloat16_rn(k_cur[(long)b * F + f0 + i]);
      vp[i] = __float2bfloat16_rn(v_cur[(long)b * F + f0 + i]);
    }
    return;
  }
  const float qmax_inv = KVB == 8 ? 1.0f / 127.0f : 1.0f / 7.0f;
  // heads written by this block: g (int8), or g and g + kvh/2 (int4)
  const int n_heads = KVB == 8 ? 1 : (g < kvh / 2 ? 2 : 0);
  for (int side = 0; side < 2; ++side) {  // K, then V
    const float* cur = side == 0 ? k_cur : v_cur;
    typename Pool<KVB>::T* pool = side == 0 ? k_pool : v_pool;
    float* scales = side == 0 ? k_scales : v_scales;
    int codes[2][FPL];
    for (int j = 0; j < n_heads; ++j) {
      const int hg = g + j * (kvh / 2);
      const int fj = hg * D + lane * FPL;
      float x[FPL], amax = 0.f;
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        x[i] = cur[(long)b * F + fj + i];
        amax = fmaxf(amax, fabsf(x[i]));
      }
      amax = warp_max(amax);
      const float s = fmaxf(__fmul_rn(amax, qmax_inv), 1e-10f);
#pragma unroll
      for (int i = 0; i < FPL; ++i) {
        float c = rintf(__fdiv_rn(x[i], s));
        if (KVB == 4) c = fminf(fmaxf(c, -7.f), 7.f);
        codes[j][i] = (int)c;
      }
      if (lane == 0) scales[((long)pg * kvh + hg) * spad + off] = s;
    }
    if (KVB == 8) {
      int8_t* p = reinterpret_cast<int8_t*>(pool) + r * F + f0;
#pragma unroll
      for (int i = 0; i < FPL; ++i) p[i] = (int8_t)codes[0][i];
    } else if (n_heads == 2) {
      uint8_t* p = reinterpret_cast<uint8_t*>(pool) + r * (F / 2) + f0;
#pragma unroll
      for (int i = 0; i < FPL; ++i)
        p[i] = (uint8_t)((codes[0][i] + 8) | ((codes[1][i] + 8) << 4));
    }
  }
}

struct Args {
  const float* q;
  void* k_pool;
  void* v_pool;
  float* k_scales;
  float* v_scales;
  const int* lengths;
  const int* page_indices;
  const float* k_cur;
  const float* v_cur;
  const int* live;
  float* out;
  float* m_out;  // return_stats: (slots, H) f32, else null
  float* l_out;
  float* ws;
  int* counters;
  int H, kvh, page, mpps, spad, S, write_current, w_live;
  float soft_cap;
};

__host__ __device__ inline int k5_smem(int row_stride, int group, int d) {
  return 4 * TILE * row_stride + (group * d + TILE * GMAX + 4 * GMAX + 4) * 4;
}

template <int KVB, int D>
__global__ void __launch_bounds__(NT) paged_attention_kernel(const Args a) {
  using R = Row<KVB, D>;
  using O = Own<D>;
  using T = typename Pool<KVB>::T;
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = a.kvh, group = a.H / kvh, F = kvh * D;
  const int len = a.lengths[b];
  const bool has_cur = a.k_cur != nullptr;
  float* out = a.out + ((long)b * a.H + g * group) * D;
  const bool stats = a.m_out != nullptr;
  if (len <= 0) {  // an idle slot: zeros (split 0), nothing written
    if (s == 0) {
      for (int i = tid; i < group * D; i += NT) out[i] = 0.f;
      if (stats && tid < group) {
        a.m_out[(long)b * a.H + g * group + tid] = MASK;
        a.l_out[(long)b * a.H + g * group + tid] = 0.f;
      }
    }
    return;
  }
  const int pool_len = max(len - (has_cur ? 1 : 0) - a.w_live, 0);
  const int chunk = split_chunk(pool_len, a.S);
  const int n_merge = pool_len > 0 ? (pool_len + chunk - 1) / chunk : 1;  // splits with tokens
  if (s >= n_merge) return;
  const int t_begin = s * chunk, t_end = min(t_begin + chunk, pool_len);
  const int* pages = a.page_indices + (long)b * a.mpps;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* kv = smem;  // [buffer][K, V][TILE][STRIDE]
  float* q_s = reinterpret_cast<float*>(smem + 4 * TILE * R::STRIDE);  // [group][D]
  float* p_s = q_s + group * D;                                       // [GMAX][TILE]
  float* a_s = p_s + TILE * GMAX;                                     // tile rescale [GMAX]
  float* m_s = a_s + GMAX;
  float* l_s = m_s + GMAX;
  float* qc_s = l_s + GMAX;
  int* flag = reinterpret_cast<int*>(qc_s + GMAX);

  const float* qb = a.q + ((long)b * a.H + g * group) * D;
  for (int i = tid * 4; i < group * D; i += NT * 4)
    *reinterpret_cast<float4*>(q_s + i) = *reinterpret_cast<const float4*>(qb + i);

  // this kv head's bytes of a pool row (int4: the low or high nibbles)
  const int half = kvh / 2;
  const int sh = KVB == 4 && g >= half ? 4 : 0;
  const long row_bytes = KVB == 16 ? 2L * F : KVB == 8 ? (long)F : (long)F / 2;
  const long head_off = KVB == 16 ? 2L * g * D : (long)(KVB == 4 && g >= half ? g - half : g) * D;
  const uint8_t* kb = static_cast<const uint8_t*>(a.k_pool) + head_off;
  const uint8_t* vb = static_cast<const uint8_t*>(a.v_pool) + head_off;

  // a tile inside one page (page a multiple of the tile) needs one lookup
  const bool tile_in_page = a.page % TILE == 0;
  auto load_tile = [&](int t0, int buf) {
    const long r0 = tile_in_page ? (long)pages[t0 / a.page] * a.page + t0 % a.page : 0;
    for (int p = tid; p < 2 * TILE * R::PIECES; p += NT) {
      const int side = p / (TILE * R::PIECES), rem = p - side * (TILE * R::PIECES);
      const int j = rem / R::PIECES, c = rem - j * R::PIECES;
      const int t = t0 + j;
      uint8_t* dst = kv + ((buf * 2 + side) * TILE + j) * R::STRIDE + c * 16;
      const uint8_t* base = side ? vb : kb;
      if (t < t_end) {
        const long r = tile_in_page ? r0 + j : (long)pages[t / a.page] * a.page + t % a.page;
        cp_async16(dst, base + r * row_bytes + c * 16, 16);
      } else {
        cp_async16(dst, base, 0);  // zero-filled: p = 0 meets a finite v
      }
    }
  };

  float m_h[GMAX / NW], l_h[GMAX / NW];
#pragma unroll
  for (int i = 0; i < GMAX / NW; ++i) m_h[i] = MASK, l_h[i] = 0.f;
  const int f0 = 2 * (tid % (D / 2)), h0 = tid / (D / 2);
  float2 acc[O::HPT];
#pragma unroll
  for (int i = 0; i < O::HPT; ++i) acc[i] = make_float2(0.f, 0.f);

  const int n_tiles = t_end > t_begin ? (t_end - t_begin + TILE - 1) / TILE : 0;
  if (n_tiles > 0) load_tile(t_begin, 0);
  cp_async_commit();
  // the current token's logits (a warp a head) and values, while the first
  // tile is in flight: the merge then waits on no global load of its own
  __syncthreads();  // q_s
#pragma unroll
  for (int hh = 0; hh < GMAX / NW; ++hh) {
    const int h = warp + hh * NW;
    if (h >= group) break;
    float part = 0.f;
    if (has_cur)
      for (int f = lane; f < D; f += 32)
        part = fmaf(q_s[h * D + f], a.k_cur[(long)b * F + g * D + f], part);
    const float qc = warp_sum(part);
    if (lane == 0) qc_s[h] = cap(qc, a.soft_cap);
  }
  const float2 vcur = has_cur ? *reinterpret_cast<const float2*>(a.v_cur + (long)b * F + g * D + f0)
                              : make_float2(0.f, 0.f);
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every thread is past tile it-1
    if (it + 1 < n_tiles) load_tile(t_begin + (it + 1) * TILE, (it + 1) & 1);
    cp_async_commit();
    const uint8_t* kt = kv + ((it & 1) * 2) * TILE * R::STRIDE;
    const uint8_t* vt = kt + TILE * R::STRIDE;
    const int t0 = t_begin + it * TILE;
    // logits: lane = token, warp = q head (warp, warp + NW)
    {
      const int t = t0 + lane;
      const bool valid = t < t_end;
      float ksc = 1.f, vsc = 1.f;
      if (KVB != 16 && valid) {
        const long si = ((long)pages[t / a.page] * kvh + g) * a.spad + t % a.page;
        ksc = a.k_scales[si];
        vsc = a.v_scales[si];
      }
#pragma unroll
      for (int hh = 0; hh < GMAX / NW; ++hh) {
        const int h = warp + hh * NW;
        if (h >= group) break;
        float logit = row_dot<KVB, D>(kt + lane * R::STRIDE, q_s + h * D, sh);
        if (KVB != 16) logit *= ksc;
        logit = cap(logit, a.soft_cap);
        const float m_new = fmaxf(m_h[hh], warp_max(valid ? logit : MASK));
        const float alpha = expf(m_h[hh] - m_new);
        const float p = valid ? expf(logit - m_new) : 0.f;
        l_h[hh] = l_h[hh] * alpha + warp_sum(p);
        m_h[hh] = m_new;
        p_s[h * TILE + lane] = KVB != 16 ? p * vsc : p;
        if (lane == 0) a_s[h] = alpha;
      }
    }
    __syncthreads();
    // P·V: a feature pair of fixed heads a thread, 4 tokens at a time (p is
    // 0 past the tile's tokens, where V was zero-filled)
    const int n_tok = min(TILE, t_end - t0);
#pragma unroll
    for (int i = 0; i < O::HPT; ++i) {
      const int h = h0 + i * O::HS;
      if (h < group) {
        const float al = a_s[h];
        acc[i].x *= al;
        acc[i].y *= al;
      }
    }
    for (int j = 0; j < n_tok; j += 4) {
      float2 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = stored2<KVB>(vt + (j + u) * R::STRIDE, f0, sh);
#pragma unroll
      for (int i = 0; i < O::HPT; ++i) {
        const int h = h0 + i * O::HS;
        if (h < group) {
          const float4 pj = *reinterpret_cast<const float4*>(p_s + h * TILE + j);
          const float pu[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[i].x = fmaf(pu[u], v[u].x, acc[i].x);
            acc[i].y = fmaf(pu[u], v[u].y, acc[i].y);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (s == 0 && warp == 0 && a.write_current && has_cur &&
      (a.live == nullptr || a.live[b] > 0))
    write_row<KVB, D>(static_cast<T*>(a.k_pool), static_cast<T*>(a.v_pool), a.k_scales,
                      a.v_scales, a.k_cur, a.v_cur, pages, b, g, kvh, len, a.page, a.spad,
                      lane);

  if (lane == 0) {
#pragma unroll
    for (int hh = 0; hh < GMAX / NW; ++hh) {
      const int h = warp + hh * NW;
      if (h < group) m_s[h] = m_h[hh], l_s[h] = l_h[hh];
    }
  }
  __syncthreads();
  const long stride = (long)group * (D + 2);  // one split's partial: m, l, acc
  float* parts = a.ws + (long)(b * kvh + g) * a.S * stride;
  if (n_merge > 1) {
    float* mine = parts + s * stride;
    if (tid < group) mine[tid] = m_s[tid], mine[group + tid] = l_s[tid];
#pragma unroll
    for (int i = 0; i < O::HPT; ++i) {
      const int h = h0 + i * O::HS;
      if (h < group) *reinterpret_cast<float2*>(mine + 2 * group + h * D + f0) = acc[i];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *flag = atomicAdd(a.counters + b * kvh + g, 1) == n_merge - 1;
    __syncthreads();
    if (!*flag) return;
    __threadfence();
  }

  // the last block: merge the splits in order 0..n_merge-1, fold in the
  // current token
  auto finish = [&](int h, float M, float L, float2 A) {
    if (has_cur) {
      const float qc = qc_s[h];
      const float m_next = fmaxf(M, qc);
      const float alpha = expf(M - m_next), p = expf(qc - m_next);
      L = L * alpha + p;
      A.x = A.x * alpha + p * vcur.x;
      A.y = A.y * alpha + p * vcur.y;
      M = m_next;
    }
    if (stats) {  // the partials: un-normalised, with their max and sum
      *reinterpret_cast<float2*>(out + h * D + f0) = A;
      if (f0 == 0) {
        a.m_out[(long)b * a.H + g * group + h] = M;
        a.l_out[(long)b * a.H + g * group + h] = L;
      }
      return;
    }
    *reinterpret_cast<float2*>(out + h * D + f0) = make_float2(A.x / L, A.y / L);
  };
  if (n_merge == 1) {
#pragma unroll
    for (int i = 0; i < O::HPT; ++i) {
      const int h = h0 + i * O::HS;
      if (h < group) finish(h, m_s[h], l_s[h], acc[i]);
    }
  } else {
    // a head at a time (registers: occupancy), loads issued 4 splits at once
#pragma unroll 1
    for (int i = 0; i < O::HPT; ++i) {
      const int h = h0 + i * O::HS;
      if (h >= group) break;
      float M = MASK, L = 0.f;
      float2 A = make_float2(0.f, 0.f);
      for (int j0 = 0; j0 < n_merge; j0 += 4) {
        float mv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mv[u] = j0 + u < n_merge ? __ldcg(parts + (j0 + u) * stride + h) : MASK;
#pragma unroll
        for (int u = 0; u < 4; ++u) M = fmaxf(M, mv[u]);
      }
      for (int j0 = 0; j0 < n_merge; j0 += 4) {
        float mv[4], lv[4];
        float2 av[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* pj = parts + (j0 + u) * stride;
          const bool in = j0 + u < n_merge;
          mv[u] = in ? __ldcg(pj + h) : MASK;
          lv[u] = in ? __ldcg(pj + group + h) : 0.f;
          av[u] = in ? __ldcg(reinterpret_cast<const float2*>(pj + 2 * group + h * D + f0))
                     : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j0 + u < n_merge) {
            const float c = expf(mv[u] - M);
            L += lv[u] * c;
            A.x += av[u].x * c;
            A.y += av[u].y * c;
          }
        }
      }
      finish(h, M, L, A);
    }
  }
  if (n_merge > 1 && tid == 0) a.counters[b * kvh + g] = 0;  // ready for the next launch
}

template <int KVB, int D>
int launch(const Args& a, int slots, int device, cudaStream_t stream) {
  static bool opted_in[64] = {};
  auto kern = paged_attention_kernel<KVB, D>;
  const int smem = k5_smem(Row<KVB, D>::STRIDE, a.H / a.kvh, D);
  const cudaError_t e = allow_smem(kern, smem, device, opted_in);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(a.S, a.kvh, slots), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KVB>
int by_dim(int d, const Args& a, int slots, int device, cudaStream_t s) {
  switch (d) {
    case 32: return launch<KVB, 32>(a, slots, device, s);
    case 64: return launch<KVB, 64>(a, slots, device, s);
    case 128: return launch<KVB, 128>(a, slots, device, s);
    case 256: return launch<KVB, 256>(a, slots, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched).  Pools,
// scales and the page table are one layer's contiguous views, pool rows
// 16-byte aligned; k_cur/v_cur (slots, F) f32 or null; live (slots,) int32
// or null; soft_cap 0 = none.  splits: S from the host's planner; with
// S > 1, ws holds slots·kvh·S·group·(d+2) f32 and counters slots·kvh int32
// that are 0 before the launch (the kernel leaves them 0).  w_live >= 0: the
// chunk window's rows the pools do not cover; m_out/l_out (slots, H) f32,
// both or neither: return the partials (out un-normalised).
int tgq_paged_attention(const float* q, void* k_pool, void* v_pool, float* k_scales,
                        float* v_scales, const int* lengths, const int* page_indices,
                        const float* k_cur, const float* v_cur, const int* live, float* out,
                        float* m_out, float* l_out, float* ws, int* counters, int slots,
                        int H, int kvh, int d, int page, int mpps, int spad, int kv_bits,
                        int splits, int write_current, int w_live, float soft_cap, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kvh <= 0 || H % kvh != 0 || H / kvh > GMAX || page <= 0 || mpps <= 0 || splits < 1 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      (kv_bits == 4 && kvh % 2 != 0) || (kv_bits != 16 && spad < page) || w_live < 0 ||
      ((m_out == nullptr) != (l_out == nullptr)) || (write_current && w_live > 0))
    return (int)cudaErrorInvalidValue;
  if (slots == 0) return 0;
  if (slots > 65535 || kvh > 65535) return (int)cudaErrorInvalidValue;
  const Args a{q,        k_pool,   v_pool, k_scales, v_scales,      lengths, page_indices,
               k_cur,    v_cur,    live,   out,      m_out,         l_out,   ws,
               counters, H,        kvh,    page,     mpps,          spad,    splits,
               write_current, w_live, soft_cap};
  cudaStream_t s = (cudaStream_t)stream;
  switch (kv_bits) {
    case 16: return by_dim<16>(d, a, slots, device, s);
    case 8: return by_dim<8>(d, a, slots, device, s);
    case 4: return by_dim<4>(d, a, slots, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
