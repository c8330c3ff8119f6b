// One panel of greedy pivoted Cholesky, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pchol_panel_kernel` in tgq/kernels/pchol_panel.py
// (driven by `_pivoted_cholesky_pallas`, tgq/solver/pchol.py).  It runs
// `steps` (<= panel) dependent pivot steps against the Schur complement `a`
// (n x n f32, row-major, left untouched).  Each step k:
//   piv  = argmax over not-done columns of d (max first, then the smallest
//          index on a tie — the jnp.argmax rule of pchol_panel.py:58-60)
//   dk   = max(d[piv], 0)
//   row  = a[piv, :] - sum_{t<k} strip[t, piv] * strip[t, :]   (exact f32)
//   l    = row * (1 / sqrt(dk));  l = 0 at done columns;  l[piv] = sqrt(dk)
//   strip[k, :] = l;  perm[k] = piv;  pivhist[k] = dk
//   done[piv] = 1;  d = done ? 0 : max(d - l*l, 0)
// Rows steps..panel-1 of the strip (a ragged last panel) are written as
// zeros, perm/pivhist there as 0.  The trailing update a -= strip^T strip
// stays outside, as an exact-f32 GEMM.
//
// What bounds it on this card: latency, not bytes or FLOPs.  Each step needs
// a global argmax over n before the next can start — `panel` dependent
// grid-wide reductions per launch, each followed by a dependent read of the
// pivot's row of `a` (HBM) and of the strip's column at the pivot (L2).
//
// Design (the plan is `_k1_plan` in kernels/pchol_panel.py): one cooperative
// block per SM at most, each owning a contiguous tile of columns.  The tile's
// strip rows live in shared memory for the whole panel (rows past what fits
// stay in global memory and are read from there, in the same loop), so the
// Schur-row correction of a column reads shared memory only; d and done of
// the tile live in shared memory too.  Each step's row is also written
// transposed (column-major scratch), so the k strip entries at the next
// pivots are one contiguous read.  A step's cross-block work is one
// 64-bit max reduction a warp on the step's own slot — the key is an
// order-preserving encoding of d (-0.0 made +0.0) over the inverted column
// index, so the largest key is "max value, then smallest index" — and one
// arrival count a block (a release reduction, no separate fence), which
// thread 0 spins on with `ld.acquire` (no sleep).  The slots and counts are fresh for every step (zeroed by the
// wrapper), so nothing is reset inside the launch.  After the arrival each
// block reads only its tile's part of the pivot row and the k strip entries
// at the pivot, both issued together.
//
// Arithmetic: every operation is rounded on its own, in the order of the
// plain version (the Schur-row correction summed over t = 0..k-1, products
// rounded before the add; no FMA, no TF32, no bf16 — a bf16 correction
// derailed pivot selection on the TPU, pchol_panel.py:72-78).  With the same
// trailing GEMM between panels, the kernel and the plain version produce the
// same bits, so their pivots and trace histories agree exactly.

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;

// Order-preserving key: larger value first, then the smaller column index.
__device__ __forceinline__ unsigned long long cand_key(float v, int j) {
  if (v == 0.f) v = 0.f;  // -0.0 and +0.0 compare equal in the plain rule
  const unsigned int u = __float_as_uint(v);
  const unsigned int e = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)e << 32) | (0xFFFFFFFFu - (unsigned int)j);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const unsigned int e = (unsigned int)(key >> 32);
  return __uint_as_float((e & 0x80000000u) ? (e & 0x7FFFFFFFu) : ~e);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}

__device__ __forceinline__ void red_max(unsigned long long* p, unsigned long long v) {
  asm volatile("red.relaxed.gpu.global.max.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void red_release_add(unsigned int* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p) : "memory");
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
pchol_panel_kernel(const float* __restrict__ a, const float* __restrict__ d_in,
                   const float* __restrict__ done_in, float* strip, float* d_out,
                   float* done_out, int* perm, float* pivhist, float* strip_t,
                   unsigned long long* keys, unsigned int* arrived, int n, int panel,
                   int steps, int tile, int rows_smem) {
  extern __shared__ float sm[];
  float* s_strip = sm;                                // rows_smem x tile
  float* s_d = s_strip + (size_t)rows_smem * tile;    // tile
  float* s_done = s_d + tile;                         // tile
  float* s_col = s_done + tile;                       // panel: strip[:k, piv]
  __shared__ unsigned long long s_key;

  const int G = gridDim.x;
  const int j0 = blockIdx.x * tile;
  const int cols = min(tile, n - j0);
  const int lane = threadIdx.x & 31;

  // this thread's best candidate over its columns (key 0 = none)
  unsigned long long best = 0ull;
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float dj = d_in[j0 + c], dn = done_in[j0 + c];
    s_d[c] = dj;
    s_done[c] = dn;
    const unsigned long long key = cand_key(dn > 0.f ? -INFINITY : dj, j0 + c);
    best = key > best ? key : best;
  }

  for (int k = 0; k < steps; ++k) {
    // publish: one atomicMax a warp, then one arrival a block
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
      best = o > best ? o : best;
    }
    if (lane == 0 && best != 0ull) red_max(keys + k, best);
    __syncthreads();  // the release below then covers the block's maxes and strip row k-1
    if (threadIdx.x == 0) {
      red_release_add(arrived + k);
      while (ld_acquire(arrived + k) < (unsigned int)G) {
      }
      s_key = ld_relaxed64(keys + k);
    }
    __syncthreads();
    const unsigned long long key = s_key;
    const int piv = key_index(key);
    const float dk = fmaxf(key_value(key), 0.f);

    // the pivot's row over this tile, and strip[:k, piv], issued together
    const float* arow = a + (size_t)piv * n + j0;
    for (int t = threadIdx.x; t < k; t += blockDim.x)
      s_col[t] = __ldcg(strip_t + (size_t)piv * panel + t);
    const int c0 = threadIdx.x;
    const float a0 = c0 < cols ? __ldg(arow + c0) : 0.f;
    __syncthreads();

    const float inv = dk > 0.f ? __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(dk, 1e-30f))) : 0.f;
    const float lpiv = __fsqrt_rn(dk);
    float* srow = strip + (size_t)k * n + j0;
    best = 0ull;
    for (int c = c0; c < cols; c += blockDim.x) {
      const int j = j0 + c;
      float acc = 0.f;
      const int ts = min(k, rows_smem);
      int t = 0;
      for (; t + 8 <= ts; t += 8) {  // 8 products ahead of their adds
        float p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          p[i] = __fmul_rn(s_col[t + i], s_strip[(size_t)(t + i) * tile + c]);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, p[i]);
      }
      for (; t < ts; ++t)
        acc = __fadd_rn(acc, __fmul_rn(s_col[t], s_strip[(size_t)t * tile + c]));
      for (int t = ts; t < k; ++t)  // rows that did not fit: this thread's own writes
        acc = __fadd_rn(acc, __fmul_rn(s_col[t], strip[(size_t)t * n + j]));
      const float av = c == c0 ? a0 : __ldg(arow + c);
      const float dn = s_done[c];
      float l = __fmul_rn(__fsub_rn(av, acc), inv);
      if (dn > 0.f) l = 0.f;
      if (j == piv) l = lpiv;
      if (k < rows_smem) s_strip[(size_t)k * tile + c] = l;
      srow[c] = l;
      strip_t[(size_t)j * panel + k] = l;
      const float nd = j == piv ? fmaxf(dn, 1.f) : dn;
      const float dj = nd > 0.f ? 0.f : fmaxf(__fsub_rn(s_d[c], __fmul_rn(l, l)), 0.f);
      s_done[c] = nd;
      s_d[c] = dj;
      const unsigned long long kk = cand_key(nd > 0.f ? -INFINITY : dj, j);
      best = kk > best ? kk : best;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      perm[k] = piv;
      pivhist[k] = dk;
    }
  }

  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    d_out[j0 + c] = s_d[c];
    done_out[j0 + c] = s_done[c];
    for (int k = steps; k < panel; ++k) strip[(size_t)k * n + j0 + c] = 0.f;
  }
  if (blockIdx.x == 0)
    for (int k = steps + threadIdx.x; k < panel; k += blockDim.x) {
      perm[k] = 0;
      pivhist[k] = 0.f;
    }
}

}  // namespace

extern "C" {

// The device's SM count and the shared memory a block may opt in to.
int tgq_device_sms(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  return v;
}

int tgq_device_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return v;
}

// Blocks of `threads` threads and `smem` bytes that fit one SM at once
// (0 or less: the plan cannot be co-resident).
int tgq_pchol_panel_blocks_per_sm(int device, int threads, int smem) {
  int per_sm = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaFuncSetAttribute(pchol_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pchol_panel_kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return per_sm;
}

// Launch one panel on `stream` with the plan's grid, tile, threads, shared
// rows and bytes; `strip_t` is n x panel scratch (the strip transposed);
// `keys` (panel u64) and `arrived` (panel u32) must be zero.
// Returns the CUDA error code (0 = launched).
int tgq_pchol_panel(const float* a, const float* d_in, const float* done_in,
                    float* strip, float* d, float* done, int* perm, float* pivhist,
                    float* strip_t, unsigned long long* keys, unsigned int* arrived, int n, int panel,
                    int steps, int grid, int tile, int threads, int rows_smem, int smem,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(pchol_panel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a,     (void*)&d_in,  (void*)&done_in, (void*)&strip,
                  (void*)&d,     (void*)&done,  (void*)&perm,    (void*)&pivhist,
                  (void*)&strip_t, (void*)&keys,  (void*)&arrived, (void*)&n,     (void*)&panel,
                  (void*)&steps, (void*)&tile,  (void*)&rows_smem};
  err = cudaLaunchCooperativeKernel((const void*)pchol_panel_kernel, dim3(grid),
                                    dim3(threads), args, (size_t)smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
