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
// grid-wide reductions per launch.  The strip (panel x n f32, 6 MB at
// n = 12288) does not fit in shared memory; it stays in L2.
//
// Design: one cooperative launch per panel.  Columns are spread over a grid
// of co-resident blocks (grid-stride, 256 threads a block); each thread owns
// its columns' d, done and strip entries for the whole panel, so the Schur
// row correction reads only the thread's own strip column.  The only
// cross-block data per step are the per-block argmax candidates and the
// strip's column `piv` (k floats), read from L2 after one grid barrier.  The
// next step's local argmax is fused into the update pass, so a step costs
// exactly one grid barrier.  The cooperative launch guarantees the blocks
// are co-resident, so the spin barrier cannot deadlock.
//
// Arithmetic: every operation is rounded on its own, in the order of the
// plain version (the Schur-row correction summed over t = 0..k-1, products
// rounded before the add; no FMA, no TF32, no bf16 — a bf16 correction
// derailed pivot selection on the TPU, pchol_panel.py:72-78).  With the same
// trailing GEMM between panels, the kernel and the plain version produce the
// same bits, so their pivots and trace histories agree exactly.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Block-wide (max, first index); the result lands in every thread.
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? sv[lane] : -INFINITY;
    i = lane < nw ? si[lane] : INT_MAX;
    warp_argmax(v, i);
    if (lane == 0) { sv[0] = v; si[0] = i; }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();
}

// Sense-counting grid barrier: bar[0] counts arrivals, bar[1] is the
// generation.  Every thread fences its global writes before the block
// arrives; the last block to arrive resets the count and bumps the
// generation.  The cooperative launch makes every block co-resident, so
// each wait ends.
__device__ void grid_barrier(unsigned int* bar, unsigned int nblocks) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
pchol_panel_kernel(const float* __restrict__ a, const float* __restrict__ d_in,
                   const float* __restrict__ done_in, float* strip, float* d,
                   float* done, int* perm, float* pivhist, float* cand_v,
                   int* cand_i, unsigned int* bar, int n, int panel, int steps) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  extern __shared__ float s_col[];  // strip[:k, piv], panel floats
  const int G = gridDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = G * blockDim.x;

  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int j = first; j < n; j += stride) {
    const float dj = d_in[j], dn = done_in[j];
    d[j] = dj;
    done[j] = dn;
    const float v = dn > 0.f ? -INFINITY : dj;
    if (better(v, j, bv, bi)) { bv = v; bi = j; }
  }

  for (int k = 0; k < steps; ++k) {
    const int par = (k & 1) * G;  // double-buffered candidates
    block_argmax(bv, bi, red_v, red_i);
    if (threadIdx.x == 0) {
      cand_v[par + blockIdx.x] = bv;
      cand_i[par + blockIdx.x] = bi;
    }
    grid_barrier(bar, G);

    bv = -INFINITY;
    bi = INT_MAX;
    for (int b = threadIdx.x; b < G; b += blockDim.x) {
      const float v = __ldcg(cand_v + par + b);
      const int i = __ldcg(cand_i + par + b);
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
    block_argmax(bv, bi, red_v, red_i);
    const int piv = bi;
    const float dk = fmaxf(bv, 0.f);
    for (int t = threadIdx.x; t < k; t += blockDim.x)
      s_col[t] = __ldcg(strip + (size_t)t * n + piv);
    __syncthreads();

    const float inv = dk > 0.f ? __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(dk, 1e-30f))) : 0.f;
    const float lpiv = __fsqrt_rn(dk);
    const float* arow = a + (size_t)piv * n;
    float* srow = strip + (size_t)k * n;
    bv = -INFINITY;
    bi = INT_MAX;
    for (int j = first; j < n; j += stride) {
      float acc = 0.f;
      for (int t = 0; t < k; ++t)
        acc = __fadd_rn(acc, __fmul_rn(s_col[t], strip[(size_t)t * n + j]));
      const float dn = done[j];
      float l = __fmul_rn(__fsub_rn(arow[j], acc), inv);
      if (dn > 0.f) l = 0.f;
      if (j == piv) l = lpiv;
      srow[j] = l;
      const float nd = j == piv ? fmaxf(dn, 1.f) : dn;
      const float dj = nd > 0.f ? 0.f : fmaxf(__fsub_rn(d[j], __fmul_rn(l, l)), 0.f);
      done[j] = nd;
      d[j] = dj;
      const float v = nd > 0.f ? -INFINITY : dj;
      if (better(v, j, bv, bi)) { bv = v; bi = j; }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      perm[k] = piv;
      pivhist[k] = dk;
    }
  }

  for (int k = steps; k < panel; ++k)
    for (int j = first; j < n; j += stride) strip[(size_t)k * n + j] = 0.f;
  if (blockIdx.x == 0)
    for (int k = steps + threadIdx.x; k < panel; k += blockDim.x) {
      perm[k] = 0;
      pivhist[k] = 0.f;
    }
}

}  // namespace

extern "C" {

// Largest cooperative grid for this kernel on `device`.
int tgq_pchol_panel_max_blocks(int device, int panel) {
  int sms = 0, per_sm = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pchol_panel_kernel, kThreads, panel * sizeof(float)) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

int tgq_pchol_panel_threads() { return kThreads; }

// Launch one panel on `stream`; returns the CUDA error code (0 = launched).
int tgq_pchol_panel(const float* a, const float* d_in, const float* done_in,
                    float* strip, float* d, float* done, int* perm, float* pivhist,
                    float* cand_v, int* cand_i, unsigned int* bar, int n, int panel,
                    int steps, int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a,      (void*)&d_in,    (void*)&done_in, (void*)&strip,
                  (void*)&d,      (void*)&done,    (void*)&perm,    (void*)&pivhist,
                  (void*)&cand_v, (void*)&cand_i,  (void*)&bar,     (void*)&n,
                  (void*)&panel,  (void*)&steps};
  err = cudaLaunchCooperativeKernel((const void*)pchol_panel_kernel, dim3(grid),
                                    dim3(kThreads), args, panel * sizeof(float),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
