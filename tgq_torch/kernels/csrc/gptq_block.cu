// In-block sequential GPTQ quantize + error propagation, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_gptq_block_kernel` in tgq/kernels/gptq_block.py
// (`process_block_pallas`, driven by tgq/solver/gptq_loop.py).  For every
// row of the (m, b) block, columns k = 0..b-1 in sequence:
//   q_k = clip(floor(w_k / s_k + z_k + 0.5), min_q, max_q)
//   e_k = (w_k - (q_k - z_k) * s_k) / R[k, k]
//   w_j -= e_k * R[k, j]            for j > k
// Outputs the codes (as f32) and the scaled errors e, both (m, b) row-major.
//
// Every operation is rounded on its own (__fdiv_rn / __fadd_rn / __fmul_rn /
// __fsub_rn, and the file is built with -fmad=false), so the codes equal
// the plain PyTorch version bit for bit: a contracted w - (q - z) s moves e
// by an ulp and flips codes at rounding ties.
//
// What bounds it on this card: the dependent column chain (b steps per row),
// i.e. latency; the bytes (w, s, z in, q, e out) and the m*b^2 propagation
// FLOPs are both far below the card's rates at the main path's shapes.
//
// Design: rows are independent, so one warp owns one row.  The row's w, s
// and z live in shared memory for the whole sweep (3*b floats a warp) and
// the 32 lanes sweep the columns j > k of each step; R's row k is read from
// L1/L2 (every warp of a block reads the same row), R's diagonal is staged
// in shared memory.  After step k, s_k and z_k are dead, so their slots
// hold q_k and e_k, and the row is written back coalesced at the end.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

__global__ void __launch_bounds__(kMaxWarps * 32)
gptq_block_kernel(const float* __restrict__ w, const float* __restrict__ s,
                  const float* __restrict__ z, const float* __restrict__ r,
                  float* __restrict__ q_out, float* __restrict__ e_out, int m,
                  int b, float min_q, float max_q) {
  extern __shared__ float sm[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* rdiag = sm;
  float* ws = sm + b + warp * 3 * b;
  float* ss = ws + b;
  float* zs = ss + b;

  for (int k = threadIdx.x; k < b; k += blockDim.x) rdiag[k] = r[(size_t)k * b + k];
  const int row = blockIdx.x * warps + warp;
  if (row < m) {
    const size_t off = (size_t)row * b;
    for (int j = lane; j < b; j += 32) {
      ws[j] = w[off + j];
      ss[j] = s[off + j];
      zs[j] = z[off + j];
    }
  }
  __syncthreads();
  if (row >= m) return;

  for (int k = 0; k < b; ++k) {
    __syncwarp();
    const float wk = ws[k], sk = ss[k], zk = zs[k], rkk = rdiag[k];
    float qk = floorf(__fadd_rn(__fadd_rn(__fdiv_rn(wk, sk), zk), 0.5f));
    qk = fminf(fmaxf(qk, min_q), max_q);
    const float ek = __fdiv_rn(__fsub_rn(wk, __fmul_rn(__fsub_rn(qk, zk), sk)), rkk);
    __syncwarp();
    if (lane == 0) {
      ss[k] = qk;
      zs[k] = ek;
    }
    const float* rrow = r + (size_t)k * b;
    for (int j = k + 1 + lane; j < b; j += 32)
      ws[j] = __fsub_rn(ws[j], __fmul_rn(ek, __ldg(rrow + j)));
  }
  __syncwarp();
  const size_t off = (size_t)row * b;
  for (int j = lane; j < b; j += 32) {
    q_out[off + j] = ss[j];
    e_out[off + j] = zs[j];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 = launched).
int tgq_gptq_block(const float* w, const float* s, const float* z, const float* r,
                   float* q, float* e, int m, int b, float min_q, float max_q,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || b <= 0) return 0;
  // as many warps (rows) per block as fit the default shared memory; a wide
  // block falls back to fewer warps, then to opting in to more memory
  const size_t per_warp = 3 * (size_t)b * sizeof(float);
  const size_t diag = (size_t)b * sizeof(float);
  int warps = (int)((kDefaultSmem - (long)diag) / (long)per_warp);
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (warps < 1) warps = 1;
  const size_t smem = diag + warps * per_warp;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)kDefaultSmem) {
    err = cudaFuncSetAttribute(gptq_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (m + warps - 1) / warps;
  gptq_block_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      w, s, z, r, q, e, m, b, min_q, max_q);
  return (int)cudaGetLastError();
}

}  // extern "C"
