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
// Rounding follows XLA:CPU's code for the JAX sweep (`_process_block_jnp`):
// w - (q - z)·s and w_j - e·R[k, j] are single-rounded FMAs (__fmaf_rn), as
// XLA contracts them; every other operation is rounded on its own
// (__fdiv_rn / __fadd_rn / __fsub_rn, and the file is built with
// -fmad=false so nothing else contracts).  The plain PyTorch version
// emulates the two FMAs exactly, so codes and e agree with it, and with the
// JAX package, bit for bit.
//
// What bounds it on this card: the dependent column chain (b steps a row,
// two IEEE divisions each) and the m·b²/2 propagation FMAs on the CUDA
// cores; the bytes (w, s, z in, q, e out) are far below both.
//
// Design (`gptq_block_kernel`, b <= 512; the plan is `_k2_plan` in
// kernels/gptq_block.py): a block owns TM = 32, 64 or 128 rows and walks the
// columns in sub-blocks of 32.  Each element w_j receives its updates in
// increasing k whether they are applied at once or later, so a sub-block's
// updates of the columns after it are deferred and applied together:
//   A. one thread a row sweeps the sub-block's 32 columns with w, s and z in
//      registers (fully unrolled: the chain is the two IEEE divisions and
//      one FMA a step; R's 32 x 32 triangle is read from shared memory as
//      broadcasts, a row ahead), and stages q and -e;
//   B. all 256 threads apply the sub-block's 32 updates, in k order, to the
//      later columns of the row tile (held in shared memory the whole
//      launch): 8 x 4 register tiles of w, -e from shared memory, R's rows
//      from a two-stage shared-memory ring filled by cp.async one sub-block
//      ahead.
// The next sub-block's s and z are loaded into the sweeping threads'
// registers while B runs.  b = 128, 256 and 512 are compiled with the
// sub-block count fixed; any other b <= 512 runs the same kernel with it
// read at run time (columns past b are zero-filled and never stored).
// Wider blocks run `gptq_block_wide_kernel`, one warp a row over shared
// memory (the first design of this port).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSub = 32;       // columns a sub-block
constexpr int kMaxCols = 512;  // widest b of the tiled kernel
constexpr int kWideWarps = 8;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// rows [r0, r0 + rows) x columns [c0, cols_to) of a row-major (.., ld) f32
// matrix with `nr` rows and `nc` columns into shared memory at stride `lds`,
// zero outside the matrix; 16-byte copies when rows are 16-byte aligned
__device__ __forceinline__ void load_tile(float* dst, int lds, const float* src, int ld,
                                          int nr, int nc, int r0, int rows, int c0,
                                          int cols_to) {
  if ((ld & 3) == 0 && ((uintptr_t)src & 15) == 0) {
    const int quads = (cols_to - c0) >> 2;
    for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
      const int r = i / quads, c = c0 + 4 * (i % quads);
      const int gr = r0 + r;
      const int valid = gr < nr ? max(0, min(4, nc - c)) * 4 : 0;
      tgq::cp_async16(dst + r * lds + c, valid ? src + (size_t)gr * ld + c : src, valid);
    }
  } else {
    const int w = cols_to - c0;
    for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
      const int r = i / w, c = c0 + i % w;
      const int gr = r0 + r;
      const bool valid = gr < nr && c < nc;
      cp_async4(dst + r * lds + c, valid ? src + (size_t)gr * ld + c : src, valid);
    }
  }
}

template <int JT>  // sub-blocks (b / 32) fixed at compile time, 0 = read at run time
__global__ void __launch_bounds__(kThreads, 1)
gptq_block_kernel(const float* __restrict__ w, const float* __restrict__ s,
                  const float* __restrict__ z, const float* __restrict__ r,
                  float* __restrict__ q_out, float* __restrict__ e_out, int m, int b,
                  int tm, float min_q, float max_q) {
  extern __shared__ __align__(16) float sm[];
  const int J = JT ? JT : (b + kSub - 1) / kSub;
  const int B = J * kSub;  // padded width
  const int ldw = B + 4;
  const int lde = tm + 4;
  const int stage = kSub * B + 2 * tm * kSub;
  float* ws = sm;                 // tm x ldw: the row tile of w
  float* ring = ws + tm * ldw;    // 2 stages: R's 32 rows, then s and z (tm x 32 each)
  float* et = ring + 2 * stage;   // kSub x lde: -e of a sub-block, k-major
  const int row0 = blockIdx.x * tm;
  const int tid = threadIdx.x;
  const bool sweeper = tid < tm;

  // sub-block c's R rows (at their own columns) and s, z tiles into stage c & 1
  auto load_stage = [&](int c) {
    float* st = ring + (c & 1) * stage;
    const int cb = c * kSub;
    load_tile(st, B, r, b, b, b, cb, kSub, cb, B);
    load_tile(st + kSub * B - cb, kSub, s, b, m, b, row0, tm, cb, cb + kSub);
    load_tile(st + kSub * B + tm * kSub - cb, kSub, z, b, m, b, row0, tm, cb, cb + kSub);
    tgq::cp_async_commit();
  };
  load_tile(ws, ldw, w, b, m, b, row0, tm, 0, B);
  load_stage(0);

  float wr[kSub], sr[kSub], zr[kSub];  // a sweeping thread's row, one sub-block

#pragma unroll 1
  for (int c = 0; c < J; ++c) {
    const int cb = c * kSub;
    const float* rc = ring + (c & 1) * stage;  // row kk: R[cb + kk, :]
    tgq::cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < J) load_stage(c + 1);

    // A. the sub-block's 32 steps, one thread a row
    if (sweeper) {
      const bool live = row0 + tid < m;
      const float4* wrow = reinterpret_cast<const float4*>(ws + tid * ldw + cb);
      const float4* srow = reinterpret_cast<const float4*>(rc + kSub * B + tid * kSub);
      const float4* zrow = reinterpret_cast<const float4*>(rc + kSub * B + (tm + tid) * kSub);
#pragma unroll
      for (int v = 0; v < kSub / 4; ++v) {
        const float4 x = wrow[v], y = srow[v], u = zrow[v];
        wr[4 * v] = x.x;
        wr[4 * v + 1] = x.y;
        wr[4 * v + 2] = x.z;
        wr[4 * v + 3] = x.w;
        // rows past m and columns past b (zero-filled) divide 1 by 1 (see
        // below): a zero operand sends the whole warp down the division's
        // slow path
        sr[4 * v] = live && cb + 4 * v < b ? y.x : 1.f;
        sr[4 * v + 1] = live && cb + 4 * v + 1 < b ? y.y : 1.f;
        sr[4 * v + 2] = live && cb + 4 * v + 2 < b ? y.z : 1.f;
        sr[4 * v + 3] = live && cb + 4 * v + 3 < b ? y.w : 1.f;
        zr[4 * v] = u.x;
        zr[4 * v + 1] = u.y;
        zr[4 * v + 2] = u.z;
        zr[4 * v + 3] = u.w;
      }
      // R's row of each step is read one step ahead, as broadcast quads
      float rn[kSub];
#pragma unroll
      for (int v = 0; v < kSub / 4; ++v) {
        const float4 x = reinterpret_cast<const float4*>(rc + cb)[v];
        rn[4 * v] = x.x;
        rn[4 * v + 1] = x.y;
        rn[4 * v + 2] = x.z;
        rn[4 * v + 3] = x.w;
      }
#pragma unroll
      for (int l = 0; l < kSub; ++l) {
        float rrow[kSub];
#pragma unroll
        for (int lp = l; lp < kSub; ++lp) rrow[lp] = rn[lp];
        if (l + 1 < kSub) {
          const float4* nx = reinterpret_cast<const float4*>(rc + (l + 1) * B + cb);
#pragma unroll
          for (int v = (l + 1) / 4; v < kSub / 4; ++v) {
            const float4 x = nx[v];
            rn[4 * v] = x.x;
            rn[4 * v + 1] = x.y;
            rn[4 * v + 2] = x.z;
            rn[4 * v + 3] = x.w;
          }
        }
        const bool ok = live && cb + l < b;  // else never stored
        const float wk = wr[l], sk = sr[l], zk = zr[l];
        float qk = floorf(__fadd_rn(__fadd_rn(__fdiv_rn(ok ? wk : 1.f, sk), zk), 0.5f));
        qk = fminf(fmaxf(qk, min_q), max_q);
        const float rkk = cb + l < b ? rrow[l] : 1.f;
        const float ek = __fdiv_rn(ok ? __fmaf_rn(-__fsub_rn(qk, zk), sk, wk) : 1.f, rkk);
        sr[l] = qk;
        zr[l] = ek;
#pragma unroll
        for (int lp = l + 1; lp < kSub; ++lp) wr[lp] = __fmaf_rn(-ek, rrow[lp], wr[lp]);
      }
      // q into the tile's spent columns, -e k-major for the update
      float4* qrow = reinterpret_cast<float4*>(ws + tid * ldw + cb);
#pragma unroll
      for (int v = 0; v < kSub / 4; ++v)
        qrow[v] = make_float4(sr[4 * v], sr[4 * v + 1], sr[4 * v + 2], sr[4 * v + 3]);
#pragma unroll
      for (int l = 0; l < kSub; ++l) et[l * lde + tid] = -zr[l];
    }
    __syncthreads();

    // q and e of the sub-block out, a row's 32 columns a warp (coalesced)
    for (int i = tid; i < tm * kSub; i += kThreads) {
      const int rr = i / kSub, l = i % kSub, row = row0 + rr, col = cb + l;
      if (row < m && col < b) {
        q_out[(size_t)row * b + col] = ws[rr * ldw + col];
        e_out[(size_t)row * b + col] = -et[l * lde + rr];
      }
    }

    // B. the sub-block's updates of the later columns, in k order
    const int nq = (B - cb - kSub) >> 2;  // column quads after the sub-block
    for (int t = tid; t < (tm >> 3) * nq; t += kThreads) {
      const int rg = (t / nq) * 8, col = cb + kSub + 4 * (t % nq);
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(ws + (rg + i) * ldw + col);
        acc[i][0] = x.x;
        acc[i][1] = x.y;
        acc[i][2] = x.z;
        acc[i][3] = x.w;
      }
#pragma unroll 8
      for (int kk = 0; kk < kSub; ++kk) {
        const float4 e0 = *reinterpret_cast<const float4*>(et + kk * lde + rg);
        const float4 e1 = *reinterpret_cast<const float4*>(et + kk * lde + rg + 4);
        const float4 rv = *reinterpret_cast<const float4*>(rc + kk * B + col);
        const float ev[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = __fmaf_rn(ev[i], rv.x, acc[i][0]);
          acc[i][1] = __fmaf_rn(ev[i], rv.y, acc[i][1]);
          acc[i][2] = __fmaf_rn(ev[i], rv.z, acc[i][2]);
          acc[i][3] = __fmaf_rn(ev[i], rv.w, acc[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(ws + (rg + i) * ldw + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// b > 512: one warp a row, the row's w, s and z in shared memory.
__global__ void __launch_bounds__(kWideWarps * 32)
gptq_block_wide_kernel(const float* __restrict__ w, const float* __restrict__ s,
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
    const float ek = __fdiv_rn(__fmaf_rn(-__fsub_rn(qk, zk), sk, wk), rkk);
    __syncwarp();
    if (lane == 0) {
      ss[k] = qk;
      zs[k] = ek;
    }
    const float* rrow = r + (size_t)k * b;
    for (int j = k + 1 + lane; j < b; j += 32)
      ws[j] = __fmaf_rn(-ek, __ldg(rrow + j), ws[j]);
  }
  __syncwarp();
  const size_t off = (size_t)row * b;
  for (int j = lane; j < b; j += 32) {
    q_out[off + j] = ss[j];
    e_out[off + j] = zs[j];
  }
}

template <int JT>
int launch_tiled(const float* w, const float* s, const float* z, const float* r, float* q,
                 float* e, int m, int b, int tm, int smem, float min_q, float max_q,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gptq_block_kernel<JT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gptq_block_kernel<JT><<<(m + tm - 1) / tm, kThreads, smem, stream>>>(
      w, s, z, r, q, e, m, b, tm, min_q, max_q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` with the plan's row tile `tm` and shared memory bytes
// (tm = 0: the wide kernel, which sizes itself); returns the CUDA error code
// (0 = launched).
int tgq_gptq_block(const float* w, const float* s, const float* z, const float* r,
                   float* q, float* e, int m, int b, int tm, int smem, float min_q,
                   float max_q, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m <= 0 || b <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (tm > 0) {
    if (b > kMaxCols || tm % 32 || tm > kThreads) return (int)cudaErrorInvalidValue;
    switch (b) {
      case 128: return launch_tiled<4>(w, s, z, r, q, e, m, b, tm, smem, min_q, max_q, st);
      case 256: return launch_tiled<8>(w, s, z, r, q, e, m, b, tm, smem, min_q, max_q, st);
      case 512: return launch_tiled<16>(w, s, z, r, q, e, m, b, tm, smem, min_q, max_q, st);
      default: return launch_tiled<0>(w, s, z, r, q, e, m, b, tm, smem, min_q, max_q, st);
    }
  }
  // as many warps (rows) per block as fit the default shared memory; a wide
  // block falls back to fewer warps, then to opting in to more memory
  const size_t per_warp = 3 * (size_t)b * sizeof(float);
  const size_t diag = (size_t)b * sizeof(float);
  int warps = (int)((kDefaultSmem - (long)diag) / (long)per_warp);
  if (warps > kWideWarps) warps = kWideWarps;
  if (warps < 1) warps = 1;
  const size_t wide = diag + warps * per_warp;
  if (wide > (size_t)tgq::MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (wide > (size_t)kDefaultSmem) {
    err = cudaFuncSetAttribute(gptq_block_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wide);
    if (err != cudaSuccess) return (int)err;
  }
  gptq_block_wide_kernel<<<(m + warps - 1) / warps, warps * 32, wide, st>>>(
      w, s, z, r, q, e, m, b, min_q, max_q);
  return (int)cudaGetLastError();
}

}  // extern "C"
