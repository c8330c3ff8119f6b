// Device helpers shared by the port's kernels: the cp.async copy ring
// (16-byte asynchronous copies into shared memory), 32-bit shared-memory
// reads, ldmatrix, bf16 pair packing and the chunk-order walk of a packed
// group (see dequant_matmul.cu: a chunk's position κ = e·uc + v is field e
// of code unit v).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tgq {

constexpr int MAX_SMEM = 227 * 1024;  // dynamic shared memory a block may use

// code row stride in shared memory for a bn-column tile: bn + 16 bytes, so
// the rows a warp's lanes read at once spread over the banks
__host__ __device__ constexpr int code_stride(int bn) { return bn + 16; }

template <int BITS>
struct Fmt {
  // codes per unit (a byte row; int3: a row of each plane)
  static constexpr int PER = BITS == 3 ? 8 : 8 / BITS;
};

// 16 bytes global -> shared; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// 8x8 b16 matrices from shared memory: lane l gives the row address of
// matrix l / 8; lane (gid, tig) receives row gid, elements 2·tig, 2·tig + 1
// (bytes 4·tig .. 4·tig + 3)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint8_t* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const uint8_t* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// (e, v) of chunk position κ advanced past the end of run e
__device__ __forceinline__ void wrap(int& e, int& v, int uc) {
  while (v >= uc) {
    v -= uc;
    ++e;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// opt a kernel into more than 48 KB of dynamic shared memory, once per device
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kern, int smem, int device, bool (&done)[64]) {
  if (smem <= 48 * 1024 || device < 0 || device >= 64 || done[device]) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e == cudaSuccess) done[device] = true;
  return e;
}

}  // namespace tgq
