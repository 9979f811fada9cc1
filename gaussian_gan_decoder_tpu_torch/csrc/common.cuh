// Shared helpers of the port's CUDA kernels (plain C interface, sm_90a):
// bf16 rounding, a block sum, and the tensor-core building blocks
// (cp.async, ldmatrix, mma.sync in bf16; the split-TF32 ones are in
// tf32.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace ggd {

// round an f32 to bf16 (round to nearest even) and back: the bf16 rounding
// points of the TPU kernels, kept in f32 registers / shared memory
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.f) - (x < 0.f)); }

// the Gaussian falloff exponent -0.5 (ca dx^2 + cc dy^2) - cb dx dy of the
// blends (K3, K4, K5), rounded op by op in the order the plain versions
// evaluate it: with FMA contraction a (pair, pixel) whose alpha lies within
// an ulp of the 1/255 cut is skipped on one side and blended on the other
__device__ __forceinline__ float falloff_power(float ca, float cb, float cc, float dx, float dy) {
  const float quad =
      __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx), __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
}

// deterministic block-wide sum (every thread gets the total); red holds
// one float per warp. blockDim.x must be a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < nw; ++i) s += red[i];
  __syncthreads();
  return s;
}

// ---- tensor-core building blocks (sm_80+ mma.sync, used on sm_90a) -------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared (L2 only, no L1 allocation)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane i gives the row address of matrix i / 8,
// row i % 8. The .trans form hands each lane a column pair instead.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* d, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* d, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(row)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace ggd
