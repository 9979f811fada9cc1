// Shared helpers of the port's CUDA kernels (plain C interface, sm_90a):
// bf16 rounding, the blends' falloff, and the tensor-core building blocks
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
//
// A thread whose pixels share one column (one dx) takes the dx terms once a
// pair (falloff_x) and each pixel's power from them (falloff_power_y): the
// same operations and roundings as falloff_power.
struct FalloffX {
  float cadx2, cbdx;   // (ca dx) dx, cb dx
};

__device__ __forceinline__ FalloffX falloff_x(float ca, float cb, float dx) {
  return {__fmul_rn(__fmul_rn(ca, dx), dx), __fmul_rn(cb, dx)};
}

__device__ __forceinline__ float falloff_power_y(FalloffX fx, float cc, float dy) {
  const float quad = __fadd_rn(fx.cadx2, __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(fx.cbdx, dy));
}

__device__ __forceinline__ float falloff_power(float ca, float cb, float cc, float dx, float dy) {
  return falloff_power_y(falloff_x(ca, cb, dx), cc, dy);
}

// A pair's reach: half-widths (ex, ey) about its centre beyond which no
// pixel's alpha reaches the 1/255 cut as the blends compute it
// (falloff_power, expf, the cut), so that a pixel, or a region of pixels,
// at |dx| > ex or |dy| > ey may skip the pair: alpha would be 0 there, T and
// the sums would not change. alpha >= 1/255 needs q = -2 power <= L =
// 2 ln(255 op), and the ellipse q <= L spans |dx| <= sqrt(L cc / det),
// |dy| <= sqrt(L ca / det), det = ca cc - cb^2. Margins: L is taken 1 %
// larger plus 0.01 (the falloff's rounding, for a correlation |cb| /
// sqrt(ca cc) <= 0.999, moves q by less than 0.08 %; expf's by 2 ulp), the
// half-widths 0.1 % larger plus 0.01 px (their own rounding, and that of a
// caller's dx, relative). -inf: no pixel anywhere (opacity below the cut);
// +inf: any pixel (a conic not safely positive definite, or not finite).
__device__ __forceinline__ float2 pair_reach(float ca, float cb, float cc, float op) {
  const float kInf = __int_as_float(0x7f800000);
  if (op < (1.f / 255.f) * 0.99999f) return make_float2(-kInf, -kInf);
  const float L = 2.02f * logf(255.f * op) + 0.01f;
  if (ca > 0.f && cc > 0.f && cb * cb <= 0.998f * (ca * cc)) {
    const float det = ca * cc - cb * cb;
    const float ex = sqrtf(L * cc / det) * 1.001f + 0.01f;
    const float ey = sqrtf(L * ca / det) * 1.001f + 0.01f;
    if (ex < kInf && ey < kInf) return make_float2(ex, ey);
  }
  return make_float2(kInf, kInf);
}

// whether the pixels [x0, x1] x [y0, y1] all lie beyond the reach r of a
// pair centred at (gx, gy) (false for NaN)
__device__ __forceinline__ bool beyond_reach(float2 r, float gx, float gy, float x0, float x1,
                                             float y0, float y1) {
  return x0 - gx > r.x || gx - x1 > r.x || y0 - gy > r.y || gy - y1 > r.y;
}

// ---- tensor-core building blocks (sm_80+ mma.sync, used on sm_90a) -------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared (L2 only, no L1 allocation)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
// 4-byte asynchronous copy global -> shared (through L1)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

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
