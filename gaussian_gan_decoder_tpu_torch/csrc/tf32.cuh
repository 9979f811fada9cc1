// f32-accurate products on the tensor cores ("3xTF32") and the f32 exact
// GELU, shared by the training chain's kernels K6 and K7 (heads_train.cu):
// the operand split, the 3xTF32 mma.sync, the cp.async weight ring and the
// exact GELU with its derivative.
#pragma once

#include "common.cuh"

namespace ggd {

// c (16x8 f32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo with both parts tf32 ("3xTF32": hi*hi + hi*lo + lo*hi keeps
// about f32 accuracy; the lo*lo term is below f32 rounding)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// c += a * b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ahi, const uint32_t* alo,
                                           uint32_t bhi0, uint32_t bhi1, uint32_t blo0,
                                           uint32_t blo1) {
  mma_tf32(c, alo, bhi0, bhi1);
  mma_tf32(c, ahi, blo0, blo1);
  mma_tf32(c, ahi, bhi0, bhi1);
}

// Rows [0, rows) of a kWidth-wide f32 matrix -> dst (row stride kLd
// floats) as 16-byte cp.async chunks, by the kThreads threads of the
// block. With kSwizzle the chunks of row k land XOR-ed by bits 2-3 of k
// (word n of the row at n ^ (8 ((k >> 2) & 3))): the rows 4 apart that one
// fragment load reads then fall on distinct banks without padding.
template <int kWidth, int kLd, bool kSwizzle, int kThreads>
__device__ __forceinline__ void cp_rows(float* dst, const float* src, int rows) {
  constexpr int kChunks = kWidth / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    cp_async16(dst + r * kLd + (kSwizzle ? c ^ (((r >> 2) & 3) << 3) : c),
               src + r * kWidth + c);
  }
}

// One step of a cp.async weight ring: wait for this thread's copies, then
// a barrier (the landed stage is visible to every warp, and every warp is
// done with the slot that fetch() refills), then fetch() starts the next
// copies, committed as one group.
template <class Fetch>
__device__ __forceinline__ void ring_step(Fetch&& fetch) {
  cp_async_wait_all();
  __syncthreads();
  fetch();
  cp_async_commit();
}

// the A&S 7.1.26 erf(a) = 1 - poly(a) exp(-a^2) for a >= 0: poly, with the
// fast reciprocal (2 ulp; the IEEE division is a subroutine call whose
// stack frame made these register-bound kernels spill)
__device__ __forceinline__ float erf_as_poly(float a) {
  const float t = __fdividef(1.f, 1.f + 0.3275911f * a);
  return t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
         t * (-1.453152027f + t * 1.061405429f))));
}

// exact GELU (on the A&S erf) and its derivative from one erf and one exp
// (K7): cdf = (1 + erf(x / sqrt 2)) / 2, gelu = x cdf, gelu' = cdf + x
// phi(x); the A&S erf's exp(-(x / sqrt 2)^2) is phi(x) sqrt(2 pi)
__device__ __forceinline__ float gelu_and_grad(float x, float& grad) {
  const float a = fabsf(x * 0.70710678118654752f);
  const float poly = erf_as_poly(a);
  const float ex = expf(-a * a);
  const float cdf = 0.5f * (1.f + sgn(x) * (1.f - poly * ex));
  grad = cdf + x * 0.3989422804014327f * ex;
  return x * cdf;
}

// exact GELU alone (K6): the same erf with the fast exp (2 ulp plus
// 2^-21 of its argument) and a copysign for the sign product, ~1e-7 of
// the value from gelu_and_grad's
__device__ __forceinline__ float gelu_exact(float x) {
  const float a = fabsf(x) * 0.70710678118654752f;
  return x * (0.5f + copysignf(0.5f - 0.5f * erf_as_poly(a) * __expf(-a * a), x));
}

}  // namespace ggd
