// Device code of the 5-head decoder chain shared by K2 (slab_decode.cu,
// bf16 staging) and K6/K7 (heads_train.cu, f32): the GELU variants, the
// exact GELU's derivative, softplus, and the 128-wide hidden layer of a
// 64-point block.
#pragma once

#include "common.cuh"

namespace ggd {

constexpr int kStage = 128;   // staging width
constexpr int kLds = 132;     // padded row stride of staging/hidden tiles (bank spread)
constexpr int kOutW = 16;     // padded head-output width
constexpr int kInitCol = 120; // raw init_position stash (3 columns)

// GELU ids (decoder/pallas_heads.py _GELU_IDS): 0 exact (A&S 7.1.26 erf),
// 1 tanh, 2 poly (deg 9 in x^2), 3 poly6, 4 none
static __constant__ float kGeluPoly[10] = {2.83848659e-05f, 3.98631713e-01f, -6.59243150e-02f,
                                    9.56686907e-03f, -1.03506464e-03f, 8.13021533e-05f,
                                    -4.45819445e-06f, 1.60138706e-07f, -3.35935034e-09f,
                                    3.10310371e-11f};
static __constant__ float kGeluPoly6[7] = {1.78927555e-03f, 3.88399878e-01f, -5.61855200e-02f,
                                    5.99722169e-03f, -3.76970754e-04f, 1.25452394e-05f,
                                    -1.69796236e-07f};

__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.f) - (x < 0.f)); }

// A&S 7.1.26 erf, the TPU kernels' erf
__device__ __forceinline__ float erf_as(float x) {
  const float a = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  return sgn(x) * (1.f - poly * expf(-a * a));
}

__device__ __forceinline__ float horner_gelu(float x, const float* c, int n) {
  const float u = x * x;
  float acc = c[n - 1];
  for (int i = n - 2; i >= 0; --i) acc = acc * u + c[i];
  const float y = 0.5f * x + acc;
  return x > 4.5f ? x : (x < -4.5f ? 0.f : y);
}

__device__ __forceinline__ float gelu(float x, int kind) {
  switch (kind) {
    case 0: return x * 0.5f * (1.f + erf_as(x * 0.70710678118654752f));
    case 1: {
      const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      const float e = expf(-2.f * fabsf(u));
      const float t = (1.f - e) / (1.f + e);
      return 0.5f * x * (1.f + sgn(u) * t);
    }
    case 2: return horner_gelu(x, kGeluPoly, 10);
    case 3: return horner_gelu(x, kGeluPoly6, 7);
    default: return x;
  }
}

constexpr int kGeluExact = 0;

// d gelu / dx of the exact GELU on the A&S erf (decoder/pallas_heads_vjp.py
// _GELU_GRADS['exact']), the only GELU the training chain differentiates
__device__ __forceinline__ float gelu_exact_grad(float x) {
  const float cdf = 0.5f * (1.f + erf_as(x * 0.70710678118654752f));
  return cdf + x * 0.3989422804014327f * expf(-0.5f * x * x);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// out = gelu(in @ W + b) for a 64 x 128 x 128 layer of a 256-thread block,
// thread tile 4 x 8; rounded to bf16 when kRound (K2's rounding points).
// in/out rows have stride kLds, sW is 128 x 128 (in, out).
template <bool kRound>
__device__ __forceinline__ void hidden_layer(const float* in, float* out, const float* sW,
                                             const float* sBias, int gelu_kind) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kStage; ++k) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = in[(ty * 4 + i) * kLds + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = sW[k * kStage + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      const float v = gelu(acc[i][j] + sBias[n], gelu_kind);
      out[(ty * 4 + i) * kLds + n] = kRound ? bf16r(v) : v;
    }
}

}  // namespace ggd
