// K1: fused StyleGAN2 mapping chain (inference, batch <= 8).
//
// Replaces the TPU kernel gaussian_gan_decoder_tpu/models/pallas_mapping.py
// ::mapping_forward_pallas (_mapping_kernel). Computes, for every batch row:
//   x = z * rsqrt(mean(z^2) + 1e-8)
//   y = bf16(c) @ we + be ; y *= rsqrt(mean(y^2) + 1e-8) ; x = [x, y]
//   x = lrelu(bf16(x) @ w_l + b_l) * sqrt(2)   for the 8 layers
//   out = w_avg + (x - w_avg) * psi
// with bf16 weights (lr_mult/gain folded in by the host) and activations
// rounded to bf16 before each product.
//
// Sums: every sum (each layer's and the embed's dot products, both norms'
// sums of squares) is taken in float64 and rounded once to f32 where the
// TPU kernel holds an f32. A product of two bf16 values, or an f32 squared,
// is exact in float64, so each sum is exact or within 1e-16 of it in any
// order, and its f32 rounding does not depend on the order: the plain
// version (models/pallas_mapping.py::mapping_forward_plain) takes the same
// sums through float64 matmuls and gets the same bits. With f32 sums the
// two orders flipped a bf16 rounding now and then, which 9 layers carried
// to 2.9e-3 of the output at width 512 with a random camera. Each norm's
// factor is 1 / sqrt in float64 rounded to f32 (both IEEE, correctly
// rounded); bias, lrelu, the bf16 roundings and the truncation lerp are f32
// operations in the plain version's order (no FMA contraction).
//
// Bound on the H100: the latency of 8 dependent layers; the bytes (4.7 MB
// of bf16 weights at the flagship's width 512) take 1.4 us at 3.35 TB/s and
// the FLOPs are ~8 MFLOP at batch 1 (float64 FMAs run at half the f32 rate,
// ~16k a block a layer). Design: one cooperative launch of up to
// one block per SM (132 on the H100). Block i owns Cb = W / nblk output
// columns (4 at W 512) of every layer and at its start copies all of its
// weight columns (fc0's rows and fc1..fc7's, 37 KB at W 512) into shared
// memory by cp.async, so the whole weight set arrives at once across the
// card. Every block computes the z norm and the c embed with its norm
// itself (the embed's 25 x W weights are read by every block), which needs
// no barrier; each layer's bf16-rounded activations (B x W f32) pass to the
// next through global memory (L2) with one grid barrier a layer. A layer
// splits its K-long sums over the block's threads, each thread summing its
// k's in order, then a fixed-order warp and block reduction: the same bits
// from run to run.
//
// Before (one block of 256 threads on one SM; each thread two columns of
// 1024 or 512 dependent 2-byte loads from device memory, one after another)
// and after: 1 -> 128 SMs at W 512; the weights arrive in one wave of
// independent cp.async copies instead of ~9 x 1024 serial round trips.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;
constexpr int kGroup = 4;   // output columns a thread sums per pass
constexpr int kRed = kWarps * kMaxB * kGroup;   // float64 partials of a pass

// floats of shared memory before the weight columns: the float64
// reduction buffer, layer 0's input (B x IN), padded to 16 bytes
__host__ __device__ __forceinline__ int base_floats(int x0_floats) {
  return (2 * kRed + x0_floats + 3) / 4 * 4;
}

// deterministic block-wide float64 sum (every thread gets the total)
__device__ __forceinline__ double block_sum64(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  for (int i = 0; i < kWarps; ++i) s += red[i];
  __syncthreads();
  return s;
}

// a norm's factor: 1 / sqrt(sum / n + eps) with the sum rounded to f32, the
// mean and eps in f32, 1 / sqrt in float64 rounded once to f32
__device__ __forceinline__ float norm_factor(double sum_sq, int n) {
  const float m = __fadd_rn(__fdiv_rn((float)sum_sq, (float)n), 1e-8f);
  return (float)(1.0 / sqrt((double)m));
}

struct MapArgs {
  const float* z;
  const float* c;
  const __nv_bfloat16* we;
  const float* be;
  const __nv_bfloat16* w0;
  const float* b0;
  const __nv_bfloat16* wr;
  const float* br;
  const float* wavg;
  float psi;
  float* out;
  float* act;   // 2 x B x W: the layer outputs, ping-pong
  int B, Z, Cd, W, n_rest;
  int Cb;       // output columns a block owns
  int unit;     // bf16 elements a cp.async copies (4, 2; 1: plain loads)
  int resident; // the block's weight columns are in shared memory
};

// the block's columns [j0, j0 + ncol) of rows [0, K) of a (K, W) bf16 matrix
// -> dst (K x Cb), by `unit`-element copies
__device__ __forceinline__ void copy_columns(__nv_bfloat16* dst, const __nv_bfloat16* w, int K,
                                             int W, int Cb, int j0, int ncol, int unit) {
  const int per_row = (ncol + unit - 1) / unit;
  for (int i = threadIdx.x; i < K * per_row; i += kThreads) {
    const int k = i / per_row, c = (i % per_row) * unit;
    const __nv_bfloat16* src = w + (size_t)k * W + j0 + c;
    __nv_bfloat16* d = dst + k * Cb + c;
    if (unit == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(ggd::smem_u32(d)),
                   "l"(src));
    } else if (unit == 2) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(ggd::smem_u32(d)),
                   "l"(src));
    } else {
      *d = *src;
    }
  }
}

// One layer: v[b][j] = sum_k x[b][k] w[k][j] (float64, rounded to f32) for
// the block's columns, then
// + bias, lrelu * sqrt 2, and either the bf16-rounded activation to xout
// or (last) the truncation lerp to out. x is (B, K) with row stride ldx, in
// shared memory (layer 0) or global memory written by other blocks
// (read through L2: kGlobalX); w is the block's (K, Cb) columns with row
// stride ldw, in shared or in global memory.
template <bool kGlobalX>
__device__ __forceinline__ void layer(const MapArgs& a, const float* x, int ldx, int K,
                                      const __nv_bfloat16* w, int ldw, const float* bias,
                                      float* xout, bool last, int j0, int ncol, double* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float kSqrt2 = 1.41421356237309515f;
  for (int c0 = 0; c0 < ncol; c0 += kGroup) {
    double acc[kMaxB][kGroup];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
#pragma unroll
      for (int c = 0; c < kGroup; ++c) acc[b][c] = 0.0;
    for (int k = tid; k < K; k += kThreads) {
      double xv[kMaxB];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        xv[b] = 0.0;
        if (b < a.B) {
          if constexpr (kGlobalX)
            xv[b] = __ldcg(x + b * ldx + k);
          else
            xv[b] = x[b * ldx + k];
        }
      }
      const __nv_bfloat16* wk = w + (size_t)k * ldw + c0;
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        if (c0 + c < ncol) {
          const double wv = ggd::bf16f(wk[c]);
          // bf16 x bf16 is exact in float64: the FMA adds the exact product
#pragma unroll
          for (int b = 0; b < kMaxB; ++b) acc[b][c] = fma(xv[b], wv, acc[b][c]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b >= a.B) break;
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        double v = acc[b][c];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) red[(warp * kMaxB + b) * kGroup + c] = v;
      }
    }
    __syncthreads();
    if (tid < a.B * kGroup) {
      const int b = tid / kGroup, c = tid % kGroup, j = j0 + c0 + c;
      if (c0 + c < ncol) {
        double s = 0.0;
        for (int wi = 0; wi < kWarps; ++wi) s += red[(wi * kMaxB + b) * kGroup + c];
        float v = __fadd_rn((float)s, bias[j]);
        // one of the two terms is 0: exact, contracted or not
        v = __fmul_rn(fmaxf(v, 0.f) + 0.2f * fminf(v, 0.f), kSqrt2);
        if (last)
          a.out[b * a.W + j] = __fadd_rn(a.wavg[j], __fmul_rn(__fsub_rn(v, a.wavg[j]), a.psi));
        else
          __stcg(xout + b * a.W + j, ggd::bf16r(v));
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) mapping_kernel(MapArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, Z = a.Z, Cd = a.Cd, W = a.W;
  const int IN = Z + (Cd > 0 ? W : 0);
  double* red = reinterpret_cast<double*>(smem);     // kWarps x kMaxB x kGroup
  float* x0 = smem + 2 * kRed;                       // B x IN: layer 0's input
  // the block's weight columns, layer after layer, from a 16-byte boundary
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + base_floats(B * IN));
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * a.Cb;
  const int ncol = min(a.Cb, W - j0);

  // the block's weight columns of every layer, in flight while the norms
  // and the embed are computed
  if (a.resident) {
    copy_columns(wsm, a.w0, IN, W, a.Cb, j0, ncol, a.unit);
    for (int l = 1; l <= a.n_rest; ++l)
      copy_columns(wsm + (size_t)(IN + (l - 1) * W) * a.Cb, a.wr + (size_t)(l - 1) * W * W, W, W,
                   a.Cb, j0, ncol, a.unit);
    ggd::cp_async_commit();
  }

  // an f32 squared is exact in float64
  for (int b = 0; b < B; ++b) {
    double ss = 0.0;
    for (int i = tid; i < Z; i += kThreads) {
      const double v = a.z[b * Z + i];
      ss = fma(v, v, ss);
    }
    const float r = norm_factor(block_sum64(ss, red), Z);
    for (int i = tid; i < Z; i += kThreads)
      x0[b * IN + i] = ggd::bf16r(__fmul_rn(a.z[b * Z + i], r));
  }
  if (Cd > 0) {
    for (int j = tid; j < W; j += kThreads) {
      double acc[kMaxB];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) acc[b] = 0.0;
      for (int i = 0; i < Cd; ++i) {
        const double wv = ggd::bf16f(a.we[(size_t)i * W + j]);
#pragma unroll
        for (int b = 0; b < kMaxB; ++b)
          if (b < B) acc[b] = fma((double)ggd::bf16r(a.c[b * Cd + i]), wv, acc[b]);
      }
#pragma unroll
      for (int b = 0; b < kMaxB; ++b)
        if (b < B) x0[b * IN + Z + j] = __fadd_rn((float)acc[b], a.be[j]);
    }
    for (int b = 0; b < B; ++b) {
      double ss = 0.0;
      for (int j = tid; j < W; j += kThreads) {
        const double v = x0[b * IN + Z + j];
        ss = fma(v, v, ss);
      }
      const float r = norm_factor(block_sum64(ss, red), W);
      for (int j = tid; j < W; j += kThreads)
        x0[b * IN + Z + j] = ggd::bf16r(__fmul_rn(x0[b * IN + Z + j], r));
    }
  }
  ggd::cp_async_wait_all();
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  for (int l = 0; l <= a.n_rest; ++l) {
    const int K = l == 0 ? IN : W;
    const __nv_bfloat16* w;
    int ldw;
    if (a.resident) {
      w = wsm + (size_t)(l == 0 ? 0 : IN + (l - 1) * W) * a.Cb;
      ldw = a.Cb;
    } else {
      w = (l == 0 ? a.w0 : a.wr + (size_t)(l - 1) * W * W) + j0;
      ldw = W;
    }
    const float* bias = l == 0 ? a.b0 : a.br + (size_t)(l - 1) * W;
    float* xout = a.act + (size_t)(l & 1) * B * W;
    const bool last = l == a.n_rest;
    if (l == 0)
      layer<false>(a, x0, IN, K, w, ldw, bias, xout, last, j0, ncol, red);
    else
      layer<true>(a, a.act + (size_t)((l - 1) & 1) * B * W, W, K, w, ldw, bias, xout, last, j0,
                  ncol, red);
    if (!last) grid.sync();   // every block's columns of this layer are written
  }
}

}  // namespace

// act: 2 x B x W f32 scratch. One cooperative launch of ceil(W / Cb)
// blocks, at most one per SM; refused (cudaErrorCooperativeLaunchTooLarge)
// when they cannot all be resident at once.
extern "C" int ggd_mapping_forward(const void* z, const void* c, const void* we,
                                   const void* be, const void* w0, const void* b0,
                                   const void* wr, const void* br, const void* wavg,
                                   float psi, void* out, void* act, int B, int Z, int Cd, int W,
                                   int n_rest, void* stream) {
  if (B < 1 || B > kMaxB || Z < 1 || W < 1 || n_rest < 0) return (int)cudaErrorInvalidValue;
  int dev, n_sm, smem_max, coop;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  MapArgs a{(const float*)z, (const float*)c, (const __nv_bfloat16*)we, (const float*)be,
            (const __nv_bfloat16*)w0, (const float*)b0, (const __nv_bfloat16*)wr,
            (const float*)br, (const float*)wavg, psi, (float*)out, (float*)act,
            B, Z, Cd, W, n_rest, 0, 1, 0};
  // columns a block: W over the SMs, even (or a multiple of 4) where W
  // allows copies of 4 (8) bytes
  a.Cb = (W + n_sm - 1) / n_sm;
  if (W % 2 == 0) a.Cb += a.Cb % 2;
  if (W % 4 == 0 && a.Cb > 2) a.Cb += (4 - a.Cb % 4) % 4;
  a.unit = (W % 4 == 0 && a.Cb % 4 == 0) ? 4 : ((W % 2 == 0 && a.Cb % 2 == 0) ? 2 : 1);
  const int nblk = (W + a.Cb - 1) / a.Cb;
  const int IN = Z + (Cd > 0 ? W : 0);
  const size_t base = (size_t)base_floats(B * IN) * sizeof(float);
  const size_t weights = (size_t)(IN + n_rest * W) * a.Cb * sizeof(__nv_bfloat16);
  a.resident = base + weights <= (size_t)smem_max;
  const size_t smem = base + (a.resident ? weights : 0);
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(mapping_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mapping_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm * n_sm < nblk) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((void*)mapping_kernel, dim3(nblk), dim3(kThreads), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
