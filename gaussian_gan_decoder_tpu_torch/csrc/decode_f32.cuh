// The bodies of the f32 decode kernels (decode_f32.cu holds their entries
// and the projection kernel): the three decode kernels, each a template of
// the GELU kind, and DecodeF32<kGelu>, whose members launch them. Each
// GELU kind's instances are compiled in a file of their own
// (decode_f32_gelu_*.cu: `template struct ggd::DecodeF32<kind>;`), so that
// nvcc builds the 5 kinds x 7 forms in parallel.
#pragma once

#include "chain_tf32.cuh"
#include "gather.cuh"

namespace ggd {

namespace f32dec {

// Block prologue of the three entries: the block's n_rows rows of the f32
// staging (Mpad x 128) from column kC0 on (the gather fills 0:kC0) by
// cp.async, in flight with the chain's stage 0 and head 0's W4
// (chain_f32_setup commits them as one group); the rest of the tile zero.
// The rows land by the chain's first barrier (or the caller's own wait).
template <int kC0>
__device__ __forceinline__ void prologue(const F32Smem& s, int* sMeta, const ChainF32& cw,
                                         const float* __restrict__ wsplit,
                                         const int* __restrict__ meta,
                                         const float* __restrict__ staging, int m0, int n_rows) {
  constexpr int kChunks = (kStage - kC0) / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < kF32Pts * kChunks; i += kF32Threads) {
    const int r = i / kChunks, c = kC0 + (i % kChunks) * 4;
    if (r < n_rows)
      cp_async16(s.X + r * kF32Ld + c, staging + (size_t)(m0 + r) * kStage + c);
    else
      *reinterpret_cast<float4*>(s.X + r * kF32Ld + c) = zero;
  }
  if constexpr (kC0 > 0)
    for (int i = n_rows * (kC0 / 4) + threadIdx.x; i < kF32Pts * (kC0 / 4); i += kF32Threads)
      *reinterpret_cast<float4*>(s.X + i / (kC0 / 4) * kF32Ld + i % (kC0 / 4) * 4) = zero;
  chain_f32_setup(s, sMeta, cw, wsplit, meta, meta[0]);
}

// The chain over the tile, then its packed outputs as rows 0:16 of out
// (project_rows_kernel writes the rest)
template <int kGelu>
__device__ __forceinline__ void tail(const F32Smem& s, const int* sMeta, const ChainF32& cw,
                                     const float* __restrict__ wsplit,
                                     const int* __restrict__ meta, float* __restrict__ out,
                                     int Mpad, int m0, float scale_offset) {
  chain_f32<kGelu>(s, sMeta, meta, cw, wsplit, meta[0], scale_offset);
  __syncthreads();
  for (int i = threadIdx.x; i < kOutW * kF32Pts; i += kF32Threads) {
    const int r = i / kF32Pts, p = i % kF32Pts;
    if (m0 + p < Mpad) out[(size_t)r * Mpad + m0 + p] = s.X[p * kF32Ld + kF32OutCol + r];
  }
}

// a thread's points in the gather: 4 threads a point, 8 channels each
constexpr int kItems = kF32Pts * 4 / kF32Threads;

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <int kGelu>
__global__ void __launch_bounds__(kF32Threads, 1) brick_decode_f32_kernel(
    const float* __restrict__ staging, const ChainF32 cw, const float* __restrict__ wsplit,
    const int* __restrict__ meta, float* __restrict__ out, int Mpad, float scale_offset) {
  extern __shared__ __align__(16) float smem[];
  const F32Smem s = f32_smem(smem);
  __shared__ int sMeta[32];
  const int m0 = blockIdx.x * kF32Pts;
  prologue<0>(s, sMeta, cw, wsplit, meta, staging, m0, min(kF32Pts, Mpad - m0));
  tail<kGelu>(s, sMeta, cw, wsplit, meta, out, Mpad, m0, scale_offset);
}

// K9: the features are gathered while the staging and the weights arrive,
// and written to columns 0:32, which no copy touches (seen by layer 1
// after the chain's first barrier). The item loop stays rolled: a block
// runs its gather once, so its code is fetched cold; one item's code run
// twice fetches half of it (scripts/f32_decode_ablation.py: unrolled costs
// 0.16-0.25 ms a call on the int8 forms)
template <int kGelu, int kCorners, typename Row, bool kDots>
__global__ void __launch_bounds__(kF32Threads, 1) fused_decode_f32_kernel(
    const float* __restrict__ aux, const Row* __restrict__ rows0, const Row* __restrict__ rows1,
    const Row* __restrict__ rows2, const float* __restrict__ wts,
    const float* __restrict__ scale_rows, const ChainF32 cw, const float* __restrict__ wsplit,
    const int* __restrict__ meta, float* __restrict__ out, int Mpad, float scale_offset) {
  extern __shared__ __align__(16) float smem[];
  const F32Smem s = f32_smem(smem);
  __shared__ int sMeta[32];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kF32Pts;
  const int n_rows = min(kF32Pts, Mpad - m0);
  prologue<kFeatC>(s, sMeta, cw, wsplit, meta, aux, m0, n_rows);
#pragma unroll 1
  for (int k = 0; k < kItems; ++k) {
    const int pt = (tid >> 2) + k * (kF32Threads / 4);
    if (pt < n_rows) {
      float acc[8];
      fused_point_features<kCorners, Row, kDots>(rows0, rows1, rows2, wts, scale_rows, m0 + pt,
                                                 tid & 3, Mpad, acc);
      store8(s.X + pt * kF32Ld + (tid & 3) * 8, acc);
    }
  }
  tail<kGelu>(s, sMeta, cw, wsplit, meta, out, Mpad, m0, scale_offset);
}

// K2: the corners are gathered while the staging arrives; a slot's
// features are zero where the staging's valid column is not
template <int kGelu, bool kBilinear>
__global__ void __launch_bounds__(kF32Threads, 1) slab_decode_f32_kernel(
    const int8_t* __restrict__ vol, const float* __restrict__ scale_rows,
    const float* __restrict__ positions, const int16_t* __restrict__ idx16,
    const float* __restrict__ aux, const float* __restrict__ inv_axes, const ChainF32 cw,
    const float* __restrict__ wsplit, const int* __restrict__ meta, float* __restrict__ out,
    int Mpad, int D, int H, int W, int DZ, int YP, int XP, float box_warp, float scale_offset) {
  extern __shared__ __align__(16) float smem[];
  const F32Smem s = f32_smem(smem);
  __shared__ int sMeta[32];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kF32Pts;
  const int n_rows = min(kF32Pts, Mpad - m0);
  prologue<kFeatC>(s, sMeta, cw, wsplit, meta, aux, m0, n_rows);
  float acc[kItems][8];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int pt = (tid >> 2) + k * (kF32Threads / 4);
    if (pt < n_rows)
      slab_point_features<kBilinear>(vol, scale_rows, positions, idx16, inv_axes, m0 + pt,
                                     tid & 3, D, H, W, DZ, YP, XP, box_warp, acc[k]);
  }
  cp_async_wait_all();   // the valid column
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int pt = (tid >> 2) + k * (kF32Threads / 4);
    if (pt < n_rows) {
      if (!(s.X[pt * kF32Ld + kValidCol] > 0.f))
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[k][c] = 0.f;
      store8(s.X + pt * kF32Ld + (tid & 3) * 8, acc[k]);
    }
  }
  tail<kGelu>(s, sMeta, cw, wsplit, meta, out, Mpad, m0, scale_offset);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kF32SmemBytes);
}

inline int n_blocks(int Mpad) { return (Mpad + kF32Pts - 1) / kF32Pts; }

template <int kGelu, int kCorners, typename Row, bool kDots>
cudaError_t launch_fused(const float* aux, const void* rows0, const void* rows1,
                         const void* rows2, const float* wts, const float* scale_rows,
                         const ChainF32& cw, const float* wsplit, const int* meta, float* out,
                         int Mpad, float scale_offset, cudaStream_t s) {
  auto kernel = fused_decode_f32_kernel<kGelu, kCorners, Row, kDots>;
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks(Mpad), kF32Threads, kF32SmemBytes, s>>>(
      aux, (const Row*)rows0, (const Row*)rows1, (const Row*)rows2, wts, scale_rows, cw, wsplit,
      meta, out, Mpad, scale_offset);
  return cudaGetLastError();
}

template <int kGelu, bool kBilinear>
cudaError_t launch_slab(const int8_t* vol, const float* scale_rows, const float* positions,
                        const int16_t* idx16, const float* aux, const float* inv_axes,
                        const ChainF32& cw, const float* wsplit, const int* meta, float* out,
                        int Mpad, int D, int H, int W, int DZ, int YP, int XP, float box_warp,
                        float scale_offset, cudaStream_t s) {
  auto kernel = slab_decode_f32_kernel<kGelu, kBilinear>;
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks(Mpad), kF32Threads, kF32SmemBytes, s>>>(
      vol, scale_rows, positions, idx16, aux, inv_axes, cw, wsplit, meta, out, Mpad, D, H, W, DZ,
      YP, XP, box_warp, scale_offset);
  return cudaGetLastError();
}

}  // namespace f32dec

// The launches of one GELU kind's decode kernels (the projection follows
// in decode_f32.cu): K8, K9 in its four forms (8 int8 or 4 bf16 corners,
// 'dots' or 'bcast'), K2 in its two (bilinear at depth 1)
template <int kGelu>
struct DecodeF32 {
  static cudaError_t brick(const float* staging, const ChainF32& cw, const float* wsplit,
                           const int* meta, float* out, int Mpad, float scale_offset,
                           cudaStream_t s);
  static cudaError_t fused(const float* aux, const void* rows0, const void* rows1,
                           const void* rows2, const float* wts, const float* scale_rows,
                           const ChainF32& cw, const float* wsplit, const int* meta, float* out,
                           int Mpad, int corners, bool dots, float scale_offset, cudaStream_t s);
  static cudaError_t slab(const int8_t* vol, const float* scale_rows, const float* positions,
                          const int16_t* idx16, const float* aux, const float* inv_axes,
                          const ChainF32& cw, const float* wsplit, const int* meta, float* out,
                          int Mpad, int D, int H, int W, int DZ, int YP, int XP, float box_warp,
                          float scale_offset, cudaStream_t s);
};

template <int kGelu>
cudaError_t DecodeF32<kGelu>::brick(const float* staging, const ChainF32& cw,
                                    const float* wsplit, const int* meta, float* out, int Mpad,
                                    float scale_offset, cudaStream_t s) {
  auto kernel = f32dec::brick_decode_f32_kernel<kGelu>;
  cudaError_t err = f32dec::allow_smem(kernel);
  if (err != cudaSuccess) return err;
  kernel<<<f32dec::n_blocks(Mpad), kF32Threads, kF32SmemBytes, s>>>(staging, cw, wsplit, meta,
                                                                     out, Mpad, scale_offset);
  return cudaGetLastError();
}

template <int kGelu>
cudaError_t DecodeF32<kGelu>::fused(const float* aux, const void* rows0, const void* rows1,
                                    const void* rows2, const float* wts,
                                    const float* scale_rows, const ChainF32& cw,
                                    const float* wsplit, const int* meta, float* out, int Mpad,
                                    int corners, bool dots, float scale_offset,
                                    cudaStream_t s) {
#define GGD_FUSED_F32(K, ROW, DOTS)                                                          \
  return f32dec::launch_fused<kGelu, K, ROW, DOTS>(aux, rows0, rows1, rows2, wts, scale_rows, \
                                                   cw, wsplit, meta, out, Mpad,               \
                                                   scale_offset, s)
  if (corners == 8) {
    if (dots) GGD_FUSED_F32(8, int8_t, true);
    GGD_FUSED_F32(8, int8_t, false);
  }
  if (dots) GGD_FUSED_F32(4, __nv_bfloat16, true);
  GGD_FUSED_F32(4, __nv_bfloat16, false);
#undef GGD_FUSED_F32
}

template <int kGelu>
cudaError_t DecodeF32<kGelu>::slab(const int8_t* vol, const float* scale_rows,
                                   const float* positions, const int16_t* idx16,
                                   const float* aux, const float* inv_axes, const ChainF32& cw,
                                   const float* wsplit, const int* meta, float* out, int Mpad,
                                   int D, int H, int W, int DZ, int YP, int XP, float box_warp,
                                   float scale_offset, cudaStream_t s) {
  auto go = D == 1 ? f32dec::launch_slab<kGelu, true> : f32dec::launch_slab<kGelu, false>;
  return go(vol, scale_rows, positions, idx16, aux, inv_axes, cw, wsplit, meta, out, Mpad, D, H,
            W, DZ, YP, XP, box_warp, scale_offset, s);
}

}  // namespace ggd
