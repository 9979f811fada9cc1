// K8 and K9: the brick route's fused decode — the 5-head decoder chain and
// the EWA projection over a bf16 staging, channel-major rows out.
//
// K8 (brick_decode_kernel) replaces the TPU kernel
// gaussian_gan_decoder_tpu/decoder/pallas_heads.py::decode_project_pallas
// (_heads_project_kernel + _chain_project_body): the staging (features,
// position conditioning, init position; bf16, pad slots zero) is prebuilt in
// device memory; each 64-point block loads its rows into the shared staging
// and runs chain.cuh's chain_project_tail, the tail K2 runs.
//
// K9 (fused_decode_kernel) replaces decode_project_pallas_fused
// (_sample_heads_project_kernel, its 'bcast' lerp form): the staging's
// feature columns are built in the kernel from the raw brick rows. Per point
// and plane it reads the 256-byte brick row (8 corners x 32 int8 channels)
// and the 8 mask-folded corner weights, accumulates sum_c row_c * w_c in
// f32, multiplies by the per-(plane, channel) dequant scale with the 1/3
// plane mean folded in, sums the planes, rounds the mean to bf16 into
// columns 0:32, then runs the same tail. 4 threads per point, 8 channels
// each (one 8-byte load per corner).
//
// Numerics are K2's: bf16 weights and staging, hidden activations rounded
// to bf16, f32 accumulation. The cull is the TPU kernels': only `visible`
// is masked, by column < n_points; there is no valid column.
//
// Bound on the H100: the chain's FLOPs (~1e5 per point) on the CUDA cores;
// K9 also reads ~0.8 KB of brick rows and weights per point, level with its
// FLOP bound at the bf16 tensor-core rate. Tensor-core MMA is a later step.
#include "chain.cuh"

namespace {

using ggd::kDecPts;
using ggd::kDecThreads;
using ggd::kLds;

constexpr int kC = 32;        // channels per plane
constexpr int kCorners = 8;   // tri-grid corners per brick row

__global__ void __launch_bounds__(kDecThreads) brick_decode_kernel(
    const __nv_bfloat16* __restrict__ staging, const ggd::DecodeChain cw,
    float* __restrict__ out, int Mpad, int n_points, float scale_offset) {
  extern __shared__ float smem[];
  const ggd::DecodeSmem s = ggd::decode_smem(smem);
  __shared__ int sMeta[32];
  const int m0 = blockIdx.x * kDecPts;
  ggd::decode_prologue(s, sMeta, cw, staging, m0);
  ggd::chain_project_tail(s, sMeta, cw, out, Mpad, m0, scale_offset, false, n_points);
}

__global__ void __launch_bounds__(kDecThreads) fused_decode_kernel(
    const __nv_bfloat16* __restrict__ aux, const int8_t* __restrict__ rows0,
    const int8_t* __restrict__ rows1, const int8_t* __restrict__ rows2,
    const float* __restrict__ wts, const float* __restrict__ scale_rows,
    const ggd::DecodeChain cw, float* __restrict__ out, int Mpad, int n_points,
    float scale_offset) {
  extern __shared__ float smem[];
  const ggd::DecodeSmem s = ggd::decode_smem(smem);
  __shared__ int sMeta[32];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kDecPts;
  ggd::decode_prologue(s, sMeta, cw, aux, m0);

  {
    const int pt = tid >> 2, part = tid & 3;
    const int m = m0 + pt;
    const int8_t* rows[3] = {rows0, rows1, rows2};
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int8_t* row = rows[p] + (size_t)m * (kCorners * kC) + part * 8;
      float accp[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) accp[c] = 0.f;
#pragma unroll
      for (int k = 0; k < kCorners; ++k) {
        const float w = wts[(size_t)(p * kCorners + k) * Mpad + m];
        const int2 q2 = *reinterpret_cast<const int2*>(row + k * kC);
        const int8_t* q = reinterpret_cast<const int8_t*>(&q2);
#pragma unroll
        for (int c = 0; c < 8; ++c) accp[c] += (float)q[c] * w;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] += accp[c] * scale_rows[p * kC + part * 8 + c];
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) s.X[pt * kLds + part * 8 + c] = ggd::bf16r(acc[c]);
  }
  __syncthreads();
  ggd::chain_project_tail(s, sMeta, cw, out, Mpad, m0, scale_offset, false, n_points);
}

}  // namespace

extern "C" int ggd_brick_decode(const void* staging, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* w3, const void* b3,
                                const void* w4, const void* b4, const void* cam,
                                const void* meta, void* out, int Mpad, int n_points,
                                float scale_offset, void* stream) {
  if (Mpad <= 0 || Mpad % kDecPts != 0 || n_points > Mpad) return (int)cudaErrorInvalidValue;
  const size_t smem = ggd::kDecodeSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(brick_decode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const ggd::DecodeChain cw = ggd::decode_chain(w1, b1, w2, b2, w3, b3, w4, b4, cam, meta);
  brick_decode_kernel<<<Mpad / kDecPts, kDecThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)staging, cw, (float*)out, Mpad, n_points, scale_offset);
  return (int)cudaGetLastError();
}

// rows0..2 (Mpad, 8 * 32) int8, wts (>= 24, Mpad) f32 channel-major,
// scale_rows (3, 32) f32
extern "C" int ggd_fused_decode(const void* aux, const void* rows0, const void* rows1,
                                const void* rows2, const void* wts, const void* scale_rows,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                const void* w3, const void* b3, const void* w4, const void* b4,
                                const void* cam, const void* meta, void* out, int Mpad,
                                int n_points, float scale_offset, void* stream) {
  if (Mpad <= 0 || Mpad % kDecPts != 0 || n_points > Mpad) return (int)cudaErrorInvalidValue;
  const size_t smem = ggd::kDecodeSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(fused_decode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const ggd::DecodeChain cw = ggd::decode_chain(w1, b1, w2, b2, w3, b3, w4, b4, cam, meta);
  fused_decode_kernel<<<Mpad / kDecPts, kDecThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)aux, (const int8_t*)rows0, (const int8_t*)rows1,
      (const int8_t*)rows2, (const float*)wts, (const float*)scale_rows, cw, (float*)out, Mpad,
      n_points, scale_offset);
  return (int)cudaGetLastError();
}
