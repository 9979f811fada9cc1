// K2: fused slab decode — trilinear sample of 3 int8 planes, the 5-head
// decoder chain and the EWA projection, channel-major rows out.
//
// Replaces the TPU kernel gaussian_gan_decoder_tpu/decoder/pallas_heads.py
// ::decode_project_pallas_slab (_slab_heads_project_kernel +
// _chain_project_body). It writes the same (32, Mpad) rows; it does not copy
// the TPU block structure (static weight matrices that turn the gather into
// matrix-unit contractions). Each point reads its 8 corners per plane
// straight from the channels-last int8 volume (32 contiguous bytes each).
//
// Per block of 64 points, 256 threads:
//   1. staging X (64 x 128) <- the static aux staging (bf16: cond, init,
//      valid at column 123);
//   2. features: 4 threads per point, 8 channels each; per plane the
//      corner weights come from the slot position and the host's padded
//      indices + validity bits (align_corners=False, zeros padding), then
//      dequant (scale / 3) and the plane mean; pad slots get 0; X[:, 0:32]
//      <- bf16(mean);
//   3. the chain: per head 3 x (128x128 linear + GELU, bf16-rounded) and a
//      128x16 linear, then the scale / xyz transforms; outputs go to the
//      raw block O16 (f32) and, bf16-rounded, back into the staging prefix;
//   4. the projection and colour/opacity activations per point, culled by
//      the valid column, written to rows 0..31.
// Steps 3 and 4 are chain.cuh's chain_project_tail, shared with K8 and K9.
// Weights and activations sit in shared memory as f32 holding bf16 values;
// products accumulate in f32 (register-tiled 4 x 8 per thread).
//
// Bound on the H100: the chain's ~1e5 FMA-heavy FLOPs per point on the CUDA
// cores (tensor-core MMA on the bf16 operands is the next step).
#include "chain.cuh"

namespace {

using ggd::kDecPts;
using ggd::kDecThreads;
using ggd::kLds;
using ggd::kValidCol;

constexpr int kC = 32;

__global__ void __launch_bounds__(kDecThreads) slab_decode_kernel(
    const int8_t* __restrict__ vol, const float* __restrict__ scales,
    const float* __restrict__ positions, const int16_t* __restrict__ idx16,
    const __nv_bfloat16* __restrict__ aux, const ggd::DecodeChain cw,
    const float* __restrict__ inv_axes, float* __restrict__ out,
    int Mpad, int D, int H, int W, int DZ, int YP, int XP, float box_warp,
    float scale_offset) {
  extern __shared__ float smem[];
  const ggd::DecodeSmem s = ggd::decode_smem(smem);
  float* X = s.X;
  __shared__ int sMeta[32];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kDecPts;
  // 1. static staging
  ggd::decode_prologue(s, sMeta, cw, aux, m0);

  // 2. trilinear features, 4 threads per point x 8 channels
  {
    const int pt = tid >> 2, part = tid & 3;
    const int m = m0 + pt;
    const float bw = 2.f / box_warp;
    const float g0 = bw * positions[m * 3 + 0];
    const float g1 = bw * positions[m * 3 + 1];
    const float g2 = bw * positions[m * 3 + 2];
    const float sizes[3] = {(float)W, (float)H, (float)D};
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    for (int p = 0; p < 3; ++p) {
      const float* inv = inv_axes + p * 9;
      float proj[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) proj[d] = g0 * inv[0 * 3 + d] + g1 * inv[1 * 3 + d] + g2 * inv[2 * 3 + d];
      const int bits = idx16[m * 12 + 4 * p + 3];
      int ip[3];
      float wa[3], wb[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        ip[d] = idx16[m * 12 + 4 * p + d];
        const float x = ((proj[d] + 1.f) * sizes[d] - 1.f) * 0.5f;
        const float w1f = x - ((float)ip[d] - 1.f);
        wa[d] = (1.f - w1f) * (float)((bits >> (2 * d)) & 1);
        wb[d] = w1f * (float)((bits >> (2 * d + 1)) & 1);
      }
      // memory safety only: valid packs never leave these bounds
      const int ix = min(max(ip[0], 0), XP - 2);
      const int iy = min(max(ip[1], 0), YP - 2);
      const int iz = min(max(ip[2], 0), DZ - 2);
      float s[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) s[c] = 0.f;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const float wzy = (dz ? wb[2] : wa[2]) * (dy ? wb[1] : wa[1]);
          const int8_t* row = vol + (((size_t)p * DZ + iz + dz) * YP + iy + dy) * (size_t)XP * kC;
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float w = wzy * (dx ? wb[0] : wa[0]);
            const int2 q2 = *reinterpret_cast<const int2*>(row + (ix + dx) * kC + part * 8);
            const int8_t* q = reinterpret_cast<const int8_t*>(&q2);
#pragma unroll
            for (int c = 0; c < 8; ++c) s[c] += w * (float)q[c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] += s[c] * (scales[p * kC + part * 8 + c] / 3.f);
    }
    const bool valid = X[pt * kLds + kValidCol] > 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) X[pt * kLds + part * 8 + c] = valid ? ggd::bf16r(acc[c]) : 0.f;
  }
  __syncthreads();

  // 3.-4. the chain and the projection, culled by the valid column
  ggd::chain_project_tail(s, sMeta, cw, out, Mpad, m0, scale_offset, true, Mpad);
}

}  // namespace

extern "C" int ggd_slab_decode(const void* vol, const void* scales, const void* positions,
                               const void* idx16, const void* aux, const void* inv_axes,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               const void* w3, const void* b3, const void* w4, const void* b4,
                               const void* cam, const void* meta, void* out, int Mpad, int D,
                               int H, int W, int DZ, int YP, int XP, float box_warp,
                               float scale_offset, void* stream) {
  if (Mpad <= 0 || Mpad % kDecPts != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = ggd::kDecodeSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(slab_decode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const ggd::DecodeChain cw = ggd::decode_chain(w1, b1, w2, b2, w3, b3, w4, b4, cam, meta);
  slab_decode_kernel<<<Mpad / kDecPts, kDecThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)vol, (const float*)scales, (const float*)positions,
      (const int16_t*)idx16, (const __nv_bfloat16*)aux, cw, (const float*)inv_axes,
      (float*)out, Mpad, D, H, W, DZ, YP, XP, box_warp, scale_offset);
  return (int)cudaGetLastError();
}
