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
// Two forms, instantiated from one template (kBilinear):
//   * the tri-grid (PanoHead, depth D > 1): volume (3, D + 2, YP, XP*32),
//     8 corners a plane, trilinear weights;
//   * the bilinear form (EG3D tri-plane, depth 1): volume (3, 1, YP, XP*32),
//     4 corners a plane, no z weight (the single layer weighs its validity
//     bit, which the bilinear pack always sets). The TPU kernel runs it
//     with dzw=1 and a 128-row y window, sized to fill one matrix-unit
//     tile; a point's corners need no window here.
//
// Per block of 128 points, 256 threads (a ragged last block is masked):
//   1. staging X (128 x 128, bf16) <- the static aux staging (cond, init,
//      valid at column 123), while the first layer's weights arrive;
//   2. features: 4 threads per point, 8 channels each (gather.cuh::
//      slab_point_features); per plane the corner weights come from the slot
//      position and the host's padded indices + validity bits
//      (align_corners=False, zeros padding), then the scale row (the dequant
//      scale with the 1/3 plane mean folded in, computed by the wrapper) and
//      the plane sum; pad slots get 0; X[:, 0:32] <- bf16(mean). Every
//      product and sum is rounded on its own (_rn intrinsics, no FMA
//      contraction), in the plain version's order, so the features are the
//      plain version's bit for bit (chip_smoke.py holds the rows against
//      K8's on the plain features);
//   3. the chain on the tensor cores: per head 3 x (128x128 linear + GELU,
//      bf16-rounded) and a 128x16 linear as bf16 mma.sync with f32
//      accumulators, each warp's 16 points kept in registers from layer to
//      layer, then the scale / xyz transforms; outputs go to the raw block
//      O16 (f32) and, bf16-rounded, back into the staging prefix;
//   4. the projection and colour/opacity activations per point, culled by
//      the valid column, written to rows 0..31.
// Steps 3 and 4 are chain.cuh's chain_project_tail, shared with K8 and K9.
//
// Bound on the H100: the chain's operations, 5.12e5 FLOPs a point at the
// bf16 tensor-core rate (0.30 ms for 572,416 slots); HBM moves ~0.7 KB a
// point (staging, corners, rows). Per point the weights read from L2 fell
// from 7.8 KB (64-point blocks, f32 FMAs from shared memory, 21 ms a frame)
// to 3.9 KB (128-point blocks, bf16 MMA).
#include "chain.cuh"
#include "gather.cuh"

namespace {

using ggd::kDecPts;
using ggd::kDecThreads;
using ggd::kValidCol;
using ggd::kXld;

template <bool kBilinear>
__global__ void __launch_bounds__(kDecThreads) slab_decode_kernel(
    const int8_t* __restrict__ vol, const float* __restrict__ scale_rows,
    const float* __restrict__ positions, const int16_t* __restrict__ idx16,
    const __nv_bfloat16* __restrict__ aux, const ggd::DecodeChain cw,
    const float* __restrict__ inv_axes, float* __restrict__ out,
    int Mpad, int D, int H, int W, int DZ, int YP, int XP, float box_warp,
    float scale_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ggd::DecodeSmem s = ggd::decode_smem(smem);
  __shared__ int sMeta[32];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kDecPts;
  const int n_rows = min(kDecPts, Mpad - m0);
  // 1. static staging (the first weights already in flight)
  ggd::decode_prologue(s, sMeta, cw, aux, m0, n_rows);

  // 2. trilinear (bilinear) features, 4 threads per point x 8 channels
  for (int pt = tid >> 2; pt < n_rows; pt += kDecThreads / 4) {
    const int part = tid & 3;
    float acc[8];
    ggd::slab_point_features<kBilinear>(vol, scale_rows, positions, idx16, inv_axes, m0 + pt,
                                        part, D, H, W, DZ, YP, XP, box_warp, acc);
    const bool valid = ggd::bf16f(s.X[pt * kXld + kValidCol]) > 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      s.X[pt * kXld + part * 8 + c] = __float2bfloat16_rn(valid ? acc[c] : 0.f);
  }
  __syncthreads();

  // 3.-4. the chain and the projection, culled by the valid column
  ggd::chain_project_tail(s, sMeta, cw, out, Mpad, m0, scale_offset, true, Mpad);
}

}  // namespace

// scale_rows (3, 32) f32: the int8 dequant scales with the 1/3 plane mean
// folded in (pallas_heads.slab_scale_rows)
extern "C" int ggd_slab_decode(const void* vol, const void* scale_rows, const void* positions,
                               const void* idx16, const void* aux, const void* inv_axes,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               const void* w3, const void* b3, const void* w4, const void* b4,
                               const void* cam, const void* meta, void* out, int Mpad, int D,
                               int H, int W, int DZ, int YP, int XP, float box_warp,
                               float scale_offset, void* stream) {
  // depth 1 (DZ 1) takes the bilinear form; a tri-grid has D + 2 z layers
  const bool bilinear = D == 1;
  if (Mpad <= 0 || D < 1 || DZ != (bilinear ? 1 : D + 2)) return (int)cudaErrorInvalidValue;
  for (const void* p : {aux, w1, w2, w3, w4})
    if (!ggd::aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = ggd::kDecodeSmemBytes;
  auto kernel = bilinear ? slab_decode_kernel<true> : slab_decode_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const ggd::DecodeChain cw = ggd::decode_chain(w1, b1, w2, b2, w3, b3, w4, b4, cam, meta);
  kernel<<<(Mpad + kDecPts - 1) / kDecPts, kDecThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)vol, (const float*)scale_rows, (const float*)positions,
      (const int16_t*)idx16, (const __nv_bfloat16*)aux, cw, (const float*)inv_axes,
      (float*)out, Mpad, D, H, W, DZ, YP, XP, box_warp, scale_offset);
  return (int)cudaGetLastError();
}
