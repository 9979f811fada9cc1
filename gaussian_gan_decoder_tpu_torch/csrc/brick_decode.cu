// K8 and K9: the brick route's fused decode — the 5-head decoder chain and
// the EWA projection over a bf16 staging, channel-major rows out.
//
// K8 (brick_decode_kernel) replaces the TPU kernel
// gaussian_gan_decoder_tpu/decoder/pallas_heads.py::decode_project_pallas
// (_heads_project_kernel + _chain_project_body): the staging (features,
// position conditioning, init position; bf16, pad slots zero) is prebuilt in
// device memory; each 128-point block loads its rows into the shared staging
// and runs chain.cuh's chain_project_tail, the tail K2 runs.
//
// K9 (fused_decode_kernel) replaces decode_project_pallas_fused
// (_sample_heads_project_kernel, both lerp_modes): the staging's feature
// columns are built in the kernel from the raw brick rows, then the same
// tail runs. Per point and plane it reads the brick row and the mask-folded
// corner weights and lerps them (gather.cuh::fused_point_features):
//   * 'bcast': sum_c row_c * w_c in f32, times the plane's scale row;
//   * 'dots' (the JAX decoder's default fused_lerp): bf16(bf16(row_c) *
//     bf16(w_c)) * bf16(scale), summed in f32 corner-major, plane by plane;
// sums the planes and rounds the mean to bf16 into columns 0:32. Each
// product and sum of the lerp is rounded on its own (_rn intrinsics, no FMA
// contraction), in the plain version's order, so the features are the
// plain version's bit for bit. 4 threads per point, 8 channels each. Four
// forms, instantiated from one template (corners, row type, lerp):
//   * tri-grid (PanoHead): 8 corners x 32 int8 channels (256 bytes; one
//     8-byte load per corner), scale rows = the per-(plane, channel) int8
//     dequant scale with the 1/3 plane mean folded in;
//   * tri-plane (EG3D, depth 1): 4 corners x 32 bf16 channels (256 bytes;
//     one 16-byte load per corner), no dequant: the scale rows are the 1/3
//     plane mean alone.
//
// Numerics are K2's: bf16 weights and staging, hidden activations rounded
// to bf16, f32 accumulation. The cull is the TPU kernels': only `visible`
// is masked, by column < n_points; there is no valid column.
//
// Bound on the H100: the chain's operations (5.12e5 FLOPs a point, padded)
// at the bf16 tensor-core rate, where chain_project_tail now runs them (bf16
// mma.sync, f32 accumulators, 128-point blocks, a ragged last block
// masked); K9 also reads ~0.8 KB of brick rows and weights per point. Only
// the front halves (K8's staging load, K9's lerp) are this file's own; they
// are not redesigned.
#include "chain.cuh"
#include "gather.cuh"

namespace {

using ggd::kDecPts;
using ggd::kDecThreads;
using ggd::kXld;

__global__ void __launch_bounds__(kDecThreads) brick_decode_kernel(
    const __nv_bfloat16* __restrict__ staging, const ggd::DecodeChain cw,
    float* __restrict__ out, int Mpad, int n_points, float scale_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ggd::DecodeSmem s = ggd::decode_smem(smem);
  __shared__ int sMeta[32];
  const int m0 = blockIdx.x * kDecPts;
  ggd::decode_prologue(s, sMeta, cw, staging, m0, min(kDecPts, Mpad - m0));
  ggd::chain_project_tail(s, sMeta, cw, out, Mpad, m0, scale_offset, false, n_points);
}

template <int kCorners, typename Row, bool kDots>
__global__ void __launch_bounds__(kDecThreads) fused_decode_kernel(
    const __nv_bfloat16* __restrict__ aux, const Row* __restrict__ rows0,
    const Row* __restrict__ rows1, const Row* __restrict__ rows2,
    const float* __restrict__ wts, const float* __restrict__ scale_rows,
    const ggd::DecodeChain cw, float* __restrict__ out, int Mpad, int n_points,
    float scale_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ggd::DecodeSmem s = ggd::decode_smem(smem);
  __shared__ int sMeta[32];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kDecPts;
  const int n_rows = min(kDecPts, Mpad - m0);
  ggd::decode_prologue(s, sMeta, cw, aux, m0, n_rows);

  for (int pt = tid >> 2; pt < n_rows; pt += kDecThreads / 4) {
    const int part = tid & 3;
    float acc[8];
    ggd::fused_point_features<kCorners, Row, kDots>(rows0, rows1, rows2, wts, scale_rows,
                                                    m0 + pt, part, Mpad, acc);
#pragma unroll
    for (int c = 0; c < 8; ++c) s.X[pt * kXld + part * 8 + c] = __float2bfloat16_rn(acc[c]);
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
  if (Mpad <= 0 || n_points > Mpad) return (int)cudaErrorInvalidValue;
  for (const void* p : {staging, w1, w2, w3, w4})
    if (!ggd::aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = ggd::kDecodeSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(brick_decode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const ggd::DecodeChain cw = ggd::decode_chain(w1, b1, w2, b2, w3, b3, w4, b4, cam, meta);
  brick_decode_kernel<<<(Mpad + kDecPts - 1) / kDecPts, kDecThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)staging, cw, (float*)out, Mpad, n_points, scale_offset);
  return (int)cudaGetLastError();
}

template <int kCorners, typename Row, bool kDots>
static int launch_fused(const void* aux, const void* rows0, const void* rows1,
                        const void* rows2, const void* wts, const void* scale_rows,
                        const ggd::DecodeChain& cw, void* out, int Mpad, int n_points,
                        float scale_offset, void* stream) {
  const size_t smem = ggd::kDecodeSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(fused_decode_kernel<kCorners, Row, kDots>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_decode_kernel<kCorners, Row, kDots>
      <<<(Mpad + kDecPts - 1) / kDecPts, kDecThreads, smem, (cudaStream_t)stream>>>(
          (const __nv_bfloat16*)aux, (const Row*)rows0, (const Row*)rows1, (const Row*)rows2,
          (const float*)wts, (const float*)scale_rows, cw, (float*)out, Mpad, n_points,
          scale_offset);
  return (int)cudaGetLastError();
}

// rows0..2 (Mpad, corners * 32): int8 with 8 corners (tri-grid) or bf16
// with 4 (tri-plane); wts (>= 3 * corners, Mpad) f32 channel-major,
// scale_rows (3, 32) f32; dots: the 'dots' lerp (else 'bcast')
extern "C" int ggd_fused_decode(const void* aux, const void* rows0, const void* rows1,
                                const void* rows2, const void* wts, const void* scale_rows,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                const void* w3, const void* b3, const void* w4, const void* b4,
                                const void* cam, const void* meta, void* out, int Mpad,
                                int n_points, int corners, int dots, float scale_offset,
                                void* stream) {
  if (Mpad <= 0 || n_points > Mpad) return (int)cudaErrorInvalidValue;
  for (const void* p : {aux, rows0, rows1, rows2, w1, w2, w3, w4})
    if (!ggd::aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const ggd::DecodeChain cw = ggd::decode_chain(w1, b1, w2, b2, w3, b3, w4, b4, cam, meta);
#define GGD_FUSED(K, ROW, DOTS)                                                              \
  return launch_fused<K, ROW, DOTS>(aux, rows0, rows1, rows2, wts, scale_rows, cw, out, Mpad, \
                                    n_points, scale_offset, stream)
  if (corners == 8) {
    if (dots) GGD_FUSED(8, int8_t, true);
    GGD_FUSED(8, int8_t, false);
  }
  if (corners == 4) {
    if (dots) GGD_FUSED(4, __nv_bfloat16, true);
    GGD_FUSED(4, __nv_bfloat16, false);
  }
#undef GGD_FUSED
  return (int)cudaErrorInvalidValue;
}
