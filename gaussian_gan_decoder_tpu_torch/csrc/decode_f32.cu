// The f32 forms of the decode kernels K8, K9 and K2: the 5-head chain in f32
// and the EWA projection, channel-major rows out.
//
// They replace the TPU kernels gaussian_gan_decoder_tpu/decoder/
// pallas_heads.py::decode_project_pallas (K8), decode_project_pallas_fused
// (K9, both lerps) and decode_project_pallas_slab (K2) at
// compute_dtype f32, the JAX GaussianDecoder's default (heads_bf16=False):
// `_chain_project_body` with an f32 staging, f32 weights and f32 hidden
// activations — nothing is rounded to bf16, neither the features, the
// conditioning, the fed-back chain outputs nor `init`.
//
// One body, three entries. The chain is K6's (chain_tf32.cuh::chain_f32:
// 3xTF32 on the tensor cores, each warp's 16 points in registers, the
// weights split into TF32 (hi, lo) pairs once per call and streamed by
// cp.async through a two-slot ring); after it comes chain.cuh's
// project_point on the tile's packed f32 outputs. The entries differ only
// in how they fill the staging tile's feature columns 0:32:
//   * K8 (brick_decode_f32_kernel): the prebuilt f32 staging as it is;
//   * K9 (fused_decode_f32_kernel<K, Row, kDots>): the lerp of the gathered
//     brick rows (gather.cuh::fused_point_features: 8 int8 tri-grid
//     corners times their dequant scale, or 4 bf16 tri-plane corners), in
//     f32 ('bcast') or with the bf16 products of 'dots', which the JAX
//     decoder keeps at f32 heads too;
//   * K2 (slab_decode_f32_kernel<kBilinear>): the slab corners in f32
//     (gather.cuh::slab_point_features: 8 a plane for the tri-grid, 4 for
//     the bilinear form), zero at pad slots.
// The lerps round every product and sum on their own in the plain
// versions' order, as the bf16 forms do, and keep the f32 result where the
// bf16 forms round it to bf16. The cull is the bf16 forms': K2 multiplies
// visible, opac and radius_f by the staging's valid column; K8 and K9 mask
// visible by column < n_points.
//
// Shared memory per block of 128 points: the f32 staging tile (128 x 144:
// 128 staging columns and the 16 packed outputs, 73.7 KB), the weight ring
// (2 x 64 split rows, 131 KB), layer 4 (10 KB) and the biases (8 KB): 223 KB
// of the 227 KB a block may take, one block an SM. K6 runs the same
// configuration.
//
// Bound on the H100: the chain's operations at f32 accuracy, 3xTF32 at a
// third of the 495 TFLOP/s TF32 rate (the f32 CUDA cores give 67 TFLOP/s);
// the gathers read ~0.8 KB a point.
#include "chain_tf32.cuh"
#include "gather.cuh"

namespace {

using ggd::kF32Ld;
using ggd::kF32OutCol;
using ggd::kF32Pts;
using ggd::kF32Threads;
using ggd::kStage;
using ggd::kValidCol;

// Block prologue of the three entries: the chain's weights in flight, then
// the block's n_rows rows of the f32 staging (Mpad x 128; the rest zero)
// and the camera by plain loads. Ends with a barrier.
__device__ __forceinline__ void decode_f32_prologue(const ggd::F32Smem& s, int* sMeta,
                                                    float* sCam, const ggd::ChainF32& cw,
                                                    const float* __restrict__ wsplit,
                                                    const int* __restrict__ meta,
                                                    const float* __restrict__ cam,
                                                    const float* __restrict__ staging, int m0,
                                                    int n_rows) {
  const int tid = threadIdx.x;
  ggd::chain_f32_setup(s, sMeta, cw, wsplit, meta, meta[0]);
  for (int i = tid; i < kF32Pts * 32; i += kF32Threads) {
    const int r = i >> 5, c = (i & 31) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows) v = *reinterpret_cast<const float4*>(staging + (size_t)(m0 + r) * kStage + c);
    *reinterpret_cast<float4*>(s.X + r * kF32Ld + c) = v;
  }
  if (tid < 36) sCam[tid] = cam[tid];
  __syncthreads();
}

// The chain over the tile, then one thread per point projects it, as
// chain.cuh's chain_project_tail does for the bf16 forms
__device__ __forceinline__ void decode_f32_tail(const ggd::F32Smem& s, const int* sMeta,
                                                const float* sCam, const ggd::ChainF32& cw,
                                                const float* __restrict__ wsplit,
                                                const int* __restrict__ meta,
                                                float* __restrict__ out, int Mpad, int m0,
                                                int gk, float scale_offset, bool valid_col,
                                                int n_points) {
  ggd::chain_f32<-1>(s, sMeta, meta, cw, wsplit, meta[0], scale_offset, gk);
  __syncthreads();
  const int tid = threadIdx.x, m = m0 + tid;
  if (tid < kF32Pts && m < Mpad) {
    const float* xrow = s.X + tid * kF32Ld;
    const float valid = valid_col ? xrow[kValidCol] : 1.f;
    const float vis_mask = valid_col ? valid : (m < n_points ? 1.f : 0.f);
    ggd::project_point(xrow + kF32OutCol, sCam, sMeta, valid, vis_mask, out + m, Mpad);
  }
}

__global__ void __launch_bounds__(kF32Threads, 1) brick_decode_f32_kernel(
    const float* __restrict__ staging, const ggd::ChainF32 cw, const float* __restrict__ wsplit,
    const int* __restrict__ meta, const float* __restrict__ cam, float* __restrict__ out,
    int Mpad, int n_points, int gk, float scale_offset) {
  extern __shared__ __align__(16) float smem[];
  const ggd::F32Smem s = ggd::f32_smem(smem);
  __shared__ int sMeta[32];
  __shared__ float sCam[36];
  const int m0 = blockIdx.x * kF32Pts;
  decode_f32_prologue(s, sMeta, sCam, cw, wsplit, meta, cam, staging, m0,
                      min(kF32Pts, Mpad - m0));
  decode_f32_tail(s, sMeta, sCam, cw, wsplit, meta, out, Mpad, m0, gk, scale_offset, false,
                  n_points);
}

template <int kCorners, typename Row, bool kDots>
__global__ void __launch_bounds__(kF32Threads, 1) fused_decode_f32_kernel(
    const float* __restrict__ aux, const Row* __restrict__ rows0, const Row* __restrict__ rows1,
    const Row* __restrict__ rows2, const float* __restrict__ wts,
    const float* __restrict__ scale_rows, const ggd::ChainF32 cw,
    const float* __restrict__ wsplit, const int* __restrict__ meta,
    const float* __restrict__ cam, float* __restrict__ out, int Mpad, int n_points, int gk,
    float scale_offset) {
  extern __shared__ __align__(16) float smem[];
  const ggd::F32Smem s = ggd::f32_smem(smem);
  __shared__ int sMeta[32];
  __shared__ float sCam[36];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kF32Pts;
  const int n_rows = min(kF32Pts, Mpad - m0);
  decode_f32_prologue(s, sMeta, sCam, cw, wsplit, meta, cam, aux, m0, n_rows);
  // features, 4 threads per point x 8 channels (seen by layer 1 after the
  // chain's first barrier)
  for (int pt = tid >> 2; pt < n_rows; pt += kF32Threads / 4) {
    const int part = tid & 3;
    float acc[8];
    ggd::fused_point_features<kCorners, Row, kDots>(rows0, rows1, rows2, wts, scale_rows,
                                                    m0 + pt, part, Mpad, acc);
#pragma unroll
    for (int c = 0; c < 8; ++c) s.X[pt * kF32Ld + part * 8 + c] = acc[c];
  }
  decode_f32_tail(s, sMeta, sCam, cw, wsplit, meta, out, Mpad, m0, gk, scale_offset, false,
                  n_points);
}

template <bool kBilinear>
__global__ void __launch_bounds__(kF32Threads, 1) slab_decode_f32_kernel(
    const int8_t* __restrict__ vol, const float* __restrict__ scale_rows,
    const float* __restrict__ positions, const int16_t* __restrict__ idx16,
    const float* __restrict__ aux, const float* __restrict__ inv_axes, const ggd::ChainF32 cw,
    const float* __restrict__ wsplit, const int* __restrict__ meta,
    const float* __restrict__ cam, float* __restrict__ out, int Mpad, int D, int H, int W,
    int DZ, int YP, int XP, int gk, float box_warp, float scale_offset) {
  extern __shared__ __align__(16) float smem[];
  const ggd::F32Smem s = ggd::f32_smem(smem);
  __shared__ int sMeta[32];
  __shared__ float sCam[36];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kF32Pts;
  const int n_rows = min(kF32Pts, Mpad - m0);
  decode_f32_prologue(s, sMeta, sCam, cw, wsplit, meta, cam, aux, m0, n_rows);
  for (int pt = tid >> 2; pt < n_rows; pt += kF32Threads / 4) {
    const int part = tid & 3;
    float acc[8];
    ggd::slab_point_features<kBilinear>(vol, scale_rows, positions, idx16, inv_axes, m0 + pt,
                                        part, D, H, W, DZ, YP, XP, box_warp, acc);
    const bool valid = s.X[pt * kF32Ld + kValidCol] > 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) s.X[pt * kF32Ld + part * 8 + c] = valid ? acc[c] : 0.f;
  }
  decode_f32_tail(s, sMeta, sCam, cw, wsplit, meta, out, Mpad, m0, gk, scale_offset, true, Mpad);
}

// the checks and the weight split every entry makes before its launch
int f32_entry_setup(const void* const* aligned, int n_aligned, const ggd::ChainF32& cw,
                    void* wsplit, int n_heads, int gk, cudaStream_t stream) {
  if (n_heads < 1 || n_heads > ggd::kMaxHeads || gk < 0 || gk > 4)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_aligned; ++i)
    if (!ggd::aligned16(aligned[i])) return (int)cudaErrorMisalignedAddress;
  return (int)ggd::split_weights(cw, wsplit, n_heads, stream);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)ggd::kF32SmemBytes);
}

}  // namespace

// K8-f32. staging (Mpad, 128) f32; w1..w3 (H, 128, 128), w4 (H, 128, 16) f32;
// wsplit: H x 3 x 128 x 128 x 2 f32 scratch for the TF32 (hi, lo) split;
// gelu: the chain's GELU id (meta[26])
extern "C" int ggd_brick_decode_f32(const void* staging, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* w3,
                                    const void* b3, const void* w4, const void* b4,
                                    const void* cam, const void* meta, void* wsplit, void* out,
                                    int Mpad, int n_points, int n_heads, int gelu,
                                    float scale_offset, void* stream) {
  if (Mpad <= 0 || n_points > Mpad) return (int)cudaErrorInvalidValue;
  const ggd::ChainF32 cw = ggd::chain_f32_ptrs(w1, b1, w2, b2, w3, b3, w4, b4);
  const void* aligned[] = {staging, w1, b1, w2, b2, w3, b3, w4, b4, wsplit};
  const cudaStream_t s = (cudaStream_t)stream;
  int e = f32_entry_setup(aligned, 10, cw, wsplit, n_heads, gelu, s);
  if (e != 0) return e;
  cudaError_t err = allow_smem(brick_decode_f32_kernel);
  if (err != cudaSuccess) return (int)err;
  brick_decode_f32_kernel<<<(Mpad + kF32Pts - 1) / kF32Pts, kF32Threads, ggd::kF32SmemBytes, s>>>(
      (const float*)staging, cw, (const float*)wsplit, (const int*)meta, (const float*)cam,
      (float*)out, Mpad, n_points, gelu, scale_offset);
  return (int)cudaGetLastError();
}

template <int kCorners, typename Row, bool kDots>
static int launch_fused_f32(const void* aux, const void* rows0, const void* rows1,
                            const void* rows2, const void* wts, const void* scale_rows,
                            const ggd::ChainF32& cw, const void* wsplit, const void* meta,
                            const void* cam, void* out, int Mpad, int n_points, int gelu,
                            float scale_offset, cudaStream_t s) {
  auto kernel = fused_decode_f32_kernel<kCorners, Row, kDots>;
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(Mpad + kF32Pts - 1) / kF32Pts, kF32Threads, ggd::kF32SmemBytes, s>>>(
      (const float*)aux, (const Row*)rows0, (const Row*)rows1, (const Row*)rows2,
      (const float*)wts, (const float*)scale_rows, cw, (const float*)wsplit, (const int*)meta,
      (const float*)cam, (float*)out, Mpad, n_points, gelu, scale_offset);
  return (int)cudaGetLastError();
}

// K9-f32. aux (Mpad, 128) f32 with zero feature columns; rows0..2 (Mpad,
// corners * 32): int8 with 8 corners (tri-grid) or bf16 with 4 (tri-plane);
// wts (>= 3 * corners, Mpad) f32 channel-major, scale_rows (3, 32) f32;
// dots: the 'dots' lerp (bf16 products, as at bf16), else 'bcast'
extern "C" int ggd_fused_decode_f32(const void* aux, const void* rows0, const void* rows1,
                                    const void* rows2, const void* wts, const void* scale_rows,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, const void* w3, const void* b3,
                                    const void* w4, const void* b4, const void* cam,
                                    const void* meta, void* wsplit, void* out, int Mpad,
                                    int n_points, int corners, int dots, int n_heads, int gelu,
                                    float scale_offset, void* stream) {
  if (Mpad <= 0 || n_points > Mpad) return (int)cudaErrorInvalidValue;
  const ggd::ChainF32 cw = ggd::chain_f32_ptrs(w1, b1, w2, b2, w3, b3, w4, b4);
  const void* aligned[] = {aux, rows0, rows1, rows2, w1, b1, w2, b2, w3, b3, w4, b4, wsplit};
  const cudaStream_t s = (cudaStream_t)stream;
  if (corners != 8 && corners != 4) return (int)cudaErrorInvalidValue;
  int e = f32_entry_setup(aligned, 13, cw, wsplit, n_heads, gelu, s);
  if (e != 0) return e;
#define GGD_FUSED_F32(K, ROW, DOTS)                                                         \
  return launch_fused_f32<K, ROW, DOTS>(aux, rows0, rows1, rows2, wts, scale_rows, cw,      \
                                        wsplit, meta, cam, out, Mpad, n_points, gelu,       \
                                        scale_offset, s)
  if (corners == 8) {
    if (dots) GGD_FUSED_F32(8, int8_t, true);
    GGD_FUSED_F32(8, int8_t, false);
  }
  if (dots) GGD_FUSED_F32(4, __nv_bfloat16, true);
  GGD_FUSED_F32(4, __nv_bfloat16, false);
#undef GGD_FUSED_F32
}

// K2-f32. aux (Mpad, 128) f32 static staging (cond, init, valid at 123);
// vol, scale_rows, positions, idx16, inv_axes as ggd_slab_decode takes them
extern "C" int ggd_slab_decode_f32(const void* vol, const void* scale_rows,
                                   const void* positions, const void* idx16, const void* aux,
                                   const void* inv_axes, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* w3,
                                   const void* b3, const void* w4, const void* b4,
                                   const void* cam, const void* meta, void* wsplit, void* out,
                                   int Mpad, int D, int H, int W, int DZ, int YP, int XP,
                                   int n_heads, int gelu, float box_warp, float scale_offset,
                                   void* stream) {
  // depth 1 (DZ 1) takes the bilinear form; a tri-grid has D + 2 z layers
  const bool bilinear = D == 1;
  if (Mpad <= 0 || D < 1 || DZ != (bilinear ? 1 : D + 2)) return (int)cudaErrorInvalidValue;
  const ggd::ChainF32 cw = ggd::chain_f32_ptrs(w1, b1, w2, b2, w3, b3, w4, b4);
  const void* aligned[] = {aux, w1, b1, w2, b2, w3, b3, w4, b4, wsplit};
  const cudaStream_t s = (cudaStream_t)stream;
  int e = f32_entry_setup(aligned, 10, cw, wsplit, n_heads, gelu, s);
  if (e != 0) return e;
  auto kernel = bilinear ? slab_decode_f32_kernel<true> : slab_decode_f32_kernel<false>;
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(Mpad + kF32Pts - 1) / kF32Pts, kF32Threads, ggd::kF32SmemBytes, s>>>(
      (const int8_t*)vol, (const float*)scale_rows, (const float*)positions,
      (const int16_t*)idx16, (const float*)aux, (const float*)inv_axes, cw, (const float*)wsplit,
      (const int*)meta, (const float*)cam, (float*)out, Mpad, D, H, W, DZ, YP, XP, gelu, box_warp,
      scale_offset);
  return (int)cudaGetLastError();
}
