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
// One body (decode_f32.cuh), three entries, then one projection kernel.
// The chain is K6's (chain_tf32.cuh::chain_f32: 3xTF32 on the tensor
// cores, each warp's 16 points in registers, the weights split into TF32
// (hi, lo) pairs once per call and streamed by cp.async through a two-slot
// ring); the block writes its tile's packed f32 outputs as rows 0:16, and
// project_rows_kernel projects them into rows 16:32
// (chain.cuh::project_screen). The entries differ only in how they fill
// the staging tile's feature columns 0:32:
//   * K8 (brick_decode_f32_kernel<kGelu>): the prebuilt f32 staging;
//   * K9 (fused_decode_f32_kernel<kGelu, K, Row, kDots>): the lerp of the
//     gathered brick rows (gather.cuh::fused_point_features: 8 int8 tri-grid
//     corners times their dequant scale, or 4 bf16 tri-plane corners), in
//     f32 ('bcast') or with the bf16 products of 'dots', which the JAX
//     decoder keeps at f32 heads too;
//   * K2 (slab_decode_f32_kernel<kGelu, kBilinear>): the slab corners in f32
//     (gather.cuh::slab_point_features: 8 a plane for the tri-grid, 4 for
//     the bilinear form), zero at pad slots.
// The lerps round every product and sum on their own in the plain
// versions' order, as the bf16 forms do, and keep the f32 result where the
// bf16 forms round it to bf16. The cull is the bf16 forms': K2 multiplies
// visible, opac and radius_f by the staging's valid column; K8 and K9 mask
// visible by column < n_points.
//
// Bound on the H100: the chain's operations at f32 accuracy, 3xTF32 at a
// third of the 495 TFLOP/s TF32 rate (the f32 CUDA cores give 67 TFLOP/s);
// the gathers read ~0.8 KB a point.
//
// What bounds them now (H100 80GB HBM3, 700 W; scripts/f32_decode_ablation.py,
// device time on D-par's shapes): the chain. K8-f32 runs within 0.1 ms of
// K6 on the same rows, K2-f32 within 0.4 and K9-f32 within 0.5-0.7, the
// rest K9's and K2's gathers (0.26-0.67 ms a call, latency: a 128-point
// block takes the SM's shared memory, 223 KB of the 227 KB, so one block an
// SM runs its gather with nothing beside it) and the projection kernel
// (0.05-0.16 ms).
//
// Design: the projection, which cost 1.6-1.8 ms a call at the end of each
// block (one point a thread on 128 threads, its code fetched cold once a
// tile, long dependent chains; K2-f32 8.71 ms of which the chain alone was
// 6.50), leaves the chain's kernel. The block writes its points' 16 packed
// outputs as rows 0:16 (all 256 threads, coalesced) and retires;
// project_rows_kernel then reads those rows back, one thread a point in
// 256-thread blocks at full occupancy, and writes rows 16:32 (chain.cuh::
// project_screen): 64 bytes a point more of device memory each way, the
// rows the parent's bit for bit. The staging rows arrive by cp.async with
// the chain's first weights, the gather's loads in flight beside them; the
// GELU kind is a template argument, as in K6 (the run-time switch cost
// 0.11-0.26 ms a call): 5 kinds x 7 forms, each kind in a file of its own
// (decode_f32_gelu_*.cu), which nvcc builds in parallel. Not a
// warp-specialised block: a producer warpgroup loading, gathering and
// projecting beside the chain's warps needs two tiles in shared memory,
// hence a weight ring of 32-row slots, and measured slower in every form
// (K2-f32 11.79 ms against 8.88): the chain lost 28 % to the ring's twice
// as many steps, and the producers' projection slowed it by 2.9-3.2 ms more.
#include "decode_f32.cuh"

// the GELU kinds' instances live in decode_f32_gelu_*.cu
extern template struct ggd::DecodeF32<0>;
extern template struct ggd::DecodeF32<1>;
extern template struct ggd::DecodeF32<2>;
extern template struct ggd::DecodeF32<3>;
extern template struct ggd::DecodeF32<4>;

namespace {

using ggd::kOutW;
using ggd::kStage;
using ggd::kValidCol;

// The projection rows 16:32 of every point from its head rows 0:16 of out
// (chain.cuh::project_screen), one thread a point. Cull: with valid_src
// (K2: its static staging, the valid column 123) visible, opac and
// radius_f are multiplied by the valid column; without it (K8, K9) visible
// is masked by column < n_points, as chain.cuh's chain_project_tail does
// for the bf16 forms.
constexpr int kProjThreads = 256;

__global__ void __launch_bounds__(kProjThreads) project_rows_kernel(
    float* __restrict__ out, const float* __restrict__ valid_src, const float* __restrict__ cam,
    const int* __restrict__ meta, int Mpad, int n_points) {
  __shared__ int sMeta[32];
  __shared__ float sCam[36];
  __shared__ float sO[kProjThreads * (kOutW + 1)];   // a point's outputs a row
  const int tid = threadIdx.x, m = blockIdx.x * kProjThreads + tid;
  if (tid < 32) sMeta[tid] = meta[tid];
  if (tid < 36) sCam[tid] = cam[tid];
  float* o = sO + tid * (kOutW + 1);
  if (m < Mpad)
#pragma unroll
    for (int r = 0; r < kOutW; ++r) o[r] = out[(size_t)r * Mpad + m];
  __syncthreads();
  if (m >= Mpad) return;
  const float valid = valid_src != nullptr ? valid_src[(size_t)m * kStage + kValidCol] : 1.f;
  const float vis_mask = valid_src != nullptr ? valid : (m < n_points ? 1.f : 0.f);
  ggd::project_screen(o, sCam, sMeta, valid, vis_mask, out + m, Mpad);
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

// after a decode kernel's launch (err): its error, else the projection
// kernel's
int project_rows(cudaError_t err, void* out, const void* valid_src, const void* cam,
                 const void* meta, int Mpad, int n_points, cudaStream_t s) {
  if (err != cudaSuccess) return (int)err;
  project_rows_kernel<<<(Mpad + kProjThreads - 1) / kProjThreads, kProjThreads, 0, s>>>(
      (float*)out, (const float*)valid_src, (const float*)cam, (const int*)meta, Mpad, n_points);
  return (int)cudaGetLastError();
}

// the launch of DecodeF32<gk>::member(args...)
#define GGD_BY_GELU(member, ...)                                 \
  (gk == 0   ? ggd::DecodeF32<0>::member(__VA_ARGS__)            \
   : gk == 1 ? ggd::DecodeF32<1>::member(__VA_ARGS__)            \
   : gk == 2 ? ggd::DecodeF32<2>::member(__VA_ARGS__)            \
   : gk == 3 ? ggd::DecodeF32<3>::member(__VA_ARGS__)            \
             : ggd::DecodeF32<4>::member(__VA_ARGS__))

}  // namespace

// K8-f32. staging (Mpad, 128) f32; w1..w3 (H, 128, 128), w4 (H, 128, 16) f32;
// wsplit: H x 3 x 128 x 128 x 2 f32 scratch for the TF32 (hi, lo) split;
// gelu: the chain's GELU id (meta[26])
extern "C" int ggd_brick_decode_f32(const void* staging, const void* w1, const void* b1,
                                    const void* w2, const void* b2, const void* w3,
                                    const void* b3, const void* w4, const void* b4,
                                    const void* cam, const void* meta, void* wsplit, void* out,
                                    int Mpad, int n_points, int n_heads, int gk,
                                    float scale_offset, void* stream) {
  if (Mpad <= 0 || n_points > Mpad) return (int)cudaErrorInvalidValue;
  const ggd::ChainF32 cw = ggd::chain_f32_ptrs(w1, b1, w2, b2, w3, b3, w4, b4);
  const void* aligned[] = {staging, w1, b1, w2, b2, w3, b3, w4, b4, wsplit};
  const cudaStream_t s = (cudaStream_t)stream;
  int e = f32_entry_setup(aligned, 10, cw, wsplit, n_heads, gk, s);
  if (e != 0) return e;
  const cudaError_t err = GGD_BY_GELU(brick, (const float*)staging, cw, (const float*)wsplit,
                                      (const int*)meta, (float*)out, Mpad, scale_offset, s);
  return project_rows(err, out, nullptr, cam, meta, Mpad, n_points, s);
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
                                    int n_points, int corners, int dots, int n_heads, int gk,
                                    float scale_offset, void* stream) {
  if (Mpad <= 0 || n_points > Mpad) return (int)cudaErrorInvalidValue;
  const ggd::ChainF32 cw = ggd::chain_f32_ptrs(w1, b1, w2, b2, w3, b3, w4, b4);
  const void* aligned[] = {aux, rows0, rows1, rows2, w1, b1, w2, b2, w3, b3, w4, b4, wsplit};
  const cudaStream_t s = (cudaStream_t)stream;
  if (corners != 8 && corners != 4) return (int)cudaErrorInvalidValue;
  int e = f32_entry_setup(aligned, 13, cw, wsplit, n_heads, gk, s);
  if (e != 0) return e;
  const cudaError_t err = GGD_BY_GELU(fused, (const float*)aux, rows0, rows1, rows2,
                                      (const float*)wts, (const float*)scale_rows, cw,
                                      (const float*)wsplit, (const int*)meta, (float*)out, Mpad,
                                      corners, dots != 0, scale_offset, s);
  return project_rows(err, out, nullptr, cam, meta, Mpad, n_points, s);
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
                                   int n_heads, int gk, float box_warp, float scale_offset,
                                   void* stream) {
  // depth 1 (DZ 1) takes the bilinear form; a tri-grid has D + 2 z layers
  if (Mpad <= 0 || D < 1 || DZ != (D == 1 ? 1 : D + 2)) return (int)cudaErrorInvalidValue;
  const ggd::ChainF32 cw = ggd::chain_f32_ptrs(w1, b1, w2, b2, w3, b3, w4, b4);
  const void* aligned[] = {aux, w1, b1, w2, b2, w3, b3, w4, b4, wsplit};
  const cudaStream_t s = (cudaStream_t)stream;
  int e = f32_entry_setup(aligned, 10, cw, wsplit, n_heads, gk, s);
  if (e != 0) return e;
  const cudaError_t err = GGD_BY_GELU(
      slab, (const int8_t*)vol, (const float*)scale_rows, (const float*)positions,
      (const int16_t*)idx16, (const float*)aux, (const float*)inv_axes, cw, (const float*)wsplit,
      (const int*)meta, (float*)out, Mpad, D, H, W, DZ, YP, XP, box_warp, scale_offset, s);
  return project_rows(err, out, aux, cam, meta, Mpad, Mpad, s);
}
