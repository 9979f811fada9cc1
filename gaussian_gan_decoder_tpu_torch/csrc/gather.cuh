// The feature front halves of the gather-fused decode kernels, shared by
// their bf16 forms (K2 slab_decode.cu, K9 brick_decode.cu) and their f32
// forms (decode_f32.cu): one thread computes 8 consecutive channels
// (`part` * 8 .. + 7) of one point's plane-mean feature in f32. Every
// product and sum is rounded on its own (_rn intrinsics, no FMA
// contraction), in the plain versions' order (pallas_heads.
// slab_features_plain, fused_features_plain), so the features equal the
// plain versions' bit for bit; the bf16 forms round the result to bf16, the
// f32 forms keep it. K9 has two lerps, the TPU kernel's lerp_mode 'bcast'
// and 'dots' (fused_point_features<..., kDots>).
#pragma once

#include "common.cuh"

namespace ggd {

constexpr int kFeatC = 32;   // channels per plane

// K2's trilinear (bilinear) sample of the int8 channels-last slab volume at
// slot m: per plane the corner weights from the slot position and the
// host's padded indices + validity bits (align_corners=False, zeros
// padding), the corners' int8 channels, the scale row (the dequant scale
// with the 1/3 plane mean folded in, pallas_heads.slab_scale_rows), summed
// over the planes. kBilinear: the depth-1 volume (3, 1, YP, XP*32), 4
// corners a plane, the single z layer weighing its validity bit.
template <bool kBilinear>
__device__ __forceinline__ void slab_point_features(
    const int8_t* __restrict__ vol, const float* __restrict__ scale_rows,
    const float* __restrict__ positions, const int16_t* __restrict__ idx16,
    const float* __restrict__ inv_axes, int m, int part, int D, int H, int W, int DZ, int YP,
    int XP, float box_warp, float (&acc)[8]) {
  const float bw = 2.f / box_warp;
  const float g0 = bw * positions[m * 3 + 0];
  const float g1 = bw * positions[m * 3 + 1];
  const float g2 = bw * positions[m * 3 + 2];
  const float sizes[3] = {(float)W, (float)H, (float)D};
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  for (int p = 0; p < 3; ++p) {
    const float* inv = inv_axes + p * 9;
    float proj[3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      proj[d] = __fadd_rn(__fadd_rn(__fmul_rn(g0, inv[0 * 3 + d]), __fmul_rn(g1, inv[1 * 3 + d])),
                          __fmul_rn(g2, inv[2 * 3 + d]));
    const int bits = idx16[m * 12 + 4 * p + 3];
    int ip[3];
    float wa[3], wb[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      ip[d] = idx16[m * 12 + 4 * p + d];
      if (kBilinear && d == 2) {
        // depth 1: the single z layer weighs its validity bit (1 << 4)
        wa[d] = (float)((bits >> 4) & 1);
        wb[d] = 0.f;
        continue;
      }
      const float x = __fsub_rn(__fmul_rn(__fadd_rn(proj[d], 1.f), sizes[d]), 1.f) * 0.5f;
      const float w1f = x - ((float)ip[d] - 1.f);
      wa[d] = (1.f - w1f) * (float)((bits >> (2 * d)) & 1);
      wb[d] = w1f * (float)((bits >> (2 * d + 1)) & 1);
    }
    // memory safety only: valid packs never leave these bounds
    const int ix = min(max(ip[0], 0), XP - 2);
    const int iy = min(max(ip[1], 0), YP - 2);
    const int iz = kBilinear ? 0 : min(max(ip[2], 0), DZ - 2);
    float sum[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) sum[c] = 0.f;
#pragma unroll
    for (int dz = 0; dz < (kBilinear ? 1 : 2); ++dz) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float wzy = (dz ? wb[2] : wa[2]) * (dy ? wb[1] : wa[1]);
        const int8_t* row =
            vol + (((size_t)p * DZ + iz + dz) * YP + iy + dy) * (size_t)XP * kFeatC;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float w = wzy * (dx ? wb[0] : wa[0]);
          const int2 q2 = *reinterpret_cast<const int2*>(row + (ix + dx) * kFeatC + part * 8);
          const int8_t* q = reinterpret_cast<const int8_t*>(&q2);
#pragma unroll
          for (int c = 0; c < 8; ++c) sum[c] = __fadd_rn(sum[c], __fmul_rn(w, (float)q[c]));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc[c] = __fadd_rn(acc[c], __fmul_rn(sum[c], scale_rows[p * kFeatC + part * 8 + c]));
  }
}

// 8 consecutive channels of one corner as f32
__device__ __forceinline__ void load8(const int8_t* p, float* v) {
  const int2 q2 = *reinterpret_cast<const int2*>(p);
  const int8_t* q = reinterpret_cast<const int8_t*>(&q2);
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = (float)q[c];
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 q4 = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* q = reinterpret_cast<const __nv_bfloat16*>(&q4);
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] = __bfloat162float(q[c]);
}

// K9's lerp of the raw brick rows at point m, over kCorners corners (8 int8
// tri-grid corners or 4 bf16 tri-plane ones); wts (>= 3 kCorners, Mpad)
// channel-major, scale_rows (3, 32) the plane's dequant scale with the 1/3
// plane mean folded in.
//  - 'bcast' (kDots false): per plane sum_c row_c * w_c in f32, times the
//    plane's scale row, summed over the planes;
//  - 'dots' (kDots true; the TPU kernel's default, two bf16 matrix-unit
//    products, pallas_heads.py:454-471): each corner weight rounded to bf16,
//    each product bf16(row) * bf16(w) rounded to bf16, times the scale
//    rounded to bf16, accumulated in f32 over the corners of each plane in
//    order, the planes in order (one sum). bf16 x bf16 products are exact
//    in f32, so only that order is fixed (the plain version's).
template <int kCorners, typename Row, bool kDots>
__device__ __forceinline__ void fused_point_features(
    const Row* __restrict__ rows0, const Row* __restrict__ rows1, const Row* __restrict__ rows2,
    const float* __restrict__ wts, const float* __restrict__ scale_rows, int m, int part,
    int Mpad, float (&acc)[8]) {
  const Row* rows[3] = {rows0, rows1, rows2};
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const Row* row = rows[p] + (size_t)m * (kCorners * kFeatC) + part * 8;
    const float* sc = scale_rows + p * kFeatC + part * 8;
    if (kDots) {
      float s[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) s[c] = bf16r(sc[c]);
#pragma unroll
      for (int k = 0; k < kCorners; ++k) {
        const float w = bf16r(wts[(size_t)(p * kCorners + k) * Mpad + m]);
        float q[8];
        load8(row + k * kFeatC, q);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[c] = __fadd_rn(acc[c], __fmul_rn(bf16r(__fmul_rn(q[c], w)), s[c]));
      }
    } else {
      float accp[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) accp[c] = 0.f;
#pragma unroll
      for (int k = 0; k < kCorners; ++k) {
        const float w = wts[(size_t)(p * kCorners + k) * Mpad + m];
        float q[8];
        load8(row + k * kFeatC, q);
#pragma unroll
        for (int c = 0; c < 8; ++c) accp[c] = __fadd_rn(accp[c], __fmul_rn(q[c], w));
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(accp[c], sc[c]));
    }
  }
}

}  // namespace ggd
