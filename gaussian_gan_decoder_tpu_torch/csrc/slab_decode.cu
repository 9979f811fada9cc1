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
// Weights and activations sit in shared memory as f32 holding bf16 values;
// products accumulate in f32 (register-tiled 4 x 8 per thread).
//
// Bound on the H100: the chain's ~1e5 FMA-heavy FLOPs per point on the CUDA
// cores (tensor-core MMA on the bf16 operands is the next step).
#include "chain.cuh"

namespace {

using ggd::kInitCol;
using ggd::kLds;
using ggd::kOutW;
using ggd::kStage;

constexpr int kPts = 64;          // points per block
constexpr int kThreads = 256;
constexpr int kC = 32;
constexpr int kNRows = 32;
constexpr int kValidCol = 123;

// row indices of the projection block
constexpr int kPx = 16, kPy = 17, kCa = 18, kCb = 19, kCc = 20, kOp = 21, kCol = 22,
              kDepth = 25, kRad = 26, kVis = 27;

// sW (K x N, f32) <- w (K x N, bf16) ; sBias <- bias (N)
__device__ __forceinline__ void load_layer(float* sW, float* sBias, const __nv_bfloat16* w,
                                           const float* bias, int K, int N) {
  for (int i = threadIdx.x; i < K * N; i += kThreads) sW[i] = ggd::bf16f(w[i]);
  for (int i = threadIdx.x; i < N; i += kThreads) sBias[i] = bias[i];
}

__global__ void __launch_bounds__(kThreads) slab_decode_kernel(
    const int8_t* __restrict__ vol, const float* __restrict__ scales,
    const float* __restrict__ positions, const int16_t* __restrict__ idx16,
    const __nv_bfloat16* __restrict__ aux,
    const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
    const __nv_bfloat16* __restrict__ w3, const float* __restrict__ b3,
    const __nv_bfloat16* __restrict__ w4, const float* __restrict__ b4,
    const float* __restrict__ cam, const float* __restrict__ inv_axes,
    const int* __restrict__ meta, float* __restrict__ out,
    int Mpad, int D, int H, int W, int DZ, int YP, int XP, float box_warp,
    float scale_offset) {
  extern __shared__ float smem[];
  float* X = smem;                        // kPts x kLds  staging
  float* A = X + kPts * kLds;             // kPts x kLds  hidden
  float* B = A + kPts * kLds;             // kPts x kLds  hidden
  float* sW = B + kPts * kLds;            // kStage x kStage  current layer
  float* sBias = sW + kStage * kStage;    // kStage
  float* O16 = sBias + kStage;            // kPts x kOutW  raw head outputs
  float* sCam = O16 + kPts * kOutW;       // 36
  __shared__ int sMeta[32];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kPts;
  if (tid < 32) sMeta[tid] = meta[tid];
  if (tid < 36) sCam[tid] = cam[tid];
  for (int i = tid; i < kPts * kOutW; i += kThreads) O16[i] = 0.f;
  // 1. static staging
  for (int i = tid; i < kPts * kStage; i += kThreads) {
    const int r = i / kStage, c = i % kStage;
    X[r * kLds + c] = ggd::bf16f(aux[(size_t)(m0 + r) * kStage + c]);
  }
  __syncthreads();

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

  // 3. the chain
  const int n_heads = sMeta[0];
  const int gk = sMeta[26];
  for (int h = 0; h < n_heads; ++h) {
    load_layer(sW, sBias, w1 + (size_t)h * kStage * kStage, b1 + h * kStage, kStage, kStage);
    __syncthreads();
    ggd::hidden_layer<true>(X, A, sW, sBias, gk);
    __syncthreads();
    load_layer(sW, sBias, w2 + (size_t)h * kStage * kStage, b2 + h * kStage, kStage, kStage);
    __syncthreads();
    ggd::hidden_layer<true>(A, B, sW, sBias, gk);
    __syncthreads();
    load_layer(sW, sBias, w3 + (size_t)h * kStage * kStage, b3 + h * kStage, kStage, kStage);
    __syncthreads();
    ggd::hidden_layer<true>(B, A, sW, sBias, gk);
    __syncthreads();
    load_layer(sW, sBias, w4 + (size_t)h * kStage * kOutW, b4 + h * kOutW, kStage, kOutW);
    __syncthreads();
    {
      const int r = tid >> 2, cb = tid & 3;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int k = 0; k < kStage; ++k) {
        const float a = A[r * kLds + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += a * sW[k * kOutW + cb + 4 * j];
      }
      const int out_dim = sMeta[1 + h], stage_col = sMeta[6 + h];
      const int out_col = sMeta[11 + h], kind = sMeta[16 + h];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cb + 4 * j;
        if (col < out_dim) {
          float o = acc[j] + sBias[col];
          if (kind == 1) o = -ggd::softplus(o + 5.f) + scale_offset;
          else if (kind == 2) o = o * 0.01f + (col < 3 ? X[r * kLds + kInitCol + col] : 0.f);
          O16[r * kOutW + out_col + col] = o;
          X[r * kLds + stage_col + col] = ggd::bf16r(o);
        }
      }
    }
    __syncthreads();
  }

  // 4. projection, one thread per point
  if (tid < kPts) {
    const int m = m0 + tid;
    const float* o = O16 + tid * kOutW;
    float* dst = out + m;
#pragma unroll
    for (int r = 0; r < kOutW; ++r) dst[(size_t)r * Mpad] = o[r];
    const float* wv = sCam;
    const float* pj = sCam + 16;
    const float tanx = sCam[32], tany = sCam[33], imw = sCam[34], imh = sCam[35];
    const int x0 = sMeta[21], r0 = sMeta[22], s0 = sMeta[23], c0 = sMeta[24], op0 = sMeta[25];
    const float mx = o[x0], my = o[x0 + 1], mz = o[x0 + 2];
    const float view_x = mx * wv[0] + my * wv[4] + mz * wv[8] + wv[12];
    const float view_y = mx * wv[1] + my * wv[5] + mz * wv[9] + wv[13];
    const float view_z = mx * wv[2] + my * wv[6] + mz * wv[10] + wv[14];
    const float clip_x = mx * pj[0] + my * pj[4] + mz * pj[8] + pj[12];
    const float clip_y = mx * pj[1] + my * pj[5] + mz * pj[9] + pj[13];
    const float clip_w = mx * pj[3] + my * pj[7] + mz * pj[11] + pj[15];
    const float p_w = 1.f / (clip_w + 1e-7f);
    const bool in_front = view_z > 0.2f;
    const float px = ((clip_x * p_w + 1.f) * imw - 1.f) * 0.5f;
    const float py = ((clip_y * p_w + 1.f) * imh - 1.f) * 0.5f;

    const float focal_x = imw / (2.f * tanx);
    const float focal_y = imh / (2.f * tany);
    const float tz = fabsf(view_z) < 1e-6f ? 1e-6f : view_z;
    const float limx = 1.3f * tanx, limy = 1.3f * tany;
    const float tx = fminf(fmaxf(view_x / tz, -limx), limx) * tz;
    const float ty = fminf(fmaxf(view_y / tz, -limy), limy) * tz;
    // V = W[:3, :3]^T: V[a][b] = wv[b * 4 + a]
    const float inv_z = 1.f / tz;
    const float j00 = focal_x * inv_z;
    const float j02 = -(focal_x * tx) * inv_z * inv_z;
    const float j11 = focal_y * inv_z;
    const float j12 = -(focal_y * ty) * inv_z * inv_z;
    const float u0 = j00 * wv[0] + j02 * wv[2];
    const float u1 = j00 * wv[4] + j02 * wv[6];
    const float u2 = j00 * wv[8] + j02 * wv[10];
    const float v0 = j11 * wv[1] + j12 * wv[2];
    const float v1 = j11 * wv[5] + j12 * wv[6];
    const float v2 = j11 * wv[9] + j12 * wv[10];

    float qr = o[r0], qx = o[r0 + 1], qy = o[r0 + 2], qz = o[r0 + 3];
    const float norm = sqrtf(qr * qr + qx * qx + qy * qy + qz * qz) + 1e-12f;
    qr /= norm; qx /= norm; qy /= norm; qz /= norm;
    const float R00 = 1.f - 2.f * (qy * qy + qz * qz), R01 = 2.f * (qx * qy - qr * qz),
                R02 = 2.f * (qx * qz + qr * qy);
    const float R10 = 2.f * (qx * qy + qr * qz), R11 = 1.f - 2.f * (qx * qx + qz * qz),
                R12 = 2.f * (qy * qz - qr * qx);
    const float R20 = 2.f * (qx * qz - qr * qy), R21 = 2.f * (qy * qz + qr * qx),
                R22 = 1.f - 2.f * (qx * qx + qy * qy);
    const float sc0 = expf(o[s0]), sc1 = expf(o[s0 + 1]), sc2 = expf(o[s0 + 2]);
    const float m00 = R00 * sc0, m01 = R01 * sc1, m02 = R02 * sc2;
    const float m10 = R10 * sc0, m11 = R11 * sc1, m12 = R12 * sc2;
    const float m20 = R20 * sc0, m21 = R21 * sc1, m22 = R22 * sc2;
    const float s_00 = m00 * m00 + m01 * m01 + m02 * m02;
    const float s_01 = m00 * m10 + m01 * m11 + m02 * m12;
    const float s_02 = m00 * m20 + m01 * m21 + m02 * m22;
    const float s_11 = m10 * m10 + m11 * m11 + m12 * m12;
    const float s_12 = m10 * m20 + m11 * m21 + m12 * m22;
    const float s_22 = m20 * m20 + m21 * m21 + m22 * m22;
    const float su0 = s_00 * u0 + s_01 * u1 + s_02 * u2;
    const float su1 = s_01 * u0 + s_11 * u1 + s_12 * u2;
    const float su2 = s_02 * u0 + s_12 * u1 + s_22 * u2;
    const float sv0 = s_00 * v0 + s_01 * v1 + s_02 * v2;
    const float sv1 = s_01 * v0 + s_11 * v1 + s_12 * v2;
    const float sv2 = s_02 * v0 + s_12 * v1 + s_22 * v2;
    const float cov_a = u0 * su0 + u1 * su1 + u2 * su2 + 0.3f;
    const float cov_b = v0 * su0 + v1 * su1 + v2 * su2;
    const float cov_c = v0 * sv0 + v1 * sv1 + v2 * sv2 + 0.3f;
    const float det = cov_a * cov_c - cov_b * cov_b;
    const bool det_ok = det > 0.f;
    const float det_inv = 1.f / (det_ok ? det : 1.f);
    const float mid = 0.5f * (cov_a + cov_c);
    const float lam = mid + sqrtf(fmaxf(0.1f, mid * mid - det));
    const bool vis0 = in_front && det_ok;
    const float radius = vis0 ? ceilf(3.f * sqrtf(lam)) : 0.f;
    const bool visible = vis0 && radius > 0.f;
    const float valid = X[tid * kLds + kValidCol];

    dst[(size_t)kPx * Mpad] = px;
    dst[(size_t)kPy * Mpad] = py;
    dst[(size_t)kCa * Mpad] = cov_c * det_inv;
    dst[(size_t)kCb * Mpad] = -cov_b * det_inv;
    dst[(size_t)kCc * Mpad] = cov_a * det_inv;
    dst[(size_t)kOp * Mpad] = valid * (1.f / (1.f + expf(-o[op0])));
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dst[(size_t)(kCol + k) * Mpad] = fmaxf(0.28209479177387814f * o[c0 + k] + 0.5f, 0.f);
    dst[(size_t)kDepth * Mpad] = view_z;
    dst[(size_t)kRad * Mpad] = radius * valid;
    dst[(size_t)kVis * Mpad] = (visible ? 1.f : 0.f) * valid;
#pragma unroll
    for (int r = kVis + 1; r < kNRows; ++r) dst[(size_t)r * Mpad] = 0.f;
  }
}

}  // namespace

extern "C" int ggd_slab_decode(const void* vol, const void* scales, const void* positions,
                               const void* idx16, const void* aux, const void* w1,
                               const void* b1, const void* w2, const void* b2, const void* w3,
                               const void* b3, const void* w4, const void* b4, const void* cam,
                               const void* inv_axes, const void* meta, void* out, int Mpad,
                               int D, int H, int W, int DZ, int YP, int XP, float box_warp,
                               float scale_offset, void* stream) {
  if (Mpad <= 0 || Mpad % kPts != 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (3 * (size_t)kPts * kLds + kStage * kStage + kStage + kPts * kOutW + 36) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(slab_decode_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  slab_decode_kernel<<<Mpad / kPts, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)vol, (const float*)scales, (const float*)positions,
      (const int16_t*)idx16, (const __nv_bfloat16*)aux, (const __nv_bfloat16*)w1,
      (const float*)b1, (const __nv_bfloat16*)w2, (const float*)b2,
      (const __nv_bfloat16*)w3, (const float*)b3, (const __nv_bfloat16*)w4,
      (const float*)b4, (const float*)cam, (const float*)inv_axes, (const int*)meta,
      (float*)out, Mpad, D, H, W, DZ, YP, XP, box_warp, scale_offset);
  return (int)cudaGetLastError();
}
