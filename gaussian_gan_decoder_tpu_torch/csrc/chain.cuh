// Device code of the 5-head decoder chain shared by the inference decode
// kernels K2 (slab_decode.cu), K8 and K9 (brick_decode.cu) — bf16 staging —
// and the training kernels K6/K7 (heads_train.cu, f32): the GELU variants,
// the exact GELU's derivative, softplus, the 128-wide hidden layer of a
// 64-point block, and the decode kernels' shared chain + EWA projection
// tail (chain_project_tail).
#pragma once

#include "common.cuh"

namespace ggd {

constexpr int kStage = 128;   // staging width
constexpr int kLds = 132;     // padded row stride of staging/hidden tiles (bank spread)
constexpr int kOutW = 16;     // padded head-output width
constexpr int kInitCol = 120; // raw init_position stash (3 columns)

// GELU ids (decoder/pallas_heads.py _GELU_IDS): 0 exact (A&S 7.1.26 erf),
// 1 tanh, 2 poly (deg 9 in x^2), 3 poly6, 4 none
static __constant__ float kGeluPoly[10] = {2.83848659e-05f, 3.98631713e-01f, -6.59243150e-02f,
                                    9.56686907e-03f, -1.03506464e-03f, 8.13021533e-05f,
                                    -4.45819445e-06f, 1.60138706e-07f, -3.35935034e-09f,
                                    3.10310371e-11f};
static __constant__ float kGeluPoly6[7] = {1.78927555e-03f, 3.88399878e-01f, -5.61855200e-02f,
                                    5.99722169e-03f, -3.76970754e-04f, 1.25452394e-05f,
                                    -1.69796236e-07f};

__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.f) - (x < 0.f)); }

// A&S 7.1.26 erf, the TPU kernels' erf
__device__ __forceinline__ float erf_as(float x) {
  const float a = fabsf(x);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  return sgn(x) * (1.f - poly * expf(-a * a));
}

__device__ __forceinline__ float horner_gelu(float x, const float* c, int n) {
  const float u = x * x;
  float acc = c[n - 1];
  for (int i = n - 2; i >= 0; --i) acc = acc * u + c[i];
  const float y = 0.5f * x + acc;
  return x > 4.5f ? x : (x < -4.5f ? 0.f : y);
}

__device__ __forceinline__ float gelu(float x, int kind) {
  switch (kind) {
    case 0: return x * 0.5f * (1.f + erf_as(x * 0.70710678118654752f));
    case 1: {
      const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      const float e = expf(-2.f * fabsf(u));
      const float t = (1.f - e) / (1.f + e);
      return 0.5f * x * (1.f + sgn(u) * t);
    }
    case 2: return horner_gelu(x, kGeluPoly, 10);
    case 3: return horner_gelu(x, kGeluPoly6, 7);
    default: return x;
  }
}

constexpr int kGeluExact = 0;

// d gelu / dx of the exact GELU on the A&S erf (decoder/pallas_heads_vjp.py
// _GELU_GRADS['exact']), the only GELU the training chain differentiates
__device__ __forceinline__ float gelu_exact_grad(float x) {
  const float cdf = 0.5f * (1.f + erf_as(x * 0.70710678118654752f));
  return cdf + x * 0.3989422804014327f * expf(-0.5f * x * x);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// out = gelu(in @ W + b) for a 64 x 128 x 128 layer of a 256-thread block,
// thread tile 4 x 8; rounded to bf16 when kRound (K2's rounding points).
// in/out rows have stride kLds, sW is 128 x 128 (in, out).
template <bool kRound>
__device__ __forceinline__ void hidden_layer(const float* in, float* out, const float* sW,
                                             const float* sBias, int gelu_kind) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kStage; ++k) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = in[(ty * 4 + i) * kLds + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = sW[k * kStage + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      const float v = gelu(acc[i][j] + sBias[n], gelu_kind);
      out[(ty * 4 + i) * kLds + n] = kRound ? bf16r(v) : v;
    }
}

// ---------------------------------------------------------------------------
// The decode kernels' tail (K2, K8, K9): the bf16 chain over a 64-point
// staging block, then the EWA projection, channel-major rows out. The TPU
// kernels' shared body is decoder/pallas_heads.py::_chain_project_body.
// ---------------------------------------------------------------------------

constexpr int kDecPts = 64;       // points per block
constexpr int kDecThreads = 256;  // threads per block
constexpr int kNRows = 32;        // output rows
constexpr int kValidCol = 123;    // K2's pad-slot mask column of the staging

// row indices of the projection block (pallas_heads.PROJ_ROWS)
constexpr int kPx = 16, kPy = 17, kCa = 18, kCb = 19, kCc = 20, kOp = 21, kCol = 22,
              kDepth = 25, kRad = 26, kVis = 27;

// the packed bf16 chain (pallas_heads.ChainWeights) and the camera
struct DecodeChain {
  const __nv_bfloat16* w1; const float* b1;
  const __nv_bfloat16* w2; const float* b2;
  const __nv_bfloat16* w3; const float* b3;
  const __nv_bfloat16* w4; const float* b4;
  const float* cam;   // 36: world_view (16), full_proj (16), tanx, tany, W, H
  const int* meta;    // 32: chain description
};

// host side: the chain's raw pointers (ctypes) as a kernel argument
inline DecodeChain decode_chain(const void* w1, const void* b1, const void* w2, const void* b2,
                                const void* w3, const void* b3, const void* w4, const void* b4,
                                const void* cam, const void* meta) {
  return DecodeChain{(const __nv_bfloat16*)w1, (const float*)b1, (const __nv_bfloat16*)w2,
                     (const float*)b2, (const __nv_bfloat16*)w3, (const float*)b3,
                     (const __nv_bfloat16*)w4, (const float*)b4, (const float*)cam,
                     (const int*)meta};
}

// dynamic shared memory of a decode block, in floats
struct DecodeSmem {
  float* X;      // kDecPts x kLds  staging
  float* A;      // kDecPts x kLds  hidden
  float* B;      // kDecPts x kLds  hidden
  float* sW;     // kStage x kStage  current layer
  float* sBias;  // kStage
  float* O16;    // kDecPts x kOutW  raw head outputs
  float* sCam;   // 36
};

constexpr size_t kDecodeSmemBytes =
    (3 * (size_t)kDecPts * kLds + kStage * kStage + kStage + kDecPts * kOutW + 36) *
    sizeof(float);

__device__ __forceinline__ DecodeSmem decode_smem(float* smem) {
  DecodeSmem s;
  s.X = smem;
  s.A = s.X + kDecPts * kLds;
  s.B = s.A + kDecPts * kLds;
  s.sW = s.B + kDecPts * kLds;
  s.sBias = s.sW + kStage * kStage;
  s.O16 = s.sBias + kStage;
  s.sCam = s.O16 + kDecPts * kOutW;
  return s;
}

// sW (K x N, f32) <- w (K x N, bf16) ; sBias <- bias (N)
__device__ __forceinline__ void load_layer_bf16(float* sW, float* sBias, const __nv_bfloat16* w,
                                                const float* bias, int K, int N) {
  for (int i = threadIdx.x; i < K * N; i += kDecThreads) sW[i] = bf16f(w[i]);
  for (int i = threadIdx.x; i < N; i += kDecThreads) sBias[i] = bias[i];
}

// block prologue: chain description and camera to shared memory, O16 zero,
// X <- the block's rows of the bf16 staging (Mpad x kStage). Ends with a
// barrier.
__device__ __forceinline__ void decode_prologue(const DecodeSmem& s, int* sMeta,
                                                const DecodeChain& cw,
                                                const __nv_bfloat16* __restrict__ staging,
                                                int m0) {
  const int tid = threadIdx.x;
  if (tid < 32) sMeta[tid] = cw.meta[tid];
  if (tid < 36) s.sCam[tid] = cw.cam[tid];
  for (int i = tid; i < kDecPts * kOutW; i += kDecThreads) s.O16[i] = 0.f;
  for (int i = tid; i < kDecPts * kStage; i += kDecThreads) {
    const int r = i / kStage, c = i % kStage;
    s.X[r * kLds + c] = bf16f(staging[(size_t)(m0 + r) * kStage + c]);
  }
  __syncthreads();
}

// The chain over X (features already in columns 0:32) and the projection,
// written to out[(row) * Mpad + m0 + point]. Cull: with valid_col (K2)
// visible, opac and radius_f are multiplied by the staging's valid column;
// without it (K8, K9) only visible is masked, by column < n_points, as the
// TPU kernel's decode_project_pallas does.
__device__ __forceinline__ void chain_project_tail(const DecodeSmem& s, const int* sMeta,
                                                   const DecodeChain& cw,
                                                   float* __restrict__ out, int Mpad, int m0,
                                                   float scale_offset, bool valid_col,
                                                   int n_points) {
  const int tid = threadIdx.x;
  float* X = s.X;
  float* A = s.A;
  float* B = s.B;
  float* sW = s.sW;
  float* sBias = s.sBias;
  float* O16 = s.O16;
  const int n_heads = sMeta[0];
  const int gk = sMeta[26];
  for (int h = 0; h < n_heads; ++h) {
    load_layer_bf16(sW, sBias, cw.w1 + (size_t)h * kStage * kStage, cw.b1 + h * kStage, kStage,
                    kStage);
    __syncthreads();
    hidden_layer<true>(X, A, sW, sBias, gk);
    __syncthreads();
    load_layer_bf16(sW, sBias, cw.w2 + (size_t)h * kStage * kStage, cw.b2 + h * kStage, kStage,
                    kStage);
    __syncthreads();
    hidden_layer<true>(A, B, sW, sBias, gk);
    __syncthreads();
    load_layer_bf16(sW, sBias, cw.w3 + (size_t)h * kStage * kStage, cw.b3 + h * kStage, kStage,
                    kStage);
    __syncthreads();
    hidden_layer<true>(B, A, sW, sBias, gk);
    __syncthreads();
    load_layer_bf16(sW, sBias, cw.w4 + (size_t)h * kStage * kOutW, cw.b4 + h * kOutW, kStage,
                    kOutW);
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
          if (kind == 1) o = -softplus(o + 5.f) + scale_offset;
          else if (kind == 2) o = o * 0.01f + (col < 3 ? X[r * kLds + kInitCol + col] : 0.f);
          O16[r * kOutW + out_col + col] = o;
          X[r * kLds + stage_col + col] = bf16r(o);
        }
      }
    }
    __syncthreads();
  }

  // projection, one thread per point
  if (tid < kDecPts) {
    const int m = m0 + tid;
    const float* o = O16 + tid * kOutW;
    float* dst = out + m;
#pragma unroll
    for (int r = 0; r < kOutW; ++r) dst[(size_t)r * Mpad] = o[r];
    const float* wv = s.sCam;
    const float* pj = s.sCam + 16;
    const float tanx = s.sCam[32], tany = s.sCam[33], imw = s.sCam[34], imh = s.sCam[35];
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
    const float valid = valid_col ? X[tid * kLds + kValidCol] : 1.f;
    const float vis_mask = valid_col ? valid : (m < n_points ? 1.f : 0.f);

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
    dst[(size_t)kVis * Mpad] = (visible ? 1.f : 0.f) * vis_mask;
#pragma unroll
    for (int r = kVis + 1; r < kNRows; ++r) dst[(size_t)r * Mpad] = 0.f;
  }
}

}  // namespace ggd
