// Device code of the 5-head decoder chain shared by the inference decode
// kernels K2 (slab_decode.cu), K8 and K9 (brick_decode.cu) — bf16 staging —
// K6's bf16 form (heads_bf16.cu), and the f32 kernels (K6/K7, heads_train.cu;
// the f32 decode tails, decode_f32.cu): the GELU variants, softplus, the
// bf16 chain on the tensor cores (chain_bf16: bf16 mma.sync with f32
// accumulators), the EWA projection of one point (project_point, which the
// f32 tails share) and the decode kernels' tail of the two
// (chain_project_tail).
//
// The tail per point, before and after it moved to the tensor cores: the
// same 5 x (3 x 128 x 128 + 128 x 16) MACs (5.12e5 FLOPs, the first layer
// zero-padded to 128 inputs); weights read from L2 7.8 KB a point (a 64-point
// block converting 500 KB of bf16 to f32 in shared memory) before, 3.9 KB
// after (a 128-point block, the bf16 tiles copied as they are by cp.async).
#pragma once

#include "common.cuh"

namespace ggd {

constexpr int kStage = 128;   // staging width
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

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// ---------------------------------------------------------------------------
// The decode kernels' tail (K2, K8, K9): the bf16 chain over a 128-point
// staging block on the tensor cores, then the EWA projection, channel-major
// rows out. The TPU kernels' shared body is
// decoder/pallas_heads.py::_chain_project_body.
//
// Warp w of the block's 8 owns points 16 w .. 16 w + 15 for the whole chain.
// Each 128 x 128 layer is 8 k-steps x 16 n-tiles of mma.sync m16n8k16
// (bf16 operands, f32 accumulators). The staging (bf16, in shared memory)
// feeds layer 1 through ldmatrix; each layer's accumulator fragment, after
// bias, GELU (f32) and the bf16 rounding, IS the next layer's A fragment
// (the m16n8 C layout of n-tiles 2k, 2k+1 is the m16k16 A layout of k-step
// k), so hidden activations never leave registers. The weights stream
// through a two-slot ring in shared memory by cp.async: the next layer's
// 32 KB arrive while this layer computes. Layer 4 (128 x 16) is two more
// n-tiles; its transformed outputs go to O16 (f32) and, rounded to bf16,
// into the staging columns later heads read.
// ---------------------------------------------------------------------------

constexpr int kDecPts = 128;      // points per block: 8 warps x 16 rows
constexpr int kDecThreads = 256;  // threads per block
constexpr int kNRows = 32;        // output rows
constexpr int kValidCol = 123;    // K2's pad-slot mask column of the staging
constexpr int kXld = 136;   // bf16 row stride of staging and weight tiles: the 8
                            // rows of an ldmatrix land on distinct banks
constexpr int kW4ld = 24;   // bf16 row stride of the 128 x 16 layer-4 tile
constexpr int kMaxHeads = 5;
constexpr int kBiasHead = 3 * kStage + kOutW;   // b1 b2 b3 b4 of one head, f32

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

// host side: cp.async and the 16-byte staging loads need 16-byte aligned rows
inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// dynamic shared memory of a decode block
struct DecodeSmem {
  __nv_bfloat16* X;    // kDecPts x kXld  staging
  __nv_bfloat16* W;    // 2 x kStage x kXld  ring of hidden-layer weights
  __nv_bfloat16* W4;   // kStage x kW4ld  layer 4 of the current head
  float* bias;         // kMaxHeads x kBiasHead
  float* O16;          // kDecPts x kOutW  raw head outputs
  float* sCam;         // 36
};

constexpr size_t kDecodeSmemBytes =
    ((size_t)kDecPts * kXld + 2 * (size_t)kStage * kXld + (size_t)kStage * kW4ld) * 2 +
    ((size_t)kMaxHeads * kBiasHead + kDecPts * kOutW + 36) * sizeof(float);

__device__ __forceinline__ DecodeSmem decode_smem(unsigned char* smem) {
  DecodeSmem s;
  s.X = reinterpret_cast<__nv_bfloat16*>(smem);
  s.W = s.X + kDecPts * kXld;
  s.W4 = s.W + 2 * kStage * kXld;
  s.bias = reinterpret_cast<float*>(s.W4 + kStage * kW4ld);
  s.O16 = s.bias + kMaxHeads * kBiasHead;
  s.sCam = s.O16 + kDecPts * kOutW;
  return s;
}

// stage st = 3 h + l of the weight stream (w1, w2, w3 of head h) -> ring
// slot st & 1, as 16-byte cp.async chunks
__device__ __forceinline__ void fetch_hidden(const DecodeSmem& s, const DecodeChain& cw, int st) {
  const int h = st / 3, l = st % 3;
  const __nv_bfloat16* src =
      (l == 0 ? cw.w1 : (l == 1 ? cw.w2 : cw.w3)) + (size_t)h * kStage * kStage;
  __nv_bfloat16* dst = s.W + (st & 1) * kStage * kXld;
  for (int i = threadIdx.x; i < kStage * kStage / 8; i += kDecThreads) {
    const int r = i >> 4, c = (i & 15) * 8;
    cp_async16(dst + r * kXld + c, src + r * kStage + c);
  }
}

__device__ __forceinline__ void fetch_w4(const DecodeSmem& s, const DecodeChain& cw, int h) {
  const __nv_bfloat16* src = cw.w4 + (size_t)h * kStage * kOutW;
  for (int i = threadIdx.x; i < kStage * kOutW / 8; i += kDecThreads) {
    const int r = i >> 1, c = (i & 1) * 8;
    cp_async16(s.W4 + r * kW4ld + c, src + r * kOutW + c);
  }
}

// block prologue: the first layer's and layer 4's weights in flight, chain
// description, biases and camera to shared memory, O16 zero, X <- the
// block's n_rows rows of the bf16 staging (Mpad x kStage; the rest zero).
// Ends with a barrier.
__device__ __forceinline__ void decode_prologue(const DecodeSmem& s, int* sMeta,
                                                const DecodeChain& cw,
                                                const __nv_bfloat16* __restrict__ staging,
                                                int m0, int n_rows) {
  const int tid = threadIdx.x;
  fetch_hidden(s, cw, 0);
  fetch_w4(s, cw, 0);
  cp_async_commit();
  if (tid < 32) sMeta[tid] = cw.meta[tid];
  if (tid < 36 && cw.cam != nullptr) s.sCam[tid] = cw.cam[tid];
  const int n_heads = cw.meta[0];
  for (int i = tid; i < n_heads * kBiasHead; i += kDecThreads) {
    const int h = i / kBiasHead, j = i % kBiasHead, l = j / kStage, c = j % kStage;
    const float* b = l == 0 ? cw.b1 : (l == 1 ? cw.b2 : (l == 2 ? cw.b3 : cw.b4));
    s.bias[i] = l < 3 ? b[h * kStage + c] : b[h * kOutW + c];
  }
  for (int i = tid; i < kDecPts * kOutW; i += kDecThreads) s.O16[i] = 0.f;
  for (int i = tid; i < kDecPts * kStage / 8; i += kDecThreads) {
    const int r = i >> 4, c = (i & 15) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) v = *reinterpret_cast<const uint4*>(staging + (size_t)(m0 + r) * kStage + c);
    *reinterpret_cast<uint4*>(s.X + r * kXld + c) = v;
  }
  __syncthreads();
}

// bias + GELU (f32) + bf16 rounding of a 16 x 128 accumulator, packed as
// the next layer's A fragments: n-tile j holds columns 8 j + 2 q + {0, 1}
// of rows g and g + 8, which are k-step j / 2's registers 2 (j & 1) and
// 2 (j & 1) + 1
template <int kGelu>
__device__ __forceinline__ void gelu_to_frag(const float (&acc)[16][4], const float* bl, int q,
                                             uint32_t (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = 8 * j + 2 * q;
    const float b0 = bl[n], b1 = bl[n + 1];
    a[j >> 1][(j & 1) * 2] = pack_bf16x2(gelu(acc[j][0] + b0, kGelu), gelu(acc[j][1] + b1, kGelu));
    a[j >> 1][(j & 1) * 2 + 1] =
        pack_bf16x2(gelu(acc[j][2] + b0, kGelu), gelu(acc[j][3] + b1, kGelu));
  }
}

// The bf16 chain over X (features already in columns 0:32): the transformed
// head outputs land in O16 and, rounded to bf16, in the staging columns
// later heads read, where stage_col + out_dim <= kStage (the TPU body's
// guard: the parallel chain's stage columns are kStage, and it writes
// none). Ends with a barrier.
__device__ __forceinline__ void chain_bf16(const DecodeSmem& s, const int* sMeta,
                                           const DecodeChain& cw, float scale_offset) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;   // ldmatrix: this lane's matrix and row
  const int r0 = warp * 16;
  const int n_heads = sMeta[0], gk = sMeta[26], n_stages = 3 * n_heads;
  uint32_t a[8][4];
  for (int h = 0; h < n_heads; ++h) {
    const float* bh = s.bias + h * kBiasHead;
    for (int l = 0; l < 3; ++l) {
      const int st = 3 * h + l;
      // this stage's weights are in; every warp is past stage st - 1, so
      // its slot and (at l = 0) the layer-4 tile may be refilled
      cp_async_wait_all();
      __syncthreads();
      if (st + 1 < n_stages) fetch_hidden(s, cw, st + 1);
      if (l == 0 && h > 0) fetch_w4(s, cw, h);
      cp_async_commit();
      if (l == 0) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          ldmatrix_x4(a[kk], s.X + (r0 + (lm & 1) * 8 + lr) * kXld + kk * 16 + (lm >> 1) * 8);
      }
      const __nv_bfloat16* Ws = s.W + (st & 1) * kStage * kXld;
      float acc[16][4];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 8; ++jp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Ws + (kk * 16 + (lm & 1) * 8 + lr) * kXld + jp * 16 + (lm >> 1) * 8);
          mma_bf16(acc[2 * jp], a[kk], b[0], b[1]);
          mma_bf16(acc[2 * jp + 1], a[kk], b[2], b[3]);
        }
      }
      const float* bl = bh + l * kStage;
      switch (gk) {
        case 0: gelu_to_frag<0>(acc, bl, q, a); break;
        case 1: gelu_to_frag<1>(acc, bl, q, a); break;
        case 2: gelu_to_frag<2>(acc, bl, q, a); break;
        case 3: gelu_to_frag<3>(acc, bl, q, a); break;
        default: gelu_to_frag<4>(acc, bl, q, a); break;
      }
    }
    // layer 4: the tile arrived with stage 3 h + 1's wait
    float o4[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o4[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, s.W4 + (kk * 16 + (lm & 1) * 8 + lr) * kW4ld + (lm >> 1) * 8);
      mma_bf16(o4[0], a[kk], b[0], b[1]);
      mma_bf16(o4[1], a[kk], b[2], b[3]);
    }
    const int out_dim = sMeta[1 + h], stage_col = sMeta[6 + h];
    const int out_col = sMeta[11 + h], kind = sMeta[16 + h];
    const float* b4 = bh + 3 * kStage;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * q + (e & 1), r = r0 + g + 8 * (e >> 1);
        if (col < out_dim) {
          float o = o4[j][e] + b4[col];
          if (kind == 1) o = -softplus(o + 5.f) + scale_offset;
          else if (kind == 2) o = o * 0.01f + (col < 3 ? bf16f(s.X[r * kXld + kInitCol + col]) : 0.f);
          s.O16[r * kOutW + out_col + col] = o;
          if (stage_col + out_dim <= kStage) s.X[r * kXld + stage_col + col] = __float2bfloat16_rn(o);
        }
      }
    __syncwarp();
  }
  __syncthreads();
}

// One point's rows: its raw head outputs o (16, f32) at rows [0:16), then
// the EWA projection, opacity and SH-C0 colour, written to dst[row * Mpad].
// valid scales opac and radius_f; vis_mask scales visible.
__device__ __forceinline__ void project_point(const float* o, const float* sCam,
                                              const int* sMeta, float valid, float vis_mask,
                                              float* __restrict__ dst, int Mpad) {
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

// The decode kernels' tail (K2, K8, K9): the chain over X, then the
// projection, written to out[(row) * Mpad + m0 + point] for the points
// below Mpad. Cull: with valid_col (K2) visible, opac and radius_f are
// multiplied by the staging's valid column; without it (K8, K9) only
// visible is masked, by column < n_points, as the TPU kernel's
// decode_project_pallas does.
__device__ __forceinline__ void chain_project_tail(const DecodeSmem& s, const int* sMeta,
                                                   const DecodeChain& cw,
                                                   float* __restrict__ out, int Mpad, int m0,
                                                   float scale_offset, bool valid_col,
                                                   int n_points) {
  chain_bf16(s, sMeta, cw, scale_offset);
  const int tid = threadIdx.x, m = m0 + tid;
  if (tid < kDecPts && m < Mpad) {
    const float valid = valid_col ? bf16f(s.X[tid * kXld + kValidCol]) : 1.f;
    const float vis_mask = valid_col ? valid : (m < n_points ? 1.f : 0.f);
    project_point(s.O16 + tid * kOutW, s.sCam, sMeta, valid, vis_mask, out + m, Mpad);
  }
}

}  // namespace ggd
