// K6 / K7: the 5-head decoder chain of the training step, f32, forward and
// backward.
//
// K6 replaces the TPU kernel gaussian_gan_decoder_tpu/decoder/pallas_heads.py
// ::decode_heads_pallas (_heads_kernel, compute_dtype f32): per point the
// staging row (128 f32: plane-mean feature, position, chain columns, init at
// 120) runs through the heads; head h reads the staging prefix, 3 x (128x128
// linear + GELU) and a 128x16 linear, then scale = -softplus(o + 5) + offset
// or xyz = 0.01 o + init; the transformed output lands in the packed (M, 16)
// result and, for later heads, in the staging columns. It is K2's chain
// (chain.cuh, hidden_layer) without the slab gather, the projection and the
// bf16 rounding. One block of 256 threads per 64 points, f32 weights of the
// current layer in shared memory.
//
// K7 replaces decoder/pallas_heads_vjp.py::_run_bwd (_heads_bwd_kernel): the
// exact reverse of K6's chain. The TPU kernel keeps 5 residual sets per head
// in VMEM (25 x block x 128 f32), which does not fit a Hopper block. K7
// takes K6's packed outputs instead: the staging before head h is the input
// staging plus the outputs of heads < h, so each head's hidden layers are
// recomputed during its reverse step from that snapshot. One block walks
// 32-point tiles (blockIdx.x, + gridDim.x, ...); the per-point staging
// gradient is written once per tile, and the weight and bias gradients are
// summed into this block's own slice of a partial buffer (no atomics), which
// heads_grad_reduce sums in a fixed order: bit-identical run to run.
//
// Bound on the H100: operations. Per point K6 does 5 x (3 x 128 x 128 +
// 128 x 16) multiply-adds (~5.1e5 FLOPs), K7 about three times that (the
// recompute, the data gradient and the weight gradient of each layer), all
// in f32 on the CUDA cores; tensor cores are a later step.
#include "chain.cuh"

namespace {

using ggd::gelu;
using ggd::gelu_exact_grad;
using ggd::kGeluExact;
using ggd::kInitCol;
using ggd::kLds;
using ggd::kOutW;
using ggd::kStage;

constexpr int kThreads = 256;
constexpr int kFwdPts = 64;   // K6 points per block
constexpr int kTile = 32;     // K7 points per tile
constexpr int kW4Ld = 17;     // padded row stride of W4 in K7 (transposed reads)
// per-head slice of the gradient partials: w1 b1 w2 b2 w3 b3 w4 b4
constexpr int kOffB1 = kStage * kStage;
constexpr int kOffW2 = kOffB1 + kStage;
constexpr int kOffB2 = kOffW2 + kStage * kStage;
constexpr int kOffW3 = kOffB2 + kStage;
constexpr int kOffB3 = kOffW3 + kStage * kStage;
constexpr int kOffW4 = kOffB3 + kStage;
constexpr int kOffB4 = kOffW4 + kStage * kOutW;
constexpr int kHeadGrad = kOffB4 + kOutW;   // 51600 floats

struct Chain {
  const float *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;
};

__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int K, int N) {
  for (int i = threadIdx.x; i < K * N; i += kThreads) dst[(i / N) * ld + i % N] = src[i];
}

// transformed head output (meta kind: 1 scale, 2 xyz)
__device__ __forceinline__ float transform(float o, int kind, int col, float scale_offset,
                                           const float* xrow) {
  if (kind == 1) return -ggd::softplus(o + 5.f) + scale_offset;
  if (kind == 2) return o * 0.01f + (col < 3 ? xrow[kInitCol + col] : 0.f);
  return o;
}

__global__ void __launch_bounds__(kThreads) heads_fwd_kernel(
    const float* __restrict__ staging, Chain cw, const int* __restrict__ meta,
    float* __restrict__ out, float scale_offset) {
  extern __shared__ float smem[];
  float* X = smem;                          // kFwdPts x kLds staging
  float* A = X + kFwdPts * kLds;            // hidden
  float* B = A + kFwdPts * kLds;            // hidden
  float* sW = B + kFwdPts * kLds;           // 128 x 128 current layer
  float* sBias = sW + kStage * kStage;      // 128
  float* O16 = sBias + kStage;              // kFwdPts x kOutW
  __shared__ int sMeta[32];
  const int tid = threadIdx.x;
  const size_t m0 = (size_t)blockIdx.x * kFwdPts;
  if (tid < 32) sMeta[tid] = meta[tid];
  for (int i = tid; i < kFwdPts * kOutW; i += kThreads) O16[i] = 0.f;
  for (int i = tid; i < kFwdPts * kStage; i += kThreads)
    X[(i / kStage) * kLds + i % kStage] = staging[m0 * kStage + i];
  __syncthreads();
  const int n_heads = sMeta[0], gk = sMeta[26];
  for (int h = 0; h < n_heads; ++h) {
    const float* ws[3] = {cw.w1, cw.w2, cw.w3};
    const float* bs[3] = {cw.b1, cw.b2, cw.b3};
    const float* src[3] = {X, A, B};
    float* dst[3] = {A, B, A};
    for (int l = 0; l < 3; ++l) {
      load_rows(sW, kStage, ws[l] + (size_t)h * kStage * kStage, kStage, kStage);
      for (int i = tid; i < kStage; i += kThreads) sBias[i] = bs[l][h * kStage + i];
      __syncthreads();
      ggd::hidden_layer<false>(src[l], dst[l], sW, sBias, gk);
      __syncthreads();
    }
    load_rows(sW, kOutW, cw.w4 + (size_t)h * kStage * kOutW, kStage, kOutW);
    if (tid < kOutW) sBias[tid] = cw.b4[h * kOutW + tid];
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
      const int od = sMeta[1 + h], sc = sMeta[6 + h], oc = sMeta[11 + h], kind = sMeta[16 + h];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cb + 4 * j;
        if (col < od) {
          const float o = transform(acc[j] + sBias[col], kind, col, scale_offset, X + r * kLds);
          O16[r * kOutW + oc + col] = o;
          if (sc + od <= kStage) X[r * kLds + sc + col] = o;
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < kFwdPts * kOutW; i += kThreads) out[m0 * kOutW + i] = O16[i];
}

// ---- K7 building blocks on a 32-point tile, 256 threads -------------------
// thread (tx, ty) = (tid & 15, tid >> 4) owns rows 2 ty + {0,1}, columns
// tx + 16 j (j < 8) of a 32 x 128 result.

// out = in @ W[:K, :128] + bias (pre-activation); act = gelu(out) when act
__device__ __forceinline__ void mm_fwd(const float* in, const float* W, int K,
                                       const float* bias, float* out, float* act) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = in[(ty * 2) * kLds + k], a1 = in[(ty * 2 + 1) * kLds + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = W[k * kLds + tx + 16 * j];
      acc[0][j] += a0 * b;
      acc[1][j] += a1 * b;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j, r = ty * 2 + i;
      const float z = acc[i][j] + bias[n];
      out[r * kLds + n] = z;
      if (act != nullptr) act[r * kLds + n] = gelu(z, kGeluExact);
    }
}

// out[:, k] (=, or += when accumulate) sum_n g[:, n] W[k, n], k < 128,
// n < N, W row stride ldw
__device__ __forceinline__ void mm_bwd(const float* g, const float* W, int ldw, int N,
                                       float* out, bool accumulate) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    const float g0 = g[(ty * 2) * kLds + n], g1 = g[(ty * 2 + 1) * kLds + n];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float b = W[(tx + 16 * j) * ldw + n];
      acc[0][j] += g0 * b;
      acc[1][j] += g1 * b;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* o = out + (ty * 2 + i) * kLds + tx + 16 * j;
      *o = accumulate ? *o + acc[i][j] : acc[i][j];
    }
}

// partial dW[k, n] += sum_p a[p, k] g[p, n] (128 x 128), db[n] += sum_p g[p, n]
__device__ __forceinline__ void wgrad(const float* a, const float* g, float* pw, float* pb) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int p = 0; p < kTile; ++p) {
    float av[8], gv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) av[i] = a[p * kLds + ty * 8 + i];
#pragma unroll
    for (int j = 0; j < 8; ++j) gv[j] = g[p * kLds + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * gv[j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) pw[(ty * 8 + i) * kStage + tx + 16 * j] += acc[i][j];
  if (threadIdx.x < kStage) {
    float s = 0.f;
    for (int p = 0; p < kTile; ++p) s += g[p * kLds + threadIdx.x];
    pb[threadIdx.x] += s;
  }
}

// dz = da * gelu'(z), in place on da
__device__ __forceinline__ void times_gelu_grad(float* da, const float* z) {
  for (int i = threadIdx.x; i < kTile * kStage; i += kThreads) {
    const int r = i / kStage, c = i % kStage;
    da[r * kLds + c] *= gelu_exact_grad(z[r * kLds + c]);
  }
}

__device__ __forceinline__ void gelu_of(const float* z, float* a) {
  for (int i = threadIdx.x; i < kTile * kStage; i += kThreads) {
    const int r = i / kStage, c = i % kStage;
    a[r * kLds + c] = gelu(z[r * kLds + c], kGeluExact);
  }
}

__global__ void __launch_bounds__(kThreads) heads_bwd_kernel(
    const float* __restrict__ staging, const float* __restrict__ out16,
    const float* __restrict__ dout, Chain cw, const int* __restrict__ meta,
    float* __restrict__ dstage, float* __restrict__ partials, int n_tiles,
    float scale_offset) {
  extern __shared__ float smem[];
  float* X = smem;                      // kTile x kLds staging before head h
  float* Z1 = X + kTile * kLds;         // pre-activations, later gradients
  float* Z2 = Z1 + kTile * kLds;
  float* Z3 = Z2 + kTile * kLds;
  float* T = Z3 + kTile * kLds;         // an activation
  float* G = T + kTile * kLds;          // dO (16 cols) then dz3
  float* DX = G + kTile * kLds;         // staging gradient
  float* Oraw = DX + kTile * kLds;      // kTile x kOutW raw layer-4 output
  float* sW = Oraw + kTile * kOutW;     // 128 x kLds (W4: 128 x kW4Ld)
  float* sBias = sW + kStage * kLds;    // 128
  __shared__ int sMeta[32];
  const int tid = threadIdx.x;
  if (tid < 32) sMeta[tid] = meta[tid];
  __syncthreads();
  const int n_heads = sMeta[0];   // the wrapper admits the exact GELU only
  float* part = partials + (size_t)blockIdx.x * 5 * kHeadGrad;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t m0 = (size_t)tile * kTile;
    for (int i = tid; i < kTile * kStage; i += kThreads) DX[(i / kStage) * kLds + i % kStage] = 0.f;
    for (int h = n_heads - 1; h >= 0; --h) {
      float* ph = part + (size_t)h * kHeadGrad;
      const int od = sMeta[1 + h], sc = sMeta[6 + h], oc = sMeta[11 + h], kind = sMeta[16 + h];
      // staging before head h: the input plus the outputs of heads < h
      for (int i = tid; i < kTile * kStage; i += kThreads) {
        const int r = i / kStage, c = i % kStage;
        float v = staging[m0 * kStage + i];
        for (int j = 0; j < h; ++j) {
          const int scj = sMeta[6 + j], odj = sMeta[1 + j];
          if (c >= scj && c < scj + odj && scj + odj <= kStage)
            v = out16[(m0 + r) * kOutW + sMeta[11 + j] + c - scj];
        }
        X[r * kLds + c] = v;
      }
      // recompute the hidden layers
      load_rows(sW, kLds, cw.w1 + (size_t)h * kStage * kStage, kStage, kStage);
      for (int i = tid; i < kStage; i += kThreads) sBias[i] = cw.b1[h * kStage + i];
      __syncthreads();
      mm_fwd(X, sW, kStage, sBias, Z1, T);
      __syncthreads();
      load_rows(sW, kLds, cw.w2 + (size_t)h * kStage * kStage, kStage, kStage);
      for (int i = tid; i < kStage; i += kThreads) sBias[i] = cw.b2[h * kStage + i];
      __syncthreads();
      mm_fwd(T, sW, kStage, sBias, Z2, nullptr);
      __syncthreads();
      gelu_of(Z2, T);
      load_rows(sW, kLds, cw.w3 + (size_t)h * kStage * kStage, kStage, kStage);
      for (int i = tid; i < kStage; i += kThreads) sBias[i] = cw.b3[h * kStage + i];
      __syncthreads();
      mm_fwd(T, sW, kStage, sBias, Z3, nullptr);
      __syncthreads();
      gelu_of(Z3, T);                                     // T = a3
      load_rows(sW, kW4Ld, cw.w4 + (size_t)h * kStage * kOutW, kStage, kOutW);
      if (tid < kOutW) sBias[tid] = cw.b4[h * kOutW + tid];
      __syncthreads();
      for (int e = tid; e < kTile * kOutW; e += kThreads) {   // raw layer-4 output
        const int r = e / kOutW, j = e % kOutW;
        float acc = 0.f;
        for (int k = 0; k < kStage; ++k) acc += T[r * kLds + k] * sW[k * kW4Ld + j];
        Oraw[e] = acc + sBias[j];
      }
      __syncthreads();
      // dT = upstream + chain-conditioning gradient; the forward's staging
      // write overwrote those columns, so their gradient stops here
      for (int e = tid; e < kTile * kOutW; e += kThreads) {
        const int r = e / kOutW, j = e % kOutW;
        float dO = 0.f;
        if (j < od) {
          float dT = dout[(m0 + r) * kOutW + oc + j];
          if (sc + od <= kStage) {
            dT += DX[r * kLds + sc + j];
            DX[r * kLds + sc + j] = 0.f;
          }
          if (kind == 1) {
            dO = -dT / (1.f + expf(-(Oraw[e] + 5.f)));
          } else if (kind == 2) {
            dO = dT * 0.01f;
            if (j < 3) DX[r * kLds + kInitCol + j] += dT;
          } else {
            dO = dT;
          }
        }
        G[r * kLds + j] = dO;
      }
      __syncthreads();
      // layer 4: dW4 += a3^T dO, db4, da3 = dO W4^T
      for (int i = 0; i < 8; ++i) {
        const int e = tid + kThreads * i, k = e >> 4, j = e & 15;
        float acc = 0.f;
        for (int p = 0; p < kTile; ++p) acc += T[p * kLds + k] * G[p * kLds + j];
        ph[kOffW4 + e] += acc;
      }
      if (tid < kOutW) {
        float s = 0.f;
        for (int p = 0; p < kTile; ++p) s += G[p * kLds + tid];
        ph[kOffB4 + tid] += s;
      }
      __syncthreads();
      mm_bwd(G, sW, kW4Ld, kOutW, T, false);             // T = da3
      __syncthreads();
      times_gelu_grad(T, Z3);                             // T = dz3
      __syncthreads();
      // layer 3
      gelu_of(Z2, Z3);                                    // Z3 = a2
      load_rows(sW, kLds, cw.w3 + (size_t)h * kStage * kStage, kStage, kStage);
      __syncthreads();
      wgrad(Z3, T, ph + kOffW3, ph + kOffB3);
      mm_bwd(T, sW, kLds, kStage, G, false);              // G = da2
      __syncthreads();
      times_gelu_grad(G, Z2);                             // G = dz2
      __syncthreads();
      // layer 2
      gelu_of(Z1, Z3);                                    // Z3 = a1
      load_rows(sW, kLds, cw.w2 + (size_t)h * kStage * kStage, kStage, kStage);
      __syncthreads();
      wgrad(Z3, G, ph + kOffW2, ph + kOffB2);
      mm_bwd(G, sW, kLds, kStage, T, false);              // T = da1
      __syncthreads();
      times_gelu_grad(T, Z1);                             // T = dz1
      __syncthreads();
      // layer 1
      load_rows(sW, kLds, cw.w1 + (size_t)h * kStage * kStage, kStage, kStage);
      __syncthreads();
      wgrad(X, T, ph, ph + kOffB1);
      mm_bwd(T, sW, kLds, kStage, DX, true);
      __syncthreads();
    }
    for (int i = tid; i < kTile * kStage; i += kThreads)
      dstage[m0 * kStage + i] = DX[(i / kStage) * kLds + i % kStage];
    __syncthreads();
  }
}

// out[i] = sum over the n_part partial slices, in order
__global__ void heads_grad_reduce(const float* __restrict__ partials, float* __restrict__ out,
                                  int n_part, int width) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  float s = 0.f;
  for (int g = 0; g < n_part; ++g) s += partials[(size_t)g * width + i];
  out[i] = s;
}

}  // namespace

extern "C" int ggd_heads_fwd(const void* staging, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* w3, const void* b3,
                             const void* w4, const void* b4, const void* meta, void* out,
                             int Mpad, float scale_offset, void* stream) {
  if (Mpad <= 0 || Mpad % kFwdPts != 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (3 * (size_t)kFwdPts * kLds + kStage * kStage + kStage + kFwdPts * kOutW) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(heads_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Chain cw{(const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
                 (const float*)w3, (const float*)b3, (const float*)w4, (const float*)b4};
  heads_fwd_kernel<<<Mpad / kFwdPts, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)staging, cw, (const int*)meta, (float*)out, scale_offset);
  return (int)cudaGetLastError();
}

// partials: n_part x (5 x 51600) zeros; grads: 5 x 51600, per head
// w1 (128x128, in x out) b1 w2 b2 w3 b3 w4 (128x16) b4
extern "C" int ggd_heads_bwd(const void* staging, const void* out16, const void* dout,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const void* w3, const void* b3, const void* w4, const void* b4,
                             const void* meta, void* dstage, void* partials, void* grads,
                             int Mpad, int n_part, float scale_offset, void* stream) {
  if (Mpad <= 0 || Mpad % kTile != 0 || n_part < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (7 * (size_t)kTile * kLds + kTile * kOutW + kStage * kLds + kStage) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(heads_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Chain cw{(const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
                 (const float*)w3, (const float*)b3, (const float*)w4, (const float*)b4};
  heads_bwd_kernel<<<n_part, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)staging, (const float*)out16, (const float*)dout, cw, (const int*)meta,
      (float*)dstage, (float*)partials, Mpad / kTile, scale_offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int width = 5 * kHeadGrad;
  heads_grad_reduce<<<(width + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)partials, (float*)grads, n_part, width);
  return (int)cudaGetLastError();
}
