// K4 / K5: the training tile blend, forward and backward (f32 payload).
//
// K4 replaces the TPU kernel gaussian_gan_decoder_tpu/splat/pallas_blend.py
// ::_blend_train_fwd (_blend_kernel with save_entries). It differs from the
// inference blend K3 (blend.cu) in exactly the TPU's training rule: a pair
// blends only while the transmittance T before it is >= 1e-4, and once T
// falls below that it stays (alpha is masked to 0, T is frozen). The rule
// does not depend on how the pairs are cut into chunks, so each pixel runs
// a sequential loop with an early exit. Residuals: none beyond the output,
// (accum rgb, final T) per pixel, which K5 reads.
//
// K5 replaces _blend_train_bwd_call (_blend_bwd_kernel + _scatter_blocks):
// the exact gradient of K4's masked forward,
//   dalpha_i = T_i (c_i . dC) - S_i / (1 - a_i) - T_final dT / (1 - a_i),
//   S_i = sum_{j > i} w_j (c_j . dC),
// zero where alpha was clamped (op exp(power) >= 0.99), skipped or masked.
// It replays the pairs FRONT TO BACK with the same arithmetic as K4 (so T_i
// and every mask decision are K4's, bit for bit) and takes
// S_i = accum . dC - prefix_i from K4's own output instead of recovering T_i
// by dividing by (1 - a) back to front. The subtraction costs S_i an absolute
// error of about 1e-7 |accum . dC| per pixel. A pair belongs to one tile, so
// its 9 gradients are sums over that tile's 256 pixels: a warp-shuffle sum
// per warp, then the 8 warp partials in a fixed order; each pair's gradient
// is written once, no atomics.
//
// One block per 16x16 tile, one thread per pixel; pairs [start, start +
// min(count, max_k)) staged through shared memory in chunks. Bound on the
// H100: operations, an exp and ~20 FLOPs per (pair, pixel) forward, ~60
// and 9 warp sums backward, serial per pixel through T.
#include "common.cuh"

namespace {

constexpr int kRows = 9;
constexpr int kChunk = 128;
constexpr int kWarps = 8;   // 256 pixels

struct Pix {
  float x, y;
};

__device__ __forceinline__ Pix pixel(int t, int p, int grid_x, int ts) {
  return {(float)((t % grid_x) * ts + p % ts), (float)((t / grid_x) * ts + p / ts)};
}

// one (pair, pixel) of the blend, the same code in K4 and K5 so that both
// make the same decisions: -> falloff exp(power), raw = op exp(power), alpha
// (0 where skipped: power > 0 or alpha < 1/255)
struct Falloff {
  float dx, dy, e, raw, alpha;
  bool live;
};

__device__ __forceinline__ Falloff falloff(Pix px, const float (*s)[kChunk], int j) {
  Falloff f;
  f.dx = px.x - s[0][j];
  f.dy = px.y - s[1][j];
  const float power = ggd::falloff_power(s[2][j], s[3][j], s[4][j], f.dx, f.dy);
  f.e = expf(power);
  f.raw = s[5][j] * f.e;
  f.alpha = fminf(0.99f, f.raw);
  f.live = !(power > 0.f || f.alpha < (1.f / 255.f));
  if (!f.live) f.alpha = 0.f;
  return f;
}

__global__ void __launch_bounds__(256) blend_train_fwd_kernel(
    const int* __restrict__ starts, const float* __restrict__ attrs, float* __restrict__ out,
    int Ptot, int grid_x, int ts, int max_k) {
  __shared__ float s[kRows][kChunk];
  const int t = blockIdx.x, p = threadIdx.x;
  const int start = starts[t];
  const int count = min(starts[t + 1] - start, max_k);
  const Pix px = pixel(t, p, grid_x, ts);
  float T = 1.f, ar = 0.f, ag = 0.f, ab = 0.f;
  bool done = false;
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    if (!__syncthreads_or(!done)) break;
    const int n = min(kChunk, count - c0);
    for (int j = p; j < n; j += blockDim.x) {
#pragma unroll
      for (int f = 0; f < kRows; ++f) s[f][j] = attrs[(size_t)f * Ptot + start + c0 + j];
    }
    __syncthreads();
    for (int j = 0; j < n && !done; ++j) {
      const float alpha = falloff(px, s, j).alpha;
      const float w = alpha * T;
      ar += w * s[6][j];
      ag += w * s[7][j];
      ab += w * s[8][j];
      T *= 1.f - alpha;
      done = T < 1e-4f;
    }
  }
  float* o = out + ((size_t)t * blockDim.x + p) * 4;
  o[0] = ar;
  o[1] = ag;
  o[2] = ab;
  o[3] = T;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(256) blend_train_bwd_kernel(
    const int* __restrict__ starts, const float* __restrict__ attrs,
    const float* __restrict__ out, const float* __restrict__ dout,
    float* __restrict__ dattrs, int Ptot, int grid_x, int ts, int max_k) {
  __shared__ float s[kRows][kChunk];
  __shared__ float red[kWarps][kRows][kChunk];
  const int t = blockIdx.x, p = threadIdx.x;
  const int warp = p >> 5, lane = p & 31;
  const int start = starts[t];
  const int count = min(starts[t + 1] - start, max_k);
  const Pix px = pixel(t, p, grid_x, ts);
  const size_t q = ((size_t)t * blockDim.x + p) * 4;
  const float dCr = dout[q], dCg = dout[q + 1], dCb = dout[q + 2];
  const float s_total = out[q] * dCr + out[q + 1] * dCg + out[q + 2] * dCb;
  const float tdt = out[q + 3] * dout[q + 3];   // T_final dT
  float T = 1.f, prefix = 0.f;
  bool done = false;
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    if (!__syncthreads_or(!done)) break;
    const int n = min(kChunk, count - c0);
    for (int j = p; j < n; j += blockDim.x) {
#pragma unroll
      for (int f = 0; f < kRows; ++f) s[f][j] = attrs[(size_t)f * Ptot + start + c0 + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float g[kRows];
#pragma unroll
      for (int f = 0; f < kRows; ++f) g[f] = 0.f;
      if (!done) {
        const Falloff fo = falloff(px, s, j);
        const float dx = fo.dx, dy = fo.dy, alpha = fo.alpha;
        const float ca = s[2][j], cb = s[3][j], cc = s[4][j];
        const float w = alpha * T;
        const float cd = s[6][j] * dCr + s[7][j] * dCg + s[8][j] * dCb;
        prefix += w * cd;
        if (fo.live && fo.raw < 0.99f) {
          const float inv1m = 1.f / (1.f - alpha);
          const float dalpha = T * cd - (s_total - prefix) * inv1m - tdt * inv1m;
          const float dpow = dalpha * alpha;
          g[0] = (ca * dx + cb * dy) * dpow;
          g[1] = (cc * dy + cb * dx) * dpow;
          g[2] = -0.5f * dx * dx * dpow;
          g[3] = -dx * dy * dpow;
          g[4] = -0.5f * dy * dy * dpow;
          g[5] = dalpha * fo.e;
        }
        g[6] = w * dCr;
        g[7] = w * dCg;
        g[8] = w * dCb;
        T *= 1.f - alpha;
        done = T < 1e-4f;
      }
      const bool any = g[0] != 0.f || g[1] != 0.f || g[2] != 0.f || g[3] != 0.f ||
                       g[4] != 0.f || g[5] != 0.f || g[6] != 0.f || g[7] != 0.f ||
                       g[8] != 0.f;
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int f = 0; f < kRows; ++f) g[f] = warp_sum(g[f]);
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kRows; ++f) red[warp][f][j] = g[f];
      }
    }
    __syncthreads();
    for (int i = p; i < kRows * n; i += blockDim.x) {
      const int f = i / n, j = i % n;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][f][j];
      dattrs[(size_t)f * Ptot + start + c0 + j] = v;
    }
  }
}

}  // namespace

extern "C" int ggd_blend_train_fwd(const void* starts, const void* attrs, void* out, int Ptot,
                                   int grid_x, int n_tiles, int ts, int max_k, void* stream) {
  if (ts * ts != 256 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  blend_train_fwd_kernel<<<n_tiles, 256, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const float*)attrs, (float*)out, Ptot, grid_x, ts, max_k);
  return (int)cudaGetLastError();
}

// dattrs must be zero-filled: pairs past a tile's max_k, and pairs after
// every pixel of the tile saturated, keep their zero gradient
extern "C" int ggd_blend_train_bwd(const void* starts, const void* attrs, const void* out,
                                   const void* dout, void* dattrs, int Ptot, int grid_x,
                                   int n_tiles, int ts, int max_k, void* stream) {
  if (ts * ts != 256 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  blend_train_bwd_kernel<<<n_tiles, 256, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const float*)attrs, (const float*)out, (const float*)dout,
      (float*)dattrs, Ptot, grid_x, ts, max_k);
  return (int)cudaGetLastError();
}
