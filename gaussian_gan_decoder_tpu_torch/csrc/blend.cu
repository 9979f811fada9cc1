// K3: per-tile front-to-back alpha blend (f32 payload, inference path).
//
// Replaces the TPU kernel gaussian_gan_decoder_tpu/splat/pallas_blend.py
// ::pallas_blend (_blend_kernel, payload_format 'f32'). One block per tile,
// one thread per pixel. The tile's pairs [start, start + min(end - start,
// max_k)) arrive (tile, depth)-sorted in a field-major (9, Ptot) f32 array:
// px, py, conic a/b/c, opacity, r, g, b. They are staged through shared
// memory in chunks (one pair per thread, coalesced along each field row),
// then each pixel blends the chunk in order:
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy,  dx = pix_x - px
//   alpha = min(0.99, op exp(power)); 0 where power > 0 or alpha < 1/255
//   accum += alpha T rgb while T >= 1e-4;  T *= 1 - alpha (always)
// Output (T, P, 4): accumulated rgb and the final transmittance.
//
// Bound on the H100: exp + ~15 FMAs per (pair, pixel) on the CUDA cores,
// serial per pixel through T. The pair stream is read once per tile.
#include "common.cuh"

namespace {

constexpr int kRows = 9;
constexpr int kChunk = 256;

__global__ void blend_kernel(const int* __restrict__ starts, const float* __restrict__ attrs,
                             float* __restrict__ out, int Ptot, int grid_x, int ts, int max_k) {
  __shared__ float s[kRows][kChunk];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int start = starts[t];
  const int count = min(starts[t + 1] - start, max_k);
  const float pixx = (float)((t % grid_x) * ts + p % ts);
  const float pixy = (float)((t / grid_x) * ts + p / ts);

  float T = 1.f, ar = 0.f, ag = 0.f, ab = 0.f;
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
    __syncthreads();
    for (int j = p; j < n; j += P) {
#pragma unroll
      for (int f = 0; f < kRows; ++f) s[f][j] = attrs[(size_t)f * Ptot + start + c0 + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = pixx - s[0][j];
      const float dy = pixy - s[1][j];
      const float power = ggd::falloff_power(s[2][j], s[3][j], s[4][j], dx, dy);
      float alpha = fminf(0.99f, s[5][j] * expf(power));
      if (power > 0.f || alpha < (1.f / 255.f)) alpha = 0.f;
      if (T >= 1e-4f) {
        const float w = alpha * T;
        ar += w * s[6][j];
        ag += w * s[7][j];
        ab += w * s[8][j];
      }
      T *= 1.f - alpha;
    }
  }
  float* o = out + ((size_t)t * P + p) * 4;
  o[0] = ar;
  o[1] = ag;
  o[2] = ab;
  o[3] = T;
}

}  // namespace

extern "C" int ggd_blend_tiles(const void* starts, const void* attrs, void* out, int Ptot,
                               int grid_x, int n_tiles, int ts, int max_k, void* stream) {
  const int P = ts * ts;
  if (P % 32 != 0 || P > 1024 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  blend_kernel<<<n_tiles, P, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const float*)attrs, (float*)out, Ptot, grid_x, ts, max_k);
  return (int)cudaGetLastError();
}
