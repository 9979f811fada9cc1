// K3: per-tile front-to-back alpha blend (f32 payload, inference path).
//
// Replaces the TPU kernel gaussian_gan_decoder_tpu/splat/pallas_blend.py
// ::pallas_blend (_blend_kernel, payload_format 'f32'). The tile's pairs
// [start, start + min(end - start, max_k)) arrive (tile, depth)-sorted in a
// field-major (9, Ptot) f32 array: px, py, conic a/b/c, opacity, r, g, b.
// Each pixel blends them in order:
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy,  dx = pix_x - px
//   alpha = min(0.99, op exp(power)); 0 where power > 0 or alpha < 1/255
//   accum += alpha T rgb while T >= 1e-4;  T *= 1 - alpha (always)
// Output (T, P, 4): accumulated rgb and the final transmittance.
//
// Bound on the H100: the issue rate of the CUDA cores. T keeps decaying past
// the 1e-4 stop, so no pixel stops early: each blended pair is evaluated at
// every pixel of its tile within its reach (the flagship frame's 314k pairs
// are 80M (pair, pixel) evaluations in all), each a chain of ~28 f32
// operations and an expf through the pixel's T; the pair stream, read once
// per tile, is 11 MB. The falloff is rounded op by op
// (common.cuh::falloff_power), which forbids FMAs in it: the f32 FLOP bound
// assumes them.
//
// Design: one block of 128 threads per 16 x 16 tile; warp w blends rows
// 4w..4w+3, each lane two pixels of one column (rows 2 apart):
//  - a pair read from shared memory serves both pixels, and the dx terms of
//    the falloff (falloff_x) are taken once for them; the two T chains are
//    independent, so their FMUL and MUFU latencies overlap (four pixels a
//    lane, 64 threads, read 6 % slower: ~2 warps a scheduler on the capped
//    tiles hide less latency; eight, 2x slower; scripts/blend_ablation.py);
//  - pairs are staged pair-major, padded to 12 floats, so a pair is three
//    16-byte shared loads (LDS.128, a broadcast) in place of nine 4-byte ones;
//  - staging is double-buffered by cp.async in chunks of 64 pairs: the next
//    chunk's loads are in flight while this one is blended;
//  - each pair's reach (common.cuh::pair_reach: beyond it alpha is below the
//    1/255 cut) is computed once, by the thread that staged it, into the
//    pair's spare floats; a warp skips a pair whose reach misses its 16 x 4
//    pixels, exactly as if it had found alpha 0 at each of them. (Skipping
//    also the rows out of reach within a warp, as K5 does, made K3 slower:
//    a branch per pixel serialises the chains, and with few warps a
//    scheduler on the capped tiles their latency then shows.)
// Before (one thread per pixel, nine 4-byte loads of a field-major chunk a
// pair, the chunk staged synchronously between two barriers, every pair
// evaluated at every pixel): ~39 instructions per evaluation; after: ~30
// (28 for the pixel, half the pair's loads and dx terms), and none for a
// warp's pixels beyond a pair's reach.
#include "common.cuh"

namespace {

constexpr int kPixPerThread = 2;               // one column, rows 2 apart
constexpr int kThreads = 256 / kPixPerThread;   // a 16 x 16 tile
constexpr int kWarpRows = 2 * kPixPerThread;    // rows of the tile a warp blends
constexpr int kStage = 64;         // pairs a staged chunk
constexpr int kPad = 12;           // floats a staged pair: 9 fields, reach x and y, 1 unused

__global__ void __launch_bounds__(kThreads) blend_kernel(const int* __restrict__ starts,
                                                         const float* __restrict__ attrs,
                                                         float4* __restrict__ out, int Ptot,
                                                         int grid_x, int max_k) {
  __shared__ __align__(16) float sp[2][kStage][kPad];
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = starts[t];
  const int count = min(starts[t + 1] - start, max_k);
  // the lane's pixels: column tx + lane % 16, rows ty + lane / 16 + 2k
  const int tx = (t % grid_x) * 16, ty = (t / grid_x) * 16 + kWarpRows * warp;
  const float x = (float)(tx + (lane & 15));
  const int y0 = ty + (lane >> 4);
  // the warp's pixels, for the reach test
  const float rx0 = (float)tx, rx1 = (float)(tx + 15), ry0 = (float)ty;
  const float ry1 = (float)(ty + kWarpRows - 1);

  // stage chunk ci into buffer ci & 1: thread j < kStage copies pair j's 9 fields
  static_assert(kThreads >= kStage, "a thread stages one pair of a chunk");
  auto stage = [&](int ci) {
    const int j = tid, n = min(kStage, count - ci * kStage);
    if (j < n) {
      float* d = sp[ci & 1][j];
      const float* s = attrs + start + ci * kStage + j;
#pragma unroll
      for (int f = 0; f < 9; ++f) ggd::cp_async4(d + f, s + (size_t)f * Ptot);
    }
    ggd::cp_async_commit();
  };

  float T[kPixPerThread], ar[kPixPerThread], ag[kPixPerThread], ab[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) T[k] = 1.f, ar[k] = ag[k] = ab[k] = 0.f;
  const int n_chunks = (count + kStage - 1) / kStage;
  if (n_chunks > 0) stage(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci + 1 < n_chunks) {
      stage(ci + 1);
      ggd::cp_async_wait<1>();
    } else {
      ggd::cp_async_wait<0>();
    }
    float(*s)[kPad] = sp[ci & 1];
    const int n = min(kStage, count - ci * kStage);
    if (tid < n) {   // this thread's own copies have landed: its pair's reach
      const float2 r = ggd::pair_reach(s[tid][2], s[tid][3], s[tid][4], s[tid][5]);
      s[tid][9] = r.x;
      s[tid][10] = r.y;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&s[j][0]);   // px py ca cb
      const float4 b = *reinterpret_cast<const float4*>(&s[j][4]);   // cc op r g
      const float4 c = *reinterpret_cast<const float4*>(&s[j][8]);   // b, reach x y, -
      if (ggd::beyond_reach(make_float2(c.y, c.z), a.x, a.y, rx0, rx1, ry0, ry1)) continue;
      const ggd::FalloffX fx = ggd::falloff_x(a.z, a.w, x - a.x);
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float dy = (float)(y0 + 2 * k) - a.y;
        const float power = ggd::falloff_power_y(fx, b.x, dy);
        float alpha = fminf(0.99f, b.y * expf(power));
        if (power > 0.f || alpha < (1.f / 255.f)) alpha = 0.f;
        if (T[k] >= 1e-4f) {
          const float w = alpha * T[k];
          ar[k] += w * b.z;
          ag[k] += w * b.w;
          ab[k] += w * c.x;
        }
        T[k] *= 1.f - alpha;
      }
    }
    __syncthreads();   // every thread is done with this buffer before it is staged again
  }
  float4* o = out + (size_t)t * 256 + (kWarpRows * warp + (lane >> 4)) * 16 + (lane & 15);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) o[32 * k] = make_float4(ar[k], ag[k], ab[k], T[k]);
}

}  // namespace

// 16 x 16 tiles
extern "C" int ggd_blend_tiles(const void* starts, const void* attrs, void* out, int Ptot,
                               int grid_x, int n_tiles, int ts, int max_k, void* stream) {
  if (ts != 16 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  blend_kernel<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const float*)attrs, (float4*)out, Ptot, grid_x, max_k);
  return (int)cudaGetLastError();
}
