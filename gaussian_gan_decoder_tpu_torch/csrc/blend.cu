// K3: per-tile front-to-back alpha blend (inference path), in the four
// payload formats of the TPU kernel and its mxu_power falloff.
//
// Replaces the TPU kernel gaussian_gan_decoder_tpu/splat/pallas_blend.py
// ::pallas_blend (_blend_kernel, every payload_format, mxu_power). The
// tile's pairs [start, start + min(end - start, max_k)) arrive (tile,
// depth)-sorted as field-major f32-bitcast words (splat/fast_raster.py):
//   f32 (9)          px, py, conic a/b/c, opacity, r, g, b
//   bf16_colors (7)  px, py, conic a/b/c, r|g, b|op (bf16 pairs)
//   packed_v2 (5)    pxl|pyl (int16, 1/32 px, tile-local), ca|cb (f16 of
//                    conic * 4096), cc, r|g, b|op
//   packed_v3 (4)    pxl|pyl, ca|cb, cc|op (f16 * 4096), rgb (10 bits, 1/256)
// Each pixel blends them in order:
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy,  dx = pix_x - px
//     (mxu_power: ((((c0 + c1 x) + c2 y) + c3 x^2) + c4 x y) + c5 y^2 of the
//     pixel's tile-local x, y, the TPU kernel's coefficients)
//   alpha = min(0.99, op exp(power)); 0 where power > 0 or alpha < 1/255
//   accum += alpha T rgb while T >= 1e-4;  T *= 1 - alpha (always)
// The packed formats' pixel coordinates are tile-local, as their pairs'.
// Output (T, P, 4): accumulated rgb and the final transmittance.
//
// Bound on the H100: the issue rate of the CUDA cores. T keeps decaying past
// the 1e-4 stop, so no pixel stops early: each blended pair is evaluated at
// every pixel of its tile within its reach (the flagship frame's 861k pairs
// are 80M (pair, pixel) evaluations in all), each a chain of ~28 f32
// operations and an expf through the pixel's T; the pair stream, read once
// per tile, is 31 MB in f32 and 14 MB in packed_v3. The falloff is rounded
// op by op (common.cuh::falloff_power), which forbids FMAs in it: the f32
// FLOP bound assumes them.
//
// Design: one block of 128 threads per 16 x 16 tile; warp w blends rows
// 4w..4w+3, each lane two pixels of one column (rows 2 apart):
//  - a pair read from shared memory serves both pixels, and the dx terms of
//    the falloff (falloff_x) are taken once for them; the two T chains are
//    independent, so their FMUL and MUFU latencies overlap (four pixels a
//    lane, 64 threads, read 6 % slower: ~2 warps a scheduler on the capped
//    tiles hide less latency; eight, 2x slower; scripts/blend_ablation.py);
//  - a pair's words are staged by cp.async (4 bytes each: the rows are
//    field-major), double-buffered in chunks of 64 pairs, so the next
//    chunk's loads are in flight while this one is blended;
//  - the thread that staged a pair unpacks it once, in place, into 12
//    floats (the 9 fields and the reach; with mxu_power the 6 coefficients,
//    opacity and rgb), so every reader takes a pair as three 16-byte shared
//    loads (LDS.128, a broadcast) whatever the format;
//  - each pair's reach (common.cuh::pair_reach of the unpacked, quantised
//    conic and opacity: beyond it alpha is below the 1/255 cut) lets a warp
//    skip a pair that misses its 16 x 4 pixels, exactly as if it had found
//    alpha 0 at each of them. The mxu_power form skips nothing: its
//    polynomial rounds differently from the direct form the reach bounds.
//    (Skipping also the rows out of reach within a warp, as K5 does, made
//    K3 slower: a branch per pixel serialises the chains, and with few
//    warps a scheduler on the capped tiles their latency then shows.)
#include "common.cuh"

namespace {

constexpr int kPixPerThread = 2;               // one column, rows 2 apart
constexpr int kThreads = 256 / kPixPerThread;   // a 16 x 16 tile
constexpr int kWarpRows = 2 * kPixPerThread;    // rows of the tile a warp blends
constexpr int kStage = 64;         // pairs a staged chunk
constexpr int kPad = 12;           // floats a staged pair once unpacked

// payload formats (splat/pallas_blend.py PAYLOAD_IDS) and their words a pair
enum : int { kF32 = 0, kBf16Colors = 1, kPackedV2 = 2, kPackedV3 = 3 };
__host__ __device__ constexpr int payload_words(int fmt) {
  return fmt == kF32 ? 9 : fmt == kBf16Colors ? 7 : fmt == kPackedV2 ? 5 : 4;
}

// an IEEE-half pattern (low 16 bits) -> f32 with the exponent re-biased by
// -12 (the 4096 conic pre-scale): exponent e -> e + 100, 0 where e = 0
__device__ __forceinline__ float f16_unpack(uint32_t u) {
  const uint32_t e = (u >> 10) & 0x1Fu;
  if (e == 0) return 0.f;
  return __uint_as_float(((u & 0x8000u) << 16) | ((e + 100u) << 23) | ((u & 0x3FFu) << 13));
}
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }

// one pair's words (w[0 .. payload_words)) -> the 9 fields px, py, ca, cb,
// cc, op, r, g, b (splat/pallas_blend.py::unpack_payload)
template <int kFmt>
__device__ __forceinline__ void unpack(const float* w, float* f) {
  if (kFmt == kF32) {
#pragma unroll
    for (int i = 0; i < 9; ++i) f[i] = w[i];
    return;
  }
  const uint32_t* u = reinterpret_cast<const uint32_t*>(w);
  if (kFmt == kBf16Colors) {
#pragma unroll
    for (int i = 0; i < 5; ++i) f[i] = w[i];
    f[5] = bf16_lo(u[6]);
    f[6] = bf16_hi(u[5]);
    f[7] = bf16_lo(u[5]);
    f[8] = bf16_hi(u[6]);
    return;
  }
  f[0] = (float)((int)u[0] >> 16) * (1.f / 32.f);
  f[1] = (float)(int16_t)(u[0] & 0xFFFFu) * (1.f / 32.f);
  f[2] = f16_unpack(u[1] >> 16);
  f[3] = f16_unpack(u[1] & 0xFFFFu);
  if (kFmt == kPackedV2) {
    f[4] = w[2];
    f[5] = bf16_lo(u[4]);
    f[6] = bf16_hi(u[3]);
    f[7] = bf16_lo(u[3]);
    f[8] = bf16_hi(u[4]);
  } else {
    f[4] = f16_unpack(u[2] >> 16);
    f[5] = f16_unpack(u[2] & 0xFFFFu);
    f[6] = (float)((u[3] >> 20) & 0x3FFu) * (1.f / 256.f);
    f[7] = (float)((u[3] >> 10) & 0x3FFu) * (1.f / 256.f);
    f[8] = (float)(u[3] & 0x3FFu) * (1.f / 256.f);
  }
}

// the staged pair's 12 floats, written in place over its words by the
// thread that staged it: direct form px py ca cb | cc op r g | b rx ry -,
// mxu_power c0 c1 c2 c3 | c4 c5 op r | g b - -
template <int kFmt, bool kMxu>
__device__ __forceinline__ void unpack_staged(float* s) {
  float f[9];
  unpack<kFmt>(s, f);
  if (kMxu) {
    const float gx = f[0], gy = f[1], ca = f[2], cb = f[3], cc = f[4];
    s[0] = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, gx), gx),
                                                 __fmul_rn(__fmul_rn(cc, gy), gy))),
                     __fmul_rn(__fmul_rn(cb, gx), gy));
    s[1] = __fadd_rn(__fmul_rn(ca, gx), __fmul_rn(cb, gy));
    s[2] = __fadd_rn(__fmul_rn(cc, gy), __fmul_rn(cb, gx));
    s[3] = __fmul_rn(-0.5f, ca);
    s[4] = -cb;
    s[5] = __fmul_rn(-0.5f, cc);
#pragma unroll
    for (int i = 5; i < 9; ++i) s[i + 1] = f[i];
    return;
  }
  const float2 r = ggd::pair_reach(f[2], f[3], f[4], f[5]);
#pragma unroll
  for (int i = 0; i < 9; ++i) s[i] = f[i];
  s[9] = r.x;
  s[10] = r.y;
}

template <int kFmt, bool kMxu>
__global__ void __launch_bounds__(kThreads) blend_kernel(const int* __restrict__ starts,
                                                         const float* __restrict__ attrs,
                                                         float4* __restrict__ out, int Ptot,
                                                         int grid_x, int max_k) {
  constexpr int kWords = payload_words(kFmt);
  constexpr bool kLocal = kFmt == kPackedV2 || kFmt == kPackedV3;
  static_assert(!kMxu || kLocal, "mxu_power needs tile-local coordinates");
  __shared__ __align__(16) float sp[2][kStage][kPad];
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = starts[t];
  const int count = min(starts[t + 1] - start, max_k);
  // the lane's pixels: column tx + lane % 16, rows ty + lane / 16 + 2k
  // (tile-local in the packed formats)
  const int tx = kLocal ? 0 : (t % grid_x) * 16;
  const int ty = (kLocal ? 0 : (t / grid_x) * 16) + kWarpRows * warp;
  const float x = (float)(tx + (lane & 15));
  const int y0 = ty + (lane >> 4);
  // the warp's pixels, for the reach test
  const float rx0 = (float)tx, rx1 = (float)(tx + 15), ry0 = (float)ty;
  const float ry1 = (float)(ty + kWarpRows - 1);
  // mxu_power: the lane's pixel terms of the polynomial
  float yk[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) yk[k] = (float)(y0 + 2 * k);
  const float xx = __fmul_rn(x, x);

  // stage chunk ci into buffer ci & 1: thread j < kStage copies pair j's words
  static_assert(kThreads >= kStage, "a thread stages one pair of a chunk");
  auto stage = [&](int ci) {
    const int j = tid, n = min(kStage, count - ci * kStage);
    if (j < n) {
      float* d = sp[ci & 1][j];
      const float* s = attrs + start + ci * kStage + j;
#pragma unroll
      for (int f = 0; f < kWords; ++f) ggd::cp_async4(d + f, s + (size_t)f * Ptot);
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
    // this thread's own copies have landed: its pair's fields and reach
    if (tid < n) unpack_staged<kFmt, kMxu>(s[tid]);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(&s[j][0]);
      const float4 b = *reinterpret_cast<const float4*>(&s[j][4]);
      const float4 c = *reinterpret_cast<const float4*>(&s[j][8]);
      if (kMxu) {
        // a = c0 c1 c2 c3, b = c4 c5 op r, c = g b - -
        const float cx = __fadd_rn(a.x, __fmul_rn(a.y, x));
        const float c3xx = __fmul_rn(a.w, xx);
#pragma unroll
        for (int k = 0; k < kPixPerThread; ++k) {
          const float y = yk[k];
          const float power = __fadd_rn(
              __fadd_rn(__fadd_rn(__fadd_rn(cx, __fmul_rn(a.z, y)), c3xx),
                        __fmul_rn(b.x, __fmul_rn(x, y))),
              __fmul_rn(b.y, __fmul_rn(y, y)));
          float alpha = fminf(0.99f, b.z * expf(power));
          if (power > 0.f || alpha < (1.f / 255.f)) alpha = 0.f;
          if (T[k] >= 1e-4f) {
            const float w = alpha * T[k];
            ar[k] += w * b.w;
            ag[k] += w * c.x;
            ab[k] += w * c.y;
          }
          T[k] *= 1.f - alpha;
        }
        continue;
      }
      // a = px py ca cb, b = cc op r g, c = b, reach x y, -
      if (ggd::beyond_reach(make_float2(c.y, c.z), a.x, a.y, rx0, rx1, ry0, ry1)) continue;
      const ggd::FalloffX fx = ggd::falloff_x(a.z, a.w, x - a.x);
#pragma unroll
      for (int k = 0; k < kPixPerThread; ++k) {
        const float dy = yk[k] - a.y;
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
  const int row = kWarpRows * warp + (lane >> 4);
  float4* o = out + (size_t)t * 256 + row * 16 + (lane & 15);
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) o[32 * k] = make_float4(ar[k], ag[k], ab[k], T[k]);
}

template <int kFmt, bool kMxu>
int launch(const void* starts, const void* attrs, void* out, int Ptot, int grid_x,
           int n_tiles, int max_k, void* stream) {
  blend_kernel<kFmt, kMxu><<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const float*)attrs, (float4*)out, Ptot, grid_x, max_k);
  return (int)cudaGetLastError();
}

}  // namespace

// 16 x 16 tiles; fmt: 0 f32, 1 bf16_colors, 2 packed_v2, 3 packed_v3; mxu
// (packed formats only): the quadratic-basis falloff
extern "C" int ggd_blend_tiles(const void* starts, const void* attrs, void* out, int Ptot,
                               int grid_x, int n_tiles, int ts, int max_k, int fmt, int mxu,
                               void* stream) {
  if (ts != 16 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  if (mxu) {
    if (fmt == kPackedV2) return launch<kPackedV2, true>(starts, attrs, out, Ptot, grid_x,
                                                          n_tiles, max_k, stream);
    if (fmt == kPackedV3) return launch<kPackedV3, true>(starts, attrs, out, Ptot, grid_x,
                                                          n_tiles, max_k, stream);
    return (int)cudaErrorInvalidValue;
  }
  switch (fmt) {
    case kF32: return launch<kF32, false>(starts, attrs, out, Ptot, grid_x, n_tiles, max_k,
                                          stream);
    case kBf16Colors: return launch<kBf16Colors, false>(starts, attrs, out, Ptot, grid_x,
                                                        n_tiles, max_k, stream);
    case kPackedV2: return launch<kPackedV2, false>(starts, attrs, out, Ptot, grid_x, n_tiles,
                                                    max_k, stream);
    case kPackedV3: return launch<kPackedV3, false>(starts, attrs, out, Ptot, grid_x, n_tiles,
                                                    max_k, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
