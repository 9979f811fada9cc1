// K4 / K5: the training tile blend, forward and backward (f32 payload).
//
// K4 replaces the TPU kernel gaussian_gan_decoder_tpu/splat/pallas_blend.py
// ::_blend_train_fwd (_blend_kernel with save_entries). It differs from the
// inference blend K3 (blend.cu) in exactly the TPU's training rule: a pair
// blends only while the transmittance T before it is >= 1e-4, and once T
// falls below that it stays (alpha is masked to 0, T is frozen). The rule
// does not depend on how the pairs are cut into chunks, so each pixel runs
// a sequential loop with an early exit. Residuals, as the TPU kernel's
// chunk entries: for every chunk of `chunk` pairs of a tile, each pixel's
// state (accum rgb, T) before the chunk's first pair, written as K4 holds
// it, into the chunk's entry slot (first_slot below). One block per 16x16
// tile, one thread per pixel, pairs staged through shared memory in chunks
// of 128. Bound on the H100: operations, an exp and ~20 FLOPs per (pair,
// pixel), serial per pixel through T.
//
// K5 replaces _blend_train_bwd_call (_blend_bwd_kernel + _scatter_blocks):
// the exact gradient of K4's masked forward,
//   dalpha_i = T_i (c_i . dC) - S_i / (1 - a_i) - T_final dT / (1 - a_i),
//   S_i = sum_{j > i} w_j (c_j . dC),
// zero where alpha was clamped (op exp(power) >= 0.99), skipped or masked.
// Bound on the H100: the serial walk of a tile's pairs, per pixel through T:
// the step's heaviest tiles hold max_k = 1024 pairs against a mean of ~45,
// and one block walking such a tile (9 warp sums of 5 shuffles a pair in
// each of 8 warps) was the whole kernel's time.
// Design: one warp per (tile, chunk) entry slot, so a heavy tile's walk is
// max_k / chunk independent chunks. A chunk starts from K4's entry state:
// its T, and S at its start, (accum_final - accum_entry) . dC. It replays
// its pairs FRONT TO BACK with K4's arithmetic (the same falloff, the same
// T *= 1 - alpha from the same T, so every mask decision is K4's, bit for
// bit) and takes S_i = S_entry - local_i, local_i the chunk's running
// sum of w (c . dC), instead of recovering T_i by dividing by (1 - a) back
// to front. The subtraction costs S_i an absolute error of about 1e-7
// |accum . dC| per pixel. Past the stop the entry T is below 1e-4 and the
// chunk writes nothing; a pair whose reach (common.cuh::pair_reach) misses
// the tile is skipped, as its alpha is 0 at every pixel, and so are the
// lanes' k-th pixels (rows 2k and 2k + 1) where it misses both rows
// (reach_row_pairs). Each lane owns 8 pixels of one column: a pair read
// from shared memory (pair-major, 3 LDS.128) serves all 8, the falloff's dx
// terms are taken once for them, and the lane sums its pixels' gradients
// in registers (with dx shared, the 5 conic and position terms need 3
// sums: dpow, dpow dy, dpow dy^2). The warp then reduces a pair's 9 sums
// with one transposing reduce-scatter (16 SHFL) where the old kernel ran 9
// butterfly sums (45 SHFL) in each of 8 warps plus a shared-memory pass.
// A pair belongs to one tile and one chunk, so its 9 gradients are written
// once, by one warp, in a fixed order of sums: no atomics, and two launches
// give the same bits.
#include "common.cuh"

namespace {

constexpr int kRows = 9;
constexpr int kChunk = 128;        // K4's staging chunk
constexpr int kPix = 256;          // pixels of a 16 x 16 tile
constexpr int kMaxEntryChunk = 64; // pairs a K5 warp stages: the entry chunk's limit
constexpr int kLanePix = 8;        // pixels a K5 lane: one column, rows 2 apart

struct Pix {
  float x, y;
};

__device__ __forceinline__ Pix pixel(int t, int p, int grid_x, int ts) {
  return {(float)((t % grid_x) * ts + p % ts), (float)((t / grid_x) * ts + p / ts)};
}

// The first entry slot of tile t. Strictly increasing in t, and tile t's
// ceil(min(count, max_k) / chunk) chunks fit below tile t + 1's first
// slot; the slots of all tiles number at most n_tiles + Ptot / chunk.
__device__ __forceinline__ int first_slot(const int* starts, int t, int chunk) {
  return t + (starts[t] - starts[0]) / chunk;
}

// one (pair, pixel) of the blend, the same code in K4 and K5 so that both
// make the same decisions: -> falloff exp(power), raw = op exp(power), alpha
// (0 where skipped: power > 0 or alpha < 1/255)
struct Falloff {
  float dx, dy, e, raw, alpha;
  bool live;
};

__device__ __forceinline__ Falloff falloff_of(float power, float op) {
  Falloff f;
  f.e = expf(power);
  f.raw = op * f.e;
  f.alpha = fminf(0.99f, f.raw);
  f.live = !(power > 0.f || f.alpha < (1.f / 255.f));
  if (!f.live) f.alpha = 0.f;
  return f;
}

__device__ __forceinline__ Falloff falloff(Pix px, const float (*s)[kChunk], int j) {
  const float dx = px.x - s[0][j], dy = px.y - s[1][j];
  Falloff f = falloff_of(ggd::falloff_power(s[2][j], s[3][j], s[4][j], dx, dy), s[5][j]);
  f.dx = dx;
  f.dy = dy;
  return f;
}

__global__ void __launch_bounds__(256) blend_train_fwd_kernel(
    const int* __restrict__ starts, const float* __restrict__ attrs, float* __restrict__ out,
    float4* __restrict__ ent, int Ptot, int grid_x, int ts, int max_k, int chunk) {
  __shared__ float s[kRows][kChunk];
  const int t = blockIdx.x, p = threadIdx.x;
  const int start = starts[t];
  const int count = min(starts[t + 1] - start, max_k);
  const Pix px = pixel(t, p, grid_x, ts);
  // this pixel's entry of the tile's first slot; the entries written
  float4* ent_t = ent + (size_t)first_slot(starts, t, chunk) * kPix + p;
  const int n_ent = (count + chunk - 1) / chunk;
  int next = 0;
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
    // entry chunks tile the staged chunk (chunk divides kChunk): each
    // starts with its entry, written as K4 holds the state
    for (int e0 = 0; e0 < n && !done; e0 += chunk) {
      next = (c0 + e0) / chunk;
      ent_t[(size_t)next++ * kPix] = make_float4(ar, ag, ab, T);
      for (int j = e0; j < min(n, e0 + chunk) && !done; ++j) {
        const float alpha = falloff(px, s, j).alpha;
        const float w = alpha * T;
        ar += w * s[6][j];
        ag += w * s[7][j];
        ab += w * s[8][j];
        T *= 1.f - alpha;
        done = T < 1e-4f;
      }
    }
  }
  // chunks past this pixel's stop enter with its final (frozen) state
  for (; next < n_ent; ++next) ent_t[(size_t)next * kPix] = make_float4(ar, ag, ab, T);
  float* o = out + ((size_t)t * blockDim.x + p) * 4;
  o[0] = ar;
  o[1] = ag;
  o[2] = ab;
  o[3] = T;
}

// The tile of entry slot b: the t with first_slot(t) <= b < first_slot(t +
// 1), -1 past the last tile. The warp narrows [lo, hi) 32-fold a round,
// each lane testing one candidate: 2 rounds for 1024 tiles.
__device__ __forceinline__ int slot_tile(const int* starts, int n_tiles, int chunk, int b,
                                         int lane) {
  if (first_slot(starts, n_tiles, chunk) <= b) return -1;
  int lo = 0, hi = n_tiles;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) >> 5;
    const int cand = lo + lane * step;
    const bool le = cand < hi && first_slot(starts, cand, chunk) <= b;
    const unsigned m = __ballot_sync(0xffffffffu, le);   // lane 0's candidate is lo
    lo += (31 - __clz((int)m)) * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

// The row pairs k (rows y0 + 2k and y0 + 2k + 1, k < 32) that may lie
// within the reach ry of a pair centred on row gy, as bits; all 32 where gy
// lies 4096 rows or more from y0 or is not finite (below that the roundings
// here stay under 2.5e-4 rows, inside the reach's 0.01 margin).
__device__ __forceinline__ unsigned reach_row_pairs(float ry, float gy, float y0) {
  if (ry < 0.f) return 0u;   // no pixel anywhere
  const float a = gy - y0;
  if (!(fabsf(a) < 4096.f && ry < 4096.f)) return 0xffffffffu;
  // row 2k + 1 >= a - ry and row 2k <= a + ry
  const int kmin = (int)ceilf((a - ry - 1.f) * 0.5f), kmax = (int)floorf((a + ry) * 0.5f);
  if (kmax < 0 || kmin > 31 || kmax < kmin) return 0u;
  const unsigned below = kmax >= 31 ? 0xffffffffu : (2u << kmax) - 1u;
  return kmin <= 0 ? below : below & ~((1u << kmin) - 1u);
}

// One round of the transposing reduce-scatter over M values: the lanes
// with bit M set keep the upper half and add their partner's, the others
// the lower half.
template <int M>
__device__ __forceinline__ void scatter_round(float (&v)[16], int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float lo = v[i], hi = v[i + M / 2];
    v[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, M);
  }
}

// v[0..8] of every lane (v[9..15] zero) -> lanes 2f and 2f + 1 hold the
// warp's sum of v[f]: four rounds (8 + 4 + 2 + 1 SHFL) leave lane l with
// value l / 2 summed over the 16 lanes that share bits 1-4 of l, a fifth
// adds the other half. Every sum has a fixed order.
__device__ __forceinline__ float warp_sum9(float (&v)[16], int lane) {
  scatter_round<16>(v, lane);
  scatter_round<8>(v, lane);
  scatter_round<4>(v, lane);
  scatter_round<2>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

__global__ void __launch_bounds__(32) blend_train_bwd_kernel(
    const int* __restrict__ starts, const float* __restrict__ attrs,
    const float4* __restrict__ out, const float4* __restrict__ dout,
    const float4* __restrict__ ent, float* __restrict__ dattrs, int Ptot, int grid_x,
    int n_tiles, int max_k, int chunk) {
  __shared__ float4 sp[kMaxEntryChunk][3];
  const int lane = threadIdx.x, b = blockIdx.x;
  const int t = slot_tile(starts, n_tiles, chunk, b, lane);
  if (t < 0) return;
  const int start = starts[t];
  const int count = min(starts[t + 1] - start, max_k);
  const int j0 = (b - first_slot(starts, t, chunk)) * chunk;
  if (j0 >= count) return;
  const int n = min(chunk, count - j0);
  const int base = start + j0;
  // the lane's pixels: column lane % 16, rows lane / 16 + 2k
  const float x = (float)((t % grid_x) * 16 + (lane & 15));
  const int y0 = (t / grid_x) * 16 + (lane >> 4);
  float T[kLanePix], loc[kLanePix], rest[kLanePix], tdt[kLanePix];
  float dCr[kLanePix], dCg[kLanePix], dCb[kLanePix];
  bool alive = false;
#pragma unroll
  for (int k = 0; k < kLanePix; ++k) {
    const size_t q = (size_t)t * kPix + lane + 32 * k;
    const float4 o = out[q], d = dout[q], e = ent[(size_t)b * kPix + lane + 32 * k];
    dCr[k] = d.x;
    dCg[k] = d.y;
    dCb[k] = d.z;
    // S before the chunk's first pair: sum_{j >= j0} w_j (c_j . dC)
    rest[k] = (o.x - e.x) * d.x + (o.y - e.y) * d.y + (o.z - e.z) * d.z;
    tdt[k] = o.w * d.w;   // T_final dT
    T[k] = e.w;
    loc[k] = 0.f;
    alive |= T[k] >= 1e-4f;
  }
  // every pixel stopped before this chunk: its gradients stay zero
  if (!__any_sync(0xffffffffu, alive)) return;
  // stage the chunk pair-major: 9 fields and the pair's reach
  for (int j = lane; j < n; j += 32) {
    float f[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) f[i] = attrs[(size_t)i * Ptot + base + j];
    const float2 r = ggd::pair_reach(f[2], f[3], f[4], f[5]);
    sp[j][0] = make_float4(f[0], f[1], f[2], f[3]);
    sp[j][1] = make_float4(f[4], f[5], f[6], f[7]);
    sp[j][2] = make_float4(f[8], r.x, r.y, 0.f);
  }
  __syncwarp();
  const float rx0 = (float)((t % grid_x) * 16), ry0 = (float)((t / grid_x) * 16);
  for (int j = 0; j < n; ++j) {
    if (!__any_sync(0xffffffffu, alive)) break;   // the rest stay zero
    const float4 a = sp[j][0];   // px py ca cb
    const float4 c = sp[j][1];   // cc op r g
    const float4 e = sp[j][2];   // b, reach x y
    // beyond its reach the pair's alpha is 0 at every pixel of the tile:
    // no gradient, T unchanged
    if (ggd::beyond_reach(make_float2(e.y, e.z), a.x, a.y, rx0, rx0 + 15.f, ry0, ry0 + 15.f))
      continue;
    const float blue = e.x;
    const unsigned rows = reach_row_pairs(e.z, a.y, ry0);
    const float dx = x - a.x;
    const ggd::FalloffX fx = ggd::falloff_x(a.z, a.w, dx);
    // the lane's sums over its pixels: dpow, dpow dy, dpow dy^2, then the
    // opacity and colour terms
    float sd = 0.f, sdy = 0.f, sdyy = 0.f, g5 = 0.f, g6 = 0.f, g7 = 0.f, g8 = 0.f;
#pragma unroll
    for (int k = 0; k < kLanePix; ++k) {
      if (!((rows >> k) & 1u)) continue;   // rows 2k, 2k + 1 of the tile: beyond reach
      if (T[k] >= 1e-4f) {
        const float dy = (float)(y0 + 2 * k) - a.y;
        const Falloff fo = falloff_of(ggd::falloff_power_y(fx, c.x, dy), c.y);
        const float alpha = fo.alpha;
        const float w = alpha * T[k];
        const float cd = c.z * dCr[k] + c.w * dCg[k] + blue * dCb[k];
        loc[k] += w * cd;
        if (fo.live && fo.raw < 0.99f) {
          const float inv1m = __frcp_rn(1.f - alpha);
          const float dalpha = T[k] * cd - (rest[k] - loc[k]) * inv1m - tdt[k] * inv1m;
          const float dpow = dalpha * alpha;
          sd += dpow;
          sdy += dpow * dy;
          sdyy += dpow * dy * dy;
          g5 += dalpha * fo.e;
        }
        g6 += w * dCr[k];
        g7 += w * dCg[k];
        g8 += w * dCb[k];
        T[k] *= 1.f - alpha;
      }
    }
    alive = false;
#pragma unroll
    for (int k = 0; k < kLanePix; ++k) alive |= T[k] >= 1e-4f;
    const bool any = sd != 0.f || sdy != 0.f || sdyy != 0.f || g5 != 0.f || g6 != 0.f ||
                     g7 != 0.f || g8 != 0.f;
    if (!__any_sync(0xffffffffu, any)) continue;   // the pair's gradient is zero
    float v[16] = {(a.z * dx) * sd + a.w * sdy,    // d px: sum (ca dx + cb dy) dpow
                   c.x * sdy + (a.w * dx) * sd,    // d py: sum (cc dy + cb dx) dpow
                   -0.5f * (dx * dx) * sd,         // d ca
                   -dx * sdy,                      // d cb
                   -0.5f * sdyy,                   // d cc
                   g5, g6, g7, g8};
    const float sum = warp_sum9(v, lane);
    if (!(lane & 1) && lane < 2 * kRows) dattrs[(size_t)(lane >> 1) * Ptot + base + j] = sum;
  }
}

}  // namespace

// ent: (n_slots, 256, 4) f32, n_slots = n_tiles + Ptot / chunk + 1; the
// slots of chunks a tile does not have are left unwritten
extern "C" int ggd_blend_train_fwd(const void* starts, const void* attrs, void* out, void* ent,
                                   int Ptot, int grid_x, int n_tiles, int ts, int max_k,
                                   int chunk, void* stream) {
  if (ts * ts != kPix || n_tiles < 1 || chunk < 1 || kChunk % chunk != 0)
    return (int)cudaErrorInvalidValue;
  blend_train_fwd_kernel<<<n_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const float*)attrs, (float*)out, (float4*)ent, Ptot, grid_x, ts,
      max_k, chunk);
  return (int)cudaGetLastError();
}

// dattrs must be zero-filled: pairs past a tile's max_k, and pairs after
// every pixel of the tile saturated, keep their zero gradient. One warp per
// entry slot of K4's ent.
extern "C" int ggd_blend_train_bwd(const void* starts, const void* attrs, const void* out,
                                   const void* dout, const void* ent, void* dattrs, int Ptot,
                                   int grid_x, int n_tiles, int ts, int max_k, int chunk,
                                   void* stream) {
  if (ts * ts != kPix || n_tiles < 1 || chunk < 1 || chunk > kMaxEntryChunk)
    return (int)cudaErrorInvalidValue;
  const int n_slots = n_tiles + Ptot / chunk + 1;
  blend_train_bwd_kernel<<<n_slots, 32, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const float*)attrs, (const float4*)out, (const float4*)dout,
      (const float4*)ent, (float*)dattrs, Ptot, grid_x, n_tiles, max_k, chunk);
  return (int)cudaGetLastError();
}
