// K4 / K5: the training tile blend, forward and backward (f32 payload).
//
// K4 replaces the TPU kernel gaussian_gan_decoder_tpu/splat/pallas_blend.py
// ::_blend_train_fwd (_blend_kernel with save_entries). It differs from the
// inference blend K3 (blend.cu) in exactly the TPU's training rule: a pair
// blends only while the transmittance T before it is >= 1e-4, and once T
// falls below that it stays (alpha is masked to 0, T is frozen). Residuals,
// as the TPU kernel's chunk entries: for every chunk of `chunk` pairs of a
// tile, each pixel's state (accum rgb, T) before the chunk's first pair,
// into the chunk's entry slot (first_slot below), which K5 starts from.
// Bound on the H100: the serial walk of a tile's pairs, per pixel through
// T. The train step's largest tile holds 450 pairs against a mean of ~45,
// and one block walking it one pair after another (a dependent chain of
// shared loads, the falloff, expf, the cut and T, ~270 cycles a pair) was
// the whole kernel's time.
// Design: the walk is cut into the entry chunks and put back together by a
// scan over them, two passes over each round of a tile's chunks, in one
// launch: a block of 16 warps per tile takes the tile's chunks in rounds
// of 8.
//  1. Two warps blend chunk r0 + i of the round, each half the tile's rows
//     (4 pixels of one column a lane, rows 2 apart, as K5's lanes hold 8;
//     the chunk staged pair-major by cp.async with each pair's reach),
//     front to back from T = 1, accum = 0, ignoring the 1e-4 stop, into
//     shared memory as (A_c rgb, P_c): the sum of the chunk's weighted
//     colours and the product of its (1 - alpha), in pair order. Pairs
//     beyond a warp's reach are skipped (alpha 0 there: the same bits), and
//     so are the lanes' k-th pixels once all their P_c are below 1e-4: the
//     scan replays the chunk wherever such a pixel is still open, and reads
//     nothing else of it there.
//  2. After a barrier, thread p walks pixel p over the round's chunks in
//     order from the state the last round left (first (0, 1)): writes the
//     entry (accum, T) into the chunk's slot and then, where T P_c >=
//     kFastT, takes accum += T A_c, T <- T P_c; elsewhere it replays the
//     chunk's pairs, still staged in shared memory, from the entry with
//     the sequential arithmetic and the stop (the alphas of 8 pairs taken
//     before their fold). Past the stop T stays and every later entry
//     holds the frozen state; once every pixel of the tile has stopped,
//     the later rounds are not blended at all.
// A round's (A_c, P_c) stay in shared memory (32 KB); device memory sees
// the entries only. (As two launches, pass 1 over every chunk into the
// slots and then the scan, the frame's 62 MB of scratch went to device
// memory and back, the scan alone took ~0.09 ms, and no chunk past a
// tile's saturation could be left.) Where a chunk takes the product, no
// pair of it stops: the sequential fold from the same entry never masks
// there either, so K5 (which replays every chunk from its entry with the
// same arithmetic) makes K4's mask decisions, bit for bit, and inside a
// chunk where a pixel stops both fold T from the same entry.
// No atomics; every sum has a fixed order, so two launches give the same
// bits.
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
constexpr int kPix = 256;          // pixels of a 16 x 16 tile
constexpr int kMaxEntryChunk = 64; // pairs a K5 warp stages: the entry chunk's limit
constexpr int kLanePix = 8;        // pixels a K4 or K5 lane: one column, rows 2 apart
constexpr int kPad = 12;           // floats a pair K4 stages: 9 fields, reach x and y, 1 unused
constexpr int kRound = 8;          // chunks a K4 block blends at once
constexpr int kChunkWarps = 2;     // warps a K4 chunk: each 8 / kChunkWarps pixels a lane
constexpr int kLaneRows = kLanePix / kChunkWarps;
constexpr int kRoundThreads = kRound * kChunkWarps * 32;
constexpr int kRoundChunk = 32;    // pairs of a K4 chunk at most
constexpr float kStop = 1e-4f;     // the training rule's stop
// The scan takes a chunk's product only where T P_c >= kFastT. The
// sequential fold of the chunk's n <= 32 factors (1 - alpha), each in
// [0.01, 1] and computed alike in both, from T rounds n times, the product
// P_c n - 1 times and T P_c once more: in the normal range (T P_c >= 1e-4
// needs T, P_c and every partial product >= 1e-4), each rounding moves a
// value by at most 2^-24 relative, so the two differ by less than 2n 2^-24
// <= 3.9e-6 relative. A margin of 1e-4 relative (26x that) keeps every T
// the fold meets above 1e-4 (T falls monotonically through the chunk:
// each factor is at most 1), so no pair of the chunk stops. A product
// that underflows (32 factors of 0.01 are 1e-64) falls below it and
// replays.
constexpr float kFastT = kStop * (1.f + 1e-4f);

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

// Stage the n sorted pairs from `base` on pair-major into s (thread i of
// `threads` stages pairs i, i + threads, ...), with each pair's reach
// (common.cuh::pair_reach) in its spare floats. cp.async: the 9 fields
// land in shared memory without passing through registers.
__device__ __forceinline__ void stage_pairs(float (*s)[kPad], const float* __restrict__ attrs,
                                            int Ptot, int base, int n, int i, int threads) {
  for (int j = i; j < n; j += threads) {
#pragma unroll
    for (int f = 0; f < kRows; ++f) ggd::cp_async4(&s[j][f], attrs + (size_t)f * Ptot + base + j);
  }
  ggd::cp_async_commit();
  ggd::cp_async_wait_all();
  for (int j = i; j < n; j += threads) {   // this thread's own copies have landed
    const float2 r = ggd::pair_reach(s[j][2], s[j][3], s[j][4], s[j][5]);
    s[j][9] = r.x;
    s[j][10] = r.y;
  }
}

// K4: one block per tile, in rounds of kRound chunks. Pass 1: the h-th of
// the kChunkWarps warps of chunk r0 + i blends its rows of the tile, each
// lane kLaneRows pixels of one column (rows 2 kLaneRows h + lane / 16 +
// 2k), into sc as (A_c rgb, P_c). Pass 2: thread p < 256 scans pixel p
// over the round's chunks into their entry slots. Measured on the H100
// (scripts/blend_ablation.py): one warp a chunk, rounds of 4, or four
// warps a chunk are slower on the train step's pairs; leaving the rounds
// after a tile's pixels all stopped saves 2.8x on pairs that saturate.
__global__ void __launch_bounds__(kRoundThreads, 1024 / kRoundThreads) blend_train_fwd_kernel(
    const int* __restrict__ starts, const float* __restrict__ attrs, float4* __restrict__ out,
    float4* __restrict__ ent, int Ptot, int grid_x, int max_k, int chunk) {
  __shared__ __align__(16) float sp[kRound][kRoundChunk][kPad];
  __shared__ float4 sc[kRound][kPix];   // the round's (A_c rgb, P_c), pixel by pixel
  const int t = blockIdx.x, p = threadIdx.x, lane = p & 31;
  const int i_own = (p >> 5) / kChunkWarps, h = (p >> 5) % kChunkWarps;
  const int start = starts[t];
  const int count = min(starts[t + 1] - start, max_k);
  const int n_ent = (count + chunk - 1) / chunk;
  float4* ent_t = ent + (size_t)first_slot(starts, t, chunk) * kPix;
  const int tx = (t % grid_x) * 16, ty = (t / grid_x) * 16;
  // pass 1: the lane's pixels, column tx + lane % 16, rows ly0 + 2k
  const float lx = (float)(tx + (lane & 15));
  const int ly0 = ty + 2 * kLaneRows * h + (lane >> 4);
  const float rx0 = (float)tx, rx1 = rx0 + 15.f, ry0 = (float)(ty + 2 * kLaneRows * h);
  const float ry1 = ry0 + (float)(2 * kLaneRows - 1);
  // pass 2: pixel p
  const float x = (float)(tx + (p & 15)), y = (float)(ty + (p >> 4));
  float T = 1.f, ar = 0.f, ag = 0.f, ab = 0.f;
  for (int r0 = 0; r0 < n_ent; r0 += kRound) {
    const int c = r0 + i_own;
    float(*s)[kPad] = sp[i_own];
    const int n = c < n_ent ? min(chunk, count - c * chunk) : 0;
    stage_pairs(s, attrs, Ptot, start + c * chunk, n, h * 32 + lane, kChunkWarps * 32);
    __syncthreads();   // the round's chunks are staged
    if (c < n_ent) {
      // -- pass 1: chunk c from T = 1, without the stop ------------------
      float P[kLaneRows], la[kLaneRows], lg[kLaneRows], lb[kLaneRows];
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k) P[k] = 1.f, la[k] = lg[k] = lb[k] = 0.f;
      // The lanes' k-th pixels (rows 2k, 2k + 1 of the warp's) are left
      // once every one of their products is below 1e-4 (the scan replays
      // the chunk wherever it is still open, and reads nothing else of it
      // there), and the chunk once all are. This is checked every 8 pairs,
      // not after each: the pairs between two checks have no exit.
      unsigned open_rows = (1u << kLaneRows) - 1u;
      for (int g0 = 0; g0 < n && open_rows; g0 += 8) {
        const int g1 = min(n, g0 + 8);
        for (int j = g0; j < g1; ++j) {
          const float4 a = *reinterpret_cast<const float4*>(&s[j][0]);   // px py ca cb
          const float4 q = *reinterpret_cast<const float4*>(&s[j][4]);   // cc op r g
          const float4 e = *reinterpret_cast<const float4*>(&s[j][8]);   // b, reach x y, -
          // beyond its reach the pair's alpha is 0 at every pixel of the warp
          if (ggd::beyond_reach(make_float2(e.y, e.z), a.x, a.y, rx0, rx1, ry0, ry1)) continue;
          const unsigned near_rows = reach_row_pairs(e.z, a.y, ry0);
          const unsigned rows = near_rows & open_rows;
          const ggd::FalloffX fx = ggd::falloff_x(a.z, a.w, lx - a.x);
#pragma unroll
          for (int k = 0; k < kLaneRows; ++k) {
            if (!((rows >> k) & 1u)) continue;   // rows 2k, 2k + 1: beyond reach, or left
            const float dy = (float)(ly0 + 2 * k) - a.y;
            const float alpha = falloff_of(ggd::falloff_power_y(fx, q.x, dy), q.y).alpha;
            const float w = alpha * P[k];
            la[k] += w * q.z;
            lg[k] += w * q.w;
            lb[k] += w * e.x;
            P[k] *= 1.f - alpha;
          }
        }
#pragma unroll
        for (int k = 0; k < kLaneRows; ++k)
          if (!__any_sync(0xffffffffu, P[k] >= kStop)) open_rows &= ~(1u << k);
      }
#pragma unroll
      for (int k = 0; k < kLaneRows; ++k)
        sc[i_own][h * 32 * kLaneRows + lane + 32 * k] = make_float4(la[k], lg[k], lb[k], P[k]);
    }
    __syncthreads();   // the round's (A_c, P_c) are the block's
    // -- pass 2: pixel p over the round's chunks (threads past the tile's
    // pixels only wait) ------------------------------------------------------
    const int m = p < kPix ? min(kRound, n_ent - r0) : 0;
    for (int i = 0; i < m; ++i) {
      const float4 loc = sc[i][p];   // (A_c rgb, P_c)
      ent_t[(size_t)(r0 + i) * kPix + p] = make_float4(ar, ag, ab, T);
      if (T < kStop) continue;   // frozen
      const float Tc = T * loc.w;
      if (Tc >= kFastT) {
        ar += T * loc.x;
        ag += T * loc.y;
        ab += T * loc.z;
        T = Tc;
        continue;
      }
      // the sequential walk with the stop, as K5 replays it: the alphas of
      // 8 pairs first (they do not depend on T, so their chains overlap),
      // then their fold, each pair blending while T >= 1e-4
      const float(*sr)[kPad] = sp[i];
      const int nr = min(chunk, count - (r0 + i) * chunk);
      for (int g0 = 0; g0 < nr && T >= kStop; g0 += 8) {
        float al[8];
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const float4 a = *reinterpret_cast<const float4*>(&sr[min(g0 + g, nr - 1)][0]);
          const float4 q = *reinterpret_cast<const float4*>(&sr[min(g0 + g, nr - 1)][4]);
          al[g] = falloff_of(ggd::falloff_power(a.z, a.w, q.x, x - a.x, y - a.y), q.y).alpha;
        }
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          if (g0 + g < nr && T >= kStop) {
            const float w = al[g] * T;
            ar += w * sr[g0 + g][6];
            ag += w * sr[g0 + g][7];
            ab += w * sr[g0 + g][8];
            T *= 1.f - al[g];
          }
        }
      }
    }
    // every pixel stopped: the later chunks are not blended, and enter with
    // the frozen state (this barrier also frees sp for the next round)
    if (!__syncthreads_or(p < kPix && T >= kStop)) {
      for (int ci = r0 + kRound; p < kPix && ci < n_ent; ++ci)
        ent_t[(size_t)ci * kPix + p] = make_float4(ar, ag, ab, T);
      break;
    }
  }
  if (p < kPix) out[(size_t)t * kPix + p] = make_float4(ar, ag, ab, T);
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
  if (ts * ts != kPix || n_tiles < 1 || chunk < 1 || chunk > kRoundChunk)
    return (int)cudaErrorInvalidValue;
  blend_train_fwd_kernel<<<n_tiles, kRoundThreads, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const float*)attrs, (float4*)out, (float4*)ent, Ptot, grid_x, max_k,
      chunk);
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
