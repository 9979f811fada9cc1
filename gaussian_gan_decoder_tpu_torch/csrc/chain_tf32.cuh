// The f32 decoder chain on the tensor cores in 3xTF32, shared by K6
// (heads_train.cu::heads_fwd_kernel, the chain alone) and the f32 forms of
// the decode tails K2, K8 and K9 (decode_f32.cu, the chain then chain.cuh's
// projection): 128-point blocks of 8 warps, the block's staging as an f32
// tile in shared memory, each warp's 16 points' activations in registers
// through all 20 layers, the weights split once per call into TF32
// (hi, lo) pairs (split_weights_kernel) and streamed by cp.async through a
// two-slot ring, half a layer a slot.
//
// Fragment roles of mma.sync m16n8k8 (g = lane / 4, q = lane % 4): A holds
// (row g, k slot q), (g + 8, q), (g, q + 4), (g + 8, q + 4); B (k slot q,
// n slot g), (q + 4, g); C (g, n slots 2q, 2q + 1), (g + 8, 2q, 2q + 1).
// A layer's 128 columns are 16 n-tiles: slot s of n-tile j is column
// 16 (j >> 1) + 2 s + (j & 1), so a thread's C registers of n-tiles 2J and
// 2J + 1 are columns 16 J + 4 q + {0, 1, 2, 3}. k-step (J, b) of the next
// layer gives slot q column 16 J + 4 q + 2 b and slot q + 4 column
// 16 J + 4 q + 2 b + 1: its A fragment is four of those C registers, after
// bias and GELU, and its B fragments are weight rows 16 J + 4 q + 2 b and
// + 1 at columns 16 J' + 2 g + {0, 1}: with each weight stored as its
// (hi, lo) pair, one 16-byte load a row for n-tiles 2J' and 2J' + 1.
#pragma once

#include "chain.cuh"
#include "tf32.cuh"

namespace ggd {

constexpr int kF32Pts = 128;      // points per block: 8 warps x 16 rows
constexpr int kF32Threads = 256;
constexpr int kF32Ld = 144;       // f32 row stride of the staging tile: 128 staging
                                  // columns, then the 16 packed outputs; 144 = 16 (mod 32)
                                  // words puts the two rows of a 16-byte fragment load on
                                  // distinct banks
constexpr int kF32OutCol = 128;   // the packed outputs in a staging tile row
constexpr int kF32W4ld = 20;      // f32 row stride of the 128 x 16 layer-4 tile
constexpr int kLayer = kStage * kStage;
constexpr int kSplitRow = 2 * kStage;      // floats of a split weight row: (hi, lo) per column
constexpr int kSplitSlot = 64 * kSplitRow; // floats of a ring slot: 64 split weight rows

// the packed f32 chain (pallas_heads.ChainWeights)
struct ChainF32 {
  const float *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;
};

// shared memory of an f32 chain block (dynamic), floats
struct F32Smem {
  float* X;      // kF32Pts x kF32Ld  staging tile + packed outputs
  float* ring;   // 2 x kSplitSlot
  float* W4;     // kStage x kF32W4ld
  float* sB;     // kMaxHeads x kBiasHead: b1 b2 b3 b4
};

constexpr size_t kF32SmemBytes = ((size_t)kF32Pts * kF32Ld + 2 * kSplitSlot +
                                  kStage * kF32W4ld + kMaxHeads * kBiasHead) * sizeof(float);

__device__ __forceinline__ F32Smem f32_smem(float* smem) {
  F32Smem s;
  s.X = smem;
  s.ring = s.X + kF32Pts * kF32Ld;
  s.W4 = s.ring + 2 * kSplitSlot;
  s.sB = s.W4 + kStage * kF32W4ld;
  return s;
}

// transformed head output (meta kind: 1 scale, 2 xyz) of a staging row
__device__ __forceinline__ float transform(float o, int kind, int col, float scale_offset,
                                           const float* xrow) {
  if (kind == 1) return -softplus(o + 5.f) + scale_offset;
  if (kind == 2) return o * 0.01f + (col < 3 ? xrow[kInitCol + col] : 0.f);
  return o;
}

template <int kGelu>
__device__ __forceinline__ float gelu_fwd(float x) {
  return kGelu == 0 ? gelu_exact(x) : gelu(x, kGelu);
}

// v <- gelu(v + bias): C register e of n-tile 2 J + p is column
// 16 J + 4 q + 2 (e & 1) + p
template <int kGelu>
__device__ __forceinline__ void bias_gelu(float (&v)[16][4], const float* bias) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int J = 0; J < 8; ++J) {
    const float4 bv = *reinterpret_cast<const float4*>(bias + 16 * J + 4 * q);
    const float bb[2][2] = {{bv.x, bv.z}, {bv.y, bv.w}};   // [p][e & 1]
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[2 * J + p][e] = gelu_fwd<kGelu>(v[2 * J + p][e] + bb[p][e & 1]);
  }
}

// acc += A @ W over k-step pairs J in [kJ0, kJ1) of one ring stage
// (kFromX: only those below nJ). A is the staging tile (kFromX: xr is this
// thread's row g, row g + 8 at 8 kF32Ld) or the previous layer's
// activations act; slot holds weight rows 16 kJ0 .. 16 kJ1 - 1 as (hi, lo)
// pairs, row k's words XOR-swizzled by bits 2-3 of k, which for this
// thread's rows 16 J + 4 q + {0..3} is q.
template <int kJ0, int kJ1, bool kFromX>
__device__ __forceinline__ void fwd_stage(float (&acc)[16][4], const float (&act)[16][4],
                                          const float* xr, const float* slot, int nJ) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int J = kJ0; J < kJ1; ++J) {
    if (kFromX && J >= nJ) break;
    float a[2][4];
    if constexpr (kFromX) {
      const float4 x0 = *reinterpret_cast<const float4*>(xr + 16 * J + 4 * q);
      const float4 x8 = *reinterpret_cast<const float4*>(xr + 8 * kF32Ld + 16 * J + 4 * q);
      a[0][0] = x0.x; a[0][1] = x8.x; a[0][2] = x0.y; a[0][3] = x8.y;
      a[1][0] = x0.z; a[1][1] = x8.z; a[1][2] = x0.w; a[1][3] = x8.w;
    } else {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        a[b][0] = act[2 * J][b];
        a[b][1] = act[2 * J][2 + b];
        a[b][2] = act[2 * J + 1][b];
        a[b][3] = act[2 * J + 1][2 + b];
      }
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[b][e], ahi[e], alo[e]);
      const float* r0 = slot + (16 * (J - kJ0) + 4 * q + 2 * b) * kSplitRow;
#pragma unroll
      for (int Jn = 0; Jn < 8; ++Jn) {
        // (hi, lo) of columns 16 Jn + 2 g and + 1, rows k and k + 1: b0 and
        // b1 of n-tiles 2 Jn and 2 Jn + 1
        const int n = (32 * Jn + 4 * g) ^ (q << 3);
        const uint4 v0 = *reinterpret_cast<const uint4*>(r0 + n);
        const uint4 v1 = *reinterpret_cast<const uint4*>(r0 + kSplitRow + n);
        mma_3xtf32(acc[2 * Jn], ahi, alo, v0.x, v1.x, v0.y, v1.y);
        mma_3xtf32(acc[2 * Jn + 1], ahi, alo, v0.z, v1.z, v0.w, v1.w);
      }
    }
  }
}

// o = act @ W4 (128 x 16): two n-tiles, slot s of n-tile p is column
// 2 s + p, so C register e of n-tile p is column 4 q + 2 (e & 1) + p
__device__ __forceinline__ void layer4(float (&o)[2][4], const float (&act)[16][4],
                                       const float* W4) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[p][e] = 0.f;
#pragma unroll
  for (int J = 0; J < 8; ++J)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float a[4] = {act[2 * J][b], act[2 * J][2 + b], act[2 * J + 1][b],
                          act[2 * J + 1][2 + b]};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ahi[e], alo[e]);
      const float* r0 = W4 + (16 * J + 4 * q + 2 * b) * kF32W4ld + 2 * g;
      const float2 v0 = *reinterpret_cast<const float2*>(r0);
      const float2 v1 = *reinterpret_cast<const float2*>(r0 + kF32W4ld);
      uint32_t h[4], l[4];
      split_tf32(v0.x, h[0], l[0]);
      split_tf32(v1.x, h[1], l[1]);
      split_tf32(v0.y, h[2], l[2]);
      split_tf32(v1.y, h[3], l[3]);
      mma_3xtf32(o[0], ahi, alo, h[0], h[1], l[0], l[1]);
      mma_3xtf32(o[1], ahi, alo, h[2], h[3], l[2], l[3]);
    }
}

// k-step pairs of head h's layer 1: w1's rows past the head's staging
// prefix (meta stage column) are zero (ChainWeights), so they are neither
// copied nor multiplied
__device__ __forceinline__ int layer1_pairs(const int* __restrict__ meta, int h) {
  return min(8, (__ldg(meta + 6 + h) + 15) / 16);
}

// Stage st of the weight stream (two stages a layer, 64 split rows each,
// layers w1 w2 w3 of head 0, 1, ...) -> ring slot st & 1
__device__ __forceinline__ void fetch_split_stage(const F32Smem& s,
                                                  const float* __restrict__ wsplit,
                                                  const int* __restrict__ meta, int st) {
  const int hl = st / 2, part = st % 2;
  const int n = min(64, (hl % 3 == 0 ? 16 * layer1_pairs(meta, hl / 3) : kStage) - 64 * part);
  const float* w = wsplit + (size_t)hl * 2 * kLayer + part * kSplitSlot;
  if (n > 0) cp_rows<kSplitRow, kSplitRow, true, kF32Threads>(s.ring + (st & 1) * kSplitSlot, w, n);
}

__device__ __forceinline__ void fetch_w4_f32(const F32Smem& s, const ChainF32& cw, int h) {
  const float* src = cw.w4 + (size_t)h * kStage * kOutW;
  for (int i = threadIdx.x; i < kStage * kOutW / 4; i += kF32Threads)
    cp_async16(s.W4 + (i >> 2) * kF32W4ld + (i & 3) * 4, src + i * 4);
}

// Block set-up of the chain (after the caller has issued or stored the
// staging rows): stage 0 and head 0's W4 in flight (committed with any
// copies the caller issued before), meta, biases and the zeroed output
// columns by plain stores. Visible to all after the chain's first barrier.
__device__ __forceinline__ void chain_f32_setup(const F32Smem& s, int* sMeta, const ChainF32& cw,
                                                const float* __restrict__ wsplit,
                                                const int* __restrict__ meta, int n_heads) {
  const int tid = threadIdx.x;
  fetch_split_stage(s, wsplit, meta, 0);
  fetch_w4_f32(s, cw, 0);
  cp_async_commit();
  if (tid < 32) sMeta[tid] = meta[tid];
  for (int i = tid; i < n_heads * kBiasHead; i += kF32Threads) {
    const int h = i / kBiasHead, j = i % kBiasHead, l = j / kStage, c = j % kStage;
    const float* b = l == 0 ? cw.b1 : (l == 1 ? cw.b2 : (l == 2 ? cw.b3 : cw.b4));
    s.sB[i] = l < 3 ? b[h * kStage + c] : b[h * kOutW + c];
  }
  for (int i = tid; i < kF32Pts * 4; i += kF32Threads)
    *reinterpret_cast<float4*>(s.X + (i >> 2) * kF32Ld + kF32OutCol + (i & 3) * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
}

// bias + GELU of a layer's accumulators, the GELU kind a template argument
// (kGelu >= 0, K6) or chosen at run time from gk (kGelu < 0: the decode
// tails, one kernel for every kind)
template <int kGelu>
__device__ __forceinline__ void bias_gelu_kind(float (&v)[16][4], const float* bias, int gk) {
  if constexpr (kGelu >= 0) {
    bias_gelu<kGelu>(v, bias);
  } else {
    switch (gk) {
      case 0: bias_gelu<0>(v, bias); break;
      case 1: bias_gelu<1>(v, bias); break;
      case 2: bias_gelu<2>(v, bias); break;
      case 3: bias_gelu<3>(v, bias); break;
      default: bias_gelu<4>(v, bias); break;
    }
  }
}

// The chain over the staging tile: head h reads the staging prefix, 3 x
// (128 x 128 linear + GELU) and a 128 x 16 linear, then the scale / xyz
// transform; the transformed output lands in the tile's packed-output
// columns and, where stage_col + out_dim <= kStage (the parallel chain
// writes none), in the staging columns later heads read. Each warp touches
// its own 16 rows only: on return the caller may read them after a
// __syncwarp, or the whole tile after a __syncthreads.
//
// Stage st of the weight stream goes to ring slot st & 1; each ring_step
// waits for stage st, then starts stage st + 1, and at a head's first
// stage that head's W4 (the barrier frees it: every warp is past the last
// head's layer 4).
template <int kGelu>
__device__ __forceinline__ void chain_f32(const F32Smem& s, const int* sMeta,
                                          const int* __restrict__ meta, const ChainF32& cw,
                                          const float* __restrict__ wsplit, int n_heads,
                                          float scale_offset, int gk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int n_stages = 6 * n_heads;
  const float* xr = s.X + (16 * warp + g) * kF32Ld;
  int st = 0;
  // wait for stage st and return its slot, the next copies started
  auto advance = [&]() -> const float* {
    ring_step([&] {
      if (st + 1 < n_stages) fetch_split_stage(s, wsplit, meta, st + 1);
      if (st % 6 == 0 && st > 0) fetch_w4_f32(s, cw, st / 6);
    });
    return s.ring + (st++ & 1) * kSplitSlot;
  };
  // act: the last layer's activations, acc the layer's sums
  float act[16][4], acc[16][4];
  for (int h = 0; h < n_heads; ++h) {
    const float* bh = s.sB + h * kBiasHead;
    for (int l = 0; l < 3; ++l) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      const int nJ = l == 0 ? layer1_pairs(meta, h) : 8;
      const float* slot = advance();
      if (l == 0)
        fwd_stage<0, 4, true>(acc, act, xr, slot, nJ);
      else
        fwd_stage<0, 4, false>(acc, act, xr, slot, nJ);
      slot = advance();
      if (l == 0)
        fwd_stage<4, 8, true>(acc, act, xr, slot, nJ);
      else
        fwd_stage<4, 8, false>(acc, act, xr, slot, nJ);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) act[j][e] = acc[j][e];
      bias_gelu_kind<kGelu>(act, bh + l * kStage, gk);
    }
    // layer 4: head h's W4 landed with the wait of the stage after its fetch
    float o[2][4];
    layer4(o, act, s.W4);
    const int od = sMeta[1 + h], sc = sMeta[6 + h], oc = sMeta[11 + h], kind = sMeta[16 + h];
    const float* b4 = bh + 3 * kStage;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * q + 2 * (e & 1) + p;
        float* xrow = s.X + (16 * warp + g + 8 * (e >> 1)) * kF32Ld;
        if (col < od) {
          const float v = transform(o[p][e] + b4[col], kind, col, scale_offset, xrow);
          xrow[kF32OutCol + oc + col] = v;
          if (sc + od <= kStage) xrow[sc + col] = v;
        }
      }
    __syncwarp();   // the warp's next layer 1 reads its own rows only
  }
}

namespace {

// w1, w2, w3 -> their TF32 (hi, lo) pairs, wsplit[h][l][128][128][2], once
// per call
__global__ void split_weights_kernel(ChainF32 cw, float* __restrict__ wsplit, int n_heads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_heads * 3 * kLayer) return;
  const int hl = i / kLayer, e = i % kLayer, l = hl % 3;
  const float* w = l == 0 ? cw.w1 : (l == 1 ? cw.w2 : cw.w3);
  uint32_t hi, lo;
  split_tf32(w[(size_t)(hl / 3) * kLayer + e], hi, lo);
  wsplit[(size_t)hl * 2 * kLayer + 2 * e] = __uint_as_float(hi);
  wsplit[(size_t)hl * 2 * kLayer + 2 * e + 1] = __uint_as_float(lo);
}

// host side: the split of a call's weights, on its stream
cudaError_t split_weights(const ChainF32& cw, void* wsplit, int n_heads, cudaStream_t stream) {
  const int n = n_heads * 3 * kLayer;
  split_weights_kernel<<<(n + 255) / 256, 256, 0, stream>>>(cw, (float*)wsplit, n_heads);
  return cudaGetLastError();
}

// host side: the chain's raw pointers (ctypes) as a kernel argument
ChainF32 chain_f32_ptrs(const void* w1, const void* b1, const void* w2, const void* b2,
                        const void* w3, const void* b3, const void* w4, const void* b4) {
  return ChainF32{(const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
                  (const float*)w3, (const float*)b3, (const float*)w4, (const float*)b4};
}

}  // namespace

}  // namespace ggd
