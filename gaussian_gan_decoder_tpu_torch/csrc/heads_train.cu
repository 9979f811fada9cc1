// K6 / K7: the 5-head decoder chain of the training step, f32, forward and
// backward, both on the tensor cores in 3xTF32 (tf32.cuh: each f32 operand
// split into TF32 high and low parts, hi*hi + hi*lo + lo*hi by mma.sync
// m16n8k8 with f32 accumulators, about f32 accuracy).
//
// K6 replaces the TPU kernel gaussian_gan_decoder_tpu/decoder/pallas_heads.py
// ::decode_heads_pallas (_heads_kernel, compute_dtype f32): per point the
// staging row (128 f32: plane-mean feature, position, chain columns, init at
// 120) runs through the heads; head h reads the staging prefix, 3 x (128x128
// linear + GELU) and a 128x16 linear, then scale = -softplus(o + 5) + offset
// or xyz = 0.01 o + init; the transformed output lands in the packed (M, 16)
// result and, for later heads, in the staging columns.
//
// Bound: operations, 5.12e5 FLOPs a point (padded), whose least time at f32
// accuracy is 3xTF32 on the tensor cores. Design: one block of 8 warps per
// 128 points; warp w owns points 16 w .. 16 w + 15 for the whole chain, and
// its activations never leave registers: the m16n8 accumulator of a layer,
// after bias and GELU, IS the next layer's A fragments once the 8 k slots of
// each k-step are assigned to the columns the thread holds (see
// chain_tf32.cuh, which holds this chain for K6 and the f32 decode tails,
// csrc/decode_f32.cu). The staging tile (f32, shared memory) feeds layer 1
// and takes the head
// outputs. The weights are split once per call on the device
// (split_weights_kernel) into TF32 (hi, lo) pairs, and stream by cp.async
// (tf32.cuh) through a two-slot ring, 64 rows a slot, the next half layer
// arriving while this one computes: twice the operand bytes of the f32
// weights, but one 16-byte load gives the hi and lo parts of two n-tiles'
// B fragments, and no split instructions run in the product loop
// (scripts/k6_ablation.py times the warps splitting as they read). Rows
// swizzled by bits 2-3 make every fragment load conflict-free without
// padding. Layer 1 multiplies only the rows of w1 within the head's
// staging prefix (the rest are zero, ChainWeights): 48 of 128 in the
// decoder's chain. Layer 4 is two more n-tiles. Bias and GELU run on the
// accumulator fragments, the GELU kind a template argument, so the
// epilogue is straight-line code; the exact GELU takes the fast exp.
//
// Per point, before (64-point blocks, f32 FMAs on the CUDA cores,
// chain.cuh::hidden_layer) and after: weights from L2 16 KB -> 12.5 KB (each
// layer serves 128 points, not 64, but as (hi, lo) pairs; layer 1 48 rows);
// activations through shared memory 3 x 2 x 512 B a layer -> none; one
// block an SM either way (171.5 KB -> 218 KB of shared memory). FLOPs
// 5.12e5 as f32 FMAs at 67 TFLOP/s -> 4.1e5 (layer 1 cut to 48 rows) three
// times over as TF32 on the tensor cores; least time for the train step's
// 500,000 points 2.86 ms -> 1.16 ms (3xTF32 at a third of 495 TFLOP/s).
//
// K7 replaces decoder/pallas_heads_vjp.py::_run_bwd (_heads_bwd_kernel): the
// exact reverse of K6's chain. The TPU kernel keeps 5 residual sets per head
// in VMEM (25 x block x 128 f32), which does not fit a Hopper block. K7
// takes K6's packed outputs instead: the staging before head h is the input
// staging plus the outputs of heads < h, so each head's hidden layers are
// recomputed during its reverse step from that snapshot.
//
// Design: 132 blocks (one per SM), heads outer and 64-point tiles inner
// (blockIdx.x, + gridDim.x, ...; a ragged last tile is masked). All three
// kinds of 128 x 128 product run on the tensor cores in 3xTF32: the
// recompute X W, the data gradient G W^T and the weight gradient A^T G.
// The 16-wide layer 4 stays on the CUDA cores. Each warp keeps its rows'
// pre-activations z1..z3 in registers (later their GELU derivatives), the
// activations and gradients pass through two shared tiles, and the weights
// stream through a two-slot ring of 64-row halves by cp.async, W3 reused from
// the recompute. Weight and bias gradients are summed into this block's own
// slice of a partial buffer (read-modify-write, no atomics); with heads
// outer, one head's slices (206 KB a block, 27 MB in all) are what the
// tiles sum into while that head runs. heads_grad_reduce sums the slices
// in a fixed order: bit-identical run to run. The staging gradient carries
// from head to head in dstage.
//
// Per point, before (32-point tiles, f32 FMAs) and after: weights from L2
// 61 KB -> 25 KB (each layer loaded twice per head and tile, now once per
// half of 64 points, W3 once); partial read-modify-write 64.5 KB -> 32 KB;
// FLOPs the same, ~1.5e6 f32 (3 x K6's 5.12e5), now 4.6e6 TF32 on the
// tensor cores. Bound: those FLOPs at a third of the 495 TFLOP/s TF32 rate.
#include "chain_tf32.cuh"

namespace {

using ggd::kBiasHead;
using ggd::kInitCol;
using ggd::kMaxHeads;
using ggd::kOutW;
using ggd::kStage;

constexpr int kThreads = 256;
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

using Chain = ggd::ChainF32;

// ---- K6: 128-point blocks, the chain in registers -------------------------
// The chain is chain_tf32.cuh's chain_f32, which the f32 decode tails
// (decode_f32.cu) share; K6 loads its staging rows, runs it and writes the
// packed outputs.

template <int kGelu>
__global__ void __launch_bounds__(kThreads, 1) heads_fwd_kernel(
    const float* __restrict__ staging, Chain cw, const float* __restrict__ wsplit,
    const int* __restrict__ meta, float* __restrict__ out, int Mpad, float scale_offset) {
  extern __shared__ __align__(16) float smem[];
  const ggd::F32Smem s = ggd::f32_smem(smem);
  __shared__ int sMeta[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * ggd::kF32Pts;
  const int n_rows = min(ggd::kF32Pts, Mpad - m0);
  const int n_heads = meta[0];

  // prologue: staging rows (zero past Mpad) in flight with stage 0 and head
  // 0's W4; meta, biases and the zeroed output columns by plain stores
  for (int i = tid; i < ggd::kF32Pts * 32; i += kThreads) {
    const int r = i >> 5, c = (i & 31) * 4;
    if (r < n_rows)
      ggd::cp_async16(s.X + r * ggd::kF32Ld + c, staging + (size_t)(m0 + r) * kStage + c);
    else
      *reinterpret_cast<float4*>(s.X + r * ggd::kF32Ld + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  ggd::chain_f32_setup(s, sMeta, cw, wsplit, meta, n_heads);
  ggd::chain_f32<kGelu>(s, sMeta, meta, cw, wsplit, n_heads, scale_offset);
  for (int i = lane; i < 16 * 4; i += 32) {
    const int r = 16 * warp + (i >> 2), c = (i & 3) * 4;
    if (r < n_rows)
      *reinterpret_cast<float4*>(out + (size_t)(m0 + r) * kOutW + c) =
          *reinterpret_cast<const float4*>(s.X + r * ggd::kF32Ld + ggd::kF32OutCol + c);
  }
}

// ---- K7 on a 64-point tile, 256 threads, products on the tensor cores ----
// Owner layout of a 64 x 128 row-major result (z, da, dx): warp w owns rows
// 16 (w & 3) + {g, g + 8} and the 8 n-tiles at columns
// 64 (j >> 2) + 32 (w >> 2) + 8 (j & 3) + 2 q + {0, 1}, j < 8, so that each
// 64-row half of a weight matrix feeds every warp (g = lane / 4,
// q = lane % 4: the mma.sync m16n8k8 fragment roles).

constexpr int kBT = 64;       // K7 points per tile
constexpr int kAld = 132;     // f32 row stride of the tile arrays
constexpr int kWld = 136;     // f32 row stride of a weight half (conflict-free B reads)
constexpr int kHalf = 64;     // weight rows per ring slot

__device__ __forceinline__ int own_col(int j, int warp) {
  return 64 * (j >> 2) + 32 * (warp >> 2) + 8 * (j & 3);
}

// rows [64 half, 64 half + 64) of a 128 x 128 f32 matrix -> ring slot
// `half`, as 16-byte cp.async chunks
__device__ __forceinline__ void fetch_half(float* ring, const float* w, int half) {
  ggd::cp_rows<kStage, kWld, false, kThreads>(ring + half * kHalf * kWld,
                                               w + (size_t)half * kHalf * kStage, kHalf);
}

__device__ __forceinline__ void zero_frag(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// the split A fragment of rows r0 + {g, g + 8}, columns k + {q, q + 4} of a
// row-major tile array
__device__ __forceinline__ void load_a(const float* A, int r0, int k, int g, int q,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  ggd::split_tf32(A[(r0 + g) * kAld + k + q], hi[0], lo[0]);
  ggd::split_tf32(A[(r0 + g + 8) * kAld + k + q], hi[1], lo[1]);
  ggd::split_tf32(A[(r0 + g) * kAld + k + q + 4], hi[2], lo[2]);
  ggd::split_tf32(A[(r0 + g + 8) * kAld + k + q + 4], hi[3], lo[3]);
}

// forward product, one weight half: acc (owner layout) += A[:, 64 half +
// (0:64)] @ W[64 half + (0:64), :], with Ws the slot holding those rows
__device__ __forceinline__ void mm_fwd_half(float (&acc)[8][4], const float* A, const float* Ws,
                                            int half) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int r0 = 16 * (warp & 3);
#pragma unroll 2
  for (int ks = 0; ks < kHalf / 8; ++ks) {
    uint32_t ahi[4], alo[4];
    load_a(A, r0, kHalf * half + 8 * ks, g, q, ahi, alo);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = own_col(j, warp) + g;
      uint32_t bh0, bh1, bl0, bl1;
      ggd::split_tf32(Ws[(8 * ks + q) * kWld + n], bh0, bl0);
      ggd::split_tf32(Ws[(8 * ks + q + 4) * kWld + n], bh1, bl1);
      ggd::mma_3xtf32(acc[j], ahi, alo, bh0, bh1, bl0, bl1);
    }
  }
}

// data gradient, one weight half: acc n-tiles 4 half .. 4 half + 3 (owner
// columns in [64 half, 64 half + 64)) += G @ W^T over all 128 columns of
// G, Ws holding W's rows 64 half + (0:64)
__device__ __forceinline__ void mm_bwd_half(float (&acc)[8][4], const float* G, const float* Ws,
                                            int half) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int r0 = 16 * (warp & 3);
#pragma unroll 2
  for (int ks = 0; ks < kStage / 8; ++ks) {
    uint32_t ahi[4], alo[4];
    load_a(G, r0, 8 * ks, g, q, ahi, alo);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* wrow = Ws + (32 * (warp >> 2) + 8 * jj + g) * kWld + 8 * ks;
      uint32_t bh0, bh1, bl0, bl1;
      ggd::split_tf32(wrow[q], bh0, bl0);
      ggd::split_tf32(wrow[q + 4], bh1, bl1);
      ggd::mma_3xtf32(acc[4 * half + jj], ahi, alo, bh0, bh1, bl0, bl1);
    }
  }
}

// weight gradient of a 128 x 128 layer: the block's partial pw[k][n] +=
// sum over the tile's points of A[p][k] G[p][n]; pb[n] += sum_p G[p][n].
// Warp w owns rows k = 16 w + {g, g + 8}, in two passes of 64 columns.
__device__ __forceinline__ void wgrad(const float* A, const float* G, float* pw, float* pb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int k0 = 16 * warp;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    // the pass's slice of the block's partial, loaded before the products
    // so that its L2 round trip overlaps them (read-modify-write, no atomics)
    float2* row[2];
    float2 old[2][8];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      row[hr] = reinterpret_cast<float2*>(pw + (k0 + g + 8 * hr) * kStage + 64 * pass) + q;
#pragma unroll
      for (int j = 0; j < 8; ++j) old[hr][j] = row[hr][4 * j];
    }
    float acc[8][4];
    zero_frag(acc);
#pragma unroll 2
    for (int ks = 0; ks < kBT / 8; ++ks) {
      const int p = 8 * ks + q;
      uint32_t ahi[4], alo[4];
      ggd::split_tf32(A[p * kAld + k0 + g], ahi[0], alo[0]);
      ggd::split_tf32(A[p * kAld + k0 + g + 8], ahi[1], alo[1]);
      ggd::split_tf32(A[(p + 4) * kAld + k0 + g], ahi[2], alo[2]);
      ggd::split_tf32(A[(p + 4) * kAld + k0 + g + 8], ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 64 * pass + 8 * j + g;
        uint32_t bh0, bh1, bl0, bl1;
        ggd::split_tf32(G[p * kAld + n], bh0, bl0);
        ggd::split_tf32(G[(p + 4) * kAld + n], bh1, bl1);
        ggd::mma_3xtf32(acc[j], ahi, alo, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        row[hr][4 * j] = make_float2(old[hr][j].x + acc[j][2 * hr],
                                     old[hr][j].y + acc[j][2 * hr + 1]);
  }
  if (threadIdx.x < kStage) {
    float s = 0.f;
    for (int p = 0; p < kBT; ++p) s += G[p * kAld + threadIdx.x];
    pb[threadIdx.x] += s;
  }
}

// owner elements of v -> dst (row-major tile array), as float2 stores
__device__ __forceinline__ void store_owner(float* dst, const float (&v)[8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const int r0 = 16 * (warp & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = own_col(j, warp) + 2 * q;
    *reinterpret_cast<float2*>(dst + (r0 + g) * kAld + c) = make_float2(v[j][0], v[j][1]);
    *reinterpret_cast<float2*>(dst + (r0 + g + 8) * kAld + c) = make_float2(v[j][2], v[j][3]);
  }
}

// z += bias (owner layout)
__device__ __forceinline__ void add_bias(float (&z)[8][4], const float* bias) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = own_col(j, warp) + 2 * q;
    z[j][0] += bias[c];
    z[j][1] += bias[c + 1];
    z[j][2] += bias[c];
    z[j][3] += bias[c + 1];
  }
}

// dst <- gelu(z) (owner layout)
__device__ __forceinline__ void store_gelu(float* dst, const float (&z)[8][4]) {
  float a[8][4], unused;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = ggd::gelu_and_grad(z[j][e], unused);
  store_owner(dst, a);
}

// dst <- gelu(z), and z <- gelu'(z) (owner layout): the layer's last use
// of its pre-activation
__device__ __forceinline__ void store_gelu_keep_grad(float* dst, float (&z)[8][4]) {
  float a[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = ggd::gelu_and_grad(z[j][e], z[j][e]);
  store_owner(dst, a);
}

// d *= gelu'(z), the derivative already in place of z (owner layout)
__device__ __forceinline__ void times(float (&d)[8][4], const float (&gz)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] *= gz[j][e];
}

__device__ __forceinline__ void next_half(float* ring, const float* w, int half) {
  ggd::ring_step([&] {
    if (w != nullptr) fetch_half(ring, w, half);
  });
}

// The weight stream of one tile of one head, in ring slots by half:
// forward W1 W2 W3 (halves 0, 1), then the backward reuses W3's halves
// where they are and reloads W2 and W1. Each load (next_half) starts
// after the barrier that frees its slot, and overlaps the product before
// the product that reads it.
__global__ void __launch_bounds__(kThreads, 1) heads_bwd_kernel(
    const float* __restrict__ staging, const float* __restrict__ out16,
    const float* __restrict__ dout, Chain cw, const int* __restrict__ meta,
    float* __restrict__ dstage, float* __restrict__ partials, int Mpad,
    float scale_offset) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                      // kBT x kAld staging before head h
  float* Sa = X + kBT * kAld;           // an activation
  float* Sg = Sa + kBT * kAld;          // a gradient dz
  float* DX = Sg + kBT * kAld;          // staging gradient
  float* ring = DX + kBT * kAld;        // 2 x kHalf x kWld weight halves
  float* W4 = ring + 2 * kHalf * kWld;  // kStage x kW4Ld
  float* Oraw = W4 + kStage * kW4Ld;    // kBT x kOutW raw layer-4 output
  float* GO = Oraw + kBT * kOutW;       // kBT x kOutW dO
  float* sB = GO + kBT * kOutW;         // b1 b2 b3 (128 each), b4 (16)
  float* slot1 = ring + kHalf * kWld;
  __shared__ int sMeta[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int r0 = 16 * (warp & 3);
  if (tid < 32) sMeta[tid] = meta[tid];
  __syncthreads();
  const int n_heads = sMeta[0];   // the wrapper admits the exact GELU only
  const int n_tiles = (Mpad + kBT - 1) / kBT;
  float* part = partials + (size_t)blockIdx.x * 5 * kHeadGrad;
  const size_t HW = (size_t)kStage * kStage;

  fetch_half(ring, cw.w1 + (n_heads - 1) * HW, 0);
  ggd::cp_async_commit();
  float z1[8][4], z2[8][4], z3[8][4], d[8][4];
  // Heads outer, tiles inner: the block's partial slice of head h (206 KB)
  // stays in L2 while each tile sums into it, and the staging gradient
  // carries from head to head in dstage.
  for (int h = n_heads - 1; h >= 0; --h) {
    const float *w1 = cw.w1 + h * HW, *w2 = cw.w2 + h * HW, *w3 = cw.w3 + h * HW;
    float* ph = part + (size_t)h * kHeadGrad;
    const int od = sMeta[1 + h], sc = sMeta[6 + h], oc = sMeta[11 + h], kind = sMeta[16 + h];
    __syncthreads();   // the last head's readers of W4 and sB are done
    for (int i = tid; i < kStage * kOutW; i += kThreads)
      W4[(i / kOutW) * kW4Ld + i % kOutW] = cw.w4[(size_t)h * kStage * kOutW + i];
    for (int i = tid; i < kStage; i += kThreads) {
      sB[i] = cw.b1[h * kStage + i];
      sB[kStage + i] = cw.b2[h * kStage + i];
      sB[2 * kStage + i] = cw.b3[h * kStage + i];
    }
    if (tid < kOutW) sB[3 * kStage + tid] = cw.b4[h * kOutW + tid];

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const size_t m0 = (size_t)tile * kBT;
      const bool last = tile + (int)gridDim.x >= n_tiles;
      // the staging before head h (the input plus the outputs of heads <
      // h) and the gradient the later heads left; rows past Mpad are zero.
      // Read (and dstage written) as streaming data, so that the partial
      // slices, not these, stay in L2
      for (int i = tid; i < kBT * kStage; i += kThreads) {
        const int r = i / kStage, c = i % kStage;
        const bool in = m0 + r < (size_t)Mpad;
        float v = in ? __ldcs(staging + m0 * kStage + i) : 0.f;
        if (in)
          for (int j = 0; j < h; ++j) {
            const int scj = sMeta[6 + j], odj = sMeta[1 + j];
            if (c >= scj && c < scj + odj && scj + odj <= kStage)
              v = __ldcs(out16 + (m0 + r) * kOutW + sMeta[11 + j] + c - scj);
          }
        X[r * kAld + c] = v;
        DX[r * kAld + c] = (in && h < n_heads - 1) ? __ldcs(dstage + m0 * kStage + i) : 0.f;
      }
      // -- recompute: z1, z2, z3 in registers, activations through Sa --
      next_half(ring, w1, 1);
      zero_frag(z1);
      mm_fwd_half(z1, X, ring, 0);
      next_half(ring, w2, 0);
      mm_fwd_half(z1, X, slot1, 1);
      add_bias(z1, sB);
      store_gelu(Sa, z1);                                   // Sa = a1
      next_half(ring, w2, 1);
      zero_frag(z2);
      mm_fwd_half(z2, Sa, ring, 0);
      next_half(ring, w3, 0);
      mm_fwd_half(z2, Sa, slot1, 1);
      add_bias(z2, sB + kStage);
      __syncthreads();
      store_gelu(Sa, z2);                                   // Sa = a2
      next_half(ring, w3, 1);
      zero_frag(z3);
      mm_fwd_half(z3, Sa, ring, 0);
      next_half(ring, nullptr, 0);                          // W3 stays for the backward
      mm_fwd_half(z3, Sa, slot1, 1);
      add_bias(z3, sB + 2 * kStage);
      __syncthreads();
      store_gelu_keep_grad(Sa, z3);                         // Sa = a3, z3 = gelu'(z3)
      __syncthreads();
      // -- layer 4 on the CUDA cores: raw output, then dO ----------------
      for (int e = tid; e < kBT * kOutW; e += kThreads) {
        const int r = e / kOutW, j = e % kOutW;
        float acc = 0.f;
        for (int k = 0; k < kStage; ++k) acc += Sa[r * kAld + k] * W4[k * kW4Ld + j];
        Oraw[e] = acc + sB[3 * kStage + j];
      }
      __syncthreads();
      // dT = upstream + chain-conditioning gradient; the forward's staging
      // write overwrote those columns, so their gradient stops here
      for (int e = tid; e < kBT * kOutW; e += kThreads) {
        const int r = e / kOutW, j = e % kOutW;
        float dO = 0.f;
        if (j < od) {
          float dT = m0 + r < (size_t)Mpad ? __ldcs(dout + (m0 + r) * kOutW + oc + j) : 0.f;
          if (sc + od <= kStage) {
            dT += DX[r * kAld + sc + j];
            DX[r * kAld + sc + j] = 0.f;
          }
          if (kind == 1) {
            dO = -__fdividef(dT, 1.f + expf(-(Oraw[e] + 5.f)));
          } else if (kind == 2) {
            dO = dT * 0.01f;
            if (j < 3) DX[r * kAld + kInitCol + j] += dT;
          } else {
            dO = dT;
          }
        }
        GO[e] = dO;
      }
      __syncthreads();
      // layer 4: dW4 += a3^T dO, db4; da3 = dO W4^T, dz3 = da3 gelu'(z3)
      for (int i = 0; i < kStage * kOutW / kThreads; ++i) {
        const int e = tid + kThreads * i, k = e / kOutW, j = e % kOutW;
        float acc = 0.f;
        for (int p = 0; p < kBT; ++p) acc += Sa[p * kAld + k] * GO[p * kOutW + j];
        ph[kOffW4 + e] += acc;
      }
      if (tid < kOutW) {
        float s = 0.f;
        for (int p = 0; p < kBT; ++p) s += GO[p * kOutW + tid];
        ph[kOffB4 + tid] += s;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g + 8 * (e >> 1), c = own_col(j, warp) + 2 * q + (e & 1);
          float acc = 0.f;
#pragma unroll
          for (int o = 0; o < kOutW; ++o) acc += GO[r * kOutW + o] * W4[c * kW4Ld + o];
          d[j][e] = acc;
        }
      times(d, z3);
      store_owner(Sg, d);                                   // Sg = dz3
      __syncthreads();
      store_gelu_keep_grad(Sa, z2);                         // Sa = a2, z2 = gelu'(z2)
      __syncthreads();
      // layer 3: dW3 += a2^T dz3; da2 = dz3 W3^T from the resident halves
      wgrad(Sa, Sg, ph + kOffW3, ph + kOffB3);
      zero_frag(d);
      mm_bwd_half(d, Sg, ring, 0);
      next_half(ring, w2, 0);
      mm_bwd_half(d, Sg, slot1, 1);
      times(d, z2);
      __syncthreads();
      store_owner(Sg, d);                                   // Sg = dz2
      store_gelu_keep_grad(Sa, z1);                         // Sa = a1, z1 = gelu'(z1)
      next_half(ring, w2, 1);
      // layer 2: dW2 += a1^T dz2; da1 = dz2 W2^T
      wgrad(Sa, Sg, ph + kOffW2, ph + kOffB2);
      zero_frag(d);
      mm_bwd_half(d, Sg, ring, 0);
      next_half(ring, w1, 0);
      mm_bwd_half(d, Sg, slot1, 1);
      times(d, z1);
      __syncthreads();
      store_owner(Sg, d);                                   // Sg = dz1
      next_half(ring, w1, 1);
      // layer 1: dW1 += X^T dz1; DX += dz1 W1^T
      wgrad(X, Sg, ph, ph + kOffB1);
      zero_frag(d);
      mm_bwd_half(d, Sg, ring, 0);
      // the next tile's first weight half: this head's W1, or the next head's
      next_half(ring, !last ? w1 : (h > 0 ? cw.w1 + (h - 1) * HW : nullptr), 0);
      mm_bwd_half(d, Sg, slot1, 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = own_col(j, warp) + 2 * q;
        float2* x0 = reinterpret_cast<float2*>(DX + (r0 + g) * kAld + c);
        float2* x1 = reinterpret_cast<float2*>(DX + (r0 + g + 8) * kAld + c);
        float2 v0 = *x0, v1 = *x1;
        v0.x += d[j][0];
        v0.y += d[j][1];
        v1.x += d[j][2];
        v1.y += d[j][3];
        *x0 = v0;
        *x1 = v1;
      }
      __syncthreads();
      for (int i = tid; i < kBT * kStage; i += kThreads) {
        const int r = i / kStage, c = i % kStage;
        if (m0 + r < (size_t)Mpad) __stcs(dstage + m0 * kStage + i, DX[r * kAld + c]);
      }
      __syncthreads();
    }
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

// wsplit: n_heads x 3 x 128 x 128 x 2 f32 scratch for the weights split
// into TF32 (hi, lo) pairs; gelu: the chain's GELU id (meta[26])
extern "C" int ggd_heads_fwd(const void* staging, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* w3, const void* b3,
                             const void* w4, const void* b4, const void* meta, void* out,
                             void* wsplit, int Mpad, int n_heads, int gelu, float scale_offset,
                             void* stream) {
  if (Mpad <= 0 || n_heads < 1 || n_heads > kMaxHeads || gelu < 0 || gelu > 4)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {staging, w1, b1, w2, b2, w3, b3, w4, b4, (const void*)out,
                        (const void*)wsplit})
    if (!ggd::aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const Chain cw = ggd::chain_f32_ptrs(w1, b1, w2, b2, w3, b3, w4, b4);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = ggd::split_weights(cw, wsplit, n_heads, s);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = ggd::kF32SmemBytes;
  const dim3 grid((Mpad + ggd::kF32Pts - 1) / ggd::kF32Pts);
  auto launch = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, s>>>((const float*)staging, cw, (const float*)wsplit,
                                        (const int*)meta, (float*)out, Mpad, scale_offset);
    return cudaGetLastError();
  };
  switch (gelu) {
    case 0: return (int)launch(heads_fwd_kernel<0>);
    case 1: return (int)launch(heads_fwd_kernel<1>);
    case 2: return (int)launch(heads_fwd_kernel<2>);
    case 3: return (int)launch(heads_fwd_kernel<3>);
    default: return (int)launch(heads_fwd_kernel<4>);
  }
}

// partials: n_part x (5 x 51600) zeros; grads: 5 x 51600, per head
// w1 (128x128, in x out) b1 w2 b2 w3 b3 w4 (128x16) b4
extern "C" int ggd_heads_bwd(const void* staging, const void* out16, const void* dout,
                             const void* w1, const void* b1, const void* w2, const void* b2,
                             const void* w3, const void* b3, const void* w4, const void* b4,
                             const void* meta, void* dstage, void* partials, void* grads,
                             int Mpad, int n_part, float scale_offset, void* stream) {
  if (Mpad <= 0 || n_part < 1 || n_part > (Mpad + kBT - 1) / kBT)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {w1, w2, w3})
    if (!ggd::aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = (4 * (size_t)kBT * kAld + 2 * kHalf * kWld + kStage * kW4Ld +
                       2 * kBT * kOutW + 3 * kStage + kOutW) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(heads_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Chain cw = ggd::chain_f32_ptrs(w1, b1, w2, b2, w3, b3, w4, b4);
  heads_bwd_kernel<<<n_part, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)staging, (const float*)out16, (const float*)dout, cw, (const int*)meta,
      (float*)dstage, (float*)partials, Mpad, scale_offset);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int width = 5 * kHeadGrad;
  heads_grad_reduce<<<(width + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)partials, (float*)grads, n_part, width);
  return (int)cudaGetLastError();
}
