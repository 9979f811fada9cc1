// K10: tri-grid -> 2x2x2-corner brick table, a pure data-movement kernel.
//
// Replaces the TPU kernel gaussian_gan_decoder_tpu/neuralfield/
// pallas_expand.py::build_brick_table (_expand_kernel). Input: the zero-padded
// channels-last volume (B, D+2, H+2, W+2, C) that the wrapper builds in plain
// PyTorch (neuralfield/pallas_expand.py), of any element size. Output: the
// table (B, (D+1) * NY * (W+1), 8C); row (z0 * NY + y0) * (W+1) + x0 holds the
// 8 corners' channels in (dz, dy, dx) order, rows with y0 > H are zero.
//
// The kernel copies bytes: each output row is 8 copies of C * itemsize
// contiguous source bytes, so one thread moves one 16-byte chunk of output
// with one 16-byte load and one 16-byte store (C * itemsize must be a
// multiple of 16). Neighbouring threads write neighbouring chunks.
//
// Bound on the H100: bytes — the table written once plus the volume read
// once (at flagship 214.7 MB + 18.9 MB int8, ~0.07 ms at 3.35 TB/s). Each
// source chunk is read by up to 8 output rows; the 18.9 MB volume stays in
// the 50 MB L2, so device memory sees it about once.
//
// The select form (brick_table_kernel<true>) replaces the TPU kernel's
// second body, _expand_kernel_select: its source rows are channel-
// DUPLICATED to 128 elements (gpt = 128 / C copies of the C channels, the
// wrapper's torch tile), and corner group g reads its channels at element
// (g mod gpt) * C of the row, the lanes the TPU kernel writes them to. The
// table is the rotate form's, byte for byte; the source it reads is gpt
// times larger (127.8 MB int8 at flagship, padded; the rotate form's 31.9 MB
// fits the 50 MB L2, this one does not).
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 256;

// kSelect: the source rows hold gpt copies of their cc chunks (row stride
// gpt * cc chunks), group g reading copy g % gpt
template <bool kSelect>
__global__ void __launch_bounds__(kThreads) brick_table_kernel(
    const uint4* __restrict__ src, uint4* __restrict__ dst, unsigned n_chunks, int D, int H,
    int W, int NY, int cc, int gpt) {
  const unsigned q = blockIdx.x * (unsigned)kThreads + threadIdx.x;
  if (q >= n_chunks) return;
  const unsigned row_chunks = 8u * cc;
  const unsigned r = q / row_chunks;
  const unsigned j = q - r * row_chunks;
  const unsigned g = j / cc, k = j - g * cc;
  const unsigned x0 = r % (W + 1);
  unsigned t = r / (W + 1);
  const unsigned y0 = t % NY;
  t /= NY;
  const unsigned z0 = t % (D + 1);
  const unsigned b = t / (D + 1);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (y0 <= (unsigned)H) {
    const unsigned dz = g >> 2, dy = (g >> 1) & 1u, dx = g & 1u;
    const size_t voxel = (((size_t)b * (D + 2) + z0 + dz) * (H + 2) + y0 + dy) * (W + 2) + x0 + dx;
    const size_t s = kSelect ? (voxel * gpt + g % (unsigned)gpt) * cc + k : voxel * cc + k;
    v = src[s];
  }
  dst[q] = v;
}

}  // namespace

template <bool kSelect>
static int launch(const void* src, void* dst, int B, int D, int H, int W, int NY, int cc,
                  int gpt, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || NY <= H || cc <= 0 || gpt <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * (D + 1) * NY * (W + 1) * 8 * cc;
  if (n > (long long)INT_MAX) return (int)cudaErrorInvalidValue;
  const unsigned n_chunks = (unsigned)n;
  const unsigned blocks = (n_chunks + kThreads - 1) / kThreads;
  brick_table_kernel<kSelect><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, (uint4*)dst, n_chunks, D, H, W, NY, cc, gpt);
  return (int)cudaGetLastError();
}

// src (B, D+2, H+2, W+2, C) padded channels-last, dst (B, (D+1)*NY*(W+1), 8C);
// cc = C * itemsize / 16
extern "C" int ggd_brick_table(const void* src, void* dst, int B, int D, int H, int W, int NY,
                               int cc, void* stream) {
  return launch<false>(src, dst, B, D, H, W, NY, cc, 1, stream);
}

// the select form: src (B, D+2, H+2, W+2, gpt * C), each row gpt copies of
// the C channels (gpt = 128 / C, 8 a multiple of gpt), the same dst
extern "C" int ggd_brick_table_select(const void* src, void* dst, int B, int D, int H, int W,
                                      int NY, int cc, int gpt, void* stream) {
  if (gpt < 1 || 8 % gpt) return (int)cudaErrorInvalidValue;
  return launch<true>(src, dst, B, D, H, W, NY, cc, gpt, stream);
}
