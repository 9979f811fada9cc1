// K6's bf16 form: the 5-head decoder chain alone over a bf16 staging,
// (Mpad, 16) transformed head outputs out, no projection.
//
// Replaces the TPU kernel gaussian_gan_decoder_tpu/decoder/pallas_heads.py
// ::decode_heads_pallas (_heads_kernel) at compute_dtype bf16: inference
// GaussianDecoder.decode_from_planes with pallas_heads and heads_bf16, and
// decode_packed / apply_packed with heads_bf16. The f32 form of the same
// TPU kernel is heads_train.cu::heads_fwd_kernel (3xTF32).
//
// The body is the decode tails' chain (chain.cuh::chain_bf16): bf16
// mma.sync with f32 accumulators on 128-point blocks of 8 warps, each
// warp's 16 points carried in registers from layer to layer, the bf16
// weights streamed through a two-slot shared-memory ring by cp.async.
// Numerics are the TPU kernel's at bf16: bf16 staging and weights, every
// hidden activation rounded to bf16, f32 accumulation, the outputs fed to
// later heads rounded to bf16 (where stage_col + out_dim <= 128), `init`
// read from the bf16 staging. Output columns past the chain's 14 are zero.
//
// Bound on the H100: the chain's operations (5.12e5 FLOPs a point padded)
// at the bf16 tensor-core rate; it moves 256 + 64 bytes a point.
#include "chain.cuh"

namespace {

using ggd::kDecPts;
using ggd::kDecThreads;
using ggd::kOutW;

__global__ void __launch_bounds__(kDecThreads) heads_bf16_kernel(
    const __nv_bfloat16* __restrict__ staging, const ggd::DecodeChain cw,
    float* __restrict__ out, int Mpad, float scale_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ggd::DecodeSmem s = ggd::decode_smem(smem);
  __shared__ int sMeta[32];
  const int m0 = blockIdx.x * kDecPts;
  const int n_rows = min(kDecPts, Mpad - m0);
  ggd::decode_prologue(s, sMeta, cw, staging, m0, n_rows);
  ggd::chain_bf16(s, sMeta, cw, scale_offset);
  for (int i = threadIdx.x; i < n_rows * kOutW / 4; i += kDecThreads)
    reinterpret_cast<float4*>(out + (size_t)m0 * kOutW)[i] =
        reinterpret_cast<const float4*>(s.O16)[i];
}

}  // namespace

// staging (Mpad, 128) bf16; w1..w3 (H, 128, 128), w4 (H, 128, 16) bf16; b1..b4
// f32; out (Mpad, 16) f32
extern "C" int ggd_heads_fwd_bf16(const void* staging, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* w3,
                                  const void* b3, const void* w4, const void* b4,
                                  const void* meta, void* out, int Mpad, float scale_offset,
                                  void* stream) {
  if (Mpad <= 0) return (int)cudaErrorInvalidValue;
  for (const void* p : {staging, w1, w2, w3, w4, (const void*)out})
    if (!ggd::aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = ggd::kDecodeSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(heads_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const ggd::DecodeChain cw =
      ggd::decode_chain(w1, b1, w2, b2, w3, b3, w4, b4, nullptr, meta);
  heads_bf16_kernel<<<(Mpad + kDecPts - 1) / kDecPts, kDecThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)staging, cw, (float*)out, Mpad, scale_offset);
  return (int)cudaGetLastError();
}
