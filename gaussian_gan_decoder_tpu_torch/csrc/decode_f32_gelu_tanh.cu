// The f32 decode kernels with the tanh GELU (GELU id 1; decode_f32.cuh,
// one file a kind, so that nvcc compiles the kinds in parallel)
#include "decode_f32.cuh"

template struct ggd::DecodeF32<1>;
