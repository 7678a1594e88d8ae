// Device helpers shared by the encoder kernels (encoder_kernels.cu,
// encoder_int8_kernels.cu).
#pragma once

#include <math.h>

namespace mm {

// FMA-only erf polynomial of matchmaker_tpu/ops/fused_attention.py
// (_ERF_FASTPOLY, _erf_fastpoly, _gelu_poly): the gelu of the bf16 MLP half
// (K2) and of the int8 MLP half (K9).
__device__ __forceinline__ float gelu_poly(float h) {
  const float u = h * 0.7071067811865476f;
  const float uc = fminf(fmaxf(u, -3.4f), 3.4f);
  const float v = uc * uc;
  float p = 1.2036946e-08f;
  p = p * v + -7.4665718e-07f;
  p = p * v + 2.0221069e-05f;
  p = p * v + -0.00031579041f;
  p = p * v + 0.0031725222f;
  p = p * v + -0.021726243f;
  p = p * v + 0.10513879f;
  p = p * v + -0.37025923f;
  p = p * v + 1.1268175f;
  return 0.5f * h * (1.0f + p * uc);
}

}  // namespace mm
