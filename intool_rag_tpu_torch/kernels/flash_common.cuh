// Shared by flash_attention.cu (forward) and flash_attention_bwd.cu (dkv, dq):
// the head width, the library's mask value, the row strides and bf16 packing.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;                       // head dim
constexpr float MASK_VALUE = -2.3819763e38f;  // -0.7 * f32 max, the library's mask value
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // in elements
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
