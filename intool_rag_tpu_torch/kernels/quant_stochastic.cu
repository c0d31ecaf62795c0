// Per-row absmax int8 quantization with stochastic rounding.
//
// Replaces the Pallas TPU kernel _quant_kernel of intool_rag_tpu/ops/quant.py
// (wrapper quantize_int8_stochastic). For a row x of [n, d] f32:
//   scale  = max(max|x|, 1e-9) / 127
//   scaled = clip(x / scale, -127, 127)
//   q      = clip(floor(scaled + u), -127, 127),  u = bits24 * 2^-24 in [0, 1)
// so E[q] = scaled: unbiased under repeated requantization. Divisions are
// IEEE (no fast-math), so scale and scaled equal the plain PyTorch version bit
// for bit; only the random stream differs.
//
// The TPU kernel used the core's own PRNG. Here u comes from Philox4x32-10, a
// counter-based generator written out below: counter (column/4, row, 0, 0),
// key (seed low, seed high); its four 32-bit words serve columns 4c..4c+3,
// each giving its top 24 bits. The same (seed, row, column) always draws the
// same u, whatever the launch shape.
//
// Bound on an H100: bytes (4 B read + 1 B written per element; about 70
// integer operations per 4 elements for Philox). One CTA per row: a block
// reduction for the absmax, then the row is read again (from L1/L2) to
// quantize.
//
// Built by kernels/build.py with nvcc for sm_90a into a shared library with a
// plain C interface (loaded through ctypes). The entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += W0;
    key.y += W1;
  }
  return ctr;
}

__device__ __forceinline__ signed char round_one(float x, float scale, uint32_t bits) {
  const float scaled = fminf(fmaxf(x / scale, -127.0f), 127.0f);
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
  const float r = fminf(fmaxf(floorf(scaled + u), -127.0f), 127.0f);
  return (signed char)(int)r;
}

__global__ void __launch_bounds__(THREADS)
quant_stochastic_kernel(const float* __restrict__ x, int d, uint2 key, signed char* __restrict__ q,
                        float* __restrict__ scale_out) {
  __shared__ float warp_max[THREADS / 32];
  __shared__ float row_scale;
  const int row = blockIdx.x;
  const float* xr = x + (size_t)row * d;
  signed char* qr = q + (size_t)row * d;

  const bool vec = d % 4 == 0;  // rows are then 16-byte aligned: float4 in, 4 packed bytes out
  float m = 0.0f;
  if (vec) {
    for (int c4 = threadIdx.x; c4 * 4 < d; c4 += THREADS) {
      const float4 v = reinterpret_cast<const float4*>(xr)[c4];
      m = fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
    }
  } else {
    for (int c = threadIdx.x; c < d; c += THREADS) m = fmaxf(m, fabsf(xr[c]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = warp_max[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) a = fmaxf(a, warp_max[w]);
    row_scale = fmaxf(a, 1e-9f) / 127.0f;
    scale_out[row] = row_scale;
  }
  __syncthreads();
  const float scale = row_scale;

  // one Philox call per group of 4 columns
  for (int c4 = threadIdx.x; c4 * 4 < d; c4 += THREADS) {
    const uint4 r = philox4x32_10(make_uint4((uint32_t)c4, (uint32_t)row, 0u, 0u), key);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
    const int c0 = c4 * 4;
    if (vec) {
      const float4 v = reinterpret_cast<const float4*>(xr)[c4];
      const uint32_t b0 = (uint8_t)round_one(v.x, scale, bits[0]);
      const uint32_t b1 = (uint8_t)round_one(v.y, scale, bits[1]);
      const uint32_t b2 = (uint8_t)round_one(v.z, scale, bits[2]);
      const uint32_t b3 = (uint8_t)round_one(v.w, scale, bits[3]);
      reinterpret_cast<uint32_t*>(qr)[c4] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + e < d) qr[c0 + e] = round_one(xr[c0 + e], scale, bits[e]);
    }
  }
}

}  // namespace

extern "C" {

// x [n, d] f32 -> q [n, d] int8, scale [n] f32.
int quant_stochastic(const void* x, int n, int d, unsigned long long seed, void* q, void* scale,
                     void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const uint2 key = make_uint2((uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32));
  quant_stochastic_kernel<<<(unsigned)n, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, d, key, (signed char*)q, (float*)scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
