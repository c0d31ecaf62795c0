// Shared by flash_attention.cu (forward) and flash_attention_bwd.cu (dkv, dq):
// the tile sizes of the bf16 kernels and their mma.sync / ldmatrix fragment
// helpers. Tiles are 64 rows of 64 bf16 values in shared-memory rows padded to
// 72 values (144 bytes), which makes every fragment load conflict-free.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;                       // head dim
constexpr float MASK_VALUE = -2.3819763e38f;  // -0.7 * f32 max, the library's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, h, s;  // in elements
};

constexpr int BM = 64;   // query rows per CTA
constexpr int BN = 64;   // keys per tile
constexpr int LDS = 72;  // padded shared-memory row, in bf16 values
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_bf16_16x8x16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed: lane l gives the address of stored row
// l%8 of matrix l/8; thread (g, t) receives {M[2t][g], M[2t+1][g]} of each.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [rows0, rows0 + 64) of one head into a padded shared tile, 16 bytes a thread
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride) {
  for (int c = threadIdx.x; c < BN * (DH / 8); c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDS + col) =
        __ldg(reinterpret_cast<const uint4*>(src + (long long)r * row_stride + col));
  }
}

}  // namespace
