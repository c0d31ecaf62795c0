// Probed scan over planar 1-bit residual codes (the dense stage of /search
// with INDEX_KIND=bits).
//
// Replaces the Pallas TPU kernel _bits_scan_kernel of
// intool_rag_tpu/ops/bits_pallas.py (wrapper ivf_bits_topk_pallas).
//
// Contract (identical to the TPU kernel). A work item is (query tile qt of 8
// queries, probe p, block bi of the probed list); it reads store block
// blk = pb[qt, p] + bi: block_n slots of W = D/8 code bytes each, and the
// block's [8, block_n] plane scales. Byte j of a slot holds bit-plane b at dim
// b*W + j; +-1 = 2*bit - 1. For every (query, slot):
//   score = c_sel[q, p] + sum_b (q[b*W:(b+1)*W] . pm1_b) * scale[b, slot]
// with the planes added in order b = 0..7 in f32 (each product rounded, then
// the sum rounded: no fused multiply-add), and -inf where scale[0, slot] < 0
// (an empty slot). With lw = block_n/group_l, slot g*lw + lane, the candidates
//   vals[q, (p*bpl + bi)*lw + lane] = max_g score[q, g*lw + lane]
//   idx [q, (p*bpl + bi)*lw + lane] = blk*block_n + g* * lw + lane
// keep the smallest maximizing g (an all -inf group gives g* = 0).
//
// Design for an H100. The scan is bound by bytes: a slot is D/8 bytes of
// codes and 32 bytes of scales against 2*8*D bf16 operations for its query
// tile (102 operations per byte at D = 1024), below the card's 295
// operations per byte. So the codes stay packed all the way into registers: a
// thread reads its slots' code words straight from global memory and feeds
// mma.sync.m16n8k16 with 16 slots on M, the 8 queries on N and 16 dims of one
// plane on K. The +-1 operand never touches shared or device memory, and it
// costs one shift and one logic operation per register: a dot product does not
// care about the order of its terms, so the K index of an MMA step is mapped
// onto the code bytes such that the two bf16 halves of an operand register
// come from bytes 0 and 2 (or 1 and 3) of one aligned 32-bit code word. Their
// plane-b bits lie 16 apart, exactly like the two sign bits of the register,
// so "shift, mask to the sign bits, or onto 0x3F803F80 (+1.0, +1.0)" builds
// both values at once (the words are inverted once, so a clear bit gives -1).
// Thread (g, t) owns bytes [t*W/4, (t+1)*W/4) of slot rows g and g+8, and the
// query tile is staged in shared memory in exactly that fragment order (dims
// 0, 2 | 1, 3 of each group of four), one 8-byte load per MMA step. A plane's
// partial product is multiplied by the f32 plane scale after its MMA steps,
// so the scale is never rounded to bf16. Scores go to shared memory once, for
// the grouped max.
//
// Measured on an H100 at Q 256, nprobe 16, 13 blocks of 1,024 slots, D 1024:
// 1.43 ms with a five-operation sign construction and 256-thread CTAs, 0.85 ms
// as it stands. Still open: no cp.async/TMA pipelining, the query tile is
// re-staged per work item, and tiles that probe the same list re-read it.
//
// Built by kernels/build.py with nvcc for sm_90a into a shared library with a
// plain C interface (loaded through ctypes). The entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps, each walks 32-slot strips of the block; small CTAs so
                              // that several, out of step with each other, share an SM
constexpr int WARPS = THREADS / 32;
constexpr int QT = 8;         // queries per tile
constexpr int PLANES = 8;
constexpr int S_PAD = 4;      // score row padding (floats): conflict-free fragment stores

// Two bf16 +-1 values from plane b of two bytes of an INVERTED code word (a
// set bit gives -1; 0x3F80 is +1.0, bit 15 the sign): bytes 0 and 2 ...
__device__ __forceinline__ uint32_t pm1_even(uint32_t inv, int b) {
  return 0x3F803F80u | ((inv << (15 - b)) & 0x80008000u);
}
// ... and bytes 1 and 3.
__device__ __forceinline__ uint32_t pm1_odd(uint32_t inv, int b) {
  return 0x3F803F80u | ((inv << (7 - b)) & 0x80008000u);
}

__device__ __forceinline__ void mma_bf16_16x8x16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The NCH consecutive 32-bit code words a thread owns of one slot row.
template <int NCH>
__device__ __forceinline__ void load_words(uint32_t (&dst)[NCH], const uint8_t* __restrict__ src) {
  if constexpr (NCH % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NCH / 4; ++i) {
      uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
      dst[4 * i] = v.x;
      dst[4 * i + 1] = v.y;
      dst[4 * i + 2] = v.z;
      dst[4 * i + 3] = v.w;
    }
  } else if constexpr (NCH % 2 == 0) {
#pragma unroll
    for (int i = 0; i < NCH / 2; ++i) {
      uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + i);
      dst[2 * i] = v.x;
      dst[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NCH; ++i) dst[i] = __ldg(reinterpret_cast<const uint32_t*>(src) + i);
  }
}

// NCH = W/16: MMA k-steps per plane. D = 128*NCH.
template <int NCH>
__global__ void __launch_bounds__(THREADS)
bits_scan_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ codes,
                 const float* __restrict__ scales, const int* __restrict__ pb,
                 const float* __restrict__ csel, int n_blocks, int block_n, int nprobe, int bpl,
                 int group_l, float* __restrict__ vals, int* __restrict__ idx) {
  constexpr int W = 16 * NCH;
  constexpr int D = PLANES * W;
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* q_s = reinterpret_cast<uint2*>(smem);                        // [8 planes][NCH][8 queries][4]
  float* s_tile = reinterpret_cast<float*>(smem + QT * D * 2);        // [8 queries][block_n + S_PAD]
  const int s_ld = block_n + S_PAD;

  const int item = blockIdx.x;
  const int bi = item % bpl;
  const int p = (item / bpl) % nprobe;
  const int qt = item / (bpl * nprobe);
  const int blk = pb[qt * nprobe + p] + bi;
  const bool in_store = blk >= 0 && blk < n_blocks;  // a block outside the store scores -inf

  // Stage the query tile in fragment order: 4 consecutive dims (8 bytes) are
  // one unit; unit (plane b, k-step c, query n, thread-in-group t) holds dims
  // b*W + t*4*NCH + 4*c + {0, 2, 1, 3} of query n, the order in which the code
  // bytes fill the MMA's K index.
  const uint2* qg = reinterpret_cast<const uint2*>(q + (size_t)qt * QT * D);
  for (int v = threadIdx.x; v < QT * D / 4; v += THREADS) {
    const int n = v / (D / 4);
    const int dim = (v % (D / 4)) * 4;
    const int b = dim / W, j = dim % W;
    const int t = j / (4 * NCH), c = (j % (4 * NCH)) / 4;
    const uint2 u = qg[v];
    q_s[((b * NCH + c) * QT + n) * 4 + t] =
        make_uint2(__byte_perm(u.x, u.y, 0x5410), __byte_perm(u.x, u.y, 0x7632));
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float cs0 = csel[(size_t)(qt * QT + 2 * t) * nprobe + p];
  const float cs1 = csel[(size_t)(qt * QT + 2 * t + 1) * nprobe + p];
  const uint8_t* cblk = codes + (size_t)(in_store ? blk : 0) * block_n * W;
  const float* sblk = scales + (size_t)(in_store ? blk : 0) * PLANES * block_n;

  for (int strip = warp; strip < block_n / 32; strip += WARPS) {
    const int slot0 = strip * 32;
    // rows of this thread: slot0 + 16*mt + 8*h + g, mt, h in {0, 1}
    uint32_t cw[2][2][NCH];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        load_words<NCH>(cw[mt][h], cblk + (size_t)(slot0 + 16 * mt + 8 * h + g) * W + t * 4 * NCH);
#pragma unroll
        for (int c = 0; c < NCH; ++c) cw[mt][h][c] = ~cw[mt][h][c];
      }
    float score[2][4];
    bool ok[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      score[mt][0] = cs0;
      score[mt][1] = cs1;
      score[mt][2] = cs0;
      score[mt][3] = cs1;
    }
#pragma unroll
    for (int b = 0; b < PLANES; ++b) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const uint2 bq = q_s[((b * NCH + c) * QT + g) * 4 + t];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16x8x16(acc[mt], pm1_even(cw[mt][0][c], b), pm1_even(cw[mt][1][c], b),
                           pm1_odd(cw[mt][0][c], b), pm1_odd(cw[mt][1][c], b), bq.x, bq.y);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sc = in_store ? __ldg(sblk + (size_t)b * block_n + slot0 + 16 * mt + 8 * h + g)
                                    : -1.0f;
          if (b == 0) ok[mt][h] = sc >= 0.0f;
          score[mt][2 * h] = __fadd_rn(score[mt][2 * h], __fmul_rn(acc[mt][2 * h], sc));
          score[mt][2 * h + 1] = __fadd_rn(score[mt][2 * h + 1], __fmul_rn(acc[mt][2 * h + 1], sc));
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s_tile[(2 * t + e) * s_ld + slot0 + 16 * mt + 8 * h + g] =
              ok[mt][h] ? score[mt][2 * h + e] : -CUDART_INF_F;
  }
  __syncthreads();

  // Grouped max over g for every (query, lane); strict '>' keeps the first
  // maximizing g, and an all -inf group keeps g = 0.
  const int lw = block_n / group_l;
  const long long n_cand = (long long)nprobe * bpl * lw;
  const long long col0 = (long long)(p * bpl + bi) * lw;
  for (int o = threadIdx.x; o < QT * lw; o += THREADS) {
    const int qi = o / lw, ln = o % lw;
    float best = -CUDART_INF_F;
    int best_g = 0;
    for (int gg = 0; gg < group_l; ++gg) {
      const float s = s_tile[qi * s_ld + gg * lw + ln];
      if (s > best) {
        best = s;
        best_g = gg;
      }
    }
    const long long out = (long long)(qt * QT + qi) * n_cand + col0 + ln;
    vals[out] = best;
    idx[out] = blk * block_n + best_g * lw + ln;
  }
}

template <int NCH>
cudaError_t launch(const void* q, const void* codes, const void* scales, const void* pb,
                   const void* csel, int Q, int n_blocks, int block_n, int nprobe, int bpl,
                   int group_l, void* vals, void* idx, cudaStream_t stream) {
  const size_t smem = (size_t)QT * (128 * NCH) * 2 + (size_t)QT * (block_n + S_PAD) * 4;
  cudaError_t err = cudaFuncSetAttribute(bits_scan_kernel<NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)(Q / QT) * nprobe * bpl;
  bits_scan_kernel<NCH><<<(unsigned)items, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)codes, (const float*)scales, (const int*)pb,
      (const float*)csel, n_blocks, block_n, nprobe, bpl, group_l, (float*)vals, (int*)idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [Q, D] bf16; codes [n_blocks*block_n, D/8] u8; scales [n_blocks, 8, block_n]
// f32; pb [Q/8, nprobe] i32; csel [Q, nprobe] f32; vals/idx
// [Q, nprobe*bpl*block_n/group_l].
int bits_scan(const void* q, const void* codes, const void* scales, const void* pb, const void* csel,
              int Q, int D, int n_blocks, int block_n, int nprobe, int bpl, int group_l, void* vals,
              void* idx, void* stream) {
  if (Q <= 0 || Q % QT != 0 || D <= 0 || D % 128 != 0 || n_blocks <= 0 || block_n <= 0 ||
      block_n % 32 != 0 || nprobe <= 0 || bpl <= 0 || group_l <= 0 || block_n % group_l != 0 ||
      (long long)(Q / QT) * nprobe * bpl > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define BITS_SCAN_CASE(NCH)                                                                      \
  case NCH:                                                                                      \
    return (int)launch<NCH>(q, codes, scales, pb, csel, Q, n_blocks, block_n, nprobe, bpl, group_l, \
                            vals, idx, s);
  switch (D / 128) {
    BITS_SCAN_CASE(1)
    BITS_SCAN_CASE(2)
    BITS_SCAN_CASE(3)
    BITS_SCAN_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BITS_SCAN_CASE
}

}  // extern "C"
