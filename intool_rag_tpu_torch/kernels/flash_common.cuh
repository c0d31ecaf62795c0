// Shared by flash_attention.cu (forward) and flash_attention_bwd.cu (dkv, dq):
// the head width, the library's mask value, the row strides and bf16 packing,
// the pieces of the bf16 tensor-core kernels (their geometry, the plan of the
// tiles a CTA computes: the tile skip, the TMA ring's bookkeeping, the tile
// counts, the accumulator helpers and the host side of their tensor maps), and
// those of the f32 (3xTF32) kernels: the split pre-pass, their tile plan, the
// tf32 fragments and products, and their tensor maps.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "tensor_map.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------- bf16 tensor-core kernels

constexpr int BT = 64;                           // rows of a streamed backward tile (queries for dkv, keys for dq)
constexpr int CT = 128;                          // rows a CTA owns: two consumer warpgroups of 64
constexpr int MAX_SEQ = 8192;
constexpr int MAX_TILES = MAX_SEQ / BT;          // streamed tiles of one row, at most 128
constexpr int CONSUMERS = 256;                   // two warpgroups
constexpr int TC_THREADS = CONSUMERS + 128;      // and a producer warpgroup, of which one warp feeds the ring
constexpr int PRODUCER_REGS = 56;   // dkv's producer warp holds a tile's row statistics
constexpr int CONSUMER_REGS = 224;  // 2 x 128 x 224 + 128 x 56 = 64,512 of the SM's 65,536
constexpr int STAGES = 6;
constexpr int TILE_BYTES = BT * DH * 2;          // 8 KB: a streamed bf16 tile
constexpr int OWN_BYTES = CT * DH * 2;           // 16 KB: one of the CTA's own tiles
constexpr int STATS_BYTES = BT * 4;              // one 64-row vector of f32 or i32 (dkv: five a stage, dq: one)
constexpr int STAGE_BYTES = 2 * TILE_BYTES + 2048;  // two tiles and up to five vectors, 1,024-aligned

// Where the bf16 kernels report what the tile skip did (the library's
// count_tiles entry): per CTA, the streamed tiles that each consumer
// warpgroup computed and that the producer loaded. Off (nullptr) unless
// asked for; a measurement, not part of the contract.
int* tile_counts = nullptr;
long long tile_counts_len = 0;

// Which streamed tiles a CTA computes.
struct TilePlan {
  int lo[MAX_TILES], hi[MAX_TILES];  // id range of each streamed tile
  int own_lo[4], own_hi[4], own_nomatch[4];  // of the own rows, per warp of 32
  uint8_t nomatch[MAX_TILES];        // a streamed query tile holds a row no key matches
  uint8_t live[MAX_TILES];          // 0 skipped, 1 computed, 2 computed and every pair of it has equal ids
};

// live[t] = 0 where the id ranges of streamed tile t (ST rows) and of the
// CTA's own 128 rows are disjoint and neither holds a query row with
// m == MASK_VALUE. stream_m (own_m) is the row max of the streamed (own) rows
// where they are queries and it is known, else nullptr. Threads
// 0..n_tiles-1 reduce one streamed tile each, the warps of threads 128..255
// the own rows. Ends in __syncthreads.
template <int ST = BT>
__device__ __forceinline__ void plan_tiles(TilePlan& pl, const int* stream_ids, const float* stream_m,
                                           const int* own_ids, const float* own_m, int n_tiles) {
  const int tid = threadIdx.x;
  if (tid < n_tiles) {
    const int4* ids = reinterpret_cast<const int4*>(stream_ids + tid * ST);
    int lo = 0x7fffffff, hi = -0x7fffffff - 1;
#pragma unroll
    for (int j = 0; j < ST / 4; ++j) {
      const int4 x = __ldg(ids + j);
      lo = min(lo, min(min(x.x, x.y), min(x.z, x.w)));
      hi = max(hi, max(max(x.x, x.y), max(x.z, x.w)));
    }
    bool nm = false;
    if (stream_m != nullptr) {
      const float4* mm = reinterpret_cast<const float4*>(stream_m + tid * ST);
#pragma unroll
      for (int j = 0; j < ST / 4; ++j) {
        const float4 x = __ldg(mm + j);
        nm |= x.x == MASK_VALUE || x.y == MASK_VALUE || x.z == MASK_VALUE || x.w == MASK_VALUE;
      }
    }
    pl.lo[tid] = lo;
    pl.hi[tid] = hi;
    pl.nomatch[tid] = nm;
  } else if (tid >= 128 && tid < 128 + CT) {
    const int r = tid - 128;
    const int id = __ldg(own_ids + r);
    const bool nm = own_m != nullptr && __ldg(own_m + r) == MASK_VALUE;
    const int lo = __reduce_min_sync(0xffffffffu, id), hi = __reduce_max_sync(0xffffffffu, id);
    const bool any_nm = __any_sync(0xffffffffu, nm);
    if ((tid & 31) == 0) {
      pl.own_lo[r / 32] = lo;
      pl.own_hi[r / 32] = hi;
      pl.own_nomatch[r / 32] = any_nm;
    }
  }
  __syncthreads();
  if (tid < n_tiles) {
    const int lo = min(min(pl.own_lo[0], pl.own_lo[1]), min(pl.own_lo[2], pl.own_lo[3]));
    const int hi = max(max(pl.own_hi[0], pl.own_hi[1]), max(pl.own_hi[2], pl.own_hi[3]));
    const bool nm = pl.own_nomatch[0] | pl.own_nomatch[1] | pl.own_nomatch[2] | pl.own_nomatch[3] | pl.nomatch[tid];
    const bool uniform = !nm && lo == hi && pl.lo[tid] == lo && pl.hi[tid] == hi;
    pl.live[tid] = uniform ? 2 : nm || !(pl.hi[tid] < lo || pl.lo[tid] > hi);
  }
  __syncthreads();
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint32_t full_count, uint64_t* empty, uint64_t* own_full) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], CONSUMERS / 32);  // lane 0 of every consumer warp
    }
    mbar_init(own_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The first live streamed tile at or after t (n_tiles if none).
__device__ __forceinline__ int next_live(const TilePlan& pl, int t, int n_tiles) {
  while (t < n_tiles && !pl.live[t]) ++t;
  return t;
}

// The ring slot of the n-th tile a CTA streams (n counts walked tiles only):
// stage n % STAGES, barrier parity (n / STAGES) & 1. One counter is the whole
// ring state, and at the end it is the number of tiles walked.
__device__ __forceinline__ int ring_stage(uint32_t n) { return n % STAGES; }
__device__ __forceinline__ uint32_t ring_phase(uint32_t n) { return (n / STAGES) & 1; }

// Tile count n of role 0 / 1 (consumer warpgroup) or 2 (producer) of this CTA,
// where counts is set.
__device__ __forceinline__ void report_tiles(int* counts, int role, uint32_t n) {
  if (counts != nullptr)
    counts[3 * (((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) + role] = n;
}

// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The register-A fragments of a 64 x N accumulator x (f32 -> bf16, NV = N / 2
// values a thread): a[4kk .. 4kk+3] for k-step kk (16 columns).
template <int NV>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NV / 2], const float (&x)[NV]) {
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) a[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

// Rows r0 and r0 + 8 of a warpgroup's 64 x 64 f32 accumulator into bf16 rows.
__device__ __forceinline__ void store_acc_bf16(__nv_bfloat16* row0, long long row_stride, const float (&acc)[32],
                                               int t4) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(row0 + hh * 8 * row_stride + 8 * c + 2 * t4) =
          pack_bf16(acc[4 * c + 2 * hh], acc[4 * c + 2 * hh + 1]);
}

__device__ __forceinline__ void zero_acc(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
}

// The 1,024-aligned start of a kernel's dynamic shared memory (128-byte swizzle).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

bool bad_shape(int B, int H, int S) {
  return B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || S % 128 != 0;
}

// [B, H, S, 64] bf16 through (batch, head, row) strides in elements, read in
// boxes of (64 values, box_rows rows) under 128-byte swizzle.
bool bhsd_map(CUtensorMap* map, const void* base, int B, int H, int S, const Strides& st, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)DH, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What a bf16 kernel needs beyond bad_shape: S up to MAX_SEQ, room for the
// grid (S/128, H, B) in tile_counts where it is set, the ids and row
// statistics 16-byte aligned (bulk copies, int4 loads), the tensor maps (box
// rows: streamed tiles BT, the CTA's own CT), and the shared-memory size.
template <typename Kernel, int NS, int NM>
cudaError_t prepare_bf16(Kernel kernel, int smem, const void* const (&stats)[NS], CUtensorMap (&maps)[NM],
                         const void* const (&tensors)[NM], const Strides (&strides)[NM], const int (&box)[NM],
                         int B, int H, int S) {
  if (S > MAX_SEQ || (tile_counts != nullptr && 3LL * (S / CT) * H * B > tile_counts_len)) return cudaErrorInvalidValue;
  for (const void* p : stats)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  for (int i = 0; i < NM; ++i)
    if (!bhsd_map(&maps[i], tensors[i], B, H, S, strides[i], box[i])) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// ---------------------------------------------------------------- f32 tensor-core kernels (3xTF32)

// The f32 forward (flash_attention.cu) and the f32 dkv and dq
// (flash_attention_bwd.cu): operands split into tf32 hi / lo planes by a
// pre-pass, products as three tf32 wgmma. Geometry: one consumer warpgroup a
// CTA owns 64 rows (queries for the forward and dq, keys for dkv) and
// streams 32-row tiles of the other side; thread 0 feeds the ring.
constexpr int F_OWN = 64;                     // rows a CTA owns
constexpr int F_T = 32;                       // rows of a streamed tile
constexpr int F_MAX_TILES = MAX_SEQ / F_T;    // 256
constexpr int F_THREADS = 128;
constexpr int F_OWN_PLANE = F_OWN * DH * 4;   // 16 KB: hi or lo of an own tensor, [2][64][32]
constexpr int F_PLANE = F_T * DH * 4;         // 8 KB: hi or lo of a streamed tile, [2][32][32] or [64][32]
constexpr int F_OWN_HALF = F_OWN * 128;       // the step from one 32-value half of a row plane to the other
constexpr int F_HALF = F_T * 128;

__device__ __forceinline__ float tf32_hi(float x) { return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u); }

// Position f of a group of 8 rows in a transposed plane holds row perm8(f):
// 0, 2, 4, 6, 1, 3, 5, 7.
__device__ __forceinline__ int perm8(int f) { return f < 4 ? 2 * f : 2 * f - 7; }

// The pre-pass: one CTA per (32 rows, head, batch) of x [B, H, S, 64]
// (strided). Where hi is set, hi and lo go to row planes [B*H, 2, S, 32]
// (the head's two halves of 32 values: one 128-byte swizzle row each) and,
// where t_hi is set, to transposed planes [B*H, 64, S] with the rows
// permuted in groups of 8 (perm8).
__global__ void __launch_bounds__(256)
split_tf32_kernel(const float* __restrict__ x, Strides sx, int S, float* __restrict__ hi, float* __restrict__ lo,
                  float* __restrict__ t_hi, float* __restrict__ t_lo) {
  __shared__ float tile[32][DH + 1];
  const int s0 = blockIdx.x * 32, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * gridDim.y + h;
  const float* src = x + b * sx.b + h * sx.h + (long long)s0 * sx.s;
  for (int i = threadIdx.x; i < 32 * DH / 4; i += 256) {
    const int r = i / 16, c = (i % 16) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + (long long)r * sx.s + c));
    if (hi != nullptr) {
      const float4 vh = make_float4(tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z), tf32_hi(v.w));
      const long long at = ((bh * 2 + c / 32) * S + s0 + r) * 32 + c % 32;
      *reinterpret_cast<float4*>(hi + at) = vh;
      *reinterpret_cast<float4*>(lo + at) = make_float4(v.x - vh.x, v.y - vh.y, v.z - vh.z, v.w - vh.w);
    }
    tile[r][c] = v.x;
    tile[r][c + 1] = v.y;
    tile[r][c + 2] = v.z;
    tile[r][c + 3] = v.w;
  }
  if (t_hi == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * DH; i += 256) {
    const int n = i / 32, pos = i % 32;
    const float v = tile[(pos & ~7) + perm8(pos & 7)][n];
    const float vh = tf32_hi(v);
    const long long at = (bh * DH + n) * S + s0 + pos;
    t_hi[at] = vh;
    t_lo[at] = v - vh;
  }
}

// Which streamed tiles a CTA of the f32 kernels computes: the bf16 kernels'
// rule (plan_tiles) for 32-row tiles against 64 own rows, and the live tiles
// listed in order for the ring.
struct TilePlanF32 {
  int lo[F_MAX_TILES], hi[F_MAX_TILES];
  int own_lo[2], own_hi[2], own_nomatch[2];
  uint8_t nomatch[F_MAX_TILES], live[F_MAX_TILES];  // live: 0 skipped, 1 computed, 2 computed, all ids equal
  uint16_t order[F_MAX_TILES];
  int n_live;
};

// As plan_tiles, with every thread of the CTA (F_THREADS) over the tiles and
// warps 0 and 1 over the own rows. Ends in __syncthreads.
__device__ __forceinline__ void plan_tiles_f32(TilePlanF32& pl, const int* stream_ids, const float* stream_m,
                                               const int* own_ids, const float* own_m, int n_tiles) {
  const int tid = threadIdx.x;
  for (int t = tid; t < n_tiles; t += F_THREADS) {
    const int4* ids = reinterpret_cast<const int4*>(stream_ids + t * F_T);
    int lo = 0x7fffffff, hi = -0x7fffffff - 1;
#pragma unroll
    for (int j = 0; j < F_T / 4; ++j) {
      const int4 x = __ldg(ids + j);
      lo = min(lo, min(min(x.x, x.y), min(x.z, x.w)));
      hi = max(hi, max(max(x.x, x.y), max(x.z, x.w)));
    }
    bool nm = false;
    if (stream_m != nullptr) {
      const float4* mm = reinterpret_cast<const float4*>(stream_m + t * F_T);
#pragma unroll
      for (int j = 0; j < F_T / 4; ++j) {
        const float4 x = __ldg(mm + j);
        nm |= x.x == MASK_VALUE || x.y == MASK_VALUE || x.z == MASK_VALUE || x.w == MASK_VALUE;
      }
    }
    pl.lo[t] = lo;
    pl.hi[t] = hi;
    pl.nomatch[t] = nm;
  }
  if (tid < F_OWN) {
    const int id = __ldg(own_ids + tid);
    const bool nm = own_m != nullptr && __ldg(own_m + tid) == MASK_VALUE;
    const int lo = __reduce_min_sync(0xffffffffu, id), hi = __reduce_max_sync(0xffffffffu, id);
    const bool any_nm = __any_sync(0xffffffffu, nm);
    if ((tid & 31) == 0) {
      pl.own_lo[tid / 32] = lo;
      pl.own_hi[tid / 32] = hi;
      pl.own_nomatch[tid / 32] = any_nm;
    }
  }
  __syncthreads();
  const int lo = min(pl.own_lo[0], pl.own_lo[1]), hi = max(pl.own_hi[0], pl.own_hi[1]);
  const bool own_nm = pl.own_nomatch[0] | pl.own_nomatch[1];
  for (int t = tid; t < n_tiles; t += F_THREADS) {
    const bool nm = own_nm || pl.nomatch[t];
    const bool uniform = !nm && lo == hi && pl.lo[t] == lo && pl.hi[t] == hi;
    pl.live[t] = uniform ? 2 : nm || !(pl.hi[t] < lo || pl.lo[t] > hi);
  }
  __syncthreads();
  if (tid < 32) {  // warp 0 lists the live tiles
    int n = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const bool live = t0 + tid < n_tiles && pl.live[t0 + tid];
      const uint32_t ballot = __ballot_sync(0xffffffffu, live);
      if (live) pl.order[n + __popc(ballot & ((1u << tid) - 1))] = t0 + tid;
      n += __popc(ballot);
    }
    if (tid == 0) pl.n_live = n;
  }
  __syncthreads();
}

__device__ __forceinline__ void init_f32_ring(uint64_t* full, int stages, uint64_t* own_full) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    if (own_full != nullptr) mbar_init(own_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// k-step kk (8 of the head's 64 values) of a row plane whose halves lie
// half_bytes apart: 32 bytes a step inside a 128-byte swizzle row.
__device__ __forceinline__ uint64_t row_step(uint64_t d, int kk, int half_bytes) {
  return d + (kk >> 2) * (half_bytes >> 4) + 2 * (kk & 3);
}

// The tf32 register-A fragments of a CTA's 64 own rows (from row0 on) of a
// row plane (hi or lo, [B*H, 2, S, 32]): k-step kk (8 of the head's values)
// in a[4kk .. 4kk + 3], rows r and r + 8 (r = 16 warp + lane / 4), columns
// t4 and t4 + 4 (mma_ra_tf32).
__device__ __forceinline__ void load_frags(uint32_t (&a)[32], const float* plane, long long bh, int S, int row0) {
  const int r = row0 + (threadIdx.x / 32) * 16 + threadIdx.x % 32 / 4, t4 = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    const float* half = plane + (bh * 2 + kk / 4) * S * 32 + 8 * (kk % 4) + t4;
    a[4 * kk] = __float_as_uint(__ldg(half + (long long)r * 32));
    a[4 * kk + 1] = __float_as_uint(__ldg(half + (long long)(r + 8) * 32));
    a[4 * kk + 2] = __float_as_uint(__ldg(half + (long long)r * 32 + 4));
    a[4 * kk + 3] = __float_as_uint(__ldg(half + (long long)(r + 8) * 32 + 4));
  }
}

// acc (64 x 32) = a . bT as mma3_rows, with a's fragments in registers.
__device__ __forceinline__ void mma3_rows_ra(float (&acc)[16], const uint32_t (&a_hi)[32], const uint32_t (&a_lo)[32],
                                             uint64_t b_hi, uint64_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    const uint64_t bh = row_step(b_hi, kk, F_HALF), bl = row_step(b_lo, kk, F_HALF);
    mma_ra_tf32<F_T>(acc, a_hi + 4 * kk, bh, kk > 0);
    mma_ra_tf32<F_T>(acc, a_hi + 4 * kk, bl, 1);
    mma_ra_tf32<F_T>(acc, a_lo + 4 * kk, bh, 1);
  }
}

// The register-A fragments (mma_ra_tf32) of a 64 x 32 accumulator x, split
// into hi and lo. K-step c holds x[4c], x[4c + 2], x[4c + 1], x[4c + 3]:
// fragment column t4 is the step's column 2 t4 and column t4 + 4 is 2 t4 + 1,
// which is the order perm8 gives the rows of the transposed planes.
__device__ __forceinline__ void tf32_frag(uint32_t (&hi)[16], uint32_t (&lo)[16], const float (&x)[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = x[4 * c + (j == 1 ? 2 : j == 2 ? 1 : j)];
      const float h = tf32_hi(v);
      hi[4 * c + j] = __float_as_uint(h);
      lo[4 * c + j] = __float_as_uint(v - h);
    }
  }
}

// acc (64 x 64) += x . b over a streamed tile's 32 rows in 3xTF32: x from
// registers (tf32_frag), B a transposed plane pair.
__device__ __forceinline__ void mma3_ra(float (&acc)[32], const uint32_t (&x_hi)[16], const uint32_t (&x_lo)[16],
                                        uint64_t b_hi, uint64_t b_lo) {
#pragma unroll
  for (int c = 0; c < F_T / 8; ++c) {
    mma_ra_tf32<64>(acc, x_hi + 4 * c, b_hi + 2 * c, 1);
    mma_ra_tf32<64>(acc, x_hi + 4 * c, b_lo + 2 * c, 1);
    mma_ra_tf32<64>(acc, x_lo + 4 * c, b_hi + 2 * c, 1);
  }
}

// Rows r0 and r0 + 8 of a warpgroup's 64 x 64 f32 accumulator.
__device__ __forceinline__ void store_acc_f32(float* row0, long long row_stride, const float (&acc)[32], int t4) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(row0 + hh * 8 * row_stride + 8 * c + 2 * t4) =
          make_float2(acc[4 * c + 2 * hh], acc[4 * c + 2 * hh + 1]);
}

// An f32 tensor map under 128-byte swizzle (strides in bytes, dims 1.. only).
template <int R>
bool f32_map(CUtensorMap* map, const float* base, const cuuint64_t (&dims)[R], const cuuint64_t (&strides)[R - 1],
             const cuuint32_t (&box)[R]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t ones[R];
  for (int i = 0; i < R; ++i) ones[i] = 1;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, R, const_cast<float*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row plane [B*H, 2, S, 32] in boxes of `rows` rows, both halves: one
// [2][rows][32] tile, each half 128-byte rows under the swizzle.
bool row_plane_map(CUtensorMap* map, const float* base, int BH, int S, int rows) {
  return f32_map<4>(map, base, {32, (cuuint64_t)S, 2, (cuuint64_t)BH},
                    {128, (cuuint64_t)S * 128, (cuuint64_t)S * 256}, {32, (cuuint32_t)rows, 2, 1});
}

// A transposed plane [B*H, 64, S] in boxes of 32 rows of the sequence: one [64][32] tile.
bool t_plane_map(CUtensorMap* map, const float* base, int BH, int S) {
  return f32_map<3>(map, base, {(cuuint64_t)S, (cuuint64_t)DH, (cuuint64_t)BH},
                    {(cuuint64_t)S * 4, (cuuint64_t)S * DH * 4}, {32, (cuuint32_t)DH, 1});
}

// The hi and lo row planes of x where hi is set, and its transposed planes where t_hi is set.
void split_tf32(const void* x, const Strides& sx, int B, int H, int S, float* hi, float* lo, float* t_hi,
                float* t_lo, cudaStream_t st) {
  split_tf32_kernel<<<dim3(S / 32, H, B), 256, 0, st>>>((const float*)x, sx, S, hi, lo, t_hi, t_lo);
}

// What an f32 kernel needs beyond bad_shape: S up to MAX_SEQ, scratch, room
// for the grid (S/64, H, B) in tile_counts where it is set, the ids and row
// statistics 16-byte aligned (bulk copies, int4 loads), and the shared memory.
template <typename Kernel, int NS>
cudaError_t prepare_f32(Kernel kernel, int smem, const void* const (&stats)[NS], const void* scratch, int B, int H,
                        int S) {
  if (S > MAX_SEQ || scratch == nullptr || (tile_counts != nullptr && 3LL * (S / F_OWN) * H * B > tile_counts_len))
    return cudaErrorInvalidValue;
  for (const void* p : stats)
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace
