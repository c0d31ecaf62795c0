// Shared by flash_attention.cu (forward) and flash_attention_bwd.cu (dkv, dq):
// the head width, the library's mask value, the row strides and bf16 packing,
// and the pieces of the bf16 tensor-core kernels: their geometry, the plan of
// the tiles a CTA computes (the tile skip), the TMA ring's bookkeeping, the
// tile counts, the accumulator helpers and the host side of their tensor maps.

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

}  // namespace
