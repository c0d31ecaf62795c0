// Fused flat-search score + grouped partial max (the dense stage of /search).
//
// Replaces the two Pallas TPU kernels of intool_rag_tpu/ops/flat_pallas.py:
//   _partial_topk_kernel       (K1: bf16/f32 corpus, optional split-query q_lo pass;
//                               f32 at precision=HIGHEST)
//   _partial_topk_kernel_int8  (K2: int8 corpus, optional q2 and residual-plane c2 passes)
// and their shared epilogue _reduce_block. K1 also takes a float16 corpus.
//
// Contract (identical to the TPU kernels): corpus block b covers rows
// [b*block_n, (b+1)*block_n) with block_n = 128*group_l. For lane in [0, 128):
//   cand_vals[q, b*128 + lane] = max_j score[q, b*block_n + j*128 + lane]
//   cand_idx [q, b*128 + lane] = b*block_n + j* * 128 + lane
// where j* is the smallest maximizing j (a group that is all -inf gives j* = 0)
// and rows >= valid_n score -inf. The [Q, N] score matrix never reaches HBM.
//
// What bounds it on an H100: at the service's batches (Q 8-16) the corpus
// bytes (one pass over the store); at Q 256 the tensor-core operations of the
// 1-3 products per corpus row (bf16 precise, int8+q2, int8r, f32's three
// tf32 products) or both about equally (bf16, int8). The TPU kernel reads every query in one grid step and
// so streams the corpus once. What keeps this design under its bound: at Q 256
// each query tile is read again from L2 for every 128-row corpus tile (a
// 128 x 128 output tile is what the registers hold beside the running max);
// at the service shape, the ring's fill and the split merge.
//
// The design for Hopper:
//  * wgmma with the corpus on M and the queries on N. A CTA takes a 128-row
//    corpus tile (two consumer warpgroups of 64 rows each, the A operand)
//    against a query tile of NQ rows (the B operand; NQ in 8..128, chosen
//    from Q by ops/flat_fused.py::plan_launch), both K-major as stored.
//    bf16 and f16 run m64nNQk16 into f32; int8 runs m64nNk32 into s32, with
//    q1 and q2 stacked along N (one wgmma for both products with c1) and
//    q1.c2 as a second one. bf16 precise adds q_lo . c as a second B tile on
//    the same A tile, into the same accumulator.
//  * A producer warpgroup keeps a ring of 4-8 stages of TMA copies (128-byte
//    swizzle) of 128-byte k-chunks of (corpus tile, query tile) in flight;
//    the consumers wait on a stage's full barrier and release its empty
//    barrier once their wgmma has read it, so loads run under the math. The
//    producer hands its registers to the consumers (setmaxnreg): 232 each
//    hold a 128-query tile's accumulators beside its running max.
//  * The grouped max is folded straight from the accumulator registers: each
//    thread owns fixed (row, query) pairs, so the running (best, j) stays in
//    registers (j one byte, four to a register) with the row scale and the
//    valid_n mask applied there. No score tile in shared memory and no block
//    barrier per 128-row tile. A tile that lies wholly past valid_n is
//    neither loaded nor multiplied: its rows would all score -inf.
//  * The corpus is streamed from device memory once per call: the items of
//    one corpus range's query tiles are neighbours in the walk and run on
//    neighbouring CTAs at the same time, so every read of a corpus tile
//    after the first is an L2 hit.
//  * Persistent CTAs, one per SM, walk the work items (query tile, split,
//    block) in that order; the ring runs on from one item to the next, so
//    an item's fold and writes overlap the next one's loads and no partial
//    last wave idles part of the card.
//  * Enough work items at small N: where query tiles x blocks is below the
//    SM count, the group_l tiles of a block are split across items; each
//    writes its partial (best, j) to scratch and the last one to arrive
//    merges them in split order, so a tie keeps the smaller j.
//  * f32 (INDEX_DTYPE=float32) runs 3xTF32 on the tensor cores, where the
//    TPU kernel's HIGHEST-precision dot runs several bf16 passes. Each
//    operand splits as x = hi + lo, hi = x with its low 13 mantissa bits
//    cleared (a tf32 value) and lo = x - hi (exact). The queries come split
//    (q_hi, q_lo: two B planes, ops/flat_fused.py::split_query_tf32); the
//    corpus stays one f32 plane in device memory, and each consumer
//    warpgroup splits its 64 rows of a landed stage in shared memory (hi in
//    place, lo into the stage's second A plane) before its wgmma reads them.
//    Three m64nNk8 tf32 products go into one f32 accumulator:
//    c_hi.q_hi + c_hi.q_lo + c_lo.q_hi. The dropped c_lo.q_lo and the tf32
//    reading of lo leave about 2^-20 |q||c| per score.
//
// K2's float order is the TPU kernel's, f32(q1.c1) [+ f32(q2.c1)/128]
// [+ f32(q1.c2)/128], times the row scale, on exact int32 products: it is
// bit-equal to the plain version.
//
// Built by kernels/build.py with nvcc for sm_90a into a shared library with a
// plain C interface (loaded through ctypes); it links against the CUDA
// runtime only and takes cuTensorMapEncodeTiled from the driver through
// cudaGetDriverEntryPoint(ByVersion) (tensor_map.cuh). Each entry point returns the
// cudaError_t of its launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_map.cuh"
#include "wgmma.cuh"

namespace {

constexpr int LW = 128;                  // candidate lanes per corpus block = rows per corpus tile
constexpr int CHUNK = 128;               // bytes of a row per k-chunk: one swizzle-atom row
constexpr int A_TILE = LW * CHUNK;       // bytes of one corpus plane's k-chunk (16 KB)
constexpr int CONSUMERS = 256;            // two warpgroups, 64 tile rows each
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup, of which one thread issues the copies
// Registers a thread keeps after setmaxnreg: the producer gives up what the
// consumers' accumulators, running max and j need (65,536 per SM in all).
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int RING_BYTES = 200 * 1024;
constexpr int MAX_STAGES = 8;

enum Kind { BF16 = 0, BF16_PRECISE, F16, I8, I8_Q2, I8_C2, I8R, F32 };

template <int KIND>
struct Variant {
  static constexpr bool INT8 = KIND >= I8 && KIND <= I8R;
  static constexpr bool TF32 = KIND == F32;                  // 3xTF32: corpus lo formed in shared memory
  static constexpr bool LO = KIND == BF16_PRECISE || TF32;  // q_lo: a second B tile
  static constexpr bool Q2 = KIND == I8_Q2 || KIND == I8R;  // q2 stacked below q1 along N
  static constexpr bool C2 = KIND == I8_C2 || KIND == I8R;  // residual plane: a second A tile
  static constexpr int A_PLANES = (C2 || TF32) ? 2 : 1;
  static constexpr int A_LOADED = C2 ? 2 : 1;                // A planes that TMA fills
  static constexpr int B_PLANES = (LO || Q2) ? 2 : 1;
  // widest query tile whose accumulators, running max and j fit in registers
  static constexpr int MAX_NQ = (Q2 || C2) ? 64 : 128;
  using T = std::conditional_t<INT8, int8_t,
                               std::conditional_t<TF32, float, std::conditional_t<KIND == F16, __half, __nv_bfloat16>>>;
  using Acc = std::conditional_t<INT8, int32_t, float>;
  static constexpr int K_ELEMS = CHUNK / (int)sizeof(T);
};

constexpr int ring_stages(int stage_bytes) {
  return RING_BYTES / stage_bytes < MAX_STAGES ? RING_BYTES / stage_bytes : MAX_STAGES;
}

template <int KIND, int NQ>
struct Ring {
  static constexpr int B_TILE = NQ * CHUNK;
  static constexpr int STAGE = Variant<KIND>::A_PLANES * A_TILE + Variant<KIND>::B_PLANES * B_TILE;
  static constexpr int TX = Variant<KIND>::A_LOADED * A_TILE + Variant<KIND>::B_PLANES * B_TILE;  // bytes TMA lands
  static constexpr int STAGES = ring_stages(STAGE);
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + slack to align the ring to 1,024 bytes
};

struct Params {
  const float* cscale;  // K2: per-row corpus scale
  int Q, D, group_l, valid_n, tiles, splits;
  int items;            // tiles * splits * blocks
  long long ncand;      // N / group_l
  float* vals;
  int* idx;
  float* part_vals;     // [splits, Q, ncand] when splits > 1
  uint8_t* part_j;
  int* arrivals;        // [blocks * tiles], zero before the launch and after it
};

__device__ __forceinline__ uint32_t set_byte(uint32_t word, int k, uint32_t value) {
  return (word & ~(0xFFu << (8 * k))) | (value << (8 * k));
}

// Tiles of block b that hold a row below valid_n. The later ones would fold
// only -inf, which strict '>' never takes, so the tensor-core kernel reads
// none of them.
__device__ __forceinline__ int live_tiles(long long b, long long block_n, int valid_n, int group_l) {
  const long long rows = valid_n - b * block_n;
  return rows <= 0 ? 0 : rows >= block_n ? group_l : (int)((rows + LW - 1) / LW);
}

// 3xTF32: a consumer warpgroup splits its 64 rows of a landed f32 corpus
// stage, hi (low 13 mantissa bits cleared) in place and lo = x - hi into
// the stage's second A plane at the same offset, so both keep the TMA
// swizzle. Then it makes the stores visible to wgmma (the async proxy) and
// waits for its 128 threads.
__device__ __forceinline__ void split_tf32_rows(uint8_t* hi, uint8_t* lo, int t, int wg) {
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int i = 0; i < A_TILE / 2 / 16 / 128; ++i) {
    const float4 x = h4[t + 128 * i];
    float4 h, l;
    h.x = __uint_as_float(__float_as_uint(x.x) & 0xFFFFE000u);
    h.y = __uint_as_float(__float_as_uint(x.y) & 0xFFFFE000u);
    h.z = __uint_as_float(__float_as_uint(x.z) & 0xFFFFE000u);
    h.w = __uint_as_float(__float_as_uint(x.w) & 0xFFFFE000u);
    l.x = x.x - h.x;
    l.y = x.y - h.y;
    l.z = x.z - h.z;
    l.w = x.w - h.w;
    h4[t + 128 * i] = h;
    l4[t + 128 * i] = l;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// A work item is one (query tile, split, block); item -> (qt, split, b) puts
// the query tiles of one corpus range next to each other.
struct Item {
  int qt, split, b;
  __device__ Item(int item, const Params& p)
      : qt(item % p.tiles), split(item / p.tiles % p.splits), b(item / p.tiles / p.splits) {}
};

template <int KIND, int NQ>
__global__ void __launch_bounds__(THREADS, 1)
partial_topk_kernel(const __grid_constant__ CUtensorMap map_c1, const __grid_constant__ CUtensorMap map_c2,
                    const __grid_constant__ CUtensorMap map_q1, const __grid_constant__ CUtensorMap map_q2,
                    const Params p) {
  using V = Variant<KIND>;
  using R = Ring<KIND, NQ>;
  using Acc = typename V::Acc;
  constexpr int NV = NQ / 2;              // scores a thread folds per tile
  constexpr int NA = V::Q2 ? NQ : NV;     // the product with c1 (q1 and q2 stacked for +q2)
  constexpr int NB = V::C2 ? NV : 1;      // q1 . c2

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ __align__(8) uint64_t full[R::STAGES], empty[R::STAGES];
  __shared__ int last_arrival;

  const int per_split = p.group_l / p.splits;
  const int nk = p.D / V::K_ELEMS;
  const long long block_n = (long long)LW * p.group_l;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent CTAs: each walks items blockIdx.x, + gridDim.x, ...; the ring
  // runs on across items, so one item's fold and writes overlap the next
  // item's loads.
  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const Item it(item, p);
        const int j_end = min((it.split + 1) * per_split, live_tiles(it.b, block_n, p.valid_n, p.group_l));
        for (int j = it.split * per_split; j < j_end; ++j) {
          const int row0 = (int)(it.b * block_n + (long long)j * LW);
          for (int kc = 0; kc < nk; ++kc) {
            mbar_wait(&empty[stage], phase ^ 1);
            uint8_t* st = ring + stage * R::STAGE;
            uint8_t* bt = st + V::A_PLANES * A_TILE;
            const int x = kc * V::K_ELEMS;
            mbar_expect_tx(&full[stage], R::TX);
            tma_load_2d(st, &map_c1, &full[stage], x, row0);
            if constexpr (V::C2) tma_load_2d(st + A_TILE, &map_c2, &full[stage], x, row0);
            tma_load_2d(bt, &map_q1, &full[stage], x, it.qt * NQ);
            if constexpr (V::B_PLANES == 2) tma_load_2d(bt + R::B_TILE, &map_q2, &full[stage], x, it.qt * NQ);
            if (++stage == R::STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int r0 = wg * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;  // tile rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);                                     // query columns 8c + c0 + {0, 1}

  float best[NV];
  uint32_t bestj[(NV + 3) / 4];
  Acc acc[NA];
  Acc acc2[NB];
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const Item it(item, p);
    const int j0 = it.split * per_split;
    const int q0 = it.qt * NQ;
    const int j_end = min(j0 + per_split, live_tiles(it.b, block_n, p.valid_n, p.group_l));
#pragma unroll
    for (int v = 0; v < NV; ++v) best[v] = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < (NV + 3) / 4; ++w) bestj[w] = (uint32_t)j0 * 0x01010101u;

    for (int j = j0; j < j_end; ++j) {
      const long long row0 = it.b * block_n + (long long)j * LW;
      float cs[2] = {1.0f, 1.0f};
      if constexpr (V::INT8) {
        cs[0] = __ldg(p.cscale + row0 + r0);
        cs[1] = __ldg(p.cscale + row0 + r0 + 8);
      }
      int prev = -1;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(&full[stage], phase);
        uint8_t* st = ring + stage * R::STAGE;
        if constexpr (V::TF32) split_tf32_rows(st + wg * (A_TILE / 2), st + A_TILE + wg * (A_TILE / 2),
                                               threadIdx.x % 128, wg);
        const uint64_t da1 = desc_sw128(st + wg * (A_TILE / 2));
        const uint64_t da2 = desc_sw128(st + A_TILE + wg * (A_TILE / 2));
        const uint64_t db1 = desc_sw128(st + V::A_PLANES * A_TILE);
        const uint64_t db2 = desc_sw128(st + V::A_PLANES * A_TILE + R::B_TILE);
        fence_regs(acc);
        fence_regs(acc2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CHUNK / 32; ++kk) {  // 32 bytes of K per wgmma: k16 bf16/f16, k8 tf32, k32 int8
          const int add = kc > 0 || kk > 0;
          if constexpr (V::INT8) {
            mma<int8_t, V::Q2 ? 2 * NQ : NQ>(acc, da1 + 2 * kk, db1 + 2 * kk, add);
            if constexpr (V::C2) mma<int8_t, NQ>(acc2, da2 + 2 * kk, db1 + 2 * kk, add);
          } else if constexpr (V::TF32) {  // c_hi.q_hi + c_hi.q_lo + c_lo.q_hi
            mma<float, NQ>(acc, da1 + 2 * kk, db1 + 2 * kk, add);
            mma<float, NQ>(acc, da1 + 2 * kk, db2 + 2 * kk, 1);
            mma<float, NQ>(acc, da2 + 2 * kk, db1 + 2 * kk, 1);
          } else {
            mma<typename V::T, NQ>(acc, da1 + 2 * kk, db1 + 2 * kk, add);
            if constexpr (V::LO) mma<typename V::T, NQ>(acc, da1 + 2 * kk, db2 + 2 * kk, 1);
          }
        }
        wgmma_commit();
        fence_regs(acc);
        fence_regs(acc2);
        if (prev >= 0) {  // the previous chunk's products are done: release its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == R::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(acc2);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // fold this tile into the running max: strict '>' keeps the first j
      const long long n0 = row0 + r0;
      const bool valid[2] = {n0 < p.valid_n, n0 + 8 < p.valid_n};
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int h = (v >> 1) & 1;
        float s;
        if constexpr (V::INT8) {
          s = static_cast<float>(acc[v]);
          if constexpr (V::Q2) s = s + static_cast<float>(acc[v + NV]) * (1.0f / 128.0f);
          if constexpr (V::C2) s = s + static_cast<float>(acc2[v]) * (1.0f / 128.0f);
          s = s * cs[h];
        } else {
          s = acc[v];
        }
        if (!valid[h]) s = -CUDART_INF_F;
        if (s > best[v]) {
          best[v] = s;
          bestj[v / 4] = set_byte(bestj[v / 4], v % 4, (uint32_t)j);
        }
      }
    }

    const long long lane0 = (long long)it.b * LW;
    const long long base_row = it.b * block_n;
    if (p.splits == 1) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int q = q0 + 8 * (v / 4) + c0 + (v & 1);
        const int r = r0 + 8 * ((v >> 1) & 1);
        if (q < p.Q) {
          const long long o = (long long)q * p.ncand + lane0 + r;
          p.vals[o] = best[v];
          p.idx[o] = (int)(base_row + (long long)((bestj[v / 4] >> (8 * (v % 4))) & 0xFF) * LW + r);
        }
      }
      continue;
    }

    // split: every item leaves its partial in scratch; the last of this
    // (block, query tile) to arrive merges them in split order
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int q = q0 + 8 * (v / 4) + c0 + (v & 1);
      const int r = r0 + 8 * ((v >> 1) & 1);
      if (q < p.Q) {
        const long long o = ((long long)it.split * p.Q + q) * p.ncand + lane0 + r;
        p.part_vals[o] = best[v];
        p.part_j[o] = (uint8_t)(bestj[v / 4] >> (8 * (v % 4)));
      }
    }
    int* arrivals = p.arrivals + (long long)it.b * p.tiles + it.qt;
    __threadfence();
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    if (threadIdx.x == 0) last_arrival = atomicAdd(arrivals, 1) == p.splits - 1;
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    if (!last_arrival) continue;
    if (threadIdx.x == 0) *arrivals = 0;  // ready for the next launch
    __threadfence();
    // Merge in a coalesced layout: consumer thread t takes lane t % 128 of
    // query rows q0 + t / 128 + 2i. best[i] becomes the merged value and
    // byte i of bestj the split it came from; every split's values load
    // together, then one j per value.
    const int mlane = threadIdx.x % LW;
    const int qt0 = q0 + threadIdx.x / LW;
    const long long e0 = (long long)qt0 * p.ncand + lane0 + mlane;  // entry of row qt0 in one plane
    const long long step = 2 * p.ncand;                             // two query rows on
    const long long plane = (long long)p.Q * p.ncand;
    for (int s = 0; s < p.splits; ++s) {
      const float* src = p.part_vals + s * plane + e0;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (qt0 + 2 * i < p.Q) {
          const float x = __ldcg(src + i * step);
          if (s == 0 || x > best[i]) {
            best[i] = x;
            bestj[i / 4] = set_byte(bestj[i / 4], i % 4, (uint32_t)s);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (qt0 + 2 * i < p.Q) {
        const long long o = e0 + i * step;
        const long long s = (bestj[i / 4] >> (8 * (i % 4))) & 0xFF;
        p.vals[o] = best[i];
        p.idx[o] = (int)(base_row + (long long)__ldcg(p.part_j + s * plane + o) * LW + mlane);
      }
    }
  }
}

// ---------------------------------------------------------------- host side

// A [rows, cols] row-major operand read in boxes of (box_rows, 128 bytes)
// under 128-byte swizzle; rows past the end read as zeros.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base, long long rows, int cols,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(CHUNK / elem), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Operands {
  const void *c1, *c2, *q1, *q2;
  long long n;
  int max_ctas;  // persistent CTAs: one per SM
};

template <int KIND, int NQ>
int launch(const Operands& op, const Params& p, cudaStream_t stream) {
  using V = Variant<KIND>;
  using R = Ring<KIND, NQ>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      partial_topk_kernel<KIND, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const CUtensorMapDataType type = V::INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : V::TF32  ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : KIND == F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int elem = (int)sizeof(typename V::T);
  CUtensorMap c1, c2, q1, q2;
  if (!tensor_map(&c1, type, elem, op.c1, op.n, p.D, LW) || !tensor_map(&q1, type, elem, op.q1, p.Q, p.D, NQ))
    return (int)cudaErrorInvalidValue;
  c2 = c1;
  q2 = q1;
  if (V::C2 && !tensor_map(&c2, type, elem, op.c2, op.n, p.D, LW)) return (int)cudaErrorInvalidValue;
  if (V::B_PLANES == 2 && !tensor_map(&q2, type, elem, op.q2, p.Q, p.D, NQ)) return (int)cudaErrorInvalidValue;
  const int ctas = p.items < op.max_ctas ? p.items : op.max_ctas;
  partial_topk_kernel<KIND, NQ><<<ctas, THREADS, R::SMEM, stream>>>(c1, c2, q1, q2, p);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_width(int width, const Operands& op, const Params& p, cudaStream_t stream) {
  switch (width) {
    case 8: return launch<KIND, 8>(op, p, stream);
    case 16: return launch<KIND, 16>(op, p, stream);
    case 32: return launch<KIND, 32>(op, p, stream);
    case 64: return launch<KIND, 64>(op, p, stream);
    case 128:
      if constexpr (Variant<KIND>::MAX_NQ >= 128) return launch<KIND, 128>(op, p, stream);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

template <int KIND>
int smem_width(int width) {
  switch (width) {
    case 8: return Ring<KIND, 8>::SMEM;
    case 16: return Ring<KIND, 16>::SMEM;
    case 32: return Ring<KIND, 32>::SMEM;
    case 64: return Ring<KIND, 64>::SMEM;
    case 128:
      if constexpr (Variant<KIND>::MAX_NQ >= 128) return Ring<KIND, 128>::SMEM;
      break;
  }
  return -1;
}

bool shapes_ok(int Q, int N, int D, int group_l, int d_multiple, int valid_n) {
  return Q > 0 && group_l > 0 && N > 0 && N % (LW * group_l) == 0 && D > 0 && D % d_multiple == 0 &&
         valid_n >= 0 && valid_n <= N;
}

}  // namespace

extern "C" {

// K1 (kind 0 bf16, 1 bf16 precise, 2 f16, 7 f32) and K2 (kind 3 int8,
// 4 int8+q2, 5 int8+c2, 6 int8r) on the tensor cores. c1/c2 are the corpus
// planes [N, D], q1/q2 the query planes [Q, D] (q_hi/q_lo for K1 bf16 precise
// and f32), cscale the K2 row
// scales. width and splits come from ops/flat_fused.py::plan_launch, n_sm
// bounds the persistent grid; with splits > 1, part_vals/part_j are
// [splits, Q, N/group_l] scratch and arrivals [tiles * blocks] zeros, which
// the launch leaves zero.
int flat_partial_topk(int kind, const void* c1, const void* c2, const void* q1, const void* q2, const void* cscale,
                      int Q, int N, int D, int group_l, int valid_n, int width, int splits, int n_sm, void* vals,
                      void* idx, void* part_vals, void* part_j, void* arrivals, void* stream) {
  const int d_multiple = kind == F32 ? 32 : kind >= I8 ? 128 : 64;  // one 128-byte k-chunk
  if (!shapes_ok(Q, N, D, group_l, d_multiple, valid_n) || group_l > 128 || splits <= 0 ||
      group_l % splits != 0 || width <= 0 || n_sm <= 0)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_vals == nullptr || part_j == nullptr || arrivals == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles = (Q + width - 1) / width;
  const long long items = (long long)tiles * splits * (N / (LW * group_l));
  if (items > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  Params p{(const float*)cscale, Q, D, group_l, valid_n, tiles, splits, (int)items, (long long)N / group_l,
           (float*)vals, (int*)idx, (float*)part_vals, (uint8_t*)part_j, (int*)arrivals};
  const Operands op{c1, c2, q1, q2, N, n_sm};
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case BF16: return launch_width<BF16>(width, op, p, s);
    case BF16_PRECISE: return launch_width<BF16_PRECISE>(width, op, p, s);
    case F16: return launch_width<F16>(width, op, p, s);
    case I8: return launch_width<I8>(width, op, p, s);
    case I8_Q2: return launch_width<I8_Q2>(width, op, p, s);
    case I8_C2: return launch_width<I8_C2>(width, op, p, s);
    case I8R: return launch_width<I8R>(width, op, p, s);
    case F32: return launch_width<F32>(width, op, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one (kind, width) instantiation, or -1.
int flat_partial_topk_smem(int kind, int width) {
  switch (kind) {
    case BF16: return smem_width<BF16>(width);
    case BF16_PRECISE: return smem_width<BF16_PRECISE>(width);
    case F16: return smem_width<F16>(width);
    case I8: return smem_width<I8>(width);
    case I8_Q2: return smem_width<I8_Q2>(width);
    case I8_C2: return smem_width<I8_C2>(width);
    case I8R: return smem_width<I8R>(width);
    case F32: return smem_width<F32>(width);
  }
  return -1;
}

}  // extern "C"
