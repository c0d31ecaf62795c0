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
// Design for an H100. By its bound the scan is a bytes kernel: a slot is D/8
// bytes of codes and 32 bytes of scales against 2*8*D bf16 operations for
// each query tile that probes it (102 operations per byte at D = 1024 and
// one tile), below the card's 295 operations per byte. Query tiles are
// sorted by their nearest list, so neighbouring tiles probe many of the same
// lists: the bytes to move are those of the DISTINCT probed blocks, and a
// kernel that reads a block once per (tile, probe) reads 2.5x as much at the
// capacity run's nprobe 16. So:
//  * A scan plan (bits_plan_kernel, one CTA, launched just before the scan on
//    the same stream, no host sync) sorts the (tile, probe) pairs by their
//    list's first block (then by pair) and cuts each run of equal blocks into
//    groups of at most G pairs. A work item is (group, bi): one block, read
//    once for up to G query tiles. G = GMAX = 4 caps the registers (below) and
//    measured fastest of 1..4; a list probed by more tiles is split across
//    items. The plan's plain model is ops/bits_scan.py::scan_plan_reference,
//    and the two are bit-equal.
//  * Persistent CTAs of 4 warps take contiguous ranges of items, so an item
//    usually keeps the query tiles of the one before (same group, next
//    block): the tiles are staged once per group, in the fragment order below.
//  * Each warp streams its own 32-slot strips (codes and the strip's [8, 32]
//    scales, two TMA copies into a per-warp ring of 2-4 stages; lane 0 refills
//    a stage once the warp has read it). A warp owns 32 lanes of the grouped
//    max and walks g = 0 .. group_l - 1 over them, so the max and its g stay
//    in registers and no score touches shared memory. (lw not a multiple of
//    32 leaves rows of the last lane chunk idle: correct, and off the served
//    shapes, where lw = 128.)
//  * The codes are unpacked to +-1 in registers and feed mma.sync.m16n8k16
//    with 16 slots on M, the 8 queries of a tile on N and 16 dims of one plane
//    on K. The +-1 operand costs one shift and one logic operation per
//    register: a dot product does not care about the order of its terms, so
//    the K index of an MMA step is mapped onto the code bytes such that the
//    two bf16 halves of an operand register come from bytes 0 and 2 (or 1 and
//    3) of one aligned 32-bit code word. Their plane-b bits lie 16 apart,
//    exactly like the two sign bits of the register, so "shift, mask to the
//    sign bits, or onto 0x3F803F80 (+1.0, +1.0)" builds both values at once
//    (the words are inverted once, so a clear bit gives -1). Each +-1
//    fragment is built once and fed to the MMAs of every tile of the item: G
//    mma.sync reusing the A registers, the tile count a template parameter
//    (scan_block<NCH, GN>), so the inner loops carry no branch. A plane at a
//    time: the registers hold one plane's code words and products.
//  * What bounds it as built (PERF.md §6): the issue of that
//    construction and of the per-tile scaling, at two CTAs (8 warps) an SM,
//    not the bytes: streaming the planned blocks alone takes a third of the
//    time. wgmma m64n(8G)k16 with the +-1 operand as register A (one
//    warpgroup, the queries K-major in shared memory) was built and measured
//    1.2-1.5x slower, fully unrolled planes 1.8x slower, and 8 warps of 16
//    slots (128 registers, 16 warps an SM) 1.15-1.2x slower: each query
//    fragment then feeds one MMA instead of two. None is kept.
//  * Thread (g, t) owns bytes [t*W/4, (t+1)*W/4) of slot rows g and g+8; the
//    query tiles are staged in exactly that fragment order (dims 0, 2 | 1, 3
//    of each group of four), one 8-byte load per tile and MMA step. At D 1024
//    (W = 128) the code rows land under the 128-byte swizzle, so those loads
//    are free of bank conflicts. A plane's partial product is multiplied by
//    the f32 plane scale after its MMA steps, so the scale is never rounded
//    to bf16.
//  * No atomics: each (query, column) is written by the one warp that owns
//    it, so a repeated call gives the same bits. Items whose block lies
//    outside the store read nothing and write -inf.
//
// Built by kernels/build.py with nvcc for sm_90a into a shared library with a
// plain C interface (loaded through ctypes); cuTensorMapEncodeTiled is looked
// up at run time (tensor_map.cuh). The entry points return the cudaError_t of
// their launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "tensor_map.cuh"
#include "wgmma.cuh"

namespace {

constexpr int THREADS = 128;   // 4 warps, each with its own strips and ring
constexpr int WARPS = THREADS / 32;
constexpr int QT = 8;          // queries per tile
constexpr int PLANES = 8;
constexpr int STRIP = 32;      // slots per strip: the M rows of a warp's two MMA row tiles
constexpr int GMAX = 4;        // query tiles an item shares its block with, at most
constexpr int PLAN_THREADS = 1024;
constexpr int PLAN_MAX = 2048;  // (tile, probe) pairs one plan sorts (two per thread)

// NCH = W/16: MMA k-steps per plane, D = 128*NCH.
template <int NCH>
struct Geo {
  static constexpr int W = 16 * NCH;
  static constexpr int D = PLANES * W;
  static constexpr int STAGES = NCH == 8 ? 2 : 4;  // strips in flight per warp
  static constexpr int CODE_BYTES = STRIP * W;
  static constexpr int STRIP_BYTES = CODE_BYTES + PLANES * STRIP * 4;  // codes, then scales [8][32]
  static constexpr int RING_BYTES = WARPS * STAGES * STRIP_BYTES;
  static constexpr int Q_BYTES = GMAX * QT * D * 2;                    // the item's query tiles
  static constexpr int SMEM = RING_BYTES + Q_BYTES + 1024;             // + slack to align the ring
};

// Two bf16 +-1 values from plane b of two bytes of an INVERTED code word (a
// set bit gives -1; 0x3F80 is +1.0, bit 15 the sign): bytes 0 and 2 with
// shift 15 - b, bytes 1 and 3 with shift 7 - b.
__device__ __forceinline__ uint32_t pm1(uint32_t inv, int shift) {
  return 0x3F803F80u | ((inv << shift) & 0x80008000u);
}

__device__ __forceinline__ void mma_bf16_16x8x16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The NCH consecutive 32-bit code words thread t owns of strip row r (code
// rows of W bytes, 16-byte chunk k of row r at chunk k ^ (r % 8) under the
// swizzle), inverted.
template <int NCH>
__device__ __forceinline__ void load_words(uint32_t (&dst)[NCH], const uint8_t* codes, int r, int t) {
  using G = Geo<NCH>;
  const uint8_t* row = codes + r * G::W;
  if constexpr (NCH % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NCH / 4; ++i) {
      const int chunk = (t * NCH / 4 + i) ^ (G::W == 128 ? r & 7 : 0);  // code rows under the 128-byte swizzle
      const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * chunk);
      dst[4 * i] = ~v.x;
      dst[4 * i + 1] = ~v.y;
      dst[4 * i + 2] = ~v.z;
      dst[4 * i + 3] = ~v.w;
    }
  } else if constexpr (NCH % 2 == 0) {
#pragma unroll
    for (int i = 0; i < NCH / 2; ++i) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + t * 4 * NCH + 8 * i);
      dst[2 * i] = ~v.x;
      dst[2 * i + 1] = ~v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NCH; ++i) dst[i] = ~*reinterpret_cast<const uint32_t*>(row + t * 4 * NCH + 4 * i);
  }
}

// ---------------------------------------------------------------- the plan

// Inclusive scan of one int >= 0 per thread over the CTA (sum, or max if
// MAX). Ends with every thread past its last read of `tot` (32 ints).
template <bool MAX>
__device__ __forceinline__ int block_scan(int v, int* tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = MAX ? max(v, u) : v + u;
  }
  if (lane == 31) tot[w] = v;
  __syncthreads();
  if (w == 0) {
    int x = lane < (int)(blockDim.x >> 5) ? tot[lane] : 0;  // 0: the identity of both (values are >= 0)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x = MAX ? max(x, u) : x + u;
    }
    tot[lane] = x;
  }
  __syncthreads();
  if (w > 0) v = MAX ? max(v, tot[w - 1]) : v + tot[w - 1];
  __syncthreads();
  return v;
}

// The plan of the pairs (t0 + i / pc, p0 + i % pc), i < n = nt * pc, of the
// probe table pb [*, nprobe]: plan[0] = the number of groups; from plan + 4,
// one int4 per group {first block of the list, first position, pairs, 0};
// from plan + 4 + 4n, the n pairs i sorted by (block, i). A group is a run of
// at most group_cap pairs of equal block, cut from the start of each run.
// Launched with 32 to PLAN_THREADS threads, two positions each.
__global__ void __launch_bounds__(PLAN_THREADS)
bits_plan_kernel(const int* __restrict__ pb, int nprobe, int t0, int nt, int p0, int pc, int group_cap,
                 int* __restrict__ plan) {
  __shared__ unsigned long long keys[PLAN_MAX];
  __shared__ int tot[32], prev_start[PLAN_THREADS];
  const int n = nt * pc, tid = threadIdx.x;
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int i = tid; i < n2; i += blockDim.x) {
    unsigned long long k = ~0ull;
    if (i < n) {
      const int blk = __ldg(pb + (long long)(t0 + i / pc) * nprobe + p0 + i % pc);
      k = ((unsigned long long)((unsigned)blk ^ 0x80000000u) << 32) | (unsigned)i;  // signed order, then i
    }
    keys[i] = k;
  }
  __syncthreads();
  for (int k = 2; k <= n2; k <<= 1)  // bitonic sort, ascending
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n2; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = keys[i], b = keys[l];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[l] = a;
          }
        }
      }
      __syncthreads();
    }
  // thread tid holds positions e0 = 2 tid, e1 = 2 tid + 1
  const int e0 = 2 * tid, e1 = e0 + 1;
  auto blk_at = [&](int e) { return (int)((unsigned)(keys[e] >> 32) ^ 0x80000000u); };
  const bool f0 = e0 < n && (e0 == 0 || blk_at(e0) != blk_at(e0 - 1));
  const bool f1 = e1 < n && blk_at(e1) != blk_at(e0);
  const int run = block_scan<true>(max(f0 ? e0 : 0, f1 ? e1 : 0), tot);  // start of the run at e1
  prev_start[tid] = run;
  __syncthreads();
  const int s0 = f0 ? e0 : (tid ? prev_start[tid - 1] : 0);
  const int s1 = f1 ? e1 : s0;
  const bool g0 = e0 < n && (e0 - s0) % group_cap == 0;
  const bool g1 = e1 < n && (e1 - s1) % group_cap == 0;
  const int incl = block_scan<false>(g0 + g1, tot);
  int gid = incl - g0 - g1;
  int4* groups = reinterpret_cast<int4*>(plan + 4);
  int* order = plan + 4 + 4 * n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = e0 + h;
    if (e >= n) break;
    order[e] = (int)(keys[e] & 0xffffffffu);
    if (h == 0 ? g0 : g1) {
      const int blk = blk_at(e);
      int cnt = 1;
      while (cnt < group_cap && e + cnt < n && blk_at(e + cnt) == blk) ++cnt;
      groups[gid++] = make_int4(blk, e, cnt, 0);
    }
  }
  if (tid == (int)blockDim.x - 1) plan[0] = incl;
}

// ---------------------------------------------------------------- the scan

struct ScanArgs {
  const __nv_bfloat16* q;  // [Q, D]
  const float* csel;       // [Q, nprobe]
  const int* plan;         // bits_plan_kernel's output for this rectangle of pairs
  float* vals;             // [Q, n_cand]
  int* idx;
  long long n_cand;
  int n_blocks, block_n, nprobe, bpl, group_l, t0, p0, pc, n_pairs;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// This warp's share of one item: block blk for GN query tiles (the staged
// q_s, tile_of, probe_of). The warp walks its lane chunks of the grouped max,
// each over g = 0 .. group_l - 1, reading its strips from its ring (ring,
// full: this warp's stages) in stream order (used counts them; issue refills
// a stage), and writes the chunk's candidates. A block outside the store
// reads nothing and gives -inf.
template <int NCH, int GN, typename Issue>
__device__ __forceinline__ void scan_block(const ScanArgs& a, const uint8_t* ring, uint64_t* full, const uint2* q_s,
                                           const int* tile_of, const int* probe_of, int blk, bool stored, int bi,
                                           int lw, int my_chunks, uint32_t& used, Issue& issue) {
  using G = Geo<NCH>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  for (int ci = 0; ci < my_chunks; ++ci) {
    const int lane0 = STRIP * (warp + WARPS * ci);  // the chunk's first lane of the grouped max
    float best[GN][2][2][2];
    int arg[GN][2][2][2];
#pragma unroll
    for (int j = 0; j < GN; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            best[j][mt][h][e] = -CUDART_INF_F;
            arg[j][mt][h][e] = 0;
          }
    for (int gg = 0; stored && gg < a.group_l; ++gg) {
      const int stage = used % G::STAGES;
      mbar_wait(&full[stage], (used / G::STAGES) & 1);
      const uint8_t* st = ring + stage * G::STRIP_BYTES;
      const float* sc_s = reinterpret_cast<const float*>(st + G::CODE_BYTES);
      float score[GN][2][4];  // starts at the centroid dot of this thread's queries 2t, 2t + 1
#pragma unroll
      for (int j = 0; j < GN; ++j) {
        const int tile = tile_of[j], p = probe_of[j];
        const float c0 = __ldg(a.csel + (long long)(tile * QT + 2 * t) * a.nprobe + p);
        const float c1 = __ldg(a.csel + (long long)(tile * QT + 2 * t + 1) * a.nprobe + p);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          score[j][mt][0] = c0;
          score[j][mt][1] = c1;
          score[j][mt][2] = c0;
          score[j][mt][3] = c1;
        }
      }
#pragma unroll 1  // a plane at a time: the registers hold one plane's code words and products
      for (int b = 0; b < PLANES; ++b) {
        const int even = 15 - b, odd = 7 - b;
        uint32_t cw[2][2][NCH];  // rows of this thread: 16 mt + 8 h + g
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) load_words<NCH>(cw[mt][h], st, 16 * mt + 8 * h + g, t);
        float acc[GN][2][4];
#pragma unroll
        for (int j = 0; j < GN; ++j)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[j][mt][v] = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          uint32_t af[2][4];  // the +-1 fragment of each row tile, built once for every tile j
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            af[mt][0] = pm1(cw[mt][0][c], even);
            af[mt][1] = pm1(cw[mt][1][c], even);
            af[mt][2] = pm1(cw[mt][0][c], odd);
            af[mt][3] = pm1(cw[mt][1][c], odd);
          }
#pragma unroll
          for (int j = 0; j < GN; ++j) {
            const uint2 bq = q_s[j * (QT * G::D / 4) + ((b * NCH + c) * QT + g) * 4 + t];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_bf16_16x8x16(acc[j][mt], af[mt][0], af[mt][1], af[mt][2], af[mt][3], bq.x, bq.y);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float sc = sc_s[b * STRIP + 16 * mt + 8 * h + g];
#pragma unroll
            for (int j = 0; j < GN; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                score[j][mt][2 * h + e] = __fadd_rn(score[j][mt][2 * h + e], __fmul_rn(acc[j][mt][2 * h + e], sc));
          }
      }
      bool ok[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) ok[mt][h] = sc_s[16 * mt + 8 * h + g] >= 0.0f;
      __syncwarp();  // every lane has read the stage: lane 0 refills it
      if (lane == 0) issue();
      ++used;
      // grouped max: strict '>' keeps the first maximizing g; an all -inf group keeps g = 0
#pragma unroll
      for (int j = 0; j < GN; ++j) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float s = ok[mt][h] ? score[j][mt][2 * h + e] : -CUDART_INF_F;
              if (s > best[j][mt][h][e]) {
                best[j][mt][h][e] = s;
                arg[j][mt][h][e] = gg;
              }
            }
      }
    }
#pragma unroll
    for (int j = 0; j < GN; ++j) {
      const long long out0 =
          (long long)(tile_of[j] * QT + 2 * t) * a.n_cand + (long long)(probe_of[j] * a.bpl + bi) * lw;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ln = lane0 + 16 * mt + 8 * h + g;
          if (ln >= lw) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long long out = out0 + e * a.n_cand + ln;
            a.vals[out] = best[j][mt][h][e];
            a.idx[out] = blk * a.block_n + arg[j][mt][h][e] * lw + ln;
          }
        }
    }
  }
}

template <int NCH>
__global__ void __launch_bounds__(THREADS, 2)
bits_scan_kernel(const __grid_constant__ CUtensorMap map_codes, const __grid_constant__ CUtensorMap map_scales,
                 const ScanArgs a) {
  using G = Geo<NCH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);                      // [warp][stage] strips
  uint2* q_s = reinterpret_cast<uint2*>(ring + G::RING_BYTES);  // [tile][8 planes][NCH][8 queries][4]
  __shared__ __align__(8) uint64_t full[WARPS][G::STAGES];
  __shared__ int tile_of[GMAX], probe_of[GMAX];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lw = a.block_n / a.group_l;
  const int n_chunks = (lw + STRIP - 1) / STRIP;  // 32-lane chunks of the grouped max
  const int my_chunks = n_chunks > warp ? (n_chunks - warp + WARPS - 1) / WARPS : 0;
  const int my_strips = my_chunks * a.group_l;     // strips of this warp in each item
  const int4* groups = reinterpret_cast<const int4*>(a.plan + 4);
  const int* order = a.plan + 4 + 4 * a.n_pairs;
  const long long n_items = (long long)a.plan[0] * a.bpl;
  const long long i_begin = n_items * blockIdx.x / gridDim.x, i_end = n_items * (blockIdx.x + 1) / gridDim.x;
  if (i_begin >= i_end) return;

  if (lane == 0) {
    for (int s = 0; s < G::STAGES; ++s) mbar_init(&full[warp][s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  const CUtensorMap* codes_map = &map_codes;
  const CUtensorMap* scales_map = &map_scales;
  auto block_of = [&](long long item) { return groups[item / a.bpl].x + (int)(item % a.bpl); };
  auto in_store = [&](int blk) { return blk >= 0 && blk < a.n_blocks; };
  // The warp's strip stream: strip s of every item of [i_begin, i_end) whose
  // block lies in the store, s = (lane chunk warp + 4 (s / group_l), g = s %
  // group_l). Lane 0 issues the next strip into stage issued % STAGES.
  long long p_item = i_begin;
  int p_strip = 0, p_blk = block_of(i_begin);  // the block of p_item, read once an item
  uint32_t issued = 0;
  auto issue = [&]() {
    while (p_item < i_end) {
      if (p_strip < my_strips && in_store(p_blk)) {
        const int slot = (p_strip % a.group_l) * lw + STRIP * (warp + WARPS * (p_strip / a.group_l));
        const int stage = issued % G::STAGES;
        uint8_t* st = ring + (warp * G::STAGES + stage) * G::STRIP_BYTES;
        mbar_expect_tx(&full[warp][stage], G::STRIP_BYTES);
        tma_load_2d(st, codes_map, &full[warp][stage], 0, p_blk * a.block_n + slot);
        tma_load_2d(st + G::CODE_BYTES, scales_map, &full[warp][stage], slot, p_blk * PLANES);
        ++issued;
        ++p_strip;
        return;
      }
      p_strip = 0;
      if (++p_item < i_end) p_blk = block_of(p_item);
    }
  };
  if (lane == 0)
    for (int s = 0; s < G::STAGES; ++s) issue();

  uint32_t used = 0;  // strips of the stream this warp has read
  int cur_group = -1, gn = 0;
  for (long long item = i_begin; item < i_end; ++item) {
    const int grp = (int)(item / a.bpl), bi = (int)(item % a.bpl);
    const int4 gr = groups[grp];  // {first block of the list, first position, pairs}
    if (grp != cur_group) {  // stage the group's query tiles (fragment order)
      __syncthreads();       // every warp is done with the previous ones
      if (threadIdx.x < gr.z) {
        const int pair = order[gr.y + threadIdx.x];
        tile_of[threadIdx.x] = a.t0 + pair / a.pc;
        probe_of[threadIdx.x] = a.p0 + pair % a.pc;
      }
      __syncthreads();
      gn = gr.z;
      constexpr int UNITS = QT * G::D / 4;  // 8-byte units of a tile
      for (int v = threadIdx.x; v < gn * UNITS; v += THREADS) {
        const int j = v / UNITS, u = v % UNITS;
        const int n = u / (G::D / 4), dim = (u % (G::D / 4)) * 4;
        const int b = dim / G::W, jj = dim % G::W;
        const int tt = jj / (4 * NCH), c = (jj % (4 * NCH)) / 4;
        const uint2 x = reinterpret_cast<const uint2*>(a.q + ((long long)tile_of[j] * QT + n) * G::D)[dim / 4];
        q_s[j * UNITS + ((b * NCH + c) * QT + n) * 4 + tt] =
            make_uint2(__byte_perm(x.x, x.y, 0x5410), __byte_perm(x.x, x.y, 0x7632));
      }
      __syncthreads();
      cur_group = grp;
    }
    const int blk = gr.x + bi;
    const bool stored = in_store(blk);

    uint64_t* full_w = full[warp];
    const uint8_t* ring_w = ring + warp * G::STAGES * G::STRIP_BYTES;
    switch (gn) {  // the item's tiles as a compile-time count: no branch in the scan's inner loops
      case 1: scan_block<NCH, 1>(a, ring_w, full_w, q_s, tile_of, probe_of, blk, stored, bi, lw, my_chunks, used, issue); break;
      case 2: scan_block<NCH, 2>(a, ring_w, full_w, q_s, tile_of, probe_of, blk, stored, bi, lw, my_chunks, used, issue); break;
      case 3: scan_block<NCH, 3>(a, ring_w, full_w, q_s, tile_of, probe_of, blk, stored, bi, lw, my_chunks, used, issue); break;
      default: scan_block<NCH, GMAX>(a, ring_w, full_w, q_s, tile_of, probe_of, blk, stored, bi, lw, my_chunks, used, issue);
    }
  }
}

// ---------------------------------------------------------------- host side

// codes [n_slots, W] u8 in boxes of 32 rows (128-byte swizzle at W = 128);
// scales [n_blocks * 8, block_n] f32 in boxes of 8 planes x 32 slots.
bool scan_maps(CUtensorMap* codes_map, CUtensorMap* scales_map, const void* codes, const void* scales, int W,
               long long n_slots, int n_blocks, int block_n) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t c_dims[2] = {(cuuint64_t)W, (cuuint64_t)n_slots}, c_strides[1] = {(cuuint64_t)W};
  const cuuint32_t c_box[2] = {(cuuint32_t)W, (cuuint32_t)STRIP};
  const cuuint64_t s_dims[2] = {(cuuint64_t)block_n, (cuuint64_t)n_blocks * PLANES};
  const cuuint64_t s_strides[1] = {(cuuint64_t)block_n * 4};
  const cuuint32_t s_box[2] = {(cuuint32_t)STRIP, (cuuint32_t)PLANES};
  return fn(codes_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(codes), c_dims, c_strides, c_box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         fn(scales_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(scales), s_dims, s_strides, s_box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Resident CTAs of the scan kernel on the current device (persistent grid).
template <int NCH>
cudaError_t resident_ctas(int* ctas) {
  static int cached[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 16 && cached[dev]) {
    *ctas = cached[dev];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(bits_scan_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<NCH>::SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bits_scan_kernel<NCH>, THREADS,
                                                           Geo<NCH>::SMEM)) != cudaSuccess)
    return err;
  *ctas = sms * std::max(per_sm, 1);
  if (dev < 16) cached[dev] = *ctas;
  return cudaSuccess;
}

// Threads of a plan of n pairs: two positions each of the sort's power of two.
int plan_threads(int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  return std::min(PLAN_THREADS, std::max(32, (n2 / 2 + 31) / 32 * 32));
}

template <int NCH>
cudaError_t launch(const void* q, const void* codes, const void* scales, const void* pb, const void* csel, int Q,
                   int n_blocks, int block_n, int nprobe, int bpl, int group_l, int group_cap, void* vals, void* idx,
                   int* plan, cudaStream_t stream) {
  CUtensorMap codes_map, scales_map;
  if (!scan_maps(&codes_map, &scales_map, codes, scales, Geo<NCH>::W, (long long)n_blocks * block_n, n_blocks,
                 block_n))
    return cudaErrorInvalidValue;
  int ctas = 0;
  cudaError_t err = resident_ctas<NCH>(&ctas);
  if (err != cudaSuccess) return err;
  const int T = Q / QT, pc = std::min(nprobe, PLAN_MAX), nt = std::max(1, PLAN_MAX / pc);
  ScanArgs args{(const __nv_bfloat16*)q, (const float*)csel, plan, (float*)vals, (int*)idx,
                (long long)nprobe * bpl * (block_n / group_l), n_blocks, block_n, nprobe, bpl, group_l,
                0, 0, 0, 0};
  // one plan and one scan per rectangle of at most PLAN_MAX (tile, probe) pairs
  for (int t0 = 0; t0 < T; t0 += nt)
    for (int p0 = 0; p0 < nprobe; p0 += pc) {
      const int tn = std::min(nt, T - t0), pn = std::min(pc, nprobe - p0);
      bits_plan_kernel<<<1, plan_threads(tn * pn), 0, stream>>>((const int*)pb, nprobe, t0, tn, p0, pn, group_cap,
                                                                plan);
      args.t0 = t0;
      args.p0 = p0;
      args.pc = pn;
      args.n_pairs = tn * pn;
      const long long items = (long long)tn * pn * bpl;  // the plan's items, at most
      bits_scan_kernel<NCH><<<(unsigned)std::min<long long>(items, ctas), THREADS, Geo<NCH>::SMEM, stream>>>(
          codes_map, scales_map, args);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Ints of plan scratch one bits_scan call needs (one rectangle of pairs at a time).
int bits_scan_plan_ints() { return 4 + 5 * PLAN_MAX; }

// Dynamic shared memory of a scan CTA at width D (the ring and the query
// tiles), or -1 for a D the kernel does not tile.
int bits_scan_smem(int D) {
  switch (D) {
    case 128: return Geo<1>::SMEM;
    case 256: return Geo<2>::SMEM;
    case 384: return Geo<3>::SMEM;
    case 1024: return Geo<8>::SMEM;
    default: return -1;
  }
}

// q [Q, D] bf16; codes [n_blocks*block_n, D/8] u8; scales [n_blocks, 8, block_n]
// f32; pb [Q/8, nprobe] i32; csel [Q, nprobe] f32; vals/idx
// [Q, nprobe*bpl*block_n/group_l]; plan: bits_scan_plan_ints() i32 of scratch;
// group_cap in 1..GMAX; every pointer 16-byte aligned.
int bits_scan(const void* q, const void* codes, const void* scales, const void* pb, const void* csel, int Q, int D,
              int n_blocks, int block_n, int nprobe, int bpl, int group_l, int group_cap, void* vals, void* idx,
              void* plan, void* stream) {
  if (Q <= 0 || Q % QT != 0 || D <= 0 || D % 128 != 0 || n_blocks <= 0 || block_n <= 0 || block_n % 32 != 0 ||
      nprobe <= 0 || bpl <= 0 || group_l <= 0 || block_n % group_l != 0 || group_cap < 1 || group_cap > GMAX ||
      (long long)n_blocks * block_n >= 2147483647LL || (long long)(Q / QT) * nprobe * bpl > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define BITS_SCAN_CASE(NCH)                                                                                      \
  case NCH:                                                                                                      \
    return (int)launch<NCH>(q, codes, scales, pb, csel, Q, n_blocks, block_n, nprobe, bpl, group_l, group_cap, \
                            vals, idx, (int*)plan, s);
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

// The plan alone, of every pair of pb [T, nprobe] (T * nprobe <= PLAN_MAX),
// into plan (4 + 5 * T * nprobe i32): what bits_scan launches before its scan.
int bits_scan_plan(const void* pb, int T, int nprobe, int group_cap, void* plan, void* stream) {
  if (T <= 0 || nprobe <= 0 || (long long)T * nprobe > PLAN_MAX || group_cap < 1 || group_cap > GMAX)
    return (int)cudaErrorInvalidValue;
  bits_plan_kernel<<<1, plan_threads(T * nprobe), 0, (cudaStream_t)stream>>>((const int*)pb, nprobe, 0, T, 0, nprobe,
                                                                             group_cap, (int*)plan);
  return (int)cudaGetLastError();
}

}  // extern "C"
