// Flash attention with segment ids, forward pass (the attention of every
// encoder row of S >= flash_min_len: packed rows and long inputs).
//
// Replaces the TPU flash-attention kernel of the JAX library
// (jax.experimental.pallas.ops.tpu.flash_attention, forward), which the JAX
// package calls at intool_rag_tpu/models/encoder.py:138 (SelfAttention).
//
// Contract (what that kernel computes). q, k, v [B, H, S, 64], seg_q and
// seg_kv [B, S] i32. For every (b, h, i):
//   s_ij = (q_i . k_j) * sm_scale            where seg_q[b, i] == seg_kv[b, j]
//   s_ij = MASK_VALUE (-0.7 * f32 max)       elsewhere (the library adds the
//          mask value to the logit, which rounds to the mask value itself)
//   o_i  = sum_j softmax_j(s_ij) * v_j
// blockwise over the keys with a running max and sum in f32, so no [S, S]
// tensor exists anywhere. p is rounded to v's type in front of p.v, as in the
// library; the sum of p is taken before that rounding. The mask value stays
// finite: a key tile that is wholly masked for a row leaves m = MASK_VALUE and
// p = 1 there, and the first real key then scales that sum away through
// exp(m_old - m_new) = 0. A row with no unmasked key at all averages v over
// every key, as a softmax over equal logits does. The accumulator is divided by
// the sum once, after the last tile (the library renormalises at every tile;
// the two agree to rounding).
//
// The tensors are read through their strides (batch, head, row; the 64 values
// of a head are contiguous), so the encoder hands over its [B, S, H*64]
// projections as they are and gets the result in that layout: no transpose is
// copied on either side.
//
// A differentiated call also saves each row's sum l and max m ([B, H, S] f32,
// m in the natural-exponent domain, the mask value itself for a row no key
// matches) for the backward kernels of flash_attention_bwd.cu; the library
// keeps the two apart as well, since m + log l would lose log l beside the
// mask value.
//
// What bounds it on an H100: operations. Per head and per pair of equal id it
// does 4 x 64 (q.kT and p.v) against 4 x 64 values moved per row; at a head
// width of 64 the exponentials, the masking and the online softmax take about
// as many issue slots as the tensor cores take cycles for the two products.
// The bf16 variant is built for the tensor cores and for doing no work that
// the ids rule out, on the geometry of the backward's dq kernel
// (flash_attention_bwd.cu, pieces shared in flash_common.cuh):
//  * one CTA per (batch, head, 128-query tile): two consumer warpgroups own
//    64 queries each, the producer warpgroup hands its registers to them
//    (setmaxnreg) and one of its threads feeds the ring. q lands once by TMA
//    in 128-byte-swizzled shared memory and stays there for the whole walk;
//    a ring of STAGES stages carries the 128-key tiles of k and v (TMA
//    from 4-D tensor maps over the strided [B, H, S, 64] view) and their
//    seg_kv (bulk copy).
//  * s = q.kT is a wgmma m64n128k16 x 4 with both operands in shared memory
//    (k K-major). The online softmax runs on the accumulator registers in the
//    exp2 domain (ex2.approx.ftz: a few ulp of f32 against the bf16 rounding
//    that follows); p, rounded to bf16, is the register-A fragment of
//    o += p.v as it stands (the accumulator layout of a wgmma is the A
//    fragment of the next), with v read as MN-major B (the transpose bit).
//    A tile's p.v is issued right behind the next tile's q.kT, so the tensor
//    cores run the two back to back and a warpgroup waits once a tile; the
//    two warpgroups take turns to issue (ping-pong on two named barriers),
//    so one's products run under the other's softmax. (Forming the next
//    softmax while p.v runs keeps p live beside s and o: at 128-key tiles
//    that spilled under the 168 registers ptxas gives a thread of this
//    384-thread CTA. 64-key tiles ran slower either way: PERF.md §6.)
//    Where every pair of a tile matches, s is not scaled in place: its max
//    is, and p = 2^(s * scale - m) takes one FFMA.
//  * Key tiles whose id range cannot meet the CTA's query rows are skipped
//    (the rule and its plain model: ops/flash_attention.py::computed_tiles
//    with query tile 128, key tile 128). For a row with a matching key this
//    is exact: every matching key lies in a walked tile, and a skipped tile
//    would add exp2(MASK_VALUE - m) = 0. A row that no key matches must still
//    average v over every key, so after the live tiles the consumers look for
//    a running max at or below the mask value; where a row of the CTA has
//    one, the producer (told through a shared flag and a barrier) streams the
//    skipped tiles too, and both warpgroups walk them. The tiles walked then
//    equal computed_tiles with the forward's own m, the rule the backward
//    kernels follow. Where both tiles hold one and the same id, every pair
//    matches and the id compare is left out. On request
//    (flash_attention_count_tiles) each CTA reports the tiles its producer
//    loaded and its consumers computed, so that the skip is measured in the
//    kernel and held against the plain model.
//  * The accumulator is divided by l once and stored in the [B, S, H, 64]
//    layout the encoder reads. No atomics: a result repeats bit for bit.
// The f32 variant runs on the tensor cores as 3xTF32, as the f32 backward
// kernels do (flash_attention_bwd.cu; the pieces are shared in
// flash_common.cuh): x = hi + lo, hi = x with its low 13 mantissa bits
// cleared, every product a_hi.b_hi + a_hi.b_lo + a_lo.b_hi into one f32
// accumulator (about 2^-20 of |a||b|, where one tf32 product is 2^-11 off).
// Bound: 2 x 3 x 64 x 2 operations a pair at the tf32 rate.
//  * tf32 wgmma reads K-major operands only, so the split pre-pass
//    (split_tf32_kernel) writes q and k as hi / lo row planes and v as hi / lo
//    transposed planes [B*H, 64, S], the keys of each group of 8 permuted
//    0, 2, 4, 6, 1, 3, 5, 7 (perm8), into a scratch the wrapper allocates.
//  * One consumer warpgroup a CTA owns 64 queries; q is register A (hi and
//    lo, 128 registers, loaded once), s = q.kT reads a streamed k tile as B.
//    The online softmax is the bf16 forward's (softmax_tile) on a 64 x 32
//    accumulator; p passes from it as tf32 register A (tf32_frag: values
//    0, 2, 1, 3 of each 4, which the vT planes' permutation matches), split
//    into hi and lo in registers, and p.v reads the vT tile as B into an
//    accumulator of its own that o takes by FMA (o = o * alpha + p.v): o
//    summed in the tensor core over every tile of a 6,500-key row missed the
//    2e-5 bar (2.2e-5 on the card).
//  * 32-key tiles through a 3-stage TMA ring (33 KB a stage), so two CTAs
//    share an SM and one's products run under the other's softmax; thread 0
//    refills a stage after the CTA's barrier at the end of the tile that read
//    it.
//  * The bf16 forward's tile skip at (64, 32) tiles (TILES["fwd f32"]):
//    key tiles whose id range cannot meet the CTA's queries are skipped, and
//    after the live tiles a CTA with a row whose running max is at or below
//    the mask value (a row no key matches) lists and walks the skipped tiles
//    too. The counts of count_tiles cover it.
//
// Built by kernels/build.py with nvcc for sm_90a into a shared library with a
// plain C interface (loaded through ctypes); cuTensorMapEncodeTiled comes from
// the driver (tensor_map.cuh). The entry point returns the cudaError_t of its
// launch.

#include "flash_common.cuh"

namespace {

constexpr float LN2 = 0.6931471805599453f;

// the running max leaves the exp2 domain for the saved residual; a row no key
// matched keeps the mask value itself
__device__ __forceinline__ float natural_max(float m2) {
  return m2 == MASK_VALUE ? MASK_VALUE : m2 * LN2;
}

// ---------------------------------------------------------------- bf16 (tensor cores)

constexpr int KT = 128;                            // keys per streamed tile
constexpr int KT_BYTES = KT * DH * 2;              // 16 KB: a k or v tile
constexpr int FWD_STAGE_BYTES = 2 * KT_BYTES + 1024;  // k, v and their ids, 1,024-aligned
constexpr int FWD_SMEM = OWN_BYTES + STAGES * FWD_STAGE_BYTES + 1024;  // q, the ring, slack to align to 1,024 bytes

// One key tile of the online softmax for this thread's two query rows (ids
// sgq): s, the tile's q.kT accumulator (value 4c + 2hh + e at row 8hh of the
// thread's pair, key 8c + 2 t4 + e), becomes p; the running max m2 (exp2
// domain) and this thread's share l of each row's running sum move on, and
// alpha is the factor that rescales o to the new max. UNIFORM: every pair has
// equal ids, so s is neither masked nor scaled in place: its max scales
// (rounding is monotone, so max(s) * scale is the max of s * scale) and
// p = 2^(s * scale - m2) takes one FFMA.
template <bool UNIFORM, int NV>
__device__ __forceinline__ void softmax_tile(float (&s)[NV], float (&alpha)[2], float (&m2)[2], float (&l)[2],
                                             const int (&sgq)[2], const int* sg_s, int t4, float scale_log2) {
  float mx[2] = {UNIFORM ? -CUDART_INF_F : m2[0], UNIFORM ? -CUDART_INF_F : m2[1]};
#pragma unroll
  for (int c = 0; c < NV / 4; ++c) {
    if constexpr (!UNIFORM) {
      const int2 sg = *reinterpret_cast<const int2*>(sg_s + 8 * c + 2 * t4);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = 4 * c + 2 * hh;
        s[v] = sgq[hh] == sg.x ? s[v] * scale_log2 : MASK_VALUE;
        s[v + 1] = sgq[hh] == sg.y ? s[v + 1] * scale_log2 : MASK_VALUE;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) mx[hh] = fmaxf(mx[hh], fmaxf(s[4 * c + 2 * hh], s[4 * c + 2 * hh + 1]));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // the four threads of a row (lanes 4g .. 4g + 3) share its max
    if constexpr (UNIFORM) mx[hh] = fmaxf(m2[hh], mx[hh] * scale_log2);
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    alpha[hh] = ex2(m2[hh] - mx[hh]);  // 0 on the first tile (m2 = -inf)
    m2[hh] = mx[hh];
  }
#pragma unroll
  for (int c = 0; c < NV / 4; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int v = 4 * c + 2 * hh;
      if constexpr (UNIFORM) {
        s[v] = ex2(fmaf(s[v], scale_log2, -m2[hh]));
        s[v + 1] = ex2(fmaf(s[v + 1], scale_log2, -m2[hh]));
      } else {
        s[v] = ex2(s[v] - m2[hh]);
        s[v + 1] = ex2(s[v + 1] - m2[hh]);
      }
      sum[hh] += s[v] + s[v + 1];
    }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
}

// One key tile of a consumer warpgroup (its 64 queries against the stage's
// KT keys at st): s = q . kT and, issued right behind it unless FIRST, the
// previous tile's o += p . v (p from the registers pa, v from stage prev as
// MN-major B), so the tensor cores run the two back to back and the
// warpgroup waits once. Then the previous stage is released, this tile's
// softmax formed, o rescaled to the new running max and p packed into pa.
// The two warpgroups take turns to issue (named barriers 1 and 2: each
// issues, then lets the other), so one's products run under the other's
// softmax. No branch lies between a product's issue and its wait, so ptxas
// keeps the products asynchronous.
template <bool UNIFORM, bool FIRST>
__device__ __forceinline__ void consume_tile(float (&o)[32], uint32_t (&pa)[KT / 4], float (&m2)[2], float (&l)[2],
                                             const int (&sgq)[2], uint64_t qa, const uint8_t* st,
                                             const uint8_t* prev, uint64_t* prev_empty, int wg, int lane, int t4,
                                             float scale_log2) {
  float s[KT / 2], alpha[2];
  const uint64_t kb = desc_sw128(st), vb = desc_mn_sw128(prev + KT_BYTES);
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");  // this warpgroup's turn to issue
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma<__nv_bfloat16, KT>(s, qa + 2 * kk, kb + 2 * kk, kk > 0);
  wgmma_commit();
  if constexpr (!FIRST) {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) mma_ra<64>(o, pa + 4 * kk, vb + 128 * kk, 1);
    wgmma_commit();
  }
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");  // the other warpgroup's turn
  wgmma_wait<0>();
  fence_regs(s);
  if constexpr (!FIRST) {  // the previous p . v is done: its stage is free, o and pa may be written
    fence_regs(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(prev_empty);
  }
  softmax_tile<UNIFORM>(s, alpha, m2, l, sgq, reinterpret_cast<const int*>(st + 2 * KT_BYTES), t4, scale_log2);
#pragma unroll
  for (int v = 0; v < 32; ++v) o[v] *= alpha[(v >> 1) & 1];
  pack_a(pa, s);
}

// The next tile of walk `walk` after t (0: the live tiles, 1: the skipped
// ones), or n_tiles.
__device__ __forceinline__ int next_walked(const TilePlan& pl, int t, int walk, int n_tiles) {
  do ++t;
  while (t < n_tiles && (pl.live[t] == 0) != (walk == 1));
  return t;
}

// SAVE: also write the row sums l and maxima m ([B, H, S] f32) the backward
// kernels need; the inference instantiation has no such stores.
template <bool SAVE>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, const int* __restrict__ seg_q,
                  const int* __restrict__ seg_kv, __nv_bfloat16* __restrict__ o, float* __restrict__ l_out,
                  float* __restrict__ m_out, int S, Strides so, float scale_log2, int* __restrict__ counts) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* own = align_1024(smem_raw);  // q: the CTA's 128 queries
  uint8_t* ring = own + OWN_BYTES;      // per stage: k tile, v tile, seg_kv
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], own_full, decided;
  __shared__ TilePlan plan;
  __shared__ int second_walk;  // a query row of this CTA met no key in the live tiles

  const int m0 = blockIdx.x * CT, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = S / KT;
  const int* sk_b = seg_kv + (long long)b * S;
  if (threadIdx.x == 0) {
    mbar_init(&decided, CONSUMERS / 32);  // lane 0 of every consumer warp, after the live tiles
    second_walk = 0;
  }
  init_ring(full, 1, empty, &own_full);
  plan_tiles<KT>(plan, sk_b, nullptr, seg_q + (long long)b * S + m0, nullptr, n_tiles);

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: one thread feeds the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(&own_full, OWN_BYTES);
      tma_load_4d(own, &map_q, &own_full, 0, m0, h, b);
      uint32_t n = 0;
      for (int walk = 0; walk < 2; ++walk) {  // the live tiles, then (maybe) the skipped ones
        if (walk == 1) {
          mbar_wait(&decided, 0);
          if (!*reinterpret_cast<volatile int*>(&second_walk)) break;
        }
        for (int t = 0; t < n_tiles; ++t) {
          if ((plan.live[t] == 0) != (walk == 1)) continue;
          const int stage = ring_stage(n);
          mbar_wait(&empty[stage], ring_phase(n) ^ 1);
          uint8_t* st = ring + stage * FWD_STAGE_BYTES;
          mbar_expect_tx(&full[stage], 2 * KT_BYTES + KT * 4);
          tma_load_4d(st, &map_k, &full[stage], 0, t * KT, h, b);
          tma_load_4d(st + KT_BYTES, &map_v, &full[stage], 0, t * KT, h, b);
          bulk_load(st + 2 * KT_BYTES, sk_b + t * KT, KT * 4, &full[stage]);
          ++n;
        }
      }
      report_tiles(counts, 2, n);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, t4 = lane % 4;
  const int row0 = m0 + wg * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;  // this thread's queries: row0, row0 + 8
  const int sgq[2] = {__ldg(seg_q + (long long)b * S + row0), __ldg(seg_q + (long long)b * S + row0 + 8)};
  const uint64_t qa = desc_sw128(own + wg * TILE_BYTES);

  float o_acc[32], m2[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  uint32_t pa[KT / 4];  // the previous tile's p as register A
  zero_acc(o_acc);
  mbar_wait(&own_full, 0);

  // After the live tiles: does a row of the CTA lack a key so far (running max
  // at, or with no tile walked below, the mask value)? Then all walk the
  // skipped tiles too. Every consumer warp asks once.
  auto second = [&]() {
    const bool lost = __any_sync(0xffffffffu, m2[0] <= MASK_VALUE || m2[1] <= MASK_VALUE);
    if (lane == 0) {
      if (lost) atomicOr(&second_walk, 1);
      mbar_arrive(&decided);
    }
    mbar_wait(&decided, 0);
    return *reinterpret_cast<volatile int*>(&second_walk) != 0;
  };
  int walk = 0, t = next_walked(plan, -1, 0, n_tiles);
  if (t == n_tiles && second()) {
    walk = 1;
    t = next_walked(plan, -1, 1, n_tiles);
  }
  if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // warpgroup 0 issues first
  // the first tile, in stage 0: no p . v before it (a CTA walks at least one tile)
  mbar_wait(&full[0], 0);
  if (plan.live[t] == 2) consume_tile<true, true>(o_acc, pa, m2, l, sgq, qa, ring, ring, nullptr, wg, lane, t4, scale_log2);
  else consume_tile<false, true>(o_acc, pa, m2, l, sgq, qa, ring, ring, nullptr, wg, lane, t4, scale_log2);
  const uint8_t* prev = ring;
  uint32_t n = 1;  // tiles walked so far
  for (;; ++n) {
    t = next_walked(plan, t, walk, n_tiles);
    if (t == n_tiles && walk == 0 && second()) {
      walk = 1;
      t = next_walked(plan, -1, 1, n_tiles);
    }
    if (t == n_tiles) break;
    const int stage = ring_stage(n);
    mbar_wait(&full[stage], ring_phase(n));
    const uint8_t* st = ring + stage * FWD_STAGE_BYTES;
    uint64_t* prev_empty = &empty[ring_stage(n - 1)];
    if (plan.live[t] == 2) consume_tile<true, false>(o_acc, pa, m2, l, sgq, qa, st, prev, prev_empty, wg, lane, t4, scale_log2);
    else consume_tile<false, false>(o_acc, pa, m2, l, sgq, qa, st, prev, prev_empty, wg, lane, t4, scale_log2);
    prev = st;
  }
  {  // the last tile's o += p . v (its stage is not released: the producer is done)
    const uint64_t vb = desc_mn_sw128(prev + KT_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) mma_ra<64>(o_acc, pa + 4 * kk, vb + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(pa);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // the four threads of a row hold its sum in shares
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  if (SAVE && t4 == 0) {
    const long long row = ((long long)b * gridDim.y + h) * S + row0;
    l_out[row] = l[0];
    l_out[row + 8] = l[1];
    m_out[row] = natural_max(m2[0]);
    m_out[row + 8] = natural_max(m2[1]);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int v = 0; v < 32; ++v) o_acc[v] *= inv[(v >> 1) & 1];
  store_acc_bf16(o + b * so.b + h * so.h + (long long)row0 * so.s, so.s, o_acc, t4);
  if (threadIdx.x % 128 == 0) report_tiles(counts, wg, n);
}

// ---------------------------------------------------------------- f32 (3xTF32 on the tensor cores)

// One consumer warpgroup a CTA owns 64 queries (q as register A, hi and lo,
// loaded once from the split planes) and streams 32-key tiles: k hi / lo row
// planes and vT hi / lo transposed planes by TMA, with their seg_kv by bulk
// copy. Three stages of 33 KB, so two CTAs share an SM.
constexpr int FWD_F32_STAGES = 3;
constexpr int FWD_F32_STAGE = 4 * F_PLANE + 1024;                    // k hi, k lo, vT hi, vT lo, then seg_kv
constexpr int FWD_F32_SMEM = FWD_F32_STAGES * FWD_F32_STAGE + 1024;  // 102,400 bytes
constexpr int FWD_F32_PLANES = 6;  // scratch: q hi, q lo, k hi, k lo (row planes), vT hi, vT lo (transposed)

struct FwdMaps {
  CUtensorMap k_hi, k_lo;    // row planes, boxes of 32 keys
  CUtensorMap vt_hi, vt_lo;  // transposed planes
};

// Lists the tiles of the plan that its live walk skipped in pl.order (warp 0)
// and returns how many. Ends in __syncthreads.
__device__ __forceinline__ int list_skipped(TilePlanF32& pl, int n_tiles) {
  __shared__ int n_skipped;
  const int tid = threadIdx.x;
  if (tid < 32) {
    int n = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const bool skipped = t0 + tid < n_tiles && !pl.live[t0 + tid];
      const uint32_t ballot = __ballot_sync(0xffffffffu, skipped);
      if (skipped) pl.order[n + __popc(ballot & ((1u << tid) - 1))] = t0 + tid;
      n += __popc(ballot);
    }
    if (tid == 0) n_skipped = n;
  }
  __syncthreads();
  return n_skipped;
}

// SAVE: also write the row sums l and maxima m ([B, H, S] f32).
template <bool SAVE>
__global__ void __launch_bounds__(F_THREADS, 2)
flash_f32_kernel(const __grid_constant__ FwdMaps maps, const float* __restrict__ q_hi, const float* __restrict__ q_lo,
                 const int* __restrict__ seg_q, const int* __restrict__ seg_kv, float* __restrict__ o,
                 float* __restrict__ l_out, float* __restrict__ m_out, int S, Strides so, float scale_log2,
                 int* __restrict__ counts) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  __shared__ __align__(8) uint64_t full[FWD_F32_STAGES];
  __shared__ TilePlanF32 plan;

  const int m0 = blockIdx.x * F_OWN, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = S / F_T, bh = b * gridDim.y + h;
  const int* sk_b = seg_kv + (long long)b * S;
  init_f32_ring(full, FWD_F32_STAGES, nullptr);
  plan_tiles_f32(plan, sk_b, nullptr, seg_q + (long long)b * S + m0, nullptr, n_tiles);
  const int tid = threadIdx.x, lane = tid % 32, t4 = lane % 4;

  uint32_t loaded = 0;  // tiles loaded, over both walks: tile n of the stream sits in stage n % STAGES
  auto load = [&](int t) {  // thread 0: key tile t into the next stage
    const int row = t * F_T;
    uint8_t* st = ring + (loaded % FWD_F32_STAGES) * FWD_F32_STAGE;
    uint64_t* bar = &full[loaded % FWD_F32_STAGES];
    mbar_expect_tx(bar, 4 * F_PLANE + F_T * 4);
    tma_load_4d(st, &maps.k_hi, bar, 0, row, 0, bh);
    tma_load_4d(st + F_PLANE, &maps.k_lo, bar, 0, row, 0, bh);
    tma_load_3d(st + 2 * F_PLANE, &maps.vt_hi, bar, row, 0, bh);
    tma_load_3d(st + 3 * F_PLANE, &maps.vt_lo, bar, row, 0, bh);
    bulk_load(st + 4 * F_PLANE, sk_b + row, F_T * 4, bar);
    ++loaded;
  };
  int n_walk = plan.n_live;
  if (tid == 0)
    for (int j = 0; j < min(FWD_F32_STAGES, n_walk); ++j) load(plan.order[j]);

  const int row0 = m0 + (tid / 32) * 16 + lane / 4;  // this thread's queries: row0, row0 + 8
  const int sgq[2] = {__ldg(seg_q + (long long)b * S + row0), __ldg(seg_q + (long long)b * S + row0 + 8)};
  uint32_t qa_hi[32], qa_lo[32];  // q as register A
  load_frags(qa_hi, q_hi, bh, S, m0);
  load_frags(qa_lo, q_lo, bh, S, m0);

  float o_acc[32], m2[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  uint32_t p_hi[16], p_lo[16];  // p as register A
  zero_acc(o_acc);
  uint32_t n = 0;  // tiles walked
  for (int walk = 0; walk < 2; ++walk) {
    if (walk == 1) {
      // After the live tiles: does a row of the CTA lack a key so far (running
      // max at, or with no tile walked below, the mask value)? Then the CTA
      // walks the skipped tiles too, so that such a row averages v over every key.
      if (!__syncthreads_or(m2[0] <= MASK_VALUE || m2[1] <= MASK_VALUE)) break;
      n_walk = list_skipped(plan, n_tiles);
      if (tid == 0)
        for (int j = 0; j < min(FWD_F32_STAGES, n_walk); ++j) load(plan.order[j]);
    }
    for (int j = 0; j < n_walk; ++j, ++n) {
      const int t = plan.order[j];
      mbar_wait(&full[n % FWD_F32_STAGES], (n / FWD_F32_STAGES) & 1);
      const uint8_t* st = ring + (n % FWD_F32_STAGES) * FWD_F32_STAGE;
      // s = q . kT: 64 queries x 32 keys
      float s[16], alpha[2];
      wgmma_fence();
      mma3_rows_ra(s, qa_hi, qa_lo, desc_sw128(st), desc_sw128(st + F_PLANE));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (plan.live[t] == 2) softmax_tile<true>(s, alpha, m2, l, sgq, reinterpret_cast<const int*>(st + 4 * F_PLANE), t4, scale_log2);
      else softmax_tile<false>(s, alpha, m2, l, sgq, reinterpret_cast<const int*>(st + 4 * F_PLANE), t4, scale_log2);
      // o = o * alpha + p . v: p from the accumulator as tf32 register A (the
      // vT planes permute each group of 8 keys to match), hi and lo split in
      // registers; the tile's products in an accumulator of their own, added
      // to o by FMA, so that o does not take thousands of tensor-core
      // additions over a long row
      tf32_frag(p_hi, p_lo, s);
      float pv[32];
      zero_acc(pv);
      wgmma_fence();
      mma3_ra(pv, p_hi, p_lo, desc_sw128(st + 2 * F_PLANE), desc_sw128(st + 3 * F_PLANE));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
      fence_regs(p_hi);
      fence_regs(p_lo);
#pragma unroll
      for (int v = 0; v < 32; ++v) o_acc[v] = fmaf(o_acc[v], alpha[(v >> 1) & 1], pv[v]);
      __syncthreads();  // every warp is done with the stage
      if (tid == 0 && j + FWD_F32_STAGES < n_walk) load(plan.order[j + FWD_F32_STAGES]);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // the four threads of a row hold its sum in shares
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  if (SAVE && t4 == 0) {
    const long long row = (long long)bh * S + row0;
    l_out[row] = l[0];
    l_out[row + 8] = l[1];
    m_out[row] = natural_max(m2[0]);
    m_out[row + 8] = natural_max(m2[1]);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int v = 0; v < 32; ++v) o_acc[v] *= inv[(v >> 1) & 1];
  store_acc_f32(o + b * so.b + h * so.h + (long long)row0 * so.s, so.s, o_acc, t4);
  if (tid == 0 || tid == 64) report_tiles(counts, tid / 64, n);  // tiles computed, as two warps walked them
  if (tid == 0) report_tiles(counts, 2, loaded);
}

}  // namespace

extern "C" {

// q, k, v, o: [B, H, S, 64] through (batch, head, row) strides in elements, the
// 64 values of a head contiguous and 16-byte aligned; bf16 when is_bf16, else
// f32. seg_q, seg_kv [B, S] i32, contiguous and 16-byte aligned. S a multiple of
// 128 up to 8192 (bf16: q, k, v strides positive). l_out, m_out: [B, H, S] f32,
// contiguous, both given (a differentiated call) or both null (inference).
// scratch: f32 only, flash_attention_f32_planes() x B*H*S*64 f32 for the split
// planes.
int flash_attention_segments(const void* q, const void* k, const void* v, const void* seg_q,
                             const void* seg_kv, void* o, void* l_out, void* m_out, int B, int H,
                             int S, int is_bf16,
                             long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                             long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                             long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                             float sm_scale, void* scratch, void* stream) {
  if (bad_shape(B, H, S) || (l_out == nullptr) != (m_out == nullptr)) return (int)cudaErrorInvalidValue;
  const bool save = l_out != nullptr;
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss}, so{o_sb, o_sh, o_ss};
  const float scale_log2 = sm_scale * LOG2E;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    auto kernel = save ? flash_bf16_kernel<true> : flash_bf16_kernel<false>;
    CUtensorMap maps[3];
    const cudaError_t err =
        prepare_bf16(kernel, FWD_SMEM, {seg_q, seg_kv}, maps, {q, k, v}, {sq, sk, sv}, {CT, KT, KT}, B, H, S);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(S / CT, H, B), TC_THREADS, FWD_SMEM, st>>>(
        maps[0], maps[1], maps[2], (const int*)seg_q, (const int*)seg_kv, (__nv_bfloat16*)o, (float*)l_out,
        (float*)m_out, S, so, scale_log2, tile_counts);
  } else {
    auto kernel = save ? flash_f32_kernel<true> : flash_f32_kernel<false>;
    const cudaError_t err = prepare_f32(kernel, FWD_F32_SMEM, {seg_q, seg_kv}, scratch, B, H, S);
    if (err != cudaSuccess) return (int)err;
    // scratch: the hi and lo row planes of q and k, then the transposed planes of v
    const long long P = (long long)B * H * S * DH;
    float* w = (float*)scratch;
    split_tf32(q, sq, B, H, S, w, w + P, nullptr, nullptr, st);
    split_tf32(k, sk, B, H, S, w + 2 * P, w + 3 * P, nullptr, nullptr, st);
    split_tf32(v, sv, B, H, S, nullptr, nullptr, w + 4 * P, w + 5 * P, st);
    FwdMaps maps;
    const int BH = B * H;
    if (!(row_plane_map(&maps.k_hi, w + 2 * P, BH, S, F_T) && row_plane_map(&maps.k_lo, w + 3 * P, BH, S, F_T) &&
          t_plane_map(&maps.vt_hi, w + 4 * P, BH, S) && t_plane_map(&maps.vt_lo, w + 5 * P, BH, S)))
      return (int)cudaErrorInvalidValue;
    kernel<<<dim3(S / F_OWN, H, B), F_THREADS, FWD_F32_SMEM, st>>>(
        maps, w, w + P, (const int*)seg_q, (const int*)seg_kv, (float*)o, (float*)l_out, (float*)m_out, S, so,
        scale_log2, tile_counts);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a bf16 forward CTA (q and the ring).
int flash_attention_smem() { return FWD_SMEM; }

// Dynamic shared memory of an f32 forward CTA (the ring).
int flash_attention_f32_smem() { return FWD_F32_SMEM; }

// Scratch of an f32 forward launch, in planes of B*H*S*64 f32.
int flash_attention_f32_planes() { return FWD_F32_PLANES; }

// Until called with nullptr, every launch writes, for CTA (b * H + h) * S/R
// + x, the key tiles that it computed (bf16, R = 128: its consumer
// warpgroups 0 and 1; f32, R = 64: its warps 0 and 2) and that it loaded into
// counts[3 * cta .. + 2] (i32 on the device, n values; a launch whose grid
// does not fit fails).
int flash_attention_count_tiles(void* counts, long long n) {
  tile_counts = (int*)counts;
  tile_counts_len = counts == nullptr ? 0 : n;
  return 0;
}

}  // extern "C"
