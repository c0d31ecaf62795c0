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
// f32 variant (CUDA cores, no TF32): one thread per query row, 128 rows per
// CTA, 32-key tiles broadcast from shared memory, online softmax in chunks of
// 8 keys; it walks every key tile.
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

// ---------------------------------------------------------------- f32

constexpr int FM = 128;  // query rows per CTA, one per thread
constexpr int FN = 32;   // keys per tile
constexpr int FC = 8;    // keys per online-softmax step

template <bool SAVE>
__global__ void __launch_bounds__(FM)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ seg_kv, float* __restrict__ o,
                 float* __restrict__ l_out, float* __restrict__ m_out, int S, Strides sq,
                 Strides sk, Strides sv, Strides so, float scale_log2) {
  __shared__ __align__(16) float k_s[FN * DH];
  __shared__ __align__(16) float v_s[FN * DH];
  __shared__ int segk_s[FN];

  const int row = blockIdx.x * FM + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  float qr[DH], acc[DH];
  const float4* qp = reinterpret_cast<const float4*>(q + b * sq.b + h * sq.h + (long long)row * sq.s);
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    const float4 x = __ldg(qp + d);
    qr[4 * d] = x.x;
    qr[4 * d + 1] = x.y;
    qr[4 * d + 2] = x.z;
    qr[4 * d + 3] = x.w;
  }
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  const int my_seg = seg_q[(long long)b * S + row];
  float m_i = -CUDART_INF_F, l_i = 0.f;

  const float* kh = k + b * sk.b + h * sk.h;
  const float* vh = v + b * sv.b + h * sv.h;
  const int* sgk = seg_kv + (long long)b * S;

  for (int n0 = 0; n0 < S; n0 += FN) {
    for (int c = threadIdx.x; c < FN * (DH / 4); c += FM) {
      const int r = c >> 4, col = (c & 15) * 4;
      *reinterpret_cast<float4*>(k_s + r * DH + col) =
          __ldg(reinterpret_cast<const float4*>(kh + (long long)(n0 + r) * sk.s + col));
      *reinterpret_cast<float4*>(v_s + r * DH + col) =
          __ldg(reinterpret_cast<const float4*>(vh + (long long)(n0 + r) * sv.s + col));
    }
    if (threadIdx.x < FN) segk_s[threadIdx.x] = sgk[n0 + threadIdx.x];
    __syncthreads();

    for (int j0 = 0; j0 < FN; j0 += FC) {
      float s[FC];
      float mx = m_i;
#pragma unroll
      for (int j = 0; j < FC; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(k_s + (j0 + j) * DH);
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DH / 4; ++d) {
          const float4 x = kr[d];
          dot = fmaf(qr[4 * d], x.x, dot);
          dot = fmaf(qr[4 * d + 1], x.y, dot);
          dot = fmaf(qr[4 * d + 2], x.z, dot);
          dot = fmaf(qr[4 * d + 3], x.w, dot);
        }
        s[j] = my_seg == segk_s[j0 + j] ? dot * scale_log2 : MASK_VALUE;
        mx = fmaxf(mx, s[j]);
      }
      const float alpha = exp2f(m_i - mx);
      m_i = mx;
      l_i *= alpha;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < FC; ++j) {
        const float p = exp2f(s[j] - mx);
        l_i += p;
        const float4* vr = reinterpret_cast<const float4*>(v_s + (j0 + j) * DH);
#pragma unroll
        for (int d = 0; d < DH / 4; ++d) {
          const float4 x = vr[d];
          acc[4 * d] = fmaf(p, x.x, acc[4 * d]);
          acc[4 * d + 1] = fmaf(p, x.y, acc[4 * d + 1]);
          acc[4 * d + 2] = fmaf(p, x.z, acc[4 * d + 2]);
          acc[4 * d + 3] = fmaf(p, x.w, acc[4 * d + 3]);
        }
      }
    }
    __syncthreads();
  }

  if (SAVE) {
    const long long at = ((long long)b * gridDim.y + h) * S + row;
    l_out[at] = l_i;
    m_out[at] = natural_max(m_i);
  }
  const float inv = 1.f / l_i;
  float4* op = reinterpret_cast<float4*>(o + b * so.b + h * so.h + (long long)row * so.s);
#pragma unroll
  for (int d = 0; d < DH / 4; ++d)
    op[d] = make_float4(acc[4 * d] * inv, acc[4 * d + 1] * inv, acc[4 * d + 2] * inv,
                        acc[4 * d + 3] * inv);
}

}  // namespace

extern "C" {

// q, k, v, o: [B, H, S, 64] through (batch, head, row) strides in elements, the
// 64 values of a head contiguous and 16-byte aligned; bf16 when is_bf16, else
// f32. seg_q, seg_kv [B, S] i32, contiguous (16-byte aligned for bf16). S a
// multiple of 128 (bf16: up to 8192, q, k, v strides positive). l_out, m_out:
// [B, H, S] f32, contiguous, both given (a differentiated call) or both null
// (inference).
int flash_attention_segments(const void* q, const void* k, const void* v, const void* seg_q,
                             const void* seg_kv, void* o, void* l_out, void* m_out, int B, int H,
                             int S, int is_bf16,
                             long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                             long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                             long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                             float sm_scale, void* stream) {
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
    kernel<<<dim3(S / FM, H, B), FM, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)seg_q, (const int*)seg_kv,
        (float*)o, (float*)l_out, (float*)m_out, S, sq, sk, sv, so, scale_log2);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a bf16 forward CTA (q and the ring).
int flash_attention_smem() { return FWD_SMEM; }

// Until called with nullptr, every bf16 launch writes, for CTA
// (b * H + h) * S/128 + x, the key tiles that its consumer warpgroups 0 and 1
// computed and that its producer loaded into counts[3 * cta .. + 2] (i32 on
// the device, n values; a launch whose grid does not fit fails).
int flash_attention_count_tiles(void* counts, long long n) {
  tile_counts = (int*)counts;
  tile_counts_len = counts == nullptr ? 0 : n;
  return 0;
}

}  // extern "C"
