// Flash attention with segment ids, backward pass: the two kernels behind the
// gradient of every encoder row of S >= flash_min_len (training on packed rows
// and long inputs).
//
// Replaces the two backward TPU kernels of the JAX library
// (jax.experimental.pallas.ops.tpu.flash_attention: _flash_attention_dkv_kernel
// and _flash_attention_dq_kernel), which jax.grad reaches through the call at
// intool_rag_tpu/models/encoder.py:138 (SelfAttention).
//
// Contract (what those kernels compute). q, k, v, do [B, H, S, 64]; seg_q and
// seg_kv [B, S] i32; l, m, di [B, H, S] f32, where l and m are the forward's
// row sum and row max (m in the natural-exponent domain, the mask value itself
// for a row no key matches) and di = sum_d o * do. For every (b, h):
//   s_ij  = (q_i . k_j) * sm_scale     where seg_q[b, i] == seg_kv[b, j]
//   p_ij  = exp(s_ij - m_i) / l_i      there; elsewhere exp(mask - m_i) / l_i,
//           which is 0, or 1 / l_i on a row no key matches (m_i = mask)
//   dv_j  = sum_i p_ij * do_i
//   ds_ij = (do_i . v_j - di_i) * p_ij * sm_scale
//   dk_j  = sum_i ds_ij * q_i          (dkv kernel: dk and dv)
//   dq_i  = sum_j ds_ij * k_j          (dq kernel)
// p and ds are rounded to the input type in front of their second products, as
// in the library; every sum is f32. No [S, S] tensor exists anywhere: p is
// recomputed tile by tile from l and m. Nothing is summed across CTAs and
// every output element is written by one CTA, so there are no atomics and a
// result repeats bit for bit.
//
// The tensors are read through their (batch, head, row) strides and the
// gradients are written through theirs, so the encoder's [B, S, H*64] layout
// is used as it is on both sides.
//
// What bounds them on an H100: operations. Per head and per pair of equal
// id, dkv does 8 x 64 (k.qT, v.doT, pT.do, dsT.q) and dq 6 x 64 (q.kT,
// do.vT, ds.k) against 6 x 64 values moved per row. At a head width of 64
// the exponentials and the masking cost about as many instruction slots as the
// tensor cores take for the products, and an m64n64k16 wgmma with both
// operands in shared memory reads as many bytes a cycle as shared memory
// gives. The bf16 variants are built for the tensor cores and for doing no
// work that the ids rule out:
//  * dkv: one CTA per (batch, head, 128-key tile). Two consumer warpgroups
//    own 64 keys each; the producer warpgroup hands its registers to them
//    (setmaxnreg 56 / 224) and its first warp feeds the ring. The k and v
//    tiles land once by TMA in 128-byte-swizzled shared memory; a ring of
//    STAGES stages carries the 64-query tiles of q and do (TMA from a 4-D
//    tensor map over the strided [B, H, S, 64] view: dims (64, S, H, B))
//    and the tile's m * log2(e), 1 / l, di, the mask's p (1 on a row no key
//    matches) and seg_q, which the producer warp loads one tile ahead and
//    writes itself, so no consumer divides. Per stage sT = k.qT and
//    dpT = v.doT are wgmma m64n64k16 x 4 with A = k / v and B = q / do, all
//    K-major in shared memory. pT is formed in the accumulator registers
//    while dpT is still running and rounded to bf16; the accumulator layout
//    of an m64n64 wgmma is the register-A fragment of the next, so it is the
//    A operand of dv += pT.do as it is, started before dsT is formed; dsT
//    then feeds dk += dsT.q the same way, and those two products run on
//    under the next tile's first products. p and ds never touch shared
//    memory; do and q are read as MN-major B (the transpose bit) from the
//    buffers that were K-major B a moment before.
//  * dq: one CTA per (batch, head, 128-query tile). q and do are resident
//    A operands (64 queries per consumer warpgroup); the ring carries the
//    64-key tiles of k and v with their seg_kv (bulk copy). s = q.kT and
//    dp = do.vT read K-major B; p is formed while dp runs; ds, rounded to
//    bf16 in registers, is the A of dq += ds.k, which reads k as MN-major B.
//  * Tiles whose segments cannot meet are skipped (the rule and its plain
//    model: ops/flash_attention.py::computed_tiles). Before the ring starts,
//    the CTA reduces the [min, max] id of each streamed 64-row tile and of
//    its own 128 rows; a streamed tile is computed unless the two ranges are
//    disjoint and no query row of either is a row no key matches
//    (m == mask value, where p = 1/l on every key). A skipped tile costs no
//    copy and no wgmma; its p and ds are exactly 0. The producer and the
//    consumers walk the same list, and a CTA that skips every tile writes
//    zeros. Where both ranges are one and the same id, every pair matches
//    and p is formed without the id compare. On request
//    (flash_attention_bwd_count_tiles) each CTA reports the tiles that its
//    producer loaded and its consumers computed, so that the skip is
//    measured in the kernel and held against the plain model.
//  * exp2 is ex2.approx.ftz on the special-function unit: a few ulp of f32
//    against the bf16 rounding that follows.
// p and ds are formed once in each kernel (twice in all): one pass would have
// to add dq across key-tile CTAs, which takes atomics or a scratch of partial
// sums.
// The f32 variants run on the tensor cores as 3xTF32, the way K1 f32 does:
// each operand splits as x = hi + lo, hi = x with its low 13 mantissa bits
// cleared (a tf32 value), lo = x - hi (exact; the tensor cores read it as
// tf32), and every product is a_hi.b_hi + a_hi.b_lo + a_lo.b_hi into one f32
// accumulator: about 2^-20 of |a||b| a product, where a single tf32 product
// is 2^-11 off. Three m64nNk8 tf32 wgmma per k-step of 8, so the tensor-core
// work per pair of equal id is 3 x 8 x 64 (dkv) and 3 x 6 x 64 (dq).
//  * tf32 wgmma takes K-major operands only (the transpose bit is for 16-bit
//    types), and the second products run along the streamed rows: dkv reads
//    q and do, dq reads k, both row-major (first products) and transposed
//    (second). A pre-pass (split_tf32_kernel, one launch per operand, on the
//    caller's stream) writes each operand's hi and lo once per call: row
//    planes [B*H, 2, S, 32] (the head's two halves of 32 values, one 128-byte
//    swizzle row each) and, for q, do (dkv) and k (dq), transposed planes
//    [B*H, 64, S]. The wrapper passes the scratch (12 or 10 planes).
//  * p and ds go from the accumulator registers to the next wgmma as tf32
//    register A. In an f32 accumulator a thread holds columns 2 t4 and
//    2 t4 + 1 of each 8; a tf32 k8 A fragment holds columns t4 and t4 + 4. So
//    the transposed planes permute the rows of each group of 8 (position f
//    holds row 0, 2, 4, 6, 1, 3, 5, 7) and the fragment is the accumulator's
//    values in the order 0, 2, 1, 3 (tf32_frag), split into hi and lo in
//    registers. p and ds never touch shared memory.
//  * At f32 with hi and lo planes the bf16 geometry does not fit in shared
//    memory, so a CTA is one consumer warpgroup that owns 64 rows (dkv:
//    keys, dq: queries) and streams 32-row tiles of the other side through a
//    TMA ring: dkv 1 stage of 64 KB (q / do rows and transposed, with m, l,
//    di and seg_q by bulk copy), dq 2 stages of 48 KB (k / v rows and kT,
//    with seg_kv). The own rows are register A of the first products where
//    the registers allow (dq: q and do, 128 registers; dkv: v, 64), loaded
//    once from the row planes; dkv's k lands by TMA (32 KB). So a CTA takes
//    about 100 KB and two fit an SM: one's products run while the other
//    forms p and ds, the overlap a single warpgroup cannot give itself (one
//    CTA an SM with 2-3 stages measured 1.4x slower). Thread 0 issues
//    the copies; a stage is refilled after the CTA's barrier at the end of
//    the tile that read it. The bf16 kernels' tile skip holds at these tiles
//    (ops/flash_attention.py::TILES "dkv f32" (32, 64), "dq f32" (64, 32)),
//    rows no key matches included; the live tiles are listed once per CTA.
//
// Built by kernels/build.py with nvcc for sm_90a into a shared library with a
// plain C interface (loaded through ctypes); cuTensorMapEncodeTiled comes from
// the driver (tensor_map.cuh). Each entry point returns the cudaError_t of its
// launch.

#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------- bf16 (tensor cores)

// geometry, tile plan, ring and tile counts: flash_common.cuh
constexpr int BWD_SMEM = 2 * OWN_BYTES + STAGES * STAGE_BYTES + 1024;  // + slack to align to 1,024 bytes

// Rows i and i + 1 of (b, h): m, l, di and seg_q (stat: the offset of (b, h)).
__device__ __forceinline__ void load_row_stats(const float* m, const float* l, const float* di, const int* seg,
                                               long long stat, int i, float2& mm, float2& ll, float2& dd, int2& sg) {
  mm = __ldg(reinterpret_cast<const float2*>(m + stat + i));
  ll = __ldg(reinterpret_cast<const float2*>(l + stat + i));
  dd = __ldg(reinterpret_cast<const float2*>(di + stat + i));
  sg = __ldg(reinterpret_cast<const int2*>(seg + i));
}

// dkv: pT in place of sT for this thread's keys (ids sgk) against the stage's
// 64 queries (column 8c + 2 t4 + e). UNIFORM: every pair has equal ids.
template <bool UNIFORM>
__device__ __forceinline__ void form_pT(float (&s)[32], const int (&sgk)[2], const float* m2_s, const float* il_s,
                                        const float* pm_s, const int* sg_s, int t4, float scale_log2) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * t4;
    const float2 m2 = *reinterpret_cast<const float2*>(m2_s + col);
    const float2 il = *reinterpret_cast<const float2*>(il_s + col);
    if constexpr (UNIFORM) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = 4 * c + 2 * hh;
        s[v] = ex2(s[v] * scale_log2 - m2.x) * il.x;
        s[v + 1] = ex2(s[v + 1] * scale_log2 - m2.y) * il.y;
      }
    } else {
      const int2 sg = *reinterpret_cast<const int2*>(sg_s + col);
      const float2 pm = *reinterpret_cast<const float2*>(pm_s + col);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = 4 * c + 2 * hh;
        s[v] = (sgk[hh] == sg.x ? ex2(s[v] * scale_log2 - m2.x) : pm.x) * il.x;
        s[v + 1] = (sgk[hh] == sg.y ? ex2(s[v + 1] * scale_log2 - m2.y) : pm.y) * il.y;
      }
    }
  }
}

// dq: p in place of s for this thread's queries (ids sgq, row statistics m2,
// pm, il) against the stage's NV / 2 keys (column 8c + 2 t4 + e).
template <bool UNIFORM, int NV>
__device__ __forceinline__ void form_p(float (&s)[NV], const int (&sgq)[2], const float (&m2)[2],
                                       const float (&pm)[2], const float (&il)[2], const int* sg_s, int t4,
                                       float scale_log2) {
#pragma unroll
  for (int c = 0; c < NV / 4; ++c) {
    if constexpr (UNIFORM) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = 4 * c + 2 * hh;
        s[v] = ex2(s[v] * scale_log2 - m2[hh]) * il[hh];
        s[v + 1] = ex2(s[v + 1] * scale_log2 - m2[hh]) * il[hh];
      }
    } else {
      const int2 sg = *reinterpret_cast<const int2*>(sg_s + 8 * c + 2 * t4);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = 4 * c + 2 * hh;
        s[v] = (sgq[hh] == sg.x ? ex2(s[v] * scale_log2 - m2[hh]) : pm[hh]) * il[hh];
        s[v + 1] = (sgq[hh] == sg.y ? ex2(s[v + 1] * scale_log2 - m2[hh]) : pm[hh]) * il[hh];
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 dkv

__global__ void __launch_bounds__(TC_THREADS, 1)
flash_dkv_bf16_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                      const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                      const float* __restrict__ l, const float* __restrict__ m, const float* __restrict__ di,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, Strides sdk,
                      Strides sdv, float scale_log2, float sm_scale, int* __restrict__ counts) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* own = align_1024(smem_raw);  // k, then v: 128 keys each
  uint8_t* ring = own + 2 * OWN_BYTES;  // per stage: q tile, do tile, then m2, 1/l, di, pmask, seg_q
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], own_full;
  __shared__ TilePlan plan;

  const int n0 = blockIdx.x * CT, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = S / BT;
  const long long stat = ((long long)b * gridDim.y + h) * S;  // row statistics of (b, h)
  const int* sq_b = seg_q + (long long)b * S;
  init_ring(full, 32, empty, &own_full);  // full: the producer warp's 32 lanes (lane 0 with the TMA bytes)
  plan_tiles(plan, sq_b, m + stat, seg_kv + (long long)b * S + n0, nullptr, n_tiles);

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup: its first warp feeds the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < CONSUMERS + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(&own_full, 2 * OWN_BYTES);
        tma_load_4d(own, &map_k, &own_full, 0, n0, h, b);
        tma_load_4d(own + OWN_BYTES, &map_v, &own_full, 0, n0, h, b);
      }
      // lane i prepares queries 2i and 2i + 1 of each tile: their statistics
      // are loaded one tile ahead, before the wait for a free stage
      int t = next_live(plan, 0, n_tiles);
      float2 mm, ll, dd;
      int2 sg;
      if (t < n_tiles) load_row_stats(m, l, di, sq_b, stat, t * BT + 2 * lane, mm, ll, dd, sg);
      uint32_t n = 0;
      while (t < n_tiles) {
        const int stage = ring_stage(n);
        mbar_wait(&empty[stage], ring_phase(n) ^ 1);
        uint8_t* st = ring + stage * STAGE_BYTES;
        float* vec = reinterpret_cast<float*>(st + 2 * TILE_BYTES) + 2 * lane;
        *reinterpret_cast<float2*>(vec) = make_float2(mm.x * LOG2E, mm.y * LOG2E);
        *reinterpret_cast<float2*>(vec + BT) = make_float2(1.f / ll.x, 1.f / ll.y);
        *reinterpret_cast<float2*>(vec + 2 * BT) = dd;
        *reinterpret_cast<float2*>(vec + 3 * BT) =
            make_float2(mm.x == MASK_VALUE ? 1.f : 0.f, mm.y == MASK_VALUE ? 1.f : 0.f);
        *reinterpret_cast<int2*>(vec + 4 * BT) = sg;
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 2 * TILE_BYTES);
          tma_load_4d(st, &map_q, &full[stage], 0, t * BT, h, b);
          tma_load_4d(st + TILE_BYTES, &map_do, &full[stage], 0, t * BT, h, b);
        } else {
          mbar_arrive(&full[stage]);
        }
        ++n;
        t = next_live(plan, t + 1, n_tiles);
        if (t < n_tiles) load_row_stats(m, l, di, sq_b, stat, t * BT + 2 * lane, mm, ll, dd, sg);
      }
      if (lane == 0) report_tiles(counts, 2, n);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, t4 = lane % 4;
  const int key0 = n0 + wg * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;  // this thread's keys: key0, key0 + 8
  const int sgk[2] = {__ldg(seg_kv + (long long)b * S + key0), __ldg(seg_kv + (long long)b * S + key0 + 8)};
  const uint64_t ka = desc_sw128(own + wg * TILE_BYTES);
  const uint64_t va = desc_sw128(own + OWN_BYTES + wg * TILE_BYTES);

  float dk_acc[32], dv_acc[32];
  uint32_t pa[16], dsa[16];  // pT and dsT as register A; in flight until the next tile's first wait
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  mbar_wait(&own_full, 0);
  uint32_t n = 0;  // live tiles done so far
  for (int t = 0; t < n_tiles; ++t) {
    if (!plan.live[t]) continue;
    const int stage = ring_stage(n);
    mbar_wait(&full[stage], ring_phase(n));
    const uint8_t* st = ring + stage * STAGE_BYTES;
    const float* m2_s = reinterpret_cast<const float*>(st + 2 * TILE_BYTES);
    const float* il_s = m2_s + BT;
    const float* di_s = m2_s + 2 * BT;
    const float* pm_s = m2_s + 3 * BT;
    const int* sg_s = reinterpret_cast<const int*>(m2_s + 4 * BT);

    // sT = k . qT and dpT = v . doT: this warpgroup's 64 keys x 64 queries
    float s[32], dp[32];
    const uint64_t qb = desc_sw128(st), dob = desc_sw128(st + TILE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma<__nv_bfloat16, 64>(s, ka + 2 * kk, qb + 2 * kk, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma<__nv_bfloat16, 64>(dp, va + 2 * kk, dob + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's second products and sT are done; dpT runs on
    fence_regs(s);
    fence_regs(pa);
    fence_regs(dsa);
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    if (n > 0 && lane == 0) mbar_arrive(&empty[ring_stage(n - 1)]);  // the stage those products read

    // pT in s
    if (plan.live[t] == 2) form_pT<true>(s, sgk, m2_s, il_s, pm_s, sg_s, t4, scale_log2);
    else form_pT<false>(s, sgk, m2_s, il_s, pm_s, sg_s, t4, scale_log2);
    pack_a(pa, s);

    // dv += pT . do: A from registers, do as MN-major B; it runs while dsT is formed
    const uint64_t dob_mn = desc_mn_sw128(st + TILE_BYTES), qb_mn = desc_mn_sw128(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ra<64>(dv_acc, pa + 4 * kk, dob_mn + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait<1>();  // dpT is done
    fence_regs(dp);

    // dsT in dp
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 dd = *reinterpret_cast<const float2*>(di_s + 8 * c + 2 * t4);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = 4 * c + 2 * hh;
        dp[v] = (dp[v] - dd.x) * s[v] * sm_scale;
        dp[v + 1] = (dp[v + 1] - dd.y) * s[v + 1] * sm_scale;
      }
    }
    pack_a(dsa, dp);

    // dk += dsT . q: q as MN-major B; it runs on under the next tile's first products
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ra<64>(dk_acc, dsa + 4 * kk, qb_mn + 128 * kk, 1);
    wgmma_commit();
    ++n;
  }
  wgmma_wait<0>();
  fence_regs(dk_acc);
  fence_regs(dv_acc);
  fence_regs(pa);
  fence_regs(dsa);

  store_acc_bf16(dk + b * sdk.b + h * sdk.h + (long long)key0 * sdk.s, sdk.s, dk_acc, t4);
  store_acc_bf16(dv + b * sdv.b + h * sdv.h + (long long)key0 * sdv.s, sdv.s, dv_acc, t4);
  if (threadIdx.x % 128 == 0) report_tiles(counts, threadIdx.x / 128, n);
}

// ---------------------------------------------------------------- bf16 dq

__global__ void __launch_bounds__(TC_THREADS, 1)
flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                     const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                     const float* __restrict__ l, const float* __restrict__ m, const float* __restrict__ di,
                     __nv_bfloat16* __restrict__ dq, int S, Strides sdq, float scale_log2, float sm_scale,
                     int* __restrict__ counts) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* own = align_1024(smem_raw);  // q, then do: 128 queries each
  uint8_t* ring = own + 2 * OWN_BYTES;  // per stage: k tile, v tile, seg_kv
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], own_full;
  __shared__ TilePlan plan;

  const int m0 = blockIdx.x * CT, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = S / BT;
  const long long stat = ((long long)b * gridDim.y + h) * S;
  const int* sk_b = seg_kv + (long long)b * S;
  init_ring(full, 1, empty, &own_full);
  plan_tiles(plan, sk_b, nullptr, seg_q + (long long)b * S + m0, m + stat + m0, n_tiles);

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(&own_full, 2 * OWN_BYTES);
      tma_load_4d(own, &map_q, &own_full, 0, m0, h, b);
      tma_load_4d(own + OWN_BYTES, &map_do, &own_full, 0, m0, h, b);
      uint32_t n = 0;
      for (int t = 0; t < n_tiles; ++t) {
        if (!plan.live[t]) continue;
        const int stage = ring_stage(n);
        mbar_wait(&empty[stage], ring_phase(n) ^ 1);
        uint8_t* st = ring + stage * STAGE_BYTES;
        mbar_expect_tx(&full[stage], 2 * TILE_BYTES + STATS_BYTES);
        tma_load_4d(st, &map_k, &full[stage], 0, t * BT, h, b);
        tma_load_4d(st + TILE_BYTES, &map_v, &full[stage], 0, t * BT, h, b);
        bulk_load(st + 2 * TILE_BYTES, sk_b + t * BT, STATS_BYTES, &full[stage]);
        ++n;
      }
      report_tiles(counts, 2, n);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, t4 = lane % 4;
  const int row0 = m0 + wg * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;  // this thread's queries: row0, row0 + 8
  int sgq[2];
  float m2[2], pm[2], il[2], dii[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row0 + 8 * hh;
    const float mi = __ldg(m + stat + i);
    sgq[hh] = __ldg(seg_q + (long long)b * S + i);
    m2[hh] = mi * LOG2E;
    pm[hh] = mi == MASK_VALUE ? 1.f : 0.f;
    il[hh] = 1.f / __ldg(l + stat + i);
    dii[hh] = __ldg(di + stat + i);
  }
  const uint64_t qa = desc_sw128(own + wg * TILE_BYTES);
  const uint64_t doa = desc_sw128(own + OWN_BYTES + wg * TILE_BYTES);

  float dq_acc[32];
  uint32_t dsa[16];  // ds as register A
  zero_acc(dq_acc);
  mbar_wait(&own_full, 0);
  uint32_t n = 0;  // live tiles done so far
  for (int t = 0; t < n_tiles; ++t) {
    if (!plan.live[t]) continue;
    const int stage = ring_stage(n);
    mbar_wait(&full[stage], ring_phase(n));
    const uint8_t* st = ring + stage * STAGE_BYTES;
    const int* sg_s = reinterpret_cast<const int*>(st + 2 * TILE_BYTES);

    // s = q . kT and dp = do . vT: this warpgroup's 64 queries x 64 keys
    float s[32], dp[32];
    const uint64_t kb = desc_sw128(st), vb = desc_sw128(st + TILE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma<__nv_bfloat16, 64>(s, qa + 2 * kk, kb + 2 * kk, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma<__nv_bfloat16, 64>(dp, doa + 2 * kk, vb + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // s is done; dp runs on
    fence_regs(s);

    // p in s
    if (plan.live[t] == 2) form_p<true>(s, sgq, m2, pm, il, sg_s, t4, scale_log2);
    else form_p<false>(s, sgq, m2, pm, il, sg_s, t4, scale_log2);
    wgmma_wait<0>();  // dp is done
    fence_regs(dp);

    // ds in dp
#pragma unroll
    for (int v = 0; v < 32; ++v) dp[v] = (dp[v] - dii[(v >> 1) & 1]) * s[v] * sm_scale;
    pack_a(dsa, dp);

    // dq += ds . k: A from registers, k as MN-major B. Waiting for it here,
    // not under the next tile's first products, measured faster.
    const uint64_t kb_mn = desc_mn_sw128(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ra<64>(dq_acc, dsa + 4 * kk, kb_mn + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(dsa);
    if (lane == 0) mbar_arrive(&empty[stage]);
    ++n;
  }

  store_acc_bf16(dq + b * sdq.b + h * sdq.h + (long long)row0 * sdq.s, sdq.s, dq_acc, t4);
  if (threadIdx.x % 128 == 0) report_tiles(counts, threadIdx.x / 128, n);
}

// ---------------------------------------------------------------- f32 (3xTF32 on the tensor cores)

constexpr int DQ_STAGES = 2;
constexpr int DKV_STAGES = 1;
// dq stage: k hi, k lo, v hi, v lo (row planes), kT hi, kT lo, then seg_kv.
// dkv stage: q hi, q lo, do hi, do lo (row planes), qT hi, qT lo, doT hi, doT
// lo, then m, l, di and seg_q. Each is 1,024-aligned. The own rows of dq (q,
// do) and of dkv's v are register A; dkv's k (hi, lo) lands in shared memory.
// Two CTAs fit an SM, so one's products run under the other's softmax.
constexpr int DQ_STAGE = 6 * F_PLANE + 1024;
constexpr int DKV_STAGE = 8 * F_PLANE + 1024;
constexpr int DQ_SMEM = DQ_STAGES * DQ_STAGE + 1024;                       // 101,376 bytes
constexpr int DKV_SMEM = 2 * F_OWN_PLANE + DKV_STAGES * DKV_STAGE + 1024;  // 100,352 bytes

// acc (64 x 32) = a . bT over the head's 64 values in 3xTF32
// (a_hi.b_hi + a_hi.b_lo + a_lo.b_hi): A the CTA's own row planes, B a
// streamed tile's.
__device__ __forceinline__ void mma3_rows(float (&acc)[16], uint64_t a_hi, uint64_t a_lo, uint64_t b_hi,
                                          uint64_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < DH / 8; ++kk) {
    const uint64_t ah = row_step(a_hi, kk, F_OWN_HALF), al = row_step(a_lo, kk, F_OWN_HALF);
    const uint64_t bh = row_step(b_hi, kk, F_HALF), bl = row_step(b_lo, kk, F_HALF);
    mma<float, F_T>(acc, ah, bh, kk > 0);
    mma<float, F_T>(acc, ah, bl, 1);
    mma<float, F_T>(acc, al, bh, 1);
  }
}

// dkv: pT in place of sT for this thread's keys (ids sgk) against a stage's
// 32 queries (column 8c + 2 t4 + e), from the stage's raw m and l.
template <bool UNIFORM>
__device__ __forceinline__ void form_pT_f32(float (&s)[16], const int (&sgk)[2], const float* m_s, const float* l_s,
                                            const int* sg_s, int t4, float scale_log2) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col = 8 * c + 2 * t4;
    const float2 mm = *reinterpret_cast<const float2*>(m_s + col);
    const float2 ll = *reinterpret_cast<const float2*>(l_s + col);
    const float m2x = mm.x * LOG2E, m2y = mm.y * LOG2E, ilx = 1.f / ll.x, ily = 1.f / ll.y;
    if constexpr (UNIFORM) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = 4 * c + 2 * hh;
        s[v] = ex2(s[v] * scale_log2 - m2x) * ilx;
        s[v + 1] = ex2(s[v + 1] * scale_log2 - m2y) * ily;
      }
    } else {
      const int2 sg = *reinterpret_cast<const int2*>(sg_s + col);
      const float pmx = mm.x == MASK_VALUE ? 1.f : 0.f, pmy = mm.y == MASK_VALUE ? 1.f : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = 4 * c + 2 * hh;
        s[v] = (sgk[hh] == sg.x ? ex2(s[v] * scale_log2 - m2x) : pmx) * ilx;
        s[v + 1] = (sgk[hh] == sg.y ? ex2(s[v + 1] * scale_log2 - m2y) : pmy) * ily;
      }
    }
  }
}

struct DkvMaps {
  CUtensorMap k_hi, k_lo;                                  // own row planes, boxes of 64 rows
  CUtensorMap q_hi, q_lo, do_hi, do_lo;                    // streamed row planes, boxes of 32 rows
  CUtensorMap qt_hi, qt_lo, dot_hi, dot_lo;                // transposed planes
};

struct DqMaps {
  CUtensorMap k_hi, k_lo, v_hi, v_lo;                      // streamed row planes
  CUtensorMap kt_hi, kt_lo;                                // transposed planes
};

// ---------------------------------------------------------------- f32 dkv

__global__ void __launch_bounds__(F_THREADS, 2)
flash_dkv_f32_kernel(const __grid_constant__ DkvMaps maps, const float* __restrict__ v_hi,
                     const float* __restrict__ v_lo, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, const float* __restrict__ l, const float* __restrict__ m,
                     const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv, int S,
                     Strides sdk, Strides sdv, float scale_log2, float sm_scale, int* __restrict__ counts) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* own = align_1024(smem_raw);   // k hi, k lo: 64 keys each
  uint8_t* ring = own + 2 * F_OWN_PLANE;
  __shared__ __align__(8) uint64_t full[DKV_STAGES], own_full;
  __shared__ TilePlanF32 plan;

  const int n0 = blockIdx.x * F_OWN, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = S / F_T, bh = b * gridDim.y + h;
  const long long stat = (long long)bh * S;  // row statistics of (b, h)
  const int* sq_b = seg_q + (long long)b * S;
  init_f32_ring(full, DKV_STAGES, &own_full);
  plan_tiles_f32(plan, sq_b, m + stat, seg_kv + (long long)b * S + n0, nullptr, n_tiles);
  const int n_live = plan.n_live;
  const int tid = threadIdx.x, lane = tid % 32, t4 = lane % 4;

  int loaded = 0;
  auto load = [&](int j) {  // thread 0: the j-th live query tile into its stage
    const int t = plan.order[j], row = t * F_T;
    uint8_t* st = ring + (j % DKV_STAGES) * DKV_STAGE;
    uint64_t* bar = &full[j % DKV_STAGES];
    mbar_expect_tx(bar, 8 * F_PLANE + 4 * F_T * 4);
    tma_load_4d(st, &maps.q_hi, bar, 0, row, 0, bh);
    tma_load_4d(st + F_PLANE, &maps.q_lo, bar, 0, row, 0, bh);
    tma_load_4d(st + 2 * F_PLANE, &maps.do_hi, bar, 0, row, 0, bh);
    tma_load_4d(st + 3 * F_PLANE, &maps.do_lo, bar, 0, row, 0, bh);
    tma_load_3d(st + 4 * F_PLANE, &maps.qt_hi, bar, row, 0, bh);
    tma_load_3d(st + 5 * F_PLANE, &maps.qt_lo, bar, row, 0, bh);
    tma_load_3d(st + 6 * F_PLANE, &maps.dot_hi, bar, row, 0, bh);
    tma_load_3d(st + 7 * F_PLANE, &maps.dot_lo, bar, row, 0, bh);
    uint8_t* vec = st + 8 * F_PLANE;
    bulk_load(vec, m + stat + row, F_T * 4, bar);
    bulk_load(vec + F_T * 4, l + stat + row, F_T * 4, bar);
    bulk_load(vec + 2 * F_T * 4, di + stat + row, F_T * 4, bar);
    bulk_load(vec + 3 * F_T * 4, sq_b + row, F_T * 4, bar);
    ++loaded;
  };
  if (tid == 0) {
    mbar_expect_tx(&own_full, 2 * F_OWN_PLANE);
    tma_load_4d(own, &maps.k_hi, &own_full, 0, n0, 0, bh);
    tma_load_4d(own + F_OWN_PLANE, &maps.k_lo, &own_full, 0, n0, 0, bh);
    for (int j = 0; j < min(DKV_STAGES, n_live); ++j) load(j);
  }

  const int key0 = n0 + (tid / 32) * 16 + lane / 4;  // this thread's keys: key0, key0 + 8
  const int sgk[2] = {__ldg(seg_kv + (long long)b * S + key0), __ldg(seg_kv + (long long)b * S + key0 + 8)};
  const uint64_t kh = desc_sw128(own), kl = desc_sw128(own + F_OWN_PLANE);
  uint32_t va_hi[32], va_lo[32];  // v as register A
  load_frags(va_hi, v_hi, bh, S, n0);
  load_frags(va_lo, v_lo, bh, S, n0);

  float dk_acc[32], dv_acc[32];
  uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];  // pT and dsT as register A
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  mbar_wait(&own_full, 0);
  for (int j = 0; j < n_live; ++j) {
    const int stage = j % DKV_STAGES;
    mbar_wait(&full[stage], (j / DKV_STAGES) & 1);
    const uint8_t* st = ring + stage * DKV_STAGE;
    const float* m_s = reinterpret_cast<const float*>(st + 8 * F_PLANE);
    const float* l_s = m_s + F_T;
    const float* di_s = m_s + 2 * F_T;
    const int* sg_s = reinterpret_cast<const int*>(m_s + 3 * F_T);

    // sT = k . qT and dpT = v . doT: 64 keys x 32 queries
    float s[16], dp[16];
    wgmma_fence();
    mma3_rows(s, kh, kl, desc_sw128(st), desc_sw128(st + F_PLANE));
    wgmma_commit();
    mma3_rows_ra(dp, va_hi, va_lo, desc_sw128(st + 2 * F_PLANE), desc_sw128(st + 3 * F_PLANE));
    wgmma_commit();
    wgmma_wait<1>();  // sT is done; dpT runs on
    fence_regs(s);

    // pT in s; dv += pT . do runs while dsT is formed
    if (plan.live[plan.order[j]] == 2) form_pT_f32<true>(s, sgk, m_s, l_s, sg_s, t4, scale_log2);
    else form_pT_f32<false>(s, sgk, m_s, l_s, sg_s, t4, scale_log2);
    tf32_frag(p_hi, p_lo, s);
    wgmma_fence();
    mma3_ra(dv_acc, p_hi, p_lo, desc_sw128(st + 6 * F_PLANE), desc_sw128(st + 7 * F_PLANE));
    wgmma_commit();
    wgmma_wait<1>();  // dpT is done
    fence_regs(dp);

    // dsT in dp; dk += dsT . q
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 dd = *reinterpret_cast<const float2*>(di_s + 8 * c + 2 * t4);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = 4 * c + 2 * hh;
        dp[v] = (dp[v] - dd.x) * s[v] * sm_scale;
        dp[v + 1] = (dp[v + 1] - dd.y) * s[v + 1] * sm_scale;
      }
    }
    tf32_frag(ds_hi, ds_lo, dp);
    wgmma_fence();
    mma3_ra(dk_acc, ds_hi, ds_lo, desc_sw128(st + 4 * F_PLANE), desc_sw128(st + 5 * F_PLANE));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && j + DKV_STAGES < n_live) load(j + DKV_STAGES);
  }

  store_acc_f32(dk + b * sdk.b + h * sdk.h + (long long)key0 * sdk.s, sdk.s, dk_acc, t4);
  store_acc_f32(dv + b * sdv.b + h * sdv.h + (long long)key0 * sdv.s, sdv.s, dv_acc, t4);
  if (tid == 0 || tid == 64) report_tiles(counts, tid / 64, n_live);  // tiles computed, as two warps walked them
  if (tid == 0) report_tiles(counts, 2, loaded);
}

// ---------------------------------------------------------------- f32 dq

__global__ void __launch_bounds__(F_THREADS, 2)
flash_dq_f32_kernel(const __grid_constant__ DqMaps maps, const float* __restrict__ q_hi,
                    const float* __restrict__ q_lo, const float* __restrict__ do_hi, const float* __restrict__ do_lo,
                    const int* __restrict__ seg_q, const int* __restrict__ seg_kv, const float* __restrict__ l,
                    const float* __restrict__ m, const float* __restrict__ di, float* __restrict__ dq, int S,
                    Strides sdq, float scale_log2, float sm_scale, int* __restrict__ counts) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  __shared__ __align__(8) uint64_t full[DQ_STAGES];
  __shared__ TilePlanF32 plan;

  const int m0 = blockIdx.x * F_OWN, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = S / F_T, bh = b * gridDim.y + h;
  const long long stat = (long long)bh * S;
  const int* sk_b = seg_kv + (long long)b * S;
  init_f32_ring(full, DQ_STAGES, nullptr);
  plan_tiles_f32(plan, sk_b, nullptr, seg_q + (long long)b * S + m0, m + stat + m0, n_tiles);
  const int n_live = plan.n_live;
  const int tid = threadIdx.x, lane = tid % 32, t4 = lane % 4;

  int loaded = 0;
  auto load = [&](int j) {  // thread 0: the j-th live key tile into its stage
    const int t = plan.order[j], row = t * F_T;
    uint8_t* st = ring + (j % DQ_STAGES) * DQ_STAGE;
    uint64_t* bar = &full[j % DQ_STAGES];
    mbar_expect_tx(bar, 6 * F_PLANE + F_T * 4);
    tma_load_4d(st, &maps.k_hi, bar, 0, row, 0, bh);
    tma_load_4d(st + F_PLANE, &maps.k_lo, bar, 0, row, 0, bh);
    tma_load_4d(st + 2 * F_PLANE, &maps.v_hi, bar, 0, row, 0, bh);
    tma_load_4d(st + 3 * F_PLANE, &maps.v_lo, bar, 0, row, 0, bh);
    tma_load_3d(st + 4 * F_PLANE, &maps.kt_hi, bar, row, 0, bh);
    tma_load_3d(st + 5 * F_PLANE, &maps.kt_lo, bar, row, 0, bh);
    bulk_load(st + 6 * F_PLANE, sk_b + row, F_T * 4, bar);
    ++loaded;
  };
  if (tid == 0) {
    for (int j = 0; j < min(DQ_STAGES, n_live); ++j) load(j);
  }

  const int row0 = m0 + (tid / 32) * 16 + lane / 4;  // this thread's queries: row0, row0 + 8
  int sgq[2];
  float m2[2], pm[2], il[2], dii[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row0 + 8 * hh;
    const float mi = __ldg(m + stat + i);
    sgq[hh] = __ldg(seg_q + (long long)b * S + i);
    m2[hh] = mi * LOG2E;
    pm[hh] = mi == MASK_VALUE ? 1.f : 0.f;
    il[hh] = 1.f / __ldg(l + stat + i);
    dii[hh] = __ldg(di + stat + i);
  }
  uint32_t qa_hi[32], qa_lo[32], doa_hi[32], doa_lo[32];  // q and do as register A
  load_frags(qa_hi, q_hi, bh, S, m0);
  load_frags(qa_lo, q_lo, bh, S, m0);
  load_frags(doa_hi, do_hi, bh, S, m0);
  load_frags(doa_lo, do_lo, bh, S, m0);

  float dq_acc[32];
  uint32_t ds_hi[16], ds_lo[16];  // ds as register A
  zero_acc(dq_acc);
  for (int j = 0; j < n_live; ++j) {
    const int stage = j % DQ_STAGES;
    mbar_wait(&full[stage], (j / DQ_STAGES) & 1);
    const uint8_t* st = ring + stage * DQ_STAGE;
    const int* sg_s = reinterpret_cast<const int*>(st + 6 * F_PLANE);

    // s = q . kT and dp = do . vT: 64 queries x 32 keys
    float s[16], dp[16];
    wgmma_fence();
    mma3_rows_ra(s, qa_hi, qa_lo, desc_sw128(st), desc_sw128(st + F_PLANE));
    wgmma_commit();
    mma3_rows_ra(dp, doa_hi, doa_lo, desc_sw128(st + 2 * F_PLANE), desc_sw128(st + 3 * F_PLANE));
    wgmma_commit();
    wgmma_wait<1>();  // s is done; dp runs on
    fence_regs(s);
    if (plan.live[plan.order[j]] == 2) form_p<true>(s, sgq, m2, pm, il, sg_s, t4, scale_log2);
    else form_p<false>(s, sgq, m2, pm, il, sg_s, t4, scale_log2);
    wgmma_wait<0>();  // dp is done
    fence_regs(dp);

    // ds in dp; dq += ds . k
#pragma unroll
    for (int v = 0; v < 16; ++v) dp[v] = (dp[v] - dii[(v >> 1) & 1]) * s[v] * sm_scale;
    tf32_frag(ds_hi, ds_lo, dp);
    wgmma_fence();
    mma3_ra(dq_acc, ds_hi, ds_lo, desc_sw128(st + 4 * F_PLANE), desc_sw128(st + 5 * F_PLANE));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && j + DQ_STAGES < n_live) load(j + DQ_STAGES);
  }

  store_acc_f32(dq + b * sdq.b + h * sdq.h + (long long)row0 * sdq.s, sdq.s, dq_acc, t4);
  if (tid == 0 || tid == 64) report_tiles(counts, tid / 64, n_live);
  if (tid == 0) report_tiles(counts, 2, loaded);
}

}  // namespace

extern "C" {

// q, k, v, dout, dk, dv: [B, H, S, 64] through (batch, head, row) strides in
// elements, the 64 values of a head contiguous and 16-byte aligned; bf16 when
// is_bf16, else f32. seg_q, seg_kv [B, S] i32 and l, m, di [B, H, S] f32,
// contiguous and 16-byte aligned. S a multiple of 128 up to 8192 (bf16:
// strides positive). scratch: f32 only, 12 (dkv) or 10 (dq) x B*H*S*64 f32
// for the split planes (flash_attention_bwd_f32_planes).
int flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const void* seg_q, const void* seg_kv, const void* l, const void* m,
                        const void* di, void* dk, void* dv, int B, int H, int S, int is_bf16,
                        long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                        long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                        long long v_ss, long long do_sb, long long do_sh, long long do_ss,
                        long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
                        long long dv_sh, long long dv_ss, float sm_scale, void* scratch, void* stream) {
  if (bad_shape(B, H, S)) return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss};
  const Strides sdo{do_sb, do_sh, do_ss}, sdk{dk_sb, dk_sh, dk_ss}, sdv{dv_sb, dv_sh, dv_ss};
  const float scale_log2 = sm_scale * LOG2E;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    CUtensorMap maps[4];
    const cudaError_t err = prepare_bf16(flash_dkv_bf16_kernel, BWD_SMEM, {seg_q, seg_kv, l, m, di}, maps, {q, k, v, dout},
                                         {sq, sk, sv, sdo}, {BT, CT, CT, BT}, B, H, S);
    if (err != cudaSuccess) return (int)err;
    flash_dkv_bf16_kernel<<<dim3(S / CT, H, B), TC_THREADS, BWD_SMEM, st>>>(
        maps[0], maps[1], maps[2], maps[3], (const int*)seg_q, (const int*)seg_kv, (const float*)l,
        (const float*)m, (const float*)di, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, sdk, sdv, scale_log2,
        sm_scale, tile_counts);
  } else {
    const cudaError_t err = prepare_f32(flash_dkv_f32_kernel, DKV_SMEM, {seg_q, seg_kv, l, m, di}, scratch, B, H, S);
    if (err != cudaSuccess) return (int)err;
    // scratch: the hi and lo row planes of q, do, k, v, then the transposed planes of q and do
    const long long P = (long long)B * H * S * DH;
    float* w = (float*)scratch;
    split_tf32(q, sq, B, H, S, w, w + P, w + 8 * P, w + 9 * P, st);
    split_tf32(dout, sdo, B, H, S, w + 2 * P, w + 3 * P, w + 10 * P, w + 11 * P, st);
    split_tf32(k, sk, B, H, S, w + 4 * P, w + 5 * P, nullptr, nullptr, st);
    split_tf32(v, sv, B, H, S, w + 6 * P, w + 7 * P, nullptr, nullptr, st);
    DkvMaps maps;
    const int BH = B * H;
    if (!(row_plane_map(&maps.k_hi, w + 4 * P, BH, S, F_OWN) && row_plane_map(&maps.k_lo, w + 5 * P, BH, S, F_OWN) &&
          row_plane_map(&maps.q_hi, w, BH, S, F_T) && row_plane_map(&maps.q_lo, w + P, BH, S, F_T) &&
          row_plane_map(&maps.do_hi, w + 2 * P, BH, S, F_T) && row_plane_map(&maps.do_lo, w + 3 * P, BH, S, F_T) &&
          t_plane_map(&maps.qt_hi, w + 8 * P, BH, S) && t_plane_map(&maps.qt_lo, w + 9 * P, BH, S) &&
          t_plane_map(&maps.dot_hi, w + 10 * P, BH, S) && t_plane_map(&maps.dot_lo, w + 11 * P, BH, S)))
      return (int)cudaErrorInvalidValue;
    flash_dkv_f32_kernel<<<dim3(S / F_OWN, H, B), F_THREADS, DKV_SMEM, st>>>(
        maps, w + 6 * P, w + 7 * P, (const int*)seg_q, (const int*)seg_kv, (const float*)l, (const float*)m,
        (const float*)di, (float*)dk, (float*)dv, S, sdk, sdv, scale_log2, sm_scale, tile_counts);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a bf16 backward CTA (k and v or q and do, and the ring).
int flash_attention_bwd_smem() { return BWD_SMEM; }

// Dynamic shared memory of an f32 dkv (dkv != 0) or dq CTA.
int flash_attention_bwd_f32_smem(int dkv) { return dkv ? DKV_SMEM : DQ_SMEM; }

// Scratch of an f32 dkv (dkv != 0) or dq launch, in planes of B*H*S*64 f32.
int flash_attention_bwd_f32_planes(int dkv) { return dkv ? 12 : 10; }

// Until called with nullptr, every launch writes, for CTA
// (b * H + h) * S/R + x, the streamed tiles that it computed (bf16: its
// consumer warpgroups 0 and 1; f32, R = 64: its warps 0 and 2) and that it
// loaded into counts[3 * cta .. + 2] (i32 on the device, n values; R = 128
// for bf16; a launch whose grid does not fit fails).
int flash_attention_bwd_count_tiles(void* counts, long long n) {
  tile_counts = (int*)counts;
  tile_counts_len = counts == nullptr ? 0 : n;
  return 0;
}

// As flash_attention_dkv, for dq.
int flash_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                       const void* seg_q, const void* seg_kv, const void* l, const void* m,
                       const void* di, void* dq, int B, int H, int S, int is_bf16, long long q_sb,
                       long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                       long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                       long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
                       long long dq_sh, long long dq_ss, float sm_scale, void* scratch, void* stream) {
  if (bad_shape(B, H, S)) return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss};
  const Strides sdo{do_sb, do_sh, do_ss}, sdq{dq_sb, dq_sh, dq_ss};
  const float scale_log2 = sm_scale * LOG2E;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    CUtensorMap maps[4];
    const cudaError_t err = prepare_bf16(flash_dq_bf16_kernel, BWD_SMEM, {seg_q, seg_kv, l, m, di}, maps, {q, k, v, dout},
                                         {sq, sk, sv, sdo}, {CT, BT, BT, CT}, B, H, S);
    if (err != cudaSuccess) return (int)err;
    flash_dq_bf16_kernel<<<dim3(S / CT, H, B), TC_THREADS, BWD_SMEM, st>>>(
        maps[0], maps[1], maps[2], maps[3], (const int*)seg_q, (const int*)seg_kv, (const float*)l,
        (const float*)m, (const float*)di, (__nv_bfloat16*)dq, S, sdq, scale_log2, sm_scale,
        tile_counts);
  } else {
    const cudaError_t err = prepare_f32(flash_dq_f32_kernel, DQ_SMEM, {seg_q, seg_kv, l, m, di}, scratch, B, H, S);
    if (err != cudaSuccess) return (int)err;
    // scratch: the hi and lo row planes of q, do, k, v, then the transposed planes of k
    const long long P = (long long)B * H * S * DH;
    float* w = (float*)scratch;
    split_tf32(q, sq, B, H, S, w, w + P, nullptr, nullptr, st);
    split_tf32(dout, sdo, B, H, S, w + 2 * P, w + 3 * P, nullptr, nullptr, st);
    split_tf32(k, sk, B, H, S, w + 4 * P, w + 5 * P, w + 8 * P, w + 9 * P, st);
    split_tf32(v, sv, B, H, S, w + 6 * P, w + 7 * P, nullptr, nullptr, st);
    DqMaps maps;
    const int BH = B * H;
    if (!(row_plane_map(&maps.k_hi, w + 4 * P, BH, S, F_T) && row_plane_map(&maps.k_lo, w + 5 * P, BH, S, F_T) &&
          row_plane_map(&maps.v_hi, w + 6 * P, BH, S, F_T) && row_plane_map(&maps.v_lo, w + 7 * P, BH, S, F_T) &&
          t_plane_map(&maps.kt_hi, w + 8 * P, BH, S) && t_plane_map(&maps.kt_lo, w + 9 * P, BH, S)))
      return (int)cudaErrorInvalidValue;
    flash_dq_f32_kernel<<<dim3(S / F_OWN, H, B), F_THREADS, DQ_SMEM, st>>>(
        maps, w, w + P, w + 2 * P, w + 3 * P, (const int*)seg_q, (const int*)seg_kv, (const float*)l,
        (const float*)m, (const float*)di, (float*)dq, S, sdq, scale_log2, sm_scale, tile_counts);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
