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
// recomputed tile by tile from l and m.
//
// The tensors are read through their (batch, head, row) strides and the
// gradients are written through theirs, so the encoder's [B, S, H*64] layout
// is used as it is on both sides.
//
// Design for an H100. The work is 8*S*S*64 (dkv) and 6*S*S*64 (dq) operations
// per head against 6*S*64 values moved: bound by operations. Nothing is summed
// across CTAs, so there are no atomics and a result repeats bit for bit.
// bf16 variants, four warps of 16 rows, mma.sync.m16n8k16 with f32 sums:
//  - dkv: one CTA per (batch, head, 64-key tile). The k and v tiles become A
//    fragments that stay in registers; the loop walks 64-query tiles of q and
//    do staged in padded shared rows, with m, 1/l, di and the ids beside them.
//    Each warp forms the transposed tiles sT = k.qT and dpT = v.doT directly
//    (16 keys x 64 queries), so that pT and dsT come out of the C fragments as
//    the A fragments of pT.do and dsT.q with no shuffle; those products read
//    do and q through ldmatrix.trans. dk and dv are 2 x 32 f32 registers a
//    thread, stored once at the end.
//  - dq: one CTA per (batch, head, 64-query tile), q and do as A fragments in
//    registers, the loop walks 64-key tiles of k and v; s = q.kT, dp = do.vT,
//    ds repacked as A fragments, dq += ds.k through ldmatrix.trans.
// f32 variants (CUDA cores, no TF32): two threads per row, each holding half of
// the head's 64 values; the halves of a dot product meet in one shuffle.
//
// Still open: wgmma and TMA, double buffering, one fused kernel that forms p
// and ds once for all three gradients (each is formed twice here), and skipping
// tiles whose segment ranges cannot meet.
//
// Built by kernels/build.py with nvcc for sm_90a into a shared library with a
// plain C interface (loaded through ctypes). Each entry point returns the
// cudaError_t of its launch.

#include "flash_common.cuh"

namespace {

// A fragments (16 rows x 64 values, four k-steps) of this warp's rows of a staged tile
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], const __nv_bfloat16* tile, int r0,
                                             int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = *reinterpret_cast<const uint32_t*>(tile + r0 * LDS + kk * 16 + 2 * t);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(tile + (r0 + 8) * LDS + kk * 16 + 2 * t);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(tile + r0 * LDS + kk * 16 + 2 * t + 8);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(tile + (r0 + 8) * LDS + kk * 16 + 2 * t + 8);
  }
}

// c[nt] += a . tileT: 16 rows x 64 tile rows, contracting the 64 values of a head
__device__ __forceinline__ void mma_a_tileT(float (&c)[8][4], const uint32_t (&a)[4][4],
                                            const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* r = tile + (nt * 8 + g) * LDS + kk * 16 + 2 * t;
      mma_bf16_16x8x16(c[nt], a[kk][0], a[kk][1], a[kk][2], a[kk][3],
                       *reinterpret_cast<const uint32_t*>(r),
                       *reinterpret_cast<const uint32_t*>(r + 8));
    }
}

// acc += x . tile, x a 16 x 64 C-fragment tile rounded to bf16 and contracted
// over the tile's 64 rows
__device__ __forceinline__ void mma_c_tile(float (&acc)[8][4], const float (&x)[8][4],
                                           const __nv_bfloat16* tile, int lane) {
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a0 = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    const uint32_t a1 = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    const uint32_t a2 = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3, tile + (kk * 16 + v_row) * LDS + dp * 16 + v_col);
      mma_bf16_16x8x16(acc[2 * dp], a0, a1, a2, a3, b0, b1);
      mma_bf16_16x8x16(acc[2 * dp + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

__device__ __forceinline__ void zero_tile(float (&c)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
}

__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* row0, long long row_stride,
                                                const float (&acc)[8][4], int t) {
  __nv_bfloat16* row1 = row0 + 8 * row_stride;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    *reinterpret_cast<uint32_t*>(row0 + dt * 8 + 2 * t) = pack_bf16(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<uint32_t*>(row1 + dt * 8 + 2 * t) = pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

// ---------------------------------------------------------------- bf16 dkv

__global__ void __launch_bounds__(THREADS)
flash_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                      const float* __restrict__ l, const float* __restrict__ m,
                      const float* __restrict__ di, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, Strides sq, Strides sk, Strides sv,
                      Strides sdo, Strides sdk, Strides sdv, float scale_log2, float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 q_s[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 do_s[BM * LDS];
  __shared__ __align__(16) float m2_s[BM];    // row max in the exp2 domain
  __shared__ __align__(16) float invl_s[BM];  // 1 / row sum
  __shared__ __align__(16) float di_s[BM];
  __shared__ __align__(16) float pmask_s[BM];  // exp(mask - m): 1 on a row no key matches, else 0
  __shared__ __align__(16) int segq_s[BM];

  const int n0 = blockIdx.x * BN, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's keys of the tile: r0 and r0 + 8

  // k and v tiles -> A fragments in registers (through q_s and do_s)
  stage_tile(q_s, k + b * sk.b + h * sk.h + (long long)n0 * sk.s, sk.s);
  stage_tile(do_s, v + b * sv.b + h * sv.h + (long long)n0 * sv.s, sv.s);
  __syncthreads();
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, q_s, r0, t);
  load_a_frags(va, do_s, r0, t);
  const int sgk0 = seg_kv[(long long)b * S + n0 + r0];
  const int sgk1 = seg_kv[(long long)b * S + n0 + r0 + 8];
  __syncthreads();

  float dk_acc[8][4], dv_acc[8][4];
  zero_tile(dk_acc);
  zero_tile(dv_acc);

  const __nv_bfloat16* qh = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* doh = dout + b * sdo.b + h * sdo.h;
  const long long stat = ((long long)b * gridDim.y + h) * S;

  for (int m0 = 0; m0 < S; m0 += BM) {
    stage_tile(q_s, qh + (long long)m0 * sq.s, sq.s);
    stage_tile(do_s, doh + (long long)m0 * sdo.s, sdo.s);
    if (threadIdx.x < BM) {
      const int i = threadIdx.x;
      const float mi = m[stat + m0 + i];
      m2_s[i] = mi * LOG2E;
      pmask_s[i] = mi == MASK_VALUE ? 1.f : 0.f;
      invl_s[i] = 1.f / l[stat + m0 + i];
      di_s[i] = di[stat + m0 + i];
      segq_s[i] = seg_q[(long long)b * S + m0 + i];
    }
    __syncthreads();

    // sT = k . qT and dpT = v . doT: 16 keys x 64 queries per warp
    float sT[8][4], dpT[8][4];
    zero_tile(sT);
    zero_tile(dpT);
    mma_a_tileT(sT, ka, q_s, g, t);
    mma_a_tileT(dpT, va, do_s, g, t);

    // pT in sT, dsT in dpT; the query is the column: c and c + 1
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const int2 sg = *reinterpret_cast<const int2*>(segq_s + c);
      const float2 m2 = *reinterpret_cast<const float2*>(m2_s + c);
      const float2 il = *reinterpret_cast<const float2*>(invl_s + c);
      const float2 dd = *reinterpret_cast<const float2*>(di_s + c);
      const float2 pm = *reinterpret_cast<const float2*>(pmask_s + c);
      const float p0 = (sgk0 == sg.x ? exp2f(sT[nt][0] * scale_log2 - m2.x) : pm.x) * il.x;
      const float p1 = (sgk0 == sg.y ? exp2f(sT[nt][1] * scale_log2 - m2.y) : pm.y) * il.y;
      const float p2 = (sgk1 == sg.x ? exp2f(sT[nt][2] * scale_log2 - m2.x) : pm.x) * il.x;
      const float p3 = (sgk1 == sg.y ? exp2f(sT[nt][3] * scale_log2 - m2.y) : pm.y) * il.y;
      sT[nt][0] = p0;
      sT[nt][1] = p1;
      sT[nt][2] = p2;
      sT[nt][3] = p3;
      dpT[nt][0] = (dpT[nt][0] - dd.x) * p0 * sm_scale;
      dpT[nt][1] = (dpT[nt][1] - dd.y) * p1 * sm_scale;
      dpT[nt][2] = (dpT[nt][2] - dd.x) * p2 * sm_scale;
      dpT[nt][3] = (dpT[nt][3] - dd.y) * p3 * sm_scale;
    }

    mma_c_tile(dv_acc, sT, do_s, lane);   // dv += pT . do
    mma_c_tile(dk_acc, dpT, q_s, lane);   // dk += dsT . q
    __syncthreads();
  }

  store_rows_bf16(dk + b * sdk.b + h * sdk.h + (long long)(n0 + r0) * sdk.s, sdk.s, dk_acc, t);
  store_rows_bf16(dv + b * sdv.b + h * sdv.h + (long long)(n0 + r0) * sdv.s, sdv.s, dv_acc, t);
}

// ---------------------------------------------------------------- bf16 dq

__global__ void __launch_bounds__(THREADS)
flash_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                     const float* __restrict__ l, const float* __restrict__ m,
                     const float* __restrict__ di, __nv_bfloat16* __restrict__ dq, int S,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, float scale_log2,
                     float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_s[BN * LDS];
  __shared__ __align__(16) int segk_s[BN];

  const int m0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's queries of the tile: r0 and r0 + 8

  // q and do tiles -> A fragments in registers (through k_s and v_s)
  stage_tile(k_s, q + b * sq.b + h * sq.h + (long long)m0 * sq.s, sq.s);
  stage_tile(v_s, dout + b * sdo.b + h * sdo.h + (long long)m0 * sdo.s, sdo.s);
  __syncthreads();
  uint32_t qa[4][4], doa[4][4];
  load_a_frags(qa, k_s, r0, t);
  load_a_frags(doa, v_s, r0, t);
  const int sgq0 = seg_q[(long long)b * S + m0 + r0];
  const int sgq1 = seg_q[(long long)b * S + m0 + r0 + 8];
  const long long stat = ((long long)b * gridDim.y + h) * S + m0 + r0;
  const float mi0 = m[stat], mi1 = m[stat + 8];
  const float m2_0 = mi0 * LOG2E, m2_1 = mi1 * LOG2E;
  const float pm0 = mi0 == MASK_VALUE ? 1.f : 0.f, pm1 = mi1 == MASK_VALUE ? 1.f : 0.f;
  const float il0 = 1.f / l[stat], il1 = 1.f / l[stat + 8];
  const float di0 = di[stat], di1 = di[stat + 8];
  __syncthreads();

  float dq_acc[8][4];
  zero_tile(dq_acc);

  const __nv_bfloat16* kh = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vh = v + b * sv.b + h * sv.h;
  const int* sgk = seg_kv + (long long)b * S;

  for (int n0 = 0; n0 < S; n0 += BN) {
    stage_tile(k_s, kh + (long long)n0 * sk.s, sk.s);
    stage_tile(v_s, vh + (long long)n0 * sv.s, sv.s);
    if (threadIdx.x < BN) segk_s[threadIdx.x] = sgk[n0 + threadIdx.x];
    __syncthreads();

    // s = q . kT and dp = do . vT: 16 queries x 64 keys per warp
    float s[8][4], dp[8][4];
    zero_tile(s);
    zero_tile(dp);
    mma_a_tileT(s, qa, k_s, g, t);
    mma_a_tileT(dp, doa, v_s, g, t);

    // ds in dp
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int2 sg = *reinterpret_cast<const int2*>(segk_s + nt * 8 + 2 * t);
      const float p0 = (sgq0 == sg.x ? exp2f(s[nt][0] * scale_log2 - m2_0) : pm0) * il0;
      const float p1 = (sgq0 == sg.y ? exp2f(s[nt][1] * scale_log2 - m2_0) : pm0) * il0;
      const float p2 = (sgq1 == sg.x ? exp2f(s[nt][2] * scale_log2 - m2_1) : pm1) * il1;
      const float p3 = (sgq1 == sg.y ? exp2f(s[nt][3] * scale_log2 - m2_1) : pm1) * il1;
      dp[nt][0] = (dp[nt][0] - di0) * p0 * sm_scale;
      dp[nt][1] = (dp[nt][1] - di0) * p1 * sm_scale;
      dp[nt][2] = (dp[nt][2] - di1) * p2 * sm_scale;
      dp[nt][3] = (dp[nt][3] - di1) * p3 * sm_scale;
    }

    mma_c_tile(dq_acc, dp, k_s, lane);  // dq += ds . k
    __syncthreads();
  }

  store_rows_bf16(dq + b * sdq.b + h * sdq.h + (long long)(m0 + r0) * sdq.s, sdq.s, dq_acc, t);
}

// ---------------------------------------------------------------- f32

constexpr int FR = 64;    // rows per CTA, two threads each
constexpr int FT = 32;    // rows of the other side per shared tile
constexpr int HALF = 32;  // values of a head per thread

__device__ __forceinline__ void load_half(float (&x)[HALF], const float* src) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int d = 0; d < HALF / 4; ++d) {
    const float4 y = __ldg(p + d);
    x[4 * d] = y.x;
    x[4 * d + 1] = y.y;
    x[4 * d + 2] = y.z;
    x[4 * d + 3] = y.w;
  }
}

__device__ __forceinline__ void store_half(float* dst, const float (&x)[HALF]) {
  float4* p = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int d = 0; d < HALF / 4; ++d)
    p[d] = make_float4(x[4 * d], x[4 * d + 1], x[4 * d + 2], x[4 * d + 3]);
}

// this thread's half of x . row, summed with its partner's (lane ^ 1)
__device__ __forceinline__ float pair_dot(const float (&x)[HALF], const float* row) {
  const float4* p = reinterpret_cast<const float4*>(row);
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < HALF / 4; ++d) {
    const float4 y = p[d];
    dot = fmaf(x[4 * d], y.x, dot);
    dot = fmaf(x[4 * d + 1], y.y, dot);
    dot = fmaf(x[4 * d + 2], y.z, dot);
    dot = fmaf(x[4 * d + 3], y.w, dot);
  }
  return dot + __shfl_xor_sync(0xffffffffu, dot, 1);
}

__device__ __forceinline__ void axpy_half(float (&acc)[HALF], float a, const float* row) {
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int d = 0; d < HALF / 4; ++d) {
    const float4 y = p[d];
    acc[4 * d] = fmaf(a, y.x, acc[4 * d]);
    acc[4 * d + 1] = fmaf(a, y.y, acc[4 * d + 1]);
    acc[4 * d + 2] = fmaf(a, y.z, acc[4 * d + 2]);
    acc[4 * d + 3] = fmaf(a, y.w, acc[4 * d + 3]);
  }
}

// FT rows of one head into an unpadded shared tile
__device__ __forceinline__ void stage_tile_f32(float* dst, const float* src, long long row_stride) {
  for (int c = threadIdx.x; c < FT * (DH / 4); c += 2 * FR) {
    const int r = c >> 4, col = (c & 15) * 4;
    *reinterpret_cast<float4*>(dst + r * DH + col) =
        __ldg(reinterpret_cast<const float4*>(src + (long long)r * row_stride + col));
  }
}

__global__ void __launch_bounds__(2 * FR)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                     const float* __restrict__ l, const float* __restrict__ m,
                     const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv,
                     int S, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                     Strides sdv, float scale_log2, float sm_scale) {
  __shared__ __align__(16) float q_s[FT * DH];
  __shared__ __align__(16) float do_s[FT * DH];
  __shared__ float m2_s[FT], invl_s[FT], di_s[FT], pmask_s[FT];
  __shared__ int segq_s[FT];

  const int key = blockIdx.x * FR + (threadIdx.x >> 1), half = (threadIdx.x & 1) * HALF;
  const int h = blockIdx.y, b = blockIdx.z;
  float kr[HALF], vr[HALF], dk_acc[HALF], dv_acc[HALF];
  load_half(kr, k + b * sk.b + h * sk.h + (long long)key * sk.s + half);
  load_half(vr, v + b * sv.b + h * sv.h + (long long)key * sv.s + half);
#pragma unroll
  for (int d = 0; d < HALF; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  const int my_seg = seg_kv[(long long)b * S + key];

  const float* qh = q + b * sq.b + h * sq.h;
  const float* doh = dout + b * sdo.b + h * sdo.h;
  const long long stat = ((long long)b * gridDim.y + h) * S;

  for (int m0 = 0; m0 < S; m0 += FT) {
    stage_tile_f32(q_s, qh + (long long)m0 * sq.s, sq.s);
    stage_tile_f32(do_s, doh + (long long)m0 * sdo.s, sdo.s);
    if (threadIdx.x < FT) {
      const int i = threadIdx.x;
      const float mi = m[stat + m0 + i];
      m2_s[i] = mi * LOG2E;
      pmask_s[i] = mi == MASK_VALUE ? 1.f : 0.f;
      invl_s[i] = 1.f / l[stat + m0 + i];
      di_s[i] = di[stat + m0 + i];
      segq_s[i] = seg_q[(long long)b * S + m0 + i];
    }
    __syncthreads();
    for (int i = 0; i < FT; ++i) {
      const float s = pair_dot(kr, q_s + i * DH + half);
      const float dp = pair_dot(vr, do_s + i * DH + half);
      const float p = (my_seg == segq_s[i] ? exp2f(s * scale_log2 - m2_s[i]) : pmask_s[i]) * invl_s[i];
      const float ds = (dp - di_s[i]) * p * sm_scale;
      axpy_half(dv_acc, p, do_s + i * DH + half);
      axpy_half(dk_acc, ds, q_s + i * DH + half);
    }
    __syncthreads();
  }
  store_half(dk + b * sdk.b + h * sdk.h + (long long)key * sdk.s + half, dk_acc);
  store_half(dv + b * sdv.b + h * sdv.h + (long long)key * sdv.s + half, dv_acc);
}

__global__ void __launch_bounds__(2 * FR)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                    const float* __restrict__ l, const float* __restrict__ m,
                    const float* __restrict__ di, float* __restrict__ dq, int S, Strides sq,
                    Strides sk, Strides sv, Strides sdo, Strides sdq, float scale_log2,
                    float sm_scale) {
  __shared__ __align__(16) float k_s[FT * DH];
  __shared__ __align__(16) float v_s[FT * DH];
  __shared__ int segk_s[FT];

  const int row = blockIdx.x * FR + (threadIdx.x >> 1), half = (threadIdx.x & 1) * HALF;
  const int h = blockIdx.y, b = blockIdx.z;
  float qr[HALF], dor[HALF], dq_acc[HALF];
  load_half(qr, q + b * sq.b + h * sq.h + (long long)row * sq.s + half);
  load_half(dor, dout + b * sdo.b + h * sdo.h + (long long)row * sdo.s + half);
#pragma unroll
  for (int d = 0; d < HALF; ++d) dq_acc[d] = 0.f;
  const int my_seg = seg_q[(long long)b * S + row];
  const long long stat = ((long long)b * gridDim.y + h) * S + row;
  const float mi = m[stat];
  const float m2 = mi * LOG2E, pm = mi == MASK_VALUE ? 1.f : 0.f;
  const float il = 1.f / l[stat], dii = di[stat];

  const float* kh = k + b * sk.b + h * sk.h;
  const float* vh = v + b * sv.b + h * sv.h;
  const int* sgk = seg_kv + (long long)b * S;

  for (int n0 = 0; n0 < S; n0 += FT) {
    stage_tile_f32(k_s, kh + (long long)n0 * sk.s, sk.s);
    stage_tile_f32(v_s, vh + (long long)n0 * sv.s, sv.s);
    if (threadIdx.x < FT) segk_s[threadIdx.x] = sgk[n0 + threadIdx.x];
    __syncthreads();
    for (int j = 0; j < FT; ++j) {
      const float s = pair_dot(qr, k_s + j * DH + half);
      const float dp = pair_dot(dor, v_s + j * DH + half);
      const float p = (my_seg == segk_s[j] ? exp2f(s * scale_log2 - m2) : pm) * il;
      const float ds = (dp - dii) * p * sm_scale;
      axpy_half(dq_acc, ds, k_s + j * DH + half);
    }
    __syncthreads();
  }
  store_half(dq + b * sdq.b + h * sdq.h + (long long)row * sdq.s + half, dq_acc);
}

bool bad_shape(int B, int H, int S) {
  return B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || S % 128 != 0;
}

}  // namespace

extern "C" {

// q, k, v, dout, dk, dv: [B, H, S, 64] through (batch, head, row) strides in
// elements, the 64 values of a head contiguous and 16-byte aligned; bf16 when
// is_bf16, else f32. seg_q, seg_kv [B, S] i32 and l, m, di [B, H, S] f32,
// contiguous. S a multiple of 128.
int flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                        const void* seg_q, const void* seg_kv, const void* l, const void* m,
                        const void* di, void* dk, void* dv, int B, int H, int S, int is_bf16,
                        long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                        long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                        long long v_ss, long long do_sb, long long do_sh, long long do_ss,
                        long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
                        long long dv_sh, long long dv_ss, float sm_scale, void* stream) {
  if (bad_shape(B, H, S)) return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss};
  const Strides sdo{do_sb, do_sh, do_ss}, sdk{dk_sb, dk_sh, dk_ss}, sdv{dv_sb, dv_sh, dv_ss};
  const float scale_log2 = sm_scale * LOG2E;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    flash_dkv_bf16_kernel<<<dim3(S / BN, H, B), THREADS, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, (const int*)seg_q, (const int*)seg_kv, (const float*)l,
        (const float*)m, (const float*)di, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, sq, sk, sv,
        sdo, sdk, sdv, scale_log2, sm_scale);
  } else {
    flash_dkv_f32_kernel<<<dim3(S / FR, H, B), 2 * FR, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const int*)seg_q,
        (const int*)seg_kv, (const float*)l, (const float*)m, (const float*)di, (float*)dk,
        (float*)dv, S, sq, sk, sv, sdo, sdk, sdv, scale_log2, sm_scale);
  }
  return (int)cudaGetLastError();
}

// As flash_attention_dkv, for dq.
int flash_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                       const void* seg_q, const void* seg_kv, const void* l, const void* m,
                       const void* di, void* dq, int B, int H, int S, int is_bf16, long long q_sb,
                       long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                       long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                       long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
                       long long dq_sh, long long dq_ss, float sm_scale, void* stream) {
  if (bad_shape(B, H, S)) return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss};
  const Strides sdo{do_sb, do_sh, do_ss}, sdq{dq_sb, dq_sh, dq_ss};
  const float scale_log2 = sm_scale * LOG2E;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    flash_dq_bf16_kernel<<<dim3(S / BM, H, B), THREADS, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, (const int*)seg_q, (const int*)seg_kv, (const float*)l,
        (const float*)m, (const float*)di, (__nv_bfloat16*)dq, S, sq, sk, sv, sdo, sdq, scale_log2,
        sm_scale);
  } else {
    flash_dq_f32_kernel<<<dim3(S / FR, H, B), 2 * FR, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const int*)seg_q,
        (const int*)seg_kv, (const float*)l, (const float*)m, (const float*)di, (float*)dq, S, sq,
        sk, sv, sdo, sdq, scale_log2, sm_scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
