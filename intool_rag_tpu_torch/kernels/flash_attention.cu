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
// Design for an H100. At S 8192 the work is 4*S*S*64 operations per head
// against 4*S*64 values moved: bound by operations, far above the card's 295
// operations per byte. bf16 variant: one CTA per (batch, head, 64 query rows),
// four warps of 16 rows. The q tile goes once through shared memory into
// mma.sync.m16n8k16 A fragments that stay in registers. The loop walks 64-key
// tiles: k and v tiles are staged in shared memory in rows padded to 72 values
// (144 bytes), which makes the fragment loads conflict-free; q.kT reads the B
// fragments of k as 32-bit words, p.v reads those of v with ldmatrix.trans,
// and the C fragments of q.kT are repacked in registers as the A fragments of
// p.v. Running max and sum live in registers, one pair per thread row. f32
// variant (CUDA cores, no TF32): one thread per query row, 128 rows per CTA,
// 32-key tiles broadcast from shared memory, online softmax in chunks of 8
// keys.
//
// A differentiated call also saves each row's sum l and max m ([B, H, S] f32,
// m in the natural-exponent domain, the mask value itself for a row no key
// matches) for the backward kernels of flash_attention_bwd.cu; the library
// keeps the two apart as well, since m + log l would lose log l beside the
// mask value.
//
// Still open: wgmma and TMA, double buffering of the k/v tiles (loads and
// MMAs of one CTA do not overlap; several CTAs per SM hide part of it), and
// skipping key tiles whose segment range cannot meet the query tile's, which
// would cut a packed row's work from S*S to the sum of its segments' squares.
//
// Built by kernels/build.py with nvcc for sm_90a into a shared library with a
// plain C interface (loaded through ctypes). The entry point returns the
// cudaError_t of its launch.

#include "flash_common.cuh"

namespace {

constexpr float LN2 = 0.6931471805599453f;

// The bf16 kernel's tiles and its mma.sync / ldmatrix fragment helpers. Tiles
// are 64 rows of 64 bf16 values in shared-memory rows padded to 72 values
// (144 bytes), which makes every fragment load conflict-free.
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

// rows [rows0, rows0 + 64) of one head into a padded shared tile, 16 bytes a thread
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long row_stride) {
  for (int c = threadIdx.x; c < BN * (DH / 8); c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDS + col) =
        __ldg(reinterpret_cast<const uint4*>(src + (long long)r * row_stride + col));
  }
}

// ---------------------------------------------------------------- bf16

// the running max leaves the exp2 domain for the saved residual; a row no key
// matched keeps the mask value itself
__device__ __forceinline__ float natural_max(float m2) {
  return m2 == MASK_VALUE ? MASK_VALUE : m2 * LN2;
}

// SAVE: also write the row sums l and maxima m ([B, H, S] f32) the backward
// kernels need; the inference instantiation has no such stores.
template <bool SAVE>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
                  const int* __restrict__ seg_kv, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ l_out, float* __restrict__ m_out, int S, Strides sq,
                  Strides sk, Strides sv, Strides so, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 k_s[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 v_s[BN * LDS];
  __shared__ __align__(16) int segk_s[BN];

  const int m0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows of the tile: r0 and r0 + 8

  // q tile -> A fragments in registers (through k_s)
  stage_tile(k_s, q + b * sq.b + h * sq.h + (long long)m0 * sq.s, sq.s);
  __syncthreads();
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(k_s + r0 * LDS + kk * 16 + 2 * t);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(k_s + (r0 + 8) * LDS + kk * 16 + 2 * t);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(k_s + r0 * LDS + kk * 16 + 2 * t + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(k_s + (r0 + 8) * LDS + kk * 16 + 2 * t + 8);
  }
  const int sgq0 = seg_q[(long long)b * S + m0 + r0];
  const int sgq1 = seg_q[(long long)b * S + m0 + r0 + 8];
  __syncthreads();

  float o_acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[dt][e] = 0.f;
  float m_i[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, in the exp2 domain
  float l_i[2] = {0.f, 0.f};                      // this thread's share of the running sum

  const __nv_bfloat16* kh = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vh = v + b * sv.b + h * sv.h;
  const int* sgk = seg_kv + (long long)b * S;
  // ldmatrix row of this lane inside a 16-key x 16-dim block of v_s
  const int v_row = ((lane >> 3) & 1) * 8 + (lane & 7), v_col = (lane >> 4) * 8;

  for (int n0 = 0; n0 < S; n0 += BN) {
    stage_tile(k_s, kh + (long long)n0 * sk.s, sk.s);
    stage_tile(v_s, vh + (long long)n0 * sv.s, sv.s);
    if (threadIdx.x < BN) segk_s[threadIdx.x] = sgk[n0 + threadIdx.x];
    __syncthreads();

    // s = q . kT: 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kr = k_s + (nt * 8 + g) * LDS + kk * 16 + 2 * t;
        mma_bf16_16x8x16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                         *reinterpret_cast<const uint32_t*>(kr),
                         *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    // scale, mask, running max
    float mx0 = m_i[0], mx1 = m_i[1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int2 sg = *reinterpret_cast<const int2*>(segk_s + nt * 8 + 2 * t);
      s[nt][0] = sgq0 == sg.x ? s[nt][0] * scale_log2 : MASK_VALUE;
      s[nt][1] = sgq0 == sg.y ? s[nt][1] * scale_log2 : MASK_VALUE;
      s[nt][2] = sgq1 == sg.x ? s[nt][2] * scale_log2 : MASK_VALUE;
      s[nt][3] = sgq1 == sg.y ? s[nt][3] * scale_log2 : MASK_VALUE;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m_i[0] - mx0), alpha1 = exp2f(m_i[1] - mx1);
    m_i[0] = mx0;
    m_i[1] = mx1;

    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx0);
      s[nt][1] = exp2f(s[nt][1] - mx0);
      s[nt][2] = exp2f(s[nt][2] - mx1);
      s[nt][3] = exp2f(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l_i[0] = l_i[0] * alpha0 + sum0;
    l_i[1] = l_i[1] * alpha1 + sum1;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o_acc[dt][0] *= alpha0;
      o_acc[dt][1] *= alpha0;
      o_acc[dt][2] *= alpha1;
      o_acc[dt][3] *= alpha1;
    }

    // o += p . v, p rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, v_s + (kk * 16 + v_row) * LDS + dp * 16 + v_col);
        mma_bf16_16x8x16(o_acc[2 * dp], a0, a1, a2, a3, b0, b1);
        mma_bf16_16x8x16(o_acc[2 * dp + 1], a0, a1, a2, a3, b2, b3);
      }
    }
    __syncthreads();
  }

  // the four threads of a row hold its sum in shares
  l_i[0] += __shfl_xor_sync(0xffffffffu, l_i[0], 1);
  l_i[0] += __shfl_xor_sync(0xffffffffu, l_i[0], 2);
  l_i[1] += __shfl_xor_sync(0xffffffffu, l_i[1], 1);
  l_i[1] += __shfl_xor_sync(0xffffffffu, l_i[1], 2);
  if (SAVE && t == 0) {
    const long long row = ((long long)b * gridDim.y + h) * S + m0 + r0;
    l_out[row] = l_i[0];
    l_out[row + 8] = l_i[1];
    m_out[row] = natural_max(m_i[0]);
    m_out[row + 8] = natural_max(m_i[1]);
  }
  const float inv0 = 1.f / l_i[0], inv1 = 1.f / l_i[1];
  __nv_bfloat16* o0 = o + b * so.b + h * so.h + (long long)(m0 + r0) * so.s;
  __nv_bfloat16* o1 = o0 + 8 * so.s;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    *reinterpret_cast<uint32_t*>(o0 + dt * 8 + 2 * t) =
        pack_bf16(o_acc[dt][0] * inv0, o_acc[dt][1] * inv0);
    *reinterpret_cast<uint32_t*>(o1 + dt * 8 + 2 * t) =
        pack_bf16(o_acc[dt][2] * inv1, o_acc[dt][3] * inv1);
  }
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
// 64 values of a head contiguous; bf16 when is_bf16, else f32. seg_q, seg_kv
// [B, S] i32, contiguous. S a multiple of 128. l_out, m_out: [B, H, S] f32,
// contiguous, both given (a differentiated call) or both null (inference).
int flash_attention_segments(const void* q, const void* k, const void* v, const void* seg_q,
                             const void* seg_kv, void* o, void* l_out, void* m_out, int B, int H,
                             int S, int is_bf16,
                             long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                             long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                             long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                             float sm_scale, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || S % 128 != 0 ||
      (l_out == nullptr) != (m_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool save = l_out != nullptr;
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss}, sv{v_sb, v_sh, v_ss}, so{o_sb, o_sh, o_ss};
  const float scale_log2 = sm_scale * LOG2E;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    auto kernel = save ? flash_bf16_kernel<true> : flash_bf16_kernel<false>;
    kernel<<<dim3(S / BM, H, B), THREADS, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const int*)seg_q,
        (const int*)seg_kv, (__nv_bfloat16*)o, (float*)l_out, (float*)m_out, S, sq, sk, sv, so,
        scale_log2);
  } else {
    auto kernel = save ? flash_f32_kernel<true> : flash_f32_kernel<false>;
    kernel<<<dim3(S / FM, H, B), FM, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int*)seg_q, (const int*)seg_kv,
        (float*)o, (float*)l_out, (float*)m_out, S, sq, sk, sv, so, scale_log2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
