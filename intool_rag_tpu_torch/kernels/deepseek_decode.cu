// The DeepSeek-V2 decoder's one-token step (models/deepseek_v2.py,
// _DecodeSteps), fused where plain PyTorch launches a kernel an operation.
//
// Replaces no TPU kernel: the JAX package has no DeepSeek-V2 decoder. Added
// because a decode step of plain operations launched ~2,800 kernels (27
// layers of ~100 small ones), which made each step's host and profiler cost
// grow with the kernel count, not with the work. Each entry point here does
// the work of several plain operations in one launch:
//
//   rms_norm          RMSNorm of bf16 rows, optionally after a residual add
//                     (replaces 8 launches, or 9 with the add). Bound: bytes.
//   mla_rope_latent   from the fused q / kv_a projection's row: the heads'
//                     q_pe and the shared k_pe through YaRN rope (HF's
//                     de-interleave, rotate-half), and the latent c through
//                     its RMSNorm; writes q_pe [B, H, rope] and the cache entry
//                     [c | k_pe] (replaces ~20 launches). Bound: bytes.
//   mla_decode        the absorbed attention of one query a row over the
//                     latent cache: scores q_lat·c + q_pe·k_pe, softmax, and
//                     the latent sum p·c, in splits of the positions
//                     (flash-decoding) and a combine (replaces ~10 launches).
//                     Bound: the cache's bytes (B · positions · 576 · 2 B a
//                     layer) and 2 · 16 · 576 FMAs a position and head group
//                     on the CUDA cores.
//   moe_router        softmax over the experts' logits, greedy top-k, the
//                     dense gate matrix [T, E], and the expert layer's tally
//                     of real tokens' pairs, touched experts and the largest
//                     expert's pairs (replaces ~15 launches). Bound: launch.
//   moe_combine       y[t] = sum over e of gate[t, e] · out[e, t], in f32,
//                     rounded once (replaces 4 launches). Bound: bytes.
//
// Arithmetic follows the plain versions in ops/deepseek_decode.py: f32
// inside, bf16 in and out, rope and the norms' products rounded as PyTorch
// rounds them (__fmul_rn / __fadd_rn keep nvcc from contracting them into
// FMAs). Sums run in another order than PyTorch's reductions.
//
// Built by kernels/build.py with nvcc for sm_90a into a shared library with a
// plain C interface (loaded through ctypes). Each entry point returns the
// cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

constexpr int NP = 32;          // cache positions a chunk of mla_decode (one a lane)
constexpr int MAX_HEADS = 16;   // mla_decode: one head a group of 16 threads in the latent sum
constexpr int MAX_PAIRS = 16;   // mla_decode: value pairs a thread accumulates (rank <= 2 * 16 * 16)
constexpr int MAX_EXPERTS = 64; // moe_router: two a lane

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 tobf(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Sum over the block; every thread gets the same value. `scratch` holds WARPS floats.
__device__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += scratch[w];
  return total;
}

// ---------------- rms_norm ----------------

// One row a block. With `res`, the row is s = bf16(x + res) (written to
// sum_out [n, d]); out [n, d] = bf16((s · rsqrt(mean(s²) + eps)) · w).
__global__ void __launch_bounds__(THREADS)
rms_norm_kernel(const __nv_bfloat16* __restrict__ x, long long xs, const __nv_bfloat16* __restrict__ res,
                long long rs, const __nv_bfloat16* __restrict__ w, int d, float eps,
                __nv_bfloat16* __restrict__ sum_out, __nv_bfloat16* __restrict__ out) {
  __shared__ float scratch[WARPS];
  const long long row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * xs;
  float ss = 0.0f;
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float v = bf(xr[c]);
    if (res != nullptr) {
      const __nv_bfloat16 s = tobf(__fadd_rn(v, bf(res[row * rs + c])));
      sum_out[row * d + c] = s;
      v = bf(s);
    }
    ss += v * v;
  }
  ss = block_sum(ss, scratch);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int c = threadIdx.x; c < d; c += THREADS) {
    const float v = res != nullptr ? bf(sum_out[row * d + c]) : bf(xr[c]);
    out[row * d + c] = tobf(__fmul_rn(__fmul_rn(v, r), bf(w[c])));
  }
}

// ---------------- mla_rope_latent ----------------

// One row a block. The row of the fused projection holds the heads' queries
// (nope then rope dims each), then c [rank], then k_pe [rope].
__global__ void __launch_bounds__(THREADS)
mla_rope_latent_kernel(const __nv_bfloat16* __restrict__ qkv, long long qs, const long long* __restrict__ pos,
                       const float* __restrict__ inv_freq, float rope_scale, const __nv_bfloat16* __restrict__ kv_w,
                       float eps, int heads, int nope, int rope, int rank, __nv_bfloat16* __restrict__ q_pe,
                       __nv_bfloat16* __restrict__ latent) {
  __shared__ float cs[64];
  __shared__ float sn[64];
  __shared__ float scratch[WARPS];
  const long long b = blockIdx.x;
  const int half = rope / 2, width = nope + rope, dim = rank + rope;
  const __nv_bfloat16* row = qkv + b * qs;
  if (threadIdx.x < half) {
    const float a = __fmul_rn((float)pos[b], inv_freq[threadIdx.x]);
    cs[threadIdx.x] = __fmul_rn(cosf(a), rope_scale);
    sn[threadIdx.x] = __fmul_rn(sinf(a), rope_scale);
  }
  __syncthreads();
  // vector v < heads: head v's q_pe; v == heads: the shared k_pe. Pair i: dims 2i, 2i+1 → i, i + half.
  for (int t = threadIdx.x; t < (heads + 1) * half; t += THREADS) {
    const int v = t / half, i = t % half;
    const __nv_bfloat16* src = v < heads ? row + v * width + nope : row + heads * width + rank;
    const float x0 = bf(src[2 * i]), x1 = bf(src[2 * i + 1]);
    const float lo = __fadd_rn(__fmul_rn(x0, cs[i]), -__fmul_rn(x1, sn[i]));
    const float hi = __fadd_rn(__fmul_rn(x1, cs[i]), __fmul_rn(x0, sn[i]));
    __nv_bfloat16* dst = v < heads ? q_pe + (b * heads + v) * rope : latent + b * dim + rank;
    dst[i] = tobf(lo);
    dst[i + half] = tobf(hi);
  }
  const __nv_bfloat16* c = row + heads * width;
  float ss = 0.0f;
  for (int j = threadIdx.x; j < rank; j += THREADS) {
    const float v = bf(c[j]);
    ss += v * v;
  }
  ss = block_sum(ss, scratch);
  const float r = rsqrtf(ss / (float)rank + eps);
  for (int j = threadIdx.x; j < rank; j += THREADS)
    latent[b * dim + j] = tobf(__fmul_rn(__fmul_rn(bf(c[j]), r), bf(kv_w[j])));
}

// ---------------- mla_decode ----------------

// Block (b, split): positions [first + split · per_split, …) of row b, all
// heads. Shared: the row's queries [heads][LD] and a chunk of NP cache rows
// [NP][LD] in bf16 (LD = dim + 2: an odd count of 4-byte words a row, so a
// warp's 32 rows fall in 32 banks), the chunk's probabilities [heads][NP].
// Writes the split's unnormalised sum o [rank], running max m and sum l a
// head.
__global__ void __launch_bounds__(THREADS)
mla_decode_partial_kernel(const __nv_bfloat16* __restrict__ q_lat, long long qlh, long long qlb,
                          const __nv_bfloat16* __restrict__ q_pe, long long qpb, long long qph,
                          const __nv_bfloat16* __restrict__ kv, long long kvb, long long kvp,
                          const bool* __restrict__ valid, long long vb, int heads, int rank, int rope, int first,
                          int end, int per_split, float scale, float* __restrict__ o_part,
                          float* __restrict__ m_part, float* __restrict__ l_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[MAX_HEADS], l_s[MAX_HEADS], alpha_s[MAX_HEADS];
  const int dim = rank + rope, ld = dim + 2, half_dim = dim / 2;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* lat_s = q_s + heads * ld;
  float* p_s = reinterpret_cast<float*>(smem + (((size_t)(heads + NP) * ld * 2 + 15) / 16) * 16);

  const long long b = blockIdx.x;
  const int split = blockIdx.y;
  const int lo = first + split * per_split;
  const int hi = min(end, lo + per_split);

  for (int t = threadIdx.x; t < heads * half_dim; t += THREADS) {
    const int h = t / half_dim, j = 2 * (t % half_dim);
    const __nv_bfloat16* src = j < rank ? q_lat + h * qlh + b * qlb + j : q_pe + b * qpb + h * qph + (j - rank);
    *reinterpret_cast<__nv_bfloat162*>(q_s + h * ld + j) = *reinterpret_cast<const __nv_bfloat162*>(src);
  }
  if (threadIdx.x < heads) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.0f;
  }
  const int h_pv = threadIdx.x / 16, lane16 = threadIdx.x % 16;
  float acc[2 * MAX_PAIRS];
#pragma unroll
  for (int k = 0; k < 2 * MAX_PAIRS; ++k) acc[k] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int vecs = dim / 8;
  for (int c0 = lo; c0 < hi; c0 += NP) {
    const int n = min(NP, hi - c0);
    for (int t = threadIdx.x; t < n * vecs; t += THREADS) {
      const int p = t / vecs, v = t % vecs;
      const uint4 val = *reinterpret_cast<const uint4*>(kv + b * kvb + (long long)(c0 + p) * kvp + v * 8);
      uint32_t* dst = reinterpret_cast<uint32_t*>(lat_s + p * ld + v * 8);
      dst[0] = val.x;
      dst[1] = val.y;
      dst[2] = val.z;
      dst[3] = val.w;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < heads * NP; t += THREADS) {
      const int h = t / NP, p = t % NP, at = c0 + p;
      float s = -INFINITY;
      if (p < n && (valid[b * vb + at] || at == end - 1)) {
        const __nv_bfloat162* qa = reinterpret_cast<const __nv_bfloat162*>(q_s + h * ld);
        const __nv_bfloat162* la = reinterpret_cast<const __nv_bfloat162*>(lat_s + p * ld);
        float d0 = 0.0f, d1 = 0.0f;
        for (int j = 0; j < half_dim; ++j) {
          const float2 qf = __bfloat1622float2(qa[j]);
          const float2 lf = __bfloat1622float2(la[j]);
          d0 = fmaf(qf.x, lf.x, d0);
          d1 = fmaf(qf.y, lf.y, d1);
        }
        s = (d0 + d1) * scale;
      }
      p_s[h * NP + p] = s;
    }
    __syncthreads();
    for (int h = warp; h < heads; h += WARPS) {  // online softmax, a warp a head
      const float s = p_s[h * NP + lane];
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, warp_max(s));
      float e = 0.0f, alpha = 1.0f;
      if (m_new != -INFINITY) {
        e = s == -INFINITY ? 0.0f : expf(s - m_new);
        alpha = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
      }
      const float sum = warp_sum(e);
      p_s[h * NP + lane] = e;
      __syncwarp();
      if (lane == 0) {
        m_s[h] = m_new;
        l_s[h] = l_s[h] * alpha + sum;
        alpha_s[h] = alpha;
      }
    }
    __syncthreads();
    if (h_pv < heads) {  // the latent sum: head h_pv, value pairs lane16 + 16k
      const float a = alpha_s[h_pv];
#pragma unroll
      for (int k = 0; k < 2 * MAX_PAIRS; ++k) acc[k] *= a;
      for (int p = 0; p < n; ++p) {
        const float pv = p_s[h_pv * NP + p];
        const __nv_bfloat162* la = reinterpret_cast<const __nv_bfloat162*>(lat_s + p * ld);
#pragma unroll
        for (int k = 0; k < MAX_PAIRS; ++k) {
          const int j = lane16 + 16 * k;
          if (2 * j < rank) {
            const float2 f = __bfloat1622float2(la[j]);
            acc[2 * k] = fmaf(pv, f.x, acc[2 * k]);
            acc[2 * k + 1] = fmaf(pv, f.y, acc[2 * k + 1]);
          }
        }
      }
    }
    __syncthreads();
  }
  const size_t base = ((size_t)b * gridDim.y + split) * heads;
  if (h_pv < heads) {
#pragma unroll
    for (int k = 0; k < MAX_PAIRS; ++k) {
      const int j = lane16 + 16 * k;
      if (2 * j < rank) {
        o_part[(base + h_pv) * rank + 2 * j] = acc[2 * k];
        o_part[(base + h_pv) * rank + 2 * j + 1] = acc[2 * k + 1];
      }
    }
  }
  if (threadIdx.x < heads) {
    m_part[base + threadIdx.x] = m_s[threadIdx.x];
    l_part[base + threadIdx.x] = l_s[threadIdx.x];
  }
}

// Block (b, h): the splits' sums weighted by exp(m_s − max m), over the
// weighted l, into out [h · oh + b · ob + c] (bf16).
__global__ void __launch_bounds__(128)
mla_decode_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                          const float* __restrict__ l_part, int splits, int heads, int rank,
                          __nv_bfloat16* __restrict__ out, long long oh, long long ob) {
  const long long b = blockIdx.x;
  const int h = blockIdx.y;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m_part[(b * splits + s) * heads + h]);
  float l = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float m = m_part[(b * splits + s) * heads + h];
    if (m != -INFINITY) l += expf(m - mx) * l_part[(b * splits + s) * heads + h];
  }
  for (int c = threadIdx.x; c < rank; c += blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float m = m_part[(b * splits + s) * heads + h];
      if (m != -INFINITY) acc += expf(m - mx) * o_part[((b * splits + s) * heads + h) * rank + c];
    }
    out[h * oh + b * ob + c] = tobf(l > 0.0f ? acc / l : 0.0f);
  }
}

// ---------------- moe_router ----------------

// One block. A warp a token row: softmax over E ≤ 64 logits (two a lane),
// k rounds of a warp argmax (ties to the lower expert), the dense gates, and
// the real rows' pairs counted an expert in shared memory; then one warp adds
// (pairs, touched experts, largest expert's pairs) to tally rows [0, rows).
__global__ void __launch_bounds__(THREADS)
moe_router_kernel(const float* __restrict__ logits, int t_rows, int experts, int k, float factor,
                  const bool* __restrict__ real, float* __restrict__ gates, long long* __restrict__ tally,
                  int tally_rows) {
  __shared__ int counts[MAX_EXPERTS];
  if (threadIdx.x < MAX_EXPERTS) counts[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e0 = lane, e1 = lane + 32;
  for (int row = warp; row < t_rows; row += WARPS) {
    const float* lr = logits + (long long)row * experts;
    const float v0 = e0 < experts ? lr[e0] : -INFINITY;
    const float v1 = e1 < experts ? lr[e1] : -INFINITY;
    const float mx = warp_max(fmaxf(v0, v1));
    const float x0 = e0 < experts ? expf(v0 - mx) : 0.0f;
    const float x1 = e1 < experts ? expf(v1 - mx) : 0.0f;
    const float sum = warp_sum(x0 + x1);
    const float p0 = x0 / sum, p1 = x1 / sum;
    bool s0 = false, s1 = false;
    for (int j = 0; j < k; ++j) {
      const float c0 = (e0 < experts && !s0) ? p0 : -1.0f;
      const float c1 = (e1 < experts && !s1) ? p1 : -1.0f;
      float bv = c0;
      int bi = e0;
      if (c1 > c0) {
        bv = c1;
        bi = e1;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, o);
        const int oi = __shfl_xor_sync(FULL, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      s0 = s0 || bi == e0;
      s1 = s1 || bi == e1;
    }
    if (e0 < experts) gates[(long long)row * experts + e0] = s0 ? p0 * factor : 0.0f;
    if (e1 < experts) gates[(long long)row * experts + e1] = s1 ? p1 * factor : 0.0f;
    if (real == nullptr || real[row]) {
      if (s0) atomicAdd(&counts[e0], 1);
      if (s1) atomicAdd(&counts[e1], 1);
    }
  }
  __syncthreads();
  if (tally != nullptr && warp == 0) {
    const int c0 = e0 < experts ? counts[e0] : 0, c1 = e1 < experts ? counts[e1] : 0;
    int pairs = c0 + c1, touched = (c0 > 0) + (c1 > 0), most = max(c0, c1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      pairs += __shfl_xor_sync(FULL, pairs, o);
      touched += __shfl_xor_sync(FULL, touched, o);
      most = max(most, __shfl_xor_sync(FULL, most, o));
    }
    if (lane == 0) {
      for (int r = 0; r < tally_rows; ++r) {
        tally[r * 3 + 0] += pairs;
        tally[r * 3 + 1] += touched;
        tally[r * 3 + 2] += most;
      }
    }
  }
}

// ---------------- moe_combine ----------------

// Block (t, column block): y[t, c] = bf16(sum over e, ascending, of gate[t, e] · out[e, t, c]).
__global__ void __launch_bounds__(THREADS)
moe_combine_kernel(const __nv_bfloat16* __restrict__ out, const float* __restrict__ gates, int experts, int t_rows,
                   int hidden, __nv_bfloat16* __restrict__ y) {
  const long long t = blockIdx.x;
  const int c = blockIdx.y * THREADS + threadIdx.x;
  if (c >= hidden) return;
  float acc = 0.0f;
  for (int e = 0; e < experts; ++e) {
    const float g = gates[t * experts + e];
    if (g != 0.0f) acc = fmaf(g, bf(out[((long long)e * t_rows + t) * hidden + c]), acc);
  }
  y[t * hidden + c] = tobf(acc);
}

}  // namespace

extern "C" {

// x [n, d] bf16 (row stride xs) → out [n, d]; with res (row stride rs), also sum_out [n, d] = x + res.
int rms_norm(const void* x, long long xs, const void* res, long long rs, const void* w, int n, int d, float eps,
             void* sum_out, void* out, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  rms_norm_kernel<<<(unsigned)n, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, xs, (const __nv_bfloat16*)res, rs, (const __nv_bfloat16*)w, d, eps,
      (__nv_bfloat16*)sum_out, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

// qkv [b, *] bf16 (row stride qs), pos [b] int64, inv_freq [rope/2] f32, kv_w [rank] bf16
// → q_pe [b, heads, rope], latent [b, rank + rope] (bf16, contiguous).
int mla_rope_latent(const void* qkv, long long qs, const void* pos, const void* inv_freq, float rope_scale,
                    const void* kv_w, float eps, int batch, int heads, int nope, int rope, int rank, void* q_pe,
                    void* latent, void* stream) {
  if (batch <= 0 || heads <= 0 || rope <= 0 || rope % 2 != 0 || rope > 128 || rank <= 0)
    return (int)cudaErrorInvalidValue;
  mla_rope_latent_kernel<<<(unsigned)batch, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qkv, qs, (const long long*)pos, (const float*)inv_freq, rope_scale,
      (const __nv_bfloat16*)kv_w, eps, heads, nope, rope, rank, (__nv_bfloat16*)q_pe, (__nv_bfloat16*)latent);
  return (int)cudaGetLastError();
}

// q_lat [heads, b, rank] (strides qlh, qlb), q_pe [b, heads, rope] (strides qpb, qph), kv [b, positions,
// rank + rope] (strides kvb, kvp), valid [b, positions] bool (stride vb); positions [first, end), the last
// one always seen → out [heads, b, rank] bf16 (strides oh, ob). o_part [b, splits, heads, rank], m_part and
// l_part [b, splits, heads] f32 are scratch.
int mla_decode(const void* q_lat, long long qlh, long long qlb, const void* q_pe, long long qpb, long long qph,
               const void* kv, long long kvb, long long kvp, const void* valid, long long vb, int batch, int heads,
               int rank, int rope, int first, int end, int splits, float scale, void* o_part, void* m_part,
               void* l_part, void* out, long long oh, long long ob, void* stream) {
  const int dim = rank + rope;
  if (batch <= 0 || heads <= 0 || heads > MAX_HEADS || rank <= 0 || rank > 2 * 16 * MAX_PAIRS || rank % 2 != 0 ||
      dim % 8 != 0 || first < 0 || end <= first || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int per_split = (end - first + splits - 1) / splits;
  const size_t smem = (((size_t)(heads + NP) * (dim + 2) * 2 + 15) / 16) * 16 + (size_t)heads * NP * 4;
  cudaError_t err = cudaFuncSetAttribute(mla_decode_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  mla_decode_partial_kernel<<<dim3((unsigned)batch, (unsigned)splits), THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q_lat, qlh, qlb, (const __nv_bfloat16*)q_pe, qpb, qph, (const __nv_bfloat16*)kv, kvb,
      kvp, (const bool*)valid, vb, heads, rank, rope, first, end, per_split, scale, (float*)o_part, (float*)m_part,
      (float*)l_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_decode_combine_kernel<<<dim3((unsigned)batch, (unsigned)heads), 128, 0, (cudaStream_t)stream>>>(
      (const float*)o_part, (const float*)m_part, (const float*)l_part, splits, heads, rank, (__nv_bfloat16*)out,
      oh, ob);
  return (int)cudaGetLastError();
}

// logits [t, experts] f32 → gates [t, experts] f32; real [t] bool or null; tally [tally_rows, 3] int64 or null.
int moe_router(const void* logits, int t_rows, int experts, int k, float factor, const void* real, void* gates,
               void* tally, int tally_rows, void* stream) {
  if (t_rows <= 0 || experts <= 0 || experts > MAX_EXPERTS || k <= 0 || k > experts) return (int)cudaErrorInvalidValue;
  moe_router_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>((const float*)logits, t_rows, experts, k, factor,
                                                             (const bool*)real, (float*)gates, (long long*)tally,
                                                             tally_rows);
  return (int)cudaGetLastError();
}

// out [experts, t, hidden] bf16, gates [t, experts] f32 → y [t, hidden] bf16 (all contiguous).
int moe_combine(const void* out, const void* gates, int experts, int t_rows, int hidden, void* y, void* stream) {
  if (experts <= 0 || t_rows <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  moe_combine_kernel<<<dim3((unsigned)t_rows, (unsigned)((hidden + THREADS - 1) / THREADS)), THREADS, 0,
                       (cudaStream_t)stream>>>((const __nv_bfloat16*)out, (const float*)gates, experts, t_rows,
                                               hidden, (__nv_bfloat16*)y);
  return (int)cudaGetLastError();
}

}  // extern "C"
