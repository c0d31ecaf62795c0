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
//                     the latent sum p·c (replaces ~10 launches). Bound: the
//                     cache's bytes, B · positions · 576 · 2 B a layer (27.5 µs
//                     at 32 rows × 2,500 positions on the H100); its ~2 · 16 ·
//                     576 multiply-adds a position are a few µs on the tensor
//                     cores. Design (FlashMLA's shape at 16 heads): the 16
//                     heads of a row that read one latent cache form the M =
//                     16 of mma.sync m16n8k16 (bf16 in, f32 sums), so each
//                     cache row, read once from device memory, feeds both
//                     products: S = Q·Kᵀ (ldmatrix) and O += P·C (ldmatrix
//                     .trans, P rounded to bf16 as the plain version rounds
//                     it). A ring of four chunks of 32 positions in shared
//                     memory, filled by cp.async, keeps three chunks in
//                     flight while one is used; which positions a chunk
//                     sees is read before the loop. A row's chunks are cut
//                     into ⌊SMs / rows⌋ contiguous splits (at least one), a
//                     block each, so the grid fills the card once and no
//                     block is more than a chunk above another; a combine
//                     merges each row's splits. More heads take more M tiles
//                     (a virtual row a tile of 16). ~1.6 µs a chunk a block
//                     in the steady state (≈ 3.0 TB/s); a call's fixed cost
//                     (the ring's first bytes, the combine) ~15 µs.
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

// mma.sync m16n8k16 layouts (PTX ISA): thread `lane` holds A (16 × 16, row
// major) at rows lane/4 (a0, a2) and lane/4 + 8 (a1, a3), columns 2·(lane%4)
// + {0, 1} (a0, a1) and + 8 (a2, a3); B (16 × 8) at k 2·(lane%4) + {0, 1}
// (b0) and + 8 (b1), column lane/4; C (16 × 8) at rows lane/4 (c0, c1) and
// lane/4 + 8 (c2, c3), columns 2·(lane%4) + {0, 1}. Each 32-bit register
// holds two bf16, the lower index in the low half.
constexpr int MLA_HEADS = 16;                  // heads a tile: the M of the products
constexpr int MLA_RANK = 512;
constexpr int MLA_ROPE = 64;
constexpr int MLA_DIM = MLA_RANK + MLA_ROPE;   // a cache row: [c | k_pe]
constexpr int MLA_CHUNK = 32;                  // positions a unit of the plan
constexpr int MLA_STAGES = 4;                  // chunks in the ring: three in flight while one is used
constexpr int MLA_LD = MLA_DIM + 8;            // bf16 a cache row in shared memory: 1,168 bytes, so the 8
                                               // rows an ldmatrix reads fall in 8 distinct bank groups
constexpr int MLA_KHALF = MLA_DIM / 16 / 2;    // k-steps of the scores a warp: half of the 36
constexpr int MLA_COLS = MLA_RANK / WARPS;     // columns of O a warp: 64, eight n-tiles
constexpr int MLA_SLD = MLA_CHUNK + 8;         // f32 a row of the score halves
constexpr int MLA_PLD = MLA_CHUNK + 8;         // bf16 a row of P: 80 bytes, ldmatrix without conflicts
constexpr int MLA_STAGE = MLA_CHUNK * MLA_LD;  // bf16 a stage
constexpr int MLA_SMEM =  // a block's shared memory, besides its seen masks (4 bytes a chunk)
    MLA_STAGES * MLA_STAGE * 2 + 2 * MLA_HEADS * MLA_SLD * 4 + MLA_HEADS * MLA_PLD * 2 + MLA_HEADS * 4;
static_assert(MLA_CHUNK * MLA_DIM / 8 % THREADS == 0, "a chunk's 16-byte pieces split evenly over the threads");
static_assert(MLA_CHUNK == 4 * 8 && WARPS == 8, "warps: four n-tiles of positions times two halves of the depth");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, past L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_16x8x16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Positions [pos0, pos0 + MLA_CHUNK) of one row's cache into a stage; zeros from `end` on.
__device__ __forceinline__ void mla_load_chunk(__nv_bfloat16* stage, const __nv_bfloat16* row, long long kvp,
                                               int pos0, int end) {
  constexpr int PIECES = MLA_DIM / 8;
#pragma unroll
  for (int k = 0; k < MLA_CHUNK * PIECES / THREADS; ++k) {
    const int t = threadIdx.x + k * THREADS, p = t / PIECES, v = t % PIECES, at = pos0 + p;
    cp_async16(stage + p * MLA_LD + v * 8, row + (long long)min(at, end - 1) * kvp + v * 8, at < end ? 16 : 0);
  }
}

// Block g holds split j = g % splits of virtual row v = g / splits (a row's
// tile of 16 heads): chunks [j·chunks / splits, (j + 1)·chunks / splits) of
// MLA_CHUNK positions. First it reads which positions its chunks see into one
// 32-bit mask a chunk: a read of `valid` inside the loop waits behind the
// ring's bytes in the memory queues, microseconds a chunk. Per chunk: warp w
// forms the scores of positions 8·(w % 4) … + 7 over half w / 4 of the depth
// (its 18 k-steps of Q held in registers); the halves meet in shared memory;
// 16 threads a head run the online softmax (running max and sum in their
// registers) and write P in bf16 and the rescale α; warp w adds P·C into its
// 64 columns of O. Then o (unnormalised), m and l go to slot g.
__global__ void __launch_bounds__(THREADS, 1)
mla_decode_mma_kernel(const __nv_bfloat16* __restrict__ q_lat, long long qlh, long long qlb,
                      const __nv_bfloat16* __restrict__ q_pe, long long qpb, long long qph,
                      const __nv_bfloat16* __restrict__ kv, long long kvb, long long kvp,
                      const bool* __restrict__ valid, long long vb, int groups, int first, int end, int chunks,
                      int splits, float scale, float* __restrict__ o_part, float* __restrict__ m_part,
                      float* __restrict__ l_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_half = reinterpret_cast<float*>(ring + MLA_STAGES * MLA_STAGE);                 // [2][16][MLA_SLD]
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(s_half + 2 * MLA_HEADS * MLA_SLD);  // [16][MLA_PLD]
  float* alpha_s = reinterpret_cast<float*>(p_s + MLA_HEADS * MLA_PLD);                    // [16]
  uint32_t* seen_s = reinterpret_cast<uint32_t*>(alpha_s + MLA_HEADS);                     // [n]: chunk i's seen bits

  const int g = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v = g / splits, j = g - v * splits, b = v / groups, tile = v - b * groups;
  const int c_lo = j * chunks / splits, n = (j + 1) * chunks / splits - c_lo;  // the block's chunks
  const int nt = warp & 3, kh = warp >> 2;                       // scores: n-tile, half of the depth
  const int sh = threadIdx.x >> 4, sp = 2 * (threadIdx.x & 15);  // softmax: head, two positions
  const int pos_lo = first + c_lo * MLA_CHUNK;
  const __nv_bfloat16* kv_row = kv + (long long)b * kvb;

  auto fetch = [&](int i) {  // the block's i-th chunk into stage i % MLA_STAGES
    if (i < n) mla_load_chunk(ring + (i % MLA_STAGES) * MLA_STAGE, kv_row, kvp, pos_lo + i * MLA_CHUNK, end);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < MLA_STAGES - 1; ++i) fetch(i);
  for (int k = threadIdx.x; k < n; k += THREADS) {  // seen: valid, or the row's own last position
    const int pos0 = pos_lo + k * MLA_CHUNK;
    const bool* row = valid + b * vb;
    uint32_t mask = 0;
#pragma unroll
    for (int p = 0; p < MLA_CHUNK; ++p) {  // every read in bounds, so all 32 go out at once
      const int at = pos0 + p;
      const bool ok = row[min(at, end - 1)];
      if (at < end && (at == end - 1 || ok)) mask |= 1u << p;
    }
    seen_s[k] = mask;
  }

  uint32_t qa[MLA_KHALF][4];  // this warp's half of the queries' depth, as the A operand
  {
    const int h0 = tile * MLA_HEADS + (lane >> 2), h1 = h0 + 8;
#pragma unroll
    for (int k = 0; k < MLA_KHALF; ++k) {
      const int d = 16 * (kh * MLA_KHALF + k) + 2 * (lane & 3);
      const __nv_bfloat16* q0 =
          d < MLA_RANK ? q_lat + h0 * qlh + b * qlb + d : q_pe + b * qpb + h0 * qph + (d - MLA_RANK);
      const __nv_bfloat16* q1 =
          d < MLA_RANK ? q_lat + h1 * qlh + b * qlb + d : q_pe + b * qpb + h1 * qph + (d - MLA_RANK);
      qa[k][0] = *reinterpret_cast<const uint32_t*>(q0);
      qa[k][1] = *reinterpret_cast<const uint32_t*>(q1);
      qa[k][2] = *reinterpret_cast<const uint32_t*>(q0 + 8);
      qa[k][3] = *reinterpret_cast<const uint32_t*>(q1 + 8);
    }
  }
  float o[MLA_COLS / 8][4] = {};
  float m_run = -INFINITY, l_run = 0.0f;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<MLA_STAGES - 2>();  // this thread's pieces of chunk i have landed
    __syncthreads();                  // everyone's have, and chunk i − 1's stage is free
    fetch(i + MLA_STAGES - 1);
    const __nv_bfloat16* stage = ring + (i % MLA_STAGES) * MLA_STAGE;

    {  // a half of S: 16 heads × 8 positions over 18 k-steps, three sums in turn to shorten the chain
      float acc[3][4] = {};
      const __nv_bfloat16* k_rows = stage + (8 * nt + (lane & 7)) * MLA_LD + 16 * kh * MLA_KHALF + 8 * (lane >> 3);
#pragma unroll
      for (int k = 0; k < MLA_KHALF; k += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, k_rows + 16 * k);
        mma_16x8x16(acc[k % 3], qa[k], kb[0], kb[1]);
        mma_16x8x16(acc[(k + 1) % 3], qa[k + 1], kb[2], kb[3]);
      }
      float* dst = s_half + (kh * MLA_HEADS + (lane >> 2)) * MLA_SLD + 8 * nt + 2 * (lane & 3);
      *reinterpret_cast<float2*>(dst) =
          make_float2(acc[0][0] + acc[1][0] + acc[2][0], acc[0][1] + acc[1][1] + acc[2][1]);
      *reinterpret_cast<float2*>(dst + 8 * MLA_SLD) =
          make_float2(acc[0][2] + acc[1][2] + acc[2][2], acc[0][3] + acc[1][3] + acc[2][3]);
    }
    __syncthreads();

    {  // the online softmax of head sh at positions sp, sp + 1
      const float2 h0 = *reinterpret_cast<const float2*>(s_half + sh * MLA_SLD + sp);
      const float2 h1 = *reinterpret_cast<const float2*>(s_half + (MLA_HEADS + sh) * MLA_SLD + sp);
      const uint32_t seen = seen_s[i] >> sp;
      const bool see0 = seen & 1u, see1 = seen & 2u;
      const float s0 = see0 ? (h0.x + h1.x) * scale : -INFINITY;
      const float s1 = see1 ? (h0.y + h1.y) * scale : -INFINITY;
      const float m_new = fmaxf(m_run, half_warp_max(fmaxf(s0, s1)));
      float e0 = 0.0f, e1 = 0.0f, alpha = 1.0f;
      if (m_new != -INFINITY) {
        e0 = see0 ? expf(s0 - m_new) : 0.0f;
        e1 = see1 ? expf(s1 - m_new) : 0.0f;
        alpha = m_run == -INFINITY ? 0.0f : expf(m_run - m_new);
      }
      l_run = l_run * alpha + half_warp_sum(e0 + e1);
      m_run = m_new;
      *reinterpret_cast<__nv_bfloat162*>(p_s + sh * MLA_PLD + sp) = __floats2bfloat162_rn(e0, e1);
      if ((threadIdx.x & 15) == 0) alpha_s[sh] = alpha;
    }
    __syncthreads();

    {  // O[:, 64·warp …] = α · O + P · C
      const float a_lo = alpha_s[lane >> 2], a_hi = alpha_s[(lane >> 2) + 8];
#pragma unroll
      for (int t = 0; t < MLA_COLS / 8; ++t) {
        o[t][0] *= a_lo;
        o[t][1] *= a_lo;
        o[t][2] *= a_hi;
        o[t][3] *= a_hi;
      }
      const int r8 = (lane & 7) + 8 * ((lane >> 3) & 1), c8 = 8 * (lane >> 4);
#pragma unroll
      for (int ks = 0; ks < MLA_CHUNK / 16; ++ks) {
        uint32_t pa[4];
        ldmatrix_x4(pa, p_s + r8 * MLA_PLD + 16 * ks + c8);
        const __nv_bfloat16* c_rows = stage + (16 * ks + r8) * MLA_LD + MLA_COLS * warp + c8;
#pragma unroll
        for (int q = 0; q < MLA_COLS / 16; ++q) {
          uint32_t cb[4];
          ldmatrix_x4_trans(cb, c_rows + 16 * q);
          mma_16x8x16(o[2 * q], pa, cb[0], cb[1]);
          mma_16x8x16(o[2 * q + 1], pa, cb[2], cb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* op = o_part + ((long long)g * MLA_HEADS + (lane >> 2)) * MLA_RANK + MLA_COLS * warp + 2 * (lane & 3);
#pragma unroll
  for (int t = 0; t < MLA_COLS / 8; ++t) {
    *reinterpret_cast<float2*>(op + 8 * t) = make_float2(o[t][0], o[t][1]);
    *reinterpret_cast<float2*>(op + 8 * MLA_RANK + 8 * t) = make_float2(o[t][2], o[t][3]);
  }
  if ((threadIdx.x & 15) == 0) {
    m_part[g * MLA_HEADS + sh] = m_run;
    l_part[g * MLA_HEADS + sh] = l_run;
  }
}

// Block (b, h): the splits of row b's head h, weighted by exp(m − max m), over
// the weighted l, into out [h · oh + b · ob + c] (bf16). 128 threads, four
// columns each.
__global__ void __launch_bounds__(128)
mla_decode_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                          const float* __restrict__ l_part, int groups, int splits,
                          __nv_bfloat16* __restrict__ out, long long oh, long long ob) {
  const long long b = blockIdx.x;
  const int h = blockIdx.y, hl = h % MLA_HEADS;
  const long long g_lo = (b * groups + h / MLA_HEADS) * splits;  // the row's first block
  float mx = -INFINITY;
  for (int j = 0; j < splits; ++j) mx = fmaxf(mx, m_part[(g_lo + j) * MLA_HEADS + hl]);
  float l = 0.0f;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int col = 4 * threadIdx.x;
  for (int j = 0; j < splits; ++j) {
    const long long slot = (g_lo + j) * MLA_HEADS + hl;
    const float m = m_part[slot];
    if (m == -INFINITY) continue;
    const float w = expf(m - mx);
    l += w * l_part[slot];
    const float4 x = *reinterpret_cast<const float4*>(o_part + slot * MLA_RANK + col);
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  if (l == 0.0f) l = INFINITY;  // no position seen: zeros
  __nv_bfloat16* dst = out + h * oh + b * ob + col;
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(acc.x / l, acc.y / l);
  *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(acc.z / l, acc.w / l);
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
// one always seen → out [heads, b, rank] bf16 (strides oh, ob). heads a multiple of 16, rank 512, rope 64.
// `splits` blocks a row of 16 heads (1 to its chunks); o_part [b · heads/16 · splits, 16, rank], m_part and
// l_part [b · heads/16 · splits, 16] f32 are scratch.
int mla_decode(const void* q_lat, long long qlh, long long qlb, const void* q_pe, long long qpb, long long qph,
               const void* kv, long long kvb, long long kvp, const void* valid, long long vb, int batch, int heads,
               int rank, int rope, int first, int end, int splits, float scale, void* o_part, void* m_part,
               void* l_part, void* out, long long oh, long long ob, void* stream) {
  const int chunks = (end - first + MLA_CHUNK - 1) / MLA_CHUNK;
  if (batch <= 0 || heads <= 0 || heads % MLA_HEADS != 0 || rank != MLA_RANK || rope != MLA_ROPE || first < 0 ||
      end <= first || splits <= 0 || splits > chunks)
    return (int)cudaErrorInvalidValue;
  const int groups = heads / MLA_HEADS;
  const long long grid = (long long)batch * groups * splits;
  const size_t smem = MLA_SMEM + 4 * (size_t)((chunks + splits - 1) / splits);  // the longest split's masks
  if (smem > 232448 || grid > 0x7fffffff) return (int)cudaErrorInvalidValue;  // the most a block may take
  cudaError_t err =
      cudaFuncSetAttribute(mla_decode_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mla_decode_mma_kernel<<<(unsigned)grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q_lat, qlh, qlb, (const __nv_bfloat16*)q_pe, qpb, qph, (const __nv_bfloat16*)kv, kvb,
      kvp, (const bool*)valid, vb, groups, first, end, chunks, splits, scale, (float*)o_part, (float*)m_part,
      (float*)l_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_decode_combine_kernel<<<dim3((unsigned)batch, (unsigned)heads), 128, 0, (cudaStream_t)stream>>>(
      (const float*)o_part, (const float*)m_part, (const float*)l_part, groups, splits, (__nv_bfloat16*)out, oh,
      ob);
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
