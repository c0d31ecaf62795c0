// Fused flat-search score + grouped partial max (the dense stage of /search).
//
// Replaces the two Pallas TPU kernels of intool_rag_tpu/ops/flat_pallas.py:
//   _partial_topk_kernel       (bf16/f32 corpus, optional split-query q_lo pass)
//   _partial_topk_kernel_int8  (int8 corpus, optional q2 and residual-plane c2 passes)
// and their shared epilogue _reduce_block.
//
// Contract (identical to the TPU kernels): corpus block b covers rows
// [b*block_n, (b+1)*block_n) with block_n = 128*group_l. For lane in [0, 128):
//   cand_vals[q, b*128 + lane] = max_j score[q, b*block_n + j*128 + lane]
//   cand_idx [q, b*128 + lane] = b*block_n + j* * 128 + lane
// where j* is the smallest maximizing j (a group that is all -inf gives j* = 0)
// and rows >= valid_n score -inf. The [Q, N] score matrix never reaches HBM:
// each CTA keeps a running max over its block's group_l 128-row tiles in
// registers and writes only the [Q, N/group_l] candidates.
//
// Bound on an H100: at the service's batch sizes the kernel streams the
// corpus once (bytes); at Q = 256 the 2-3 tensor-core products per block make
// it operations-bound. This first version uses warp-level WMMA tiles
// (bf16 -> f32, s8 -> s32) with synchronous shared-memory staging; the f32
// variant runs on CUDA-core FMA so its products stay full precision, as the
// TPU kernel's HIGHEST-precision dot does.
//
// Built by kernels/build.py with nvcc for sm_90a into a shared library with a
// plain C interface (loaded through ctypes). Each entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math_constants.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int LW = 128;          // candidate lanes per corpus block
constexpr int BQ = 64;           // query rows per CTA
constexpr int THREADS = 256;     // 8 warps: 2 (queries) x 4 (corpus rows), 32x32 each
constexpr int ROW_BYTES = 128;   // bytes of one row staged per k-chunk
constexpr int S_LD = LW + 4;     // score tile leading dimension (floats)
constexpr int OWN = BQ * LW / THREADS;  // score elements each thread reduces: 32

// Running grouped max of the scores a thread owns across a block's group_l
// 128-row tiles. Strict '>' keeps the FIRST maximizing tile index j, which is
// the TPU kernel's first-occurrence argmax; an all -inf group keeps j = 0.
struct RunningMax {
  float best[OWN];
  int bestj[OWN];
  __device__ void init() {
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      best[i] = -CUDART_INF_F;
      bestj[i] = 0;
    }
  }
};

// Copies a [rows, 128 bytes] tile (row stride ld elements of T in global
// memory) into shared memory in k-block-major order: 16-element k-blocks,
// each a dense [rows, 16] matrix, so every WMMA fragment pointer is 32-byte
// aligned with ldm = 16. Rows at or past row_limit are zero-filled.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          long long ld, int row0, int row_limit, int k0) {
  constexpr int CHUNKS = ROW_BYTES / 16;            // 16-byte chunks per row: 8
  constexpr int KB_BYTES = 16 * sizeof(T);          // bytes of one k-block row
  constexpr int TOTAL = ROWS * CHUNKS;
  char* dst_b = reinterpret_cast<char*>(dst);
#pragma unroll
  for (int it = 0; it < TOTAL / THREADS; ++it) {
    int id = threadIdx.x + it * THREADS;
    // 8 consecutive threads take 8 rows of one chunk (conflict-free stores);
    // a warp covers 8 rows x 4 chunks (64 contiguous bytes per row).
    int r = (id & 7) + 8 * (id >> 6);
    int c = (id >> 3) & 7;
    int row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < row_limit) {
      const char* g = reinterpret_cast<const char*>(src + (long long)row * ld + k0) + c * 16;
      v = *reinterpret_cast<const uint4*>(g);
    }
    int byte0 = c * 16;                         // byte offset within the 128-byte row
    int kb = byte0 / KB_BYTES;
    int within = byte0 % KB_BYTES;
    *reinterpret_cast<uint4*>(dst_b + kb * ROWS * KB_BYTES + r * KB_BYTES + within) = v;
  }
}

// Folds this tile's scores (in shared memory) into the running max and
// applies the per-row corpus scale and the valid_n mask.
__device__ __forceinline__ void fold_tile(RunningMax& rm, const float* __restrict__ s_tile,
                                          const float* __restrict__ cscale, long long row_base,
                                          int j, int valid_n) {
  const int lane = threadIdx.x % LW;
  const long long n = row_base + lane;
  const float cs = cscale != nullptr ? cscale[n] : 1.0f;
  const bool valid = n < valid_n;
#pragma unroll
  for (int i = 0; i < OWN; ++i) {
    int r = threadIdx.x / LW + 2 * i;
    float s = s_tile[r * S_LD + lane];
    if (cscale != nullptr) s = s * cs;
    if (!valid) s = -CUDART_INF_F;
    if (s > rm.best[i]) {
      rm.best[i] = s;
      rm.bestj[i] = j;
    }
  }
}

__device__ __forceinline__ void write_candidates(const RunningMax& rm, float* __restrict__ vals,
                                                 int* __restrict__ idx, int q0, int Q,
                                                 long long ncand, int b, int block_n) {
  const int lane = threadIdx.x % LW;
#pragma unroll
  for (int i = 0; i < OWN; ++i) {
    int q = q0 + threadIdx.x / LW + 2 * i;
    if (q < Q) {
      long long o = (long long)q * ncand + (long long)b * LW + lane;
      vals[o] = rm.best[i];
      idx[o] = b * block_n + rm.bestj[i] * LW + lane;
    }
  }
}

// ---------------------------------------------------------------- bf16 (K1)

// q_lo (nullable) is the split-query compensation operand: q ~= q_hi + q_lo
// in bf16, both multiplied into the same f32 accumulator.
__global__ void __launch_bounds__(THREADS)
partial_topk_bf16_kernel(const __nv_bfloat16* __restrict__ q_hi, const __nv_bfloat16* __restrict__ q_lo,
                         const __nv_bfloat16* __restrict__ corpus, int Q, int D, int group_l,
                         int valid_n, float* __restrict__ vals, int* __restrict__ idx) {
  using T = __nv_bfloat16;
  constexpr int KT = ROW_BYTES / sizeof(T);  // 64 elements per k-chunk
  constexpr int NKB = KT / 16;
  extern __shared__ __align__(128) char smem[];
  T* a_s = reinterpret_cast<T*>(smem);
  T* alo_s = a_s + BQ * KT;
  T* b_s = alo_s + BQ * KT;
  float* s_tile = reinterpret_cast<float*>(b_s + LW * KT);

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const int block_n = LW * group_l;
  const long long ncand = (long long)gridDim.y * LW;
  const int warp = threadIdx.x / 32;
  const int wq = warp / 4, wn = warp % 4;

  RunningMax rm;
  rm.init();
  for (int j = 0; j < group_l; ++j) {
    const long long row0 = (long long)b * block_n + (long long)j * LW;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) wmma::fill_fragment(acc[x][y], 0.0f);
    for (int k0 = 0; k0 < D; k0 += KT) {
      __syncthreads();
      load_tile<T, BQ>(a_s, q_hi, D, q0, Q, k0);
      if (q_lo != nullptr) load_tile<T, BQ>(alo_s, q_lo, D, q0, Q, k0);
      load_tile<T, LW>(b_s, corpus + row0 * D, D, 0, LW, k0);
      __syncthreads();
#pragma unroll
      for (int kb = 0; kb < NKB; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb[2];
#pragma unroll
        for (int y = 0; y < 2; ++y)
          wmma::load_matrix_sync(fb[y], b_s + kb * LW * 16 + (wn * 32 + y * 16) * 16, 16);
#pragma unroll
        for (int x = 0; x < 2; ++x)
          wmma::load_matrix_sync(fa[x], a_s + kb * BQ * 16 + (wq * 32 + x * 16) * 16, 16);
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < 2; ++y) wmma::mma_sync(acc[x][y], fa[x], fb[y], acc[x][y]);
        if (q_lo != nullptr) {
#pragma unroll
          for (int x = 0; x < 2; ++x)
            wmma::load_matrix_sync(fa[x], alo_s + kb * BQ * 16 + (wq * 32 + x * 16) * 16, 16);
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 2; ++y) wmma::mma_sync(acc[x][y], fa[x], fb[y], acc[x][y]);
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y)
        wmma::store_matrix_sync(s_tile + (wq * 32 + x * 16) * S_LD + wn * 32 + y * 16, acc[x][y],
                                S_LD, wmma::mem_row_major);
    __syncthreads();
    fold_tile(rm, s_tile, nullptr, row0, j, valid_n);
  }
  write_candidates(rm, vals, idx, q0, Q, ncand, b, block_n);
}

// ---------------------------------------------------------------- int8 (K2)

// score = f32(q1.c1) [+ f32(q2.c1)/128] [+ f32(q1.c2)/128], times the corpus
// row scale. Each product accumulates exactly in int32; the float sums follow
// the TPU kernel's order, so the result is bit-identical to the plain
// version (the 1/128 products are exact, so FMA contraction changes nothing).
__global__ void __launch_bounds__(THREADS)
partial_topk_int8_kernel(const int8_t* __restrict__ q1, const int8_t* __restrict__ q2,
                         const int8_t* __restrict__ c1, const int8_t* __restrict__ c2,
                         const float* __restrict__ cscale, int Q, int D, int group_l, int valid_n,
                         float* __restrict__ vals, int* __restrict__ idx) {
  using T = signed char;
  constexpr int KT = ROW_BYTES;  // 128 int8 elements per k-chunk
  constexpr int NKB = KT / 16;
  extern __shared__ __align__(128) char smem[];
  T* a1_s = reinterpret_cast<T*>(smem);
  T* a2_s = a1_s + BQ * KT;
  T* b1_s = a2_s + BQ * KT;
  T* b2_s = b1_s + LW * KT;
  float* s_tile = reinterpret_cast<float*>(b2_s + LW * KT);
  const T* q1t = reinterpret_cast<const T*>(q1);
  const T* q2t = reinterpret_cast<const T*>(q2);
  const T* c1t = reinterpret_cast<const T*>(c1);
  const T* c2t = reinterpret_cast<const T*>(c2);

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const int block_n = LW * group_l;
  const long long ncand = (long long)gridDim.y * LW;
  const int warp = threadIdx.x / 32;
  const int wq = warp / 4, wn = warp % 4;

  RunningMax rm;
  rm.init();
  for (int j = 0; j < group_l; ++j) {
    const long long row0 = (long long)b * block_n + (long long)j * LW;
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc1[2][2], acc2[2][2], acc3[2][2];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        wmma::fill_fragment(acc1[x][y], 0);
        wmma::fill_fragment(acc2[x][y], 0);
        wmma::fill_fragment(acc3[x][y], 0);
      }
    for (int k0 = 0; k0 < D; k0 += KT) {
      __syncthreads();
      load_tile<T, BQ>(a1_s, q1t, D, q0, Q, k0);
      if (q2t != nullptr) load_tile<T, BQ>(a2_s, q2t, D, q0, Q, k0);
      load_tile<T, LW>(b1_s, c1t + row0 * D, D, 0, LW, k0);
      if (c2t != nullptr) load_tile<T, LW>(b2_s, c2t + row0 * D, D, 0, LW, k0);
      __syncthreads();
#pragma unroll
      for (int kb = 0; kb < NKB; ++kb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb[2];
#pragma unroll
        for (int y = 0; y < 2; ++y)
          wmma::load_matrix_sync(fb[y], b1_s + kb * LW * 16 + (wn * 32 + y * 16) * 16, 16);
#pragma unroll
        for (int x = 0; x < 2; ++x)
          wmma::load_matrix_sync(fa[x], a1_s + kb * BQ * 16 + (wq * 32 + x * 16) * 16, 16);
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < 2; ++y) wmma::mma_sync(acc1[x][y], fa[x], fb[y], acc1[x][y]);
        if (c2t != nullptr) {
          // q1 . c2 reuses the q1 fragments already in registers
#pragma unroll
          for (int y = 0; y < 2; ++y)
            wmma::load_matrix_sync(fb[y], b2_s + kb * LW * 16 + (wn * 32 + y * 16) * 16, 16);
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 2; ++y) wmma::mma_sync(acc3[x][y], fa[x], fb[y], acc3[x][y]);
        }
        if (q2t != nullptr) {
#pragma unroll
          for (int y = 0; y < 2; ++y)
            wmma::load_matrix_sync(fb[y], b1_s + kb * LW * 16 + (wn * 32 + y * 16) * 16, 16);
#pragma unroll
          for (int x = 0; x < 2; ++x)
            wmma::load_matrix_sync(fa[x], a2_s + kb * BQ * 16 + (wq * 32 + x * 16) * 16, 16);
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int y = 0; y < 2; ++y) wmma::mma_sync(acc2[x][y], fa[x], fb[y], acc2[x][y]);
        }
      }
    }
    // Accumulator fragments of one type share one element layout, so the
    // three products combine elementwise; the f32 result is stored through
    // the int fragment as raw bits.
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) {
#pragma unroll
        for (int t = 0; t < acc1[x][y].num_elements; ++t) {
          float s = static_cast<float>(acc1[x][y].x[t]);
          if (q2t != nullptr) s = s + static_cast<float>(acc2[x][y].x[t]) * (1.0f / 128.0f);
          if (c2t != nullptr) s = s + static_cast<float>(acc3[x][y].x[t]) * (1.0f / 128.0f);
          acc1[x][y].x[t] = __float_as_int(s);
        }
        wmma::store_matrix_sync(reinterpret_cast<int*>(s_tile) + (wq * 32 + x * 16) * S_LD +
                                    wn * 32 + y * 16,
                                acc1[x][y], S_LD, wmma::mem_row_major);
      }
    __syncthreads();
    fold_tile(rm, s_tile, cscale, row0, j, valid_n);
  }
  write_candidates(rm, vals, idx, q0, Q, ncand, b, block_n);
}

// ---------------------------------------------------------------- f32 (K1, INDEX_DTYPE=float32)

// CUDA-core FMA: each thread owns a fixed 8 x 4 set of (query, lane) scores
// for every tile j, so the running max needs no shared memory.
constexpr int F_KT = 32;
__global__ void __launch_bounds__(THREADS)
partial_topk_f32_kernel(const float* __restrict__ qf, const float* __restrict__ corpus, int Q, int D,
                        int group_l, int valid_n, float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ float a_s[F_KT][BQ + 4];
  __shared__ float b_s[F_KT][LW + 4];
  const int tx = threadIdx.x % 32;  // lanes tx + 32*c
  const int ty = threadIdx.x / 32;  // rows ty + 8*r
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y;
  const int block_n = LW * group_l;
  const long long ncand = (long long)gridDim.y * LW;

  float best[8][4];
  int bestj[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      best[r][c] = -CUDART_INF_F;
      bestj[r][c] = 0;
    }
  for (int j = 0; j < group_l; ++j) {
    const long long row0 = (long long)b * block_n + (long long)j * LW;
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    for (int k0 = 0; k0 < D; k0 += F_KT) {
      __syncthreads();
      for (int id = threadIdx.x; id < BQ * F_KT; id += THREADS) {
        int r = id / F_KT, k = id % F_KT;
        a_s[k][r] = (q0 + r < Q) ? qf[(long long)(q0 + r) * D + k0 + k] : 0.0f;
      }
      for (int id = threadIdx.x; id < LW * F_KT; id += THREADS) {
        int r = id / F_KT, k = id % F_KT;
        b_s[k][r] = corpus[(row0 + r) * D + k0 + k];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < F_KT; ++k) {
        float av[8], bv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r) av[r] = a_s[k][ty + 8 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = b_s[k][tx + 32 * c];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool valid = row0 + tx + 32 * c < valid_n;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float s = valid ? acc[r][c] : -CUDART_INF_F;
        if (s > best[r][c]) {
          best[r][c] = s;
          bestj[r][c] = j;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int q = q0 + ty + 8 * r;
    if (q >= Q) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int lane = tx + 32 * c;
      long long o = (long long)q * ncand + (long long)b * LW + lane;
      vals[o] = best[r][c];
      idx[o] = b * block_n + bestj[r][c] * LW + lane;
    }
  }
}

constexpr size_t kBf16Smem = (2 * BQ * 64 + LW * 64) * 2 + BQ * S_LD * 4;
constexpr size_t kInt8Smem = 2 * BQ * 128 + 2 * LW * 128 + BQ * S_LD * 4;

bool shapes_ok(int Q, int N, int D, int group_l, int kt, int valid_n) {
  return Q > 0 && group_l > 0 && N > 0 && N % (LW * group_l) == 0 && D > 0 && D % kt == 0 &&
         valid_n >= 0 && valid_n <= N;
}

}  // namespace

extern "C" {

int flat_partial_topk_bf16(const void* q_hi, const void* q_lo, const void* corpus, int Q, int N, int D,
                           int group_l, int valid_n, void* vals, void* idx, void* stream) {
  if (!shapes_ok(Q, N, D, group_l, 64, valid_n)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(partial_topk_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBf16Smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + BQ - 1) / BQ, N / (LW * group_l));
  partial_topk_bf16_kernel<<<grid, THREADS, kBf16Smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q_hi, (const __nv_bfloat16*)q_lo, (const __nv_bfloat16*)corpus, Q, D,
      group_l, valid_n, (float*)vals, (int*)idx);
  return (int)cudaGetLastError();
}

int flat_partial_topk_f32(const void* q, const void* corpus, int Q, int N, int D, int group_l,
                          int valid_n, void* vals, void* idx, void* stream) {
  if (!shapes_ok(Q, N, D, group_l, F_KT, valid_n)) return (int)cudaErrorInvalidValue;
  dim3 grid((Q + BQ - 1) / BQ, N / (LW * group_l));
  partial_topk_f32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)corpus, Q, D, group_l, valid_n, (float*)vals, (int*)idx);
  return (int)cudaGetLastError();
}

int flat_partial_topk_int8(const void* q1, const void* q2, const void* c1, const void* c2,
                           const void* cscale, int Q, int N, int D, int group_l, int valid_n,
                           void* vals, void* idx, void* stream) {
  if (!shapes_ok(Q, N, D, group_l, 128, valid_n)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(partial_topk_int8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kInt8Smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + BQ - 1) / BQ, N / (LW * group_l));
  partial_topk_int8_kernel<<<grid, THREADS, kInt8Smem, (cudaStream_t)stream>>>(
      (const int8_t*)q1, (const int8_t*)q2, (const int8_t*)c1, (const int8_t*)c2,
      (const float*)cscale, Q, D, group_l, valid_n, (float*)vals, (int*)idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
