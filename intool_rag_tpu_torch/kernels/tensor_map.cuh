// Host side of the TMA: cuTensorMapEncodeTiled, taken from the driver through
// cudaGetDriverEntryPoint(ByVersion), so a kernel library links against the
// CUDA runtime only (no -lcuda). Shared by flat_partial_topk.cu (K1/K2) and
// flash_attention_bwd.cu (K5 dkv / dq).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, or nullptr where it cannot be found.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

}  // namespace
