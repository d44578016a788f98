// Shared by the quantized-matmul kernels (quant_matmul.cu: float
// activations; quant_matmul_a8.cu: int8 activations): the block geometry,
// the 16-byte asynchronous copy, and the typed output store.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace qmm {

constexpr int kThreads = 128;            // 4 warps
constexpr int kBN = 128;                 // output columns per block, 32 per warp
constexpr int kWStride = kBN + 16;       // bytes per q row in shared memory
constexpr int kStages = 4;               // shared-memory stages: 3 in flight
constexpr int kOutStride = kBN + 1;      // words per output row staged in shared memory

__device__ __forceinline__ void store_out(void* out, int64_t i, float v, int out_bf16) {
  if (out_bf16) static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else static_cast<float*>(out)[i] = v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading src.
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// 16 bytes of q row `src` (valid columns [0, ncols)) into shared memory, byte
// by byte: the path for rows that break 16-byte alignment.
__device__ __forceinline__ void copy16_bytes(uint8_t* dst, const int8_t* src, bool row_ok,
                                             int col, int ncols) {
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (row_ok && col + b < ncols)
      v[b / 4] |= uint32_t(static_cast<uint8_t>(src[b])) << (8 * (b % 4));
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace qmm
