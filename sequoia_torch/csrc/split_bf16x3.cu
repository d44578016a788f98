// The f32 activations of the quant matmuls split into three bf16 planes,
// the first half of the tensor-core route for f32 x (the planes
// instantiations of quant_matmul_int8_sm90.cu and quant_matmul_int4_sm90.cu,
// which together replace the Pallas kernels sequoia_tpu/kernels/
// quant_matmul.py::_kernel_int8, _kernel_int4 and _kernel_int4_tiled at f32
// x; the TPU runs those products in f32 and needs no split):
//   planes[p, r, k] = b_p, x[r, k] = b0 + b1 + b2,
// b0 = x with its low 16 bits zeroed, r = x - b0 (exact), b1 = r with its
// low 16 bits zeroed, b2 = r - b1 (exact), each plane the high half of its
// f32 bits. b0 and b1 are bf16 values by construction; b2 has at most 8
// significant bits, all of them at or above 2^-133 (bf16's least subnormal)
// wherever |x| >= 2^-110, so the split is exact there; below, b2 is
// truncated toward zero, an absolute error under 2^-133. Each residual
// takes x's sign (it has it, or is zero), so -0 splits into three -0.
// kernels/quant_matmul.py::split_bf16x3_plain is the same truncation on
// the CPU, bit for bit.
//
// Bound on the H100: bytes, R*K*(4 + 6): 2.6 MB at R = 64, K = 4096, 0.0008
// ms at 3.35 TB/s, below the cost of a launch.
//
// Design: one pass. Each thread splits a 16-byte vector (four f32) into
// three 8-byte stores, one per plane, in a grid-stride loop (single
// elements where R*K % 4 != 0 or x is not 16-byte aligned). The matmul
// after it is a programmatic dependent launch: the split lets it start as
// the split starts (grid_dep_launch), and its producer waits for the
// split's grid before the first plane box.

#include "common.cuh"

namespace {

using namespace sq;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // the grid-stride loop covers the rest

// The three planes of x, as the high halves of their f32 bits.
__device__ __forceinline__ void split3(float x, uint32_t& h0, uint32_t& h1, uint32_t& h2) {
  const uint32_t u = __float_as_uint(x), sign = u & 0x80000000u;
  const float b0 = __uint_as_float(u & 0xFFFF0000u);
  const uint32_t r = __float_as_uint(x - b0) | sign;
  const float b1 = __uint_as_float(r & 0xFFFF0000u);
  const uint32_t r2 = __float_as_uint(__uint_as_float(r) - b1) | sign;
  h0 = u >> 16;
  h1 = r >> 16;
  h2 = r2 >> 16;
}

// x[n] f32 -> planes[3][n] bf16 (as 16-bit words). kVec: n % 4 == 0 and x
// 16-byte aligned (each plane then 8-byte aligned).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
split_planes(const float* __restrict__ x, uint16_t* __restrict__ planes, int64_t n) {
  grid_dep_launch();   // the matmul's set-up may start now
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if constexpr (kVec) {
    for (int64_t i = first; i < n / 4; i += stride) {
      const float4 v = reinterpret_cast<const float4*>(x)[i];
      const float f[4] = {v.x, v.y, v.z, v.w};
      uint32_t h[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split3(f[e], h[0][e], h[1][e], h[2][e]);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        reinterpret_cast<uint2*>(planes + p * n)[i] =
            make_uint2(h[p][0] | (h[p][1] << 16), h[p][2] | (h[p][3] << 16));
    }
  } else {
    for (int64_t i = first; i < n; i += stride) {
      uint32_t h0, h1, h2;
      split3(x[i], h0, h1, h2);
      planes[i] = static_cast<uint16_t>(h0);
      planes[n + i] = static_cast<uint16_t>(h1);
      planes[2 * n + i] = static_cast<uint16_t>(h2);
    }
  }
}

}  // namespace

extern "C" {

// x float32 [R, K] -> planes bfloat16 [3, R, K] (see the file note).
int sequoia_split_bf16x3(const void* x, void* planes, int R, int K, void* stream) {
  if (R <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(R) * K;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(planes) % 8 == 0;
  const int64_t want = ((vec ? n / 4 : n) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  uint16_t* out = static_cast<uint16_t*>(planes);
  if (vec) split_planes<true><<<blocks, kThreads, 0, st>>>(xf, out, n);
  else split_planes<false><<<blocks, kThreads, 0, st>>>(xf, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
