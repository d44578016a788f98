// Quantized matmuls with f32 activations on the CUDA cores, for the int8,
// packed-int4 and panel-tiled int4 weights of the f32 test models.
//
// Replaces, for f32 x, the Pallas kernels sequoia_tpu/kernels/
// quant_matmul.py::quant_matmul (bits=8, _kernel_int8; bits=4, _kernel_int4,
// whose "shift" and "float" unpacks compute the same numbers) and
// ::quant_matmul_tiled (_kernel_int4_tiled):
//   out[R, N] = (x[R, K] @ w[K, N]) * scale[1, N], f32, cast once.
// int8: q[K, N] int8, w = q. int4: q[K/2, N] int8, half-split packed: byte
// [k, n] holds w[k, n] in its low nibble and w[K/2 + k, n] in its high
// nibble, both sign-extended (0x8 is -8). Tiled int4: q[ceil(N / 128), K/2,
// 128], panel n holding columns [128 n, 128 n + 128) as contiguous 128-byte
// rows, zero past N; the logical N comes from the scale. bf16 x runs on the
// tensor cores instead (quant_matmul_int8_sm90.cu, quant_matmul_int4_sm90.cu).
//
// Bound on the H100: operations, 2*R*K*N f32 at 67 TFLOP/s on the CUDA
// cores, from R ~ 10 (int8) or ~ 5 (int4) rows above the weight bytes. The
// products stay in full f32 so that the card's forward agrees with the
// CPU's within 1e-4, which bf16 tensor-core products would not.
//
// Design, simple: one thread per output column and eight rows, the K loop
// inside the thread, no split, the weight read once per eight rows.

#include "common.cuh"

namespace {

using namespace sq;
using namespace sq::qmm;

constexpr int kRowsF = 8;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quant_matmul_f32(const float* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, void* __restrict__ out, int R, int K,
                 int N, int64_t panel_stride, int out_bf16) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int r0 = blockIdx.y * kRowsF;
  if (n >= N) return;
  const int Kq = BITS == 8 ? K : K / 2;
  // This column in q row 0, and q's row stride (panels: see the file note).
  const int8_t* qn = panel_stride ? q + (n / kBN) * panel_stride + n % kBN : q + n;
  const int ldq = panel_stride ? kBN : N;
  float acc[kRowsF];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) acc[r] = 0.f;
  for (int k = 0; k < Kq; ++k) {
    const int b = qn[static_cast<int64_t>(k) * ldq];
    if (BITS == 8) {
      const float w = static_cast<float>(b);
#pragma unroll
      for (int r = 0; r < kRowsF; ++r)
        if (r0 + r < R) acc[r] = fmaf(x[static_cast<int64_t>(r0 + r) * K + k], w, acc[r]);
    } else {
      const float lo = static_cast<float>(static_cast<int>(static_cast<uint32_t>(b) << 28) >> 28);
      const float hi = static_cast<float>(b >> 4);
#pragma unroll
      for (int r = 0; r < kRowsF; ++r)
        if (r0 + r < R) {
          const float* xr = x + static_cast<int64_t>(r0 + r) * K;
          acc[r] = fmaf(xr[k], lo, acc[r]);
          acc[r] = fmaf(xr[Kq + k], hi, acc[r]);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsF; ++r)
    if (r0 + r < R) store_out(out, static_cast<int64_t>(r0 + r) * N + n, acc[r] * scale[n], out_bf16);
}

}  // namespace

extern "C" {

// x float32 [R, K], q int8 ([K, N] at bits = 8; packed [K/2, N] at bits = 4,
// or the panels [ceil(N / 128), K/2, 128] with tiled = 1), scale float32
// [N], out [R, N] (out_dtype 0 = float32, 1 = bfloat16). The wrapper checks
// shapes, types and alignment.
int sequoia_quant_matmul_f32(const void* x, const void* q, const void* scale, void* out, int R,
                             int K, int N, int bits, int tiled, int out_dtype, void* stream) {
  if (R <= 0 || N <= 0 || K <= 0 || (bits != 8 && bits != 4) || (bits == 4 && K % 2) ||
      (tiled && bits != 4) || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t panel_stride = tiled ? static_cast<int64_t>(K / 2) * kBN : 0;
  const dim3 grid((N + kThreads - 1) / kThreads, (R + kRowsF - 1) / kRowsF);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  if (bits == 8)
    quant_matmul_f32<8><<<grid, kThreads, 0, st>>>(xf, qb, sc, out, R, K, N, 0, out_dtype);
  else
    quant_matmul_f32<4><<<grid, kThreads, 0, st>>>(xf, qb, sc, out, R, K, N, panel_stride,
                                                   out_dtype);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
