// The per-row activation quantizer that feeds the int8-activation matmuls:
// w4a8 (quant_matmul_int4_sm90.cu, the x8 instantiation) and the w8a8 route
// (quant_matmul_int8_sm90.cu).
//
// Replaces the XLA ops around the Pallas kernel sequoia_tpu/kernels/
// quant_matmul.py::quant_matmul(unpack="w4a8") (`:361-364`) and in
// sequoia_tpu/quant/qtensor.py::_matmul_w8a8:
//   sx[r] = max(amax |x[r, :]|, 1e-8) / 127 (f32),
//   x8[r, k] = clip(round(x[r, k] / sx[r]), -127, 127) (int8),
// with a true division and round-half-to-even, so that x8 and sx equal the
// JAX values bit for bit.
//
// Bound on the H100: bytes, R*K*(2 + 1) for bf16 x (0.00094 ms at R = 256,
// K = 4096), far below the cost of a launch: at the rows of a tree verify
// the launch and one round trip to device memory are the cost.
//
// Design: one pass over device memory. One block per row, of 32..512
// threads (one thread per 16-byte vector of the row, rounded up to whole
// warps and capped at 512, so that two blocks fit an SM and 256 rows run
// in one wave: 512 at K = 4096 and 11008 bf16), each thread loading its
// vectors (8 bf16 or 4 f32) in one round and keeping them in registers (up
// to 4); the row's amax is reduced by one redux.sync per warp and one
// shared-memory step; each thread then quantizes its vectors from
// registers and stores 8 (or 4) bytes per vector, each a true division
// x / s rounded half to even. Given row maxima `amax_in` (one float a row,
// at least the row's own: the maxima of whole rows when x is one rank's
// slice of K under tensor parallelism), the block scales by those instead
// of its own reduction. Rows that do not fit (K > 16384 bf16, 8192 f32), and
// rows whose K or base breaks 16-byte vectors, loop over the row twice
// (the second pass from L2), an element at a time where unaligned.
//
// The quantizer's consumers are programmatic dependent launches (common.cuh):
// the quantizer lets them start as it starts (grid_dep_launch), so that
// their set-up and weight loads overlap it; they wait for its grid before
// they read x8 or sx.

#include "common.cuh"

namespace {

using namespace sq;

constexpr int kMaxVecs = 4;        // 16-byte vectors a thread keeps in registers
constexpr int kMaxThreads = 512;   // two blocks an SM at any register count <= 64

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// E elements of T: one 16-byte vector or one element.
template <typename T, int E>
struct alignas(E * sizeof(T)) Pack {
  T v[E];
};

template <typename T, int E>
__device__ __forceinline__ Pack<T, E> load_pack(const T* p) {
  Pack<T, E> r;
  if constexpr (E * sizeof(T) == 16)
    *reinterpret_cast<uint4*>(r.v) = *reinterpret_cast<const uint4*>(p);
  else
    r.v[0] = p[0];
  return r;
}

template <typename T, int E>
__device__ __forceinline__ float pack_amax(const Pack<T, E>& p, float amax) {
#pragma unroll
  for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(to_f(p.v[e])));
  return amax;
}

// clip(rint(x / s), +-127): the true quotient, rounded half to even.
__device__ __forceinline__ int round_quotient(float x, float s) {
  return __float2int_rn(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

// x8 of E elements at o, stored as E bytes at once.
template <typename T, int E>
__device__ __forceinline__ void store_pack(const Pack<T, E>& p, float s, int8_t* o) {
  if constexpr (E == 1) {
    *o = static_cast<int8_t>(round_quotient(to_f(p.v[0]), s));
  } else {
    uint32_t w[E / 4];
#pragma unroll
    for (int g = 0; g < E / 4; ++g) {
      int i[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) i[e] = round_quotient(to_f(p.v[4 * g + e]), s);
      // the low bytes of i[0..3], in order
      w[g] = __byte_perm(__byte_perm(i[0], i[1], 0x0040), __byte_perm(i[2], i[3], 0x0040),
                         0x5410);
    }
    if constexpr (E == 8) *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
    else *reinterpret_cast<uint32_t*>(o) = w[0];
  }
}

// One row per block. E = 16 / sizeof(T) (vectors; K % E == 0 and x 16-byte
// aligned) or 1.
template <typename T, int E>
__global__ void __launch_bounds__(kMaxThreads)
quantize_rows(const T* __restrict__ x, int8_t* __restrict__ x8, float* __restrict__ sx,
              const float* __restrict__ amax_in, int K) {
  grid_dep_launch();   // the consumer's set-up may start now
  __shared__ float warp_max[kMaxThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * K;
  const T* row = x + base;
  int8_t* orow = x8 + base;
  const int nvec = K / E, nt = blockDim.x;
  const bool fits = nvec <= kMaxVecs * nt;
  Pack<T, E> v[kMaxVecs];
  float amax = 0.f;
  if (fits) {
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
      const int j = threadIdx.x + i * nt;
      if (j < nvec) v[i] = load_pack<T, E>(row + j * E);
    }
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i)
      if (threadIdx.x + i * nt < nvec) amax = pack_amax(v[i], amax);
  } else {
    for (int j = threadIdx.x; j < nvec; j += nt)
      amax = pack_amax(load_pack<T, E>(row + j * E), amax);
  }
  // amax >= 0, so its bits order as unsigned integers: one redux.sync each
  amax = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(amax)));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = threadIdx.x % 32 < nt / 32 ? warp_max[threadIdx.x % 32] : 0.f;   // every warp
  amax = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(amax)));
  if (amax_in != nullptr) amax = amax_in[blockIdx.x];
  const float s = fmaxf(amax, 1e-8f) / 127.0f;   // a true division (no fast math)
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  if (fits) {
#pragma unroll
    for (int i = 0; i < kMaxVecs; ++i) {
      const int j = threadIdx.x + i * nt;
      if (j < nvec) store_pack(v[i], s, orow + j * E);
    }
  } else {
    for (int j = threadIdx.x; j < nvec; j += nt)
      store_pack(load_pack<T, E>(row + j * E), s, orow + j * E);
  }
}

// The block size for nvec vectors: one each, whole warps, 32..kMaxThreads.
int block_threads(int nvec) {
  const int t = ((nvec + 31) / 32) * 32;
  return t > kMaxThreads ? kMaxThreads : t;
}

template <typename T>
cudaError_t launch(const void* x, void* x8, void* sx, const void* amax, int R, int K,
                   cudaStream_t st) {
  constexpr int kE = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  int8_t* op = static_cast<int8_t*>(x8);
  float* sp = static_cast<float*>(sx);
  const float* ap = static_cast<const float*>(amax);
  if (K % kE == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x8) % kE == 0)
    quantize_rows<T, kE><<<R, block_threads(K / kE), 0, st>>>(xp, op, sp, ap, K);
  else
    quantize_rows<T, 1><<<R, block_threads(K), 0, st>>>(xp, op, sp, ap, K);
  return cudaGetLastError();
}

// An empty kernel: the launch floor that chip_smoke.py times the quantizer
// against (the same harness, the quantizer's grid of one block per row).
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// x [R, K] (x_dtype 0 = float32, 1 = bfloat16) -> x8 [R, K] int8, sx [R]
// float32: sx = max(amax |x|, 1e-8) / 127, x8 = clip(round(x / sx), +-127);
// amax [R] float32 or null: the row maxima to use instead of x's own.
int sequoia_quantize_activations(const void* x, void* x8, void* sx, const void* amax, int R,
                                 int K, int x_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0) return static_cast<int>(launch<float>(x, x8, sx, amax, R, K, st));
  if (x_dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(x, x8, sx, amax, R, K, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// `blocks` blocks of `threads` threads of an empty kernel.
int sequoia_empty_kernel(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
