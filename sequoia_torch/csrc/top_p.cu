// Nucleus cutoff (top-p threshold) for Hopper.
//
// Replaces the Pallas kernels of sequoia_tpu/kernels/top_p.py:
//   top_p_threshold_from_logits (_kernel_from_logits + _resolve_boundary)
//   top_p_threshold_fused       (_kernel + _resolve_boundary)
//
// Per row: c* = inf{c : sum(p[p > c]) <= top_p} by 32 bisection passes (the
// masses summed in f64, unlike the JAX kernel's f32, so that the cut does
// not depend on the summation order), then
// the exact boundary resolution of ops/sampling.py::top_p_threshold, which
// returns an inclusive threshold at the midpoint of the gap next to the
// boundary value (keep = p >= t). The from-logits variant first computes
// softmax(logits / T) in the block: a true division by T and expf, never
// --use_fast_math, so the row matches the accept walk's per-node
// torch.softmax up to rounding, which the midpoint threshold absorbs.
//
// Bound on the H100: bytes. The kernel reads the [R, V] f32 input once
// (R = 64, V = 32000: 8.2 MB, about 2.4 us at 3.35 TB/s) and writes R floats;
// the arithmetic (about 40 masked passes over each row) is small next to
// that. Design: one block per row, 512 threads, and the whole row held in
// registers (ITEMS values per thread, V <= 512 * 64), so the 32 bisection
// passes and the 4 resolution passes never go back to device memory. Each
// pass is a per-thread loop plus one block reduction (warp shuffles, then
// one shared-memory exchange). With R = 64 only 64 of 132 SMs work; rows
// are independent, so a later version can split a row over a cluster.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 32;

enum class Op { Sum, Max, Min };

template <Op op, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if (op == Op::Sum) return a + b;
  if (op == Op::Max) return a > b ? a : b;
  return a < b ? a : b;
}

// Block-wide reduction; every thread gets the result. `red` holds kWarps
// values. Two __syncthreads: one before the shared exchange is read, one
// after, so the buffer can be reused by the next call.
template <Op op, typename T>
__device__ T block_reduce(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = combine<op>(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = combine<op>(r, red[w]);
  __syncthreads();
  return r;
}

template <int ITEMS, bool FROM_LOGITS>
__global__ void __launch_bounds__(kThreads)
top_p_kernel(const float* __restrict__ in, float* __restrict__ out, int V,
             double top_p, float temperature) {
  __shared__ float red[kWarps];
  __shared__ double redd[kWarps];
  const float* row = in + static_cast<int64_t>(blockIdx.x) * V;
  float p[ITEMS];
  // Element i of this thread is column threadIdx.x + i * kThreads
  // (coalesced loads). Columns past V hold 0, which is inert in every pass:
  // it never exceeds lo >= 0, never enters a mass, and max(x, 0) = x for
  // probabilities (the JAX kernel pads the same way).
  if (FROM_LOGITS) {
    float mx = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int c = threadIdx.x + i * kThreads;
      p[i] = c < V ? row[c] / temperature : -FLT_MAX;
      mx = fmaxf(mx, p[i]);
    }
    mx = block_reduce<Op::Max>(mx, red);
    double sd = 0.0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int c = threadIdx.x + i * kThreads;
      p[i] = c < V ? expf(p[i] - mx) : 0.f;
      sd += p[i];
    }
    // The normalizer is summed in f64 and rounded once, so it does not
    // depend on the summation order (torch.softmax's f32 sum is usually
    // the same float).
    const float s = static_cast<float>(block_reduce<Op::Sum>(sd, redd));
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) p[i] = p[i] / s;
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int c = threadIdx.x + i * kThreads;
      p[i] = c < V ? row[c] : 0.f;
    }
  }

  float hi = -FLT_MAX;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) hi = fmaxf(hi, p[i]);
  hi = block_reduce<Op::Max>(hi, red);
  float lo = 0.f;
  for (int it = 0; it < kIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    // Masses in f64: f32 sums of 32000 terms differ by ~1e-7 between
    // summation orders, the size of a tail probability at top_p = 0.99, so
    // an f32 mass would make the cut depend on the order.
    double m = 0.0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) m += p[i] > mid ? p[i] : 0.f;
    m = block_reduce<Op::Sum>(m, redd);
    if (m > top_p) lo = mid; else hi = mid;
  }

  // Boundary resolution (sequoia_tpu/kernels/top_p.py::_resolve_boundary).
  const float big = FLT_MAX;
  float cand = big;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) if (p[i] > lo) cand = fminf(cand, p[i]);
  cand = block_reduce<Op::Min>(cand, red);
  double mass_gt = 0.0;
  float below = -big, above = big;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (p[i] > cand) { mass_gt += p[i]; above = fminf(above, p[i]); }
    if (p[i] < cand) below = fmaxf(below, p[i]);
  }
  mass_gt = block_reduce<Op::Sum>(mass_gt, redd);
  below = block_reduce<Op::Max>(below, red);
  above = block_reduce<Op::Min>(above, red);
  if (threadIdx.x == 0) {
    const bool include_cand = mass_gt <= top_p;
    below = below > -big ? below : 0.f;
    above = above < big ? above : cand * 2.f;
    float t_inc = 0.5f * (cand + below);
    t_inc = t_inc > below ? t_inc : cand;
    float t_exc = 0.5f * (cand + above);
    t_exc = t_exc > cand ? t_exc : above;
    out[blockIdx.x] = include_cand ? t_inc : t_exc;
  }
}

template <bool FROM_LOGITS>
cudaError_t launch(const float* in, float* out, int R, int V, double top_p,
                   float temperature, cudaStream_t stream) {
  const int items = (V + kThreads - 1) / kThreads;
  const dim3 grid(R), block(kThreads);
#define SEQ_TOP_P_CASE(N)                                                    \
  if (items <= N) {                                                          \
    top_p_kernel<N, FROM_LOGITS><<<grid, block, 0, stream>>>(in, out, V,     \
                                                             top_p,          \
                                                             temperature);   \
    return cudaGetLastError();                                               \
  }
  SEQ_TOP_P_CASE(1)
  SEQ_TOP_P_CASE(2)
  SEQ_TOP_P_CASE(4)
  SEQ_TOP_P_CASE(8)
  SEQ_TOP_P_CASE(16)
  SEQ_TOP_P_CASE(32)
  SEQ_TOP_P_CASE(64)
#undef SEQ_TOP_P_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest vocabulary the register-resident row holds; the wrapper checks it.
int sequoia_top_p_max_vocab() { return kThreads * 64; }

// logits [R, V] f32 -> out [R] f32 (threshold on softmax(logits / T)).
int sequoia_top_p_from_logits(const void* logits, void* out, int R, int V,
                              double top_p, float temperature, void* stream) {
  return static_cast<int>(launch<true>(
      static_cast<const float*>(logits), static_cast<float*>(out), R, V, top_p,
      temperature, static_cast<cudaStream_t>(stream)));
}

// probs [R, V] f32 -> out [R] f32.
int sequoia_top_p_fused(const void* probs, void* out, int R, int V,
                        double top_p, void* stream) {
  return static_cast<int>(launch<false>(
      static_cast<const float*>(probs), static_cast<float*>(out), R, V, top_p,
      1.f, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
