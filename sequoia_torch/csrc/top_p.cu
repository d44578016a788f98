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
// (R = 64, V = 32000: 8.2 MB, about 2.4 us at 3.35 TB/s; V = 128256: 32.8
// MB, 9.8 us) and writes R floats; the arithmetic (about 40 masked passes
// over each row) is small next to that. Two routes, chosen from V before the
// launch:
// - V <= 32768 (top_p_kernel): one block per row, 512 threads, and the whole
//   row held in registers (ITEMS values per thread, V <= 512 * 64), so the 32
//   bisection passes and the 4 resolution passes never go back to device
//   memory. Each pass is a per-thread loop plus one block reduction (warp
//   shuffles, then one shared-memory exchange). With R = 64 only 64 of 132
//   SMs work.
// - V > 32768 (top_p_cluster_kernel; Llama-3's 128256): the row does not fit
//   one block's registers, so a thread-block cluster of C = ceil(V / 32768)
//   blocks (at most 8) holds it, 64 values per thread: rank b's thread i
//   holds columns b * 512 + i + j * 512 * C. Each reduction is the block
//   reduction followed by an exchange through distributed shared memory:
//   every rank reads the C block values in rank order, so all ranks compute
//   the same number and take the same bisection branch. Columns past
//   512 * 64 * C (V > 262144) are re-read from device memory (L2) in every
//   pass. Chosen over re-reading the whole row from L2 in each of the 36
//   passes with one block per row (the other design): the row is read once,
//   and a pass costs a cluster barrier instead of a 513 KB read.
//   Summation order: a mass is each thread's sum over its columns in
//   ascending j, then the warp tree, the 16 warps in order, then the ranks
//   in order; the same for every run and independent of scheduling, but not
//   the plain version's order. The masses are f64 sums of f32 values, so
//   the two orders differ only in the last f64 bits: the fused route stays
//   bit-identical to top_p_threshold_plain unless a mass lies within ~1e-13
//   of top_p. The from-logits softmax denominator is likewise one f64 sum
//   over all ranks, rounded once to f32 (torch.softmax sums in f32 in its
//   own order), and the max is exact in any order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// V > 32768: the row over a cluster of blocks
// ---------------------------------------------------------------------------

constexpr int kItemsC = 64;      // register values per thread in the cluster kernel
constexpr int kMaxCluster = 8;   // portable cluster size

// Cluster-wide reduction; every thread of every rank gets the same result.
// `xch` holds two slots (alternate calls use alternate slots, so one cluster
// barrier per call suffices: a slot is written again only after every rank
// has passed the next call's barrier, i.e. finished reading it); `bc`
// broadcasts warp 0's result within the block.
template <Op op, typename T>
__device__ T cluster_reduce(T v, T* red, T* xch, T* bc, int& slot,
                            cg::cluster_group& cluster, int csize) {
  v = block_reduce<op>(v, red);
  if (threadIdx.x == 0) xch[slot] = v;
  cluster.sync();
  if (threadIdx.x < 32) {
    T r = *cluster.map_shared_rank(&xch[slot], 0);
    for (int b = 1; b < csize; ++b) r = combine<op>(r, *cluster.map_shared_rank(&xch[slot], b));
    if (threadIdx.x == 0) *bc = r;
  }
  slot ^= 1;
  __syncthreads();
  return *bc;
}

template <bool FROM_LOGITS>
__global__ void __launch_bounds__(kThreads)
top_p_cluster_kernel(const float* __restrict__ in, float* __restrict__ out, int V,
                     double top_p, float temperature) {
  __shared__ float red[kWarps];
  __shared__ double redd[kWarps];
  __shared__ float xch[2], bc;
  __shared__ double xchd[2], bcd;
  int slot = 0, slotd = 0;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int stride = kThreads * csize;
  const int first = rank * kThreads + threadIdx.x;
  const float* row = in + static_cast<int64_t>(blockIdx.x / csize) * V;
  // Columns first + j * stride, j < kItemsC, in registers (0 past V, inert
  // as in top_p_kernel); columns from first + kItemsC * stride on (V >
  // 262144 only) are read again in each pass through `value`.
  const int tail = first + kItemsC * stride;
  float mx = -FLT_MAX, s = 1.f;
  auto value = [&](int c) {
    const float v = row[c];
    return FROM_LOGITS ? expf(v / temperature - mx) / s : v;
  };
  float p[kItemsC];
  if (FROM_LOGITS) {
#pragma unroll
    for (int i = 0; i < kItemsC; ++i) {
      const int c = first + i * stride;
      p[i] = c < V ? row[c] / temperature : -FLT_MAX;
      mx = fmaxf(mx, p[i]);
    }
    for (int c = tail; c < V; c += stride) mx = fmaxf(mx, row[c] / temperature);
    mx = cluster_reduce<Op::Max>(mx, red, xch, &bc, slot, cluster, csize);
    double sd = 0.0;
#pragma unroll
    for (int i = 0; i < kItemsC; ++i) {
      const int c = first + i * stride;
      p[i] = c < V ? expf(p[i] - mx) : 0.f;
      sd += p[i];
    }
    for (int c = tail; c < V; c += stride) sd += expf(row[c] / temperature - mx);
    s = static_cast<float>(cluster_reduce<Op::Sum>(sd, redd, xchd, &bcd, slotd, cluster,
                                                   csize));
#pragma unroll
    for (int i = 0; i < kItemsC; ++i) p[i] = p[i] / s;
  } else {
#pragma unroll
    for (int i = 0; i < kItemsC; ++i) {
      const int c = first + i * stride;
      p[i] = c < V ? row[c] : 0.f;
    }
  }

  float hi = -FLT_MAX;
#pragma unroll
  for (int i = 0; i < kItemsC; ++i) hi = fmaxf(hi, p[i]);
  for (int c = tail; c < V; c += stride) hi = fmaxf(hi, value(c));
  hi = cluster_reduce<Op::Max>(hi, red, xch, &bc, slot, cluster, csize);
  float lo = 0.f;
  for (int it = 0; it < kIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    double m = 0.0;
#pragma unroll
    for (int i = 0; i < kItemsC; ++i) m += p[i] > mid ? p[i] : 0.f;
    for (int c = tail; c < V; c += stride) {
      const float v = value(c);
      m += v > mid ? v : 0.f;
    }
    m = cluster_reduce<Op::Sum>(m, redd, xchd, &bcd, slotd, cluster, csize);
    if (m > top_p) lo = mid; else hi = mid;
  }

  // Boundary resolution (sequoia_tpu/kernels/top_p.py::_resolve_boundary).
  const float big = FLT_MAX;
  float cand = big;
#pragma unroll
  for (int i = 0; i < kItemsC; ++i) if (p[i] > lo) cand = fminf(cand, p[i]);
  for (int c = tail; c < V; c += stride) {
    const float v = value(c);
    if (v > lo) cand = fminf(cand, v);
  }
  cand = cluster_reduce<Op::Min>(cand, red, xch, &bc, slot, cluster, csize);
  double mass_gt = 0.0;
  float below = -big, above = big;
  auto visit = [&](float v) {
    if (v > cand) { mass_gt += v; above = fminf(above, v); }
    if (v < cand) below = fmaxf(below, v);
  };
#pragma unroll
  for (int i = 0; i < kItemsC; ++i) visit(p[i]);
  for (int c = tail; c < V; c += stride) visit(value(c));
  mass_gt = cluster_reduce<Op::Sum>(mass_gt, redd, xchd, &bcd, slotd, cluster, csize);
  below = cluster_reduce<Op::Max>(below, red, xch, &bc, slot, cluster, csize);
  above = cluster_reduce<Op::Min>(above, red, xch, &bc, slot, cluster, csize);
  if (rank == 0 && threadIdx.x == 0) {
    const bool include_cand = mass_gt <= top_p;
    below = below > -big ? below : 0.f;
    above = above < big ? above : cand * 2.f;
    float t_inc = 0.5f * (cand + below);
    t_inc = t_inc > below ? t_inc : cand;
    float t_exc = 0.5f * (cand + above);
    t_exc = t_exc > cand ? t_exc : above;
    out[blockIdx.x / csize] = include_cand ? t_inc : t_exc;
  }
  cluster.sync();   // no rank leaves while another reads its exchange slots
}

template <bool FROM_LOGITS>
cudaError_t launch_cluster(const float* in, float* out, int R, int V, double top_p,
                           float temperature, cudaStream_t stream) {
  const int per_block = kThreads * kItemsC;
  const int csize = (V + per_block - 1) / per_block < kMaxCluster
                        ? (V + per_block - 1) / per_block : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, top_p_cluster_kernel<FROM_LOGITS>, in, out, V, top_p,
                            temperature);
}

}  // namespace

extern "C" {

// logits [R, V] f32 -> out [R] f32 (threshold on softmax(logits / T)).
// cluster: 0 = one block per row (V <= 512 * 64), 1 = a cluster of blocks
// per row (any V).
int sequoia_top_p_from_logits(const void* logits, void* out, int R, int V, double top_p,
                              float temperature, int cluster, void* stream) {
  const float* in = static_cast<const float*>(logits);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cluster ? launch_cluster<true>(in, o, R, V, top_p, temperature, st)
                                  : launch<true>(in, o, R, V, top_p, temperature, st));
}

// probs [R, V] f32 -> out [R] f32.
int sequoia_top_p_fused(const void* probs, void* out, int R, int V, double top_p, int cluster,
                        void* stream) {
  const float* in = static_cast<const float*>(probs);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cluster ? launch_cluster<false>(in, o, R, V, top_p, 1.f, st)
                                  : launch<false>(in, o, R, V, top_p, 1.f, st));
}

}  // extern "C"
