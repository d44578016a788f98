// Nucleus cutoff (top-p threshold) for Hopper.
//
// Replaces the Pallas kernels of sequoia_tpu/kernels/top_p.py:
//   top_p_threshold_from_logits (_kernel_from_logits + _resolve_boundary)
//   top_p_threshold_fused       (_kernel + _resolve_boundary)
//
// The function is that of kernels/top_p.py::top_p_threshold_plain: 32
// bisection steps for c* = min{c : sum(p[p > c]) <= top_p}, then the
// boundary resolution of ops/sampling.py::top_p_threshold, which returns an
// inclusive threshold at the midpoint of the gap next to the boundary value
// (keep = p >= t). The from-logits variant first computes softmax(logits /
// T) in the block: a correctly rounded division by T and expf, never
// --use_fast_math, so the row matches the accept walk's per-node
// torch.softmax up to rounding, which the midpoint threshold absorbs; the
// normalizer is an f64 sum rounded once.
//
// Design: the bisection is not run. f(c) = sum(p[p > c]) is non-increasing
// and right-continuous, so {c : f(c) <= top_p} = [c*, inf) with c* = 0 or
// one of the row's values, and the bisection's test f(mid) > top_p is
// mid < c*: its 32 steps depend only on c* and max(p). So each row
//   1. loads into registers (and takes its softmax), with max(p) (from
//      logits, 1 / s) and a lower bound on the row's sum. The floor L =
//      (sum - top_p) / 2V has f(L) >= sum - V L > top_p, so c* > L; each
//      thread lists its values above L in shared memory as runs of equal
//      values, (value, count), in 16 slots (a few values in a hundred lie
//      above L in a peaked row, and a uniform row lists one run; a flat
//      row, e.g. logits of std 1 at T = 0.6, overflows and is read from
//      the registers);
//   2. finds c* exactly by a radix select over the bit patterns of the
//      values above L (a positive float orders as its bits): three levels of
//      11, 10 and 10 bits (kernels/top_p.py RADIX_LEVELS). A level adds each
//      value's 24-bit mantissa into the shared-memory bin of its bits (two
//      32-bit atomics, the low and high 12 bits: a 64-bit shared atomic is a
//      CAS loop on sm_90), over the values whose higher bits match the bins
//      chosen so far; a listed run adds count times its mantissa, so a
//      uniform row does not pile an atomic a value onto one address (32
//      lanes on one address serialize). Level 0 holds the whole exponent,
//      so a bin's mass is its mantissa sum times one power of two:
//      integers, the same in any order, in 128-bit fixed point (unit 2^-S,
//      S from V and max(p) so that a row's total stays under 2^126) and
//      exact within an exponent; levels 1 and 2 share one exponent and
//      count in mantissa units. One warp walks a level's occupied bins from
//      the top down with a running suffix sum and takes the lowest
//      non-empty bin whose mass above fits in top_p; after three levels the
//      bin is c*. Values at or below L never change a mass above a bin that
//      can hold c*, so they take no part;
//   3. replays the 32 bisection steps from (0, max(p)) with mid < c* as the
//      test: scalar code, no barrier;
//   4. resolves the boundary in one reduction: cand = min{p > lo}, the next
//      distinct value above it and max{p <= lo} (the value below it); cand
//      is kept iff cand >= c*.
// About 8 barrier-separated phases a row in place of the 37 block
// reductions of a bisection run pass by pass, each of which turned all 64
// register values of every thread to f64 (16 conversions a clock on an SM:
// ~1.1 of a pass's ~1.4 us, measured on an H100).
//
// The threshold equals top_p_threshold_plain's bit for bit unless a mass
// lies within the plain version's f64 summation rounding (~1e-13) of top_p:
// the kernel's masses are exact to 2^-S per exponent, the plain version's
// are f64 sums in its own order. The kernel is deterministic: integer sums
// and fixed-order reductions (max, min, and the f64 softmax normalizer:
// each thread's columns in ascending order, the warp tree, the warps in
// order, then the cluster ranks in order).
//
// Bound on the H100: bytes. The kernel reads the [R, V] f32 input once and
// writes R floats (R = 64, V = 32000: 8.2 MB, about 2.4 us at 3.35 TB/s; V
// = 128256: 32.8 MB, 9.8 us). At small R one SM's load of its row and the
// serial phases, not the bytes, take the time. Two routes, chosen from V
// before the launch:
// - V <= 32768: one block per row, 512 threads, the row in registers
//   (ITEMS values per thread, V <= 512 * 64).
// - V > 32768 (Llama-3's 128256): a thread-block cluster of C = ceil(V /
//   32768) blocks (at most 8) per row, 64 values per thread: rank b's thread
//   i holds columns b * 512 + i + j * 512 * C. A reduction is the block
//   reduction and an exchange through distributed shared memory (each rank
//   reads the C block values in rank order, so every rank computes the same
//   number); a radix level sums the C ranks' bins through distributed
//   shared memory, each rank's warp 0 all of them, so every rank picks the
//   same bin. Columns past 512 * 64 * C (V > 262144) are re-read from device
//   memory (L2) in every pass.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;
using u128 = unsigned __int128;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 32;
constexpr int kItemsC = 64;      // register values per thread in the cluster route
constexpr int kMaxCluster = 8;   // portable cluster size
// Radix levels over bits 30..0 of a positive f32: lowest bit, width, and
// the first of its bins in Scratch::hist.
constexpr int kLevels = 3;
__host__ __device__ constexpr int level_shift(int lv) { return lv == 0 ? 20 : lv == 1 ? 10 : 0; }
__host__ __device__ constexpr int level_bits(int lv) { return lv == 0 ? 11 : 10; }
__host__ __device__ constexpr int level_offset(int lv) {
  return lv == 0 ? 0 : lv == 1 ? 2048 : 3072;
}
constexpr int kBins = 4096;
constexpr int kSlots = 16;    // runs of values above the floor a thread lists in shared memory
constexpr unsigned kFull = 0xffffffffu;   // every lane of a warp
// Per block, a bin's sum of 12-bit halves stays under 2^32 up to 2^20
// values: V <= 8 * 2^20 on the cluster route.
constexpr int kMaxVocab = 1 << 23;

struct Max {
  template <typename T> __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct Min {
  template <typename T> __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};
struct Sum {
  template <typename T> __device__ T operator()(T a, T b) const { return a + b; }
};
struct MaxSum {   // (max, sum)
  __device__ float2 operator()(float2 a, float2 b) const {
    return make_float2(fmaxf(a.x, b.x), a.y + b.y);
  }
};
// (max{p <= lo}, the least and the second least distinct values above lo),
// missing ones FLT_MAX: a value above the least of both sides is the second
// least of its side unless it is that least.
struct Resolve {
  __device__ float4 operator()(float4 a, float4 b) const {
    const float c = fminf(a.y, b.y);
    return make_float4(fmaxf(a.x, b.x), c, fminf(a.y > c ? a.y : a.z, b.y > c ? b.y : b.z),
                       0.f);
  }
};

__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ double shfl_xor(double v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ float2 shfl_xor(float2 v, int o) {
  return make_float2(shfl_xor(v.x, o), shfl_xor(v.y, o));
}
__device__ __forceinline__ float4 shfl_xor(float4 v, int o) {
  return make_float4(shfl_xor(v.x, o), shfl_xor(v.y, o), shfl_xor(v.z, o), 0.f);
}

// One reduction's shared state. `slot` alternates between calls, so one
// cluster barrier per call suffices: a slot is written again only after
// every rank has passed the next call's barrier, i.e. finished reading it.
template <typename T>
struct Exchange {
  T red[kWarps];
  T slot[2];
  T bc;
};

template <typename T>
struct Pick {
  int bin;
  T gt;      // the mass of the bins above it
  T total;   // the mass of the bins looked at (all of them when none was too much)
};

struct Scratch {
  uint2 hist[kBins];      // per bin: sums of the low and high 12 mantissa bits
  float list[kSlots + 1][kThreads];   // list[k][t]: thread t's k-th run of equal values
                                      // above the floor (row kSlots takes the overflow)
  uint16_t count[kSlots + 1][kThreads];   // ... and its length
  Pick<u128> pick0;      // warp 0's choice at level 0, for the block
  Pick<u64> pick[kLevels];   // ... and at levels 1 and 2
  int2 range[kLevels];    // the lowest and highest occupied bin of levels 1 and 2
  Exchange<float> xf;
  Exchange<double> xd;
  Exchange<float2> x2;
  Exchange<float4> x4;
};

template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, shfl_xor(v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, red[w]);
  __syncthreads();
  return r;
}

// Block-wide reduction, then (cluster) across the ranks in rank order;
// every thread of every rank gets the same value.
template <bool CLUSTER, typename T, typename Op>
__device__ T row_reduce(T v, Exchange<T>& x, int& slot, Op op) {
  T r = block_reduce(v, x.red, op);
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) x.slot[slot] = r;
    cluster.sync();
    if (threadIdx.x == 0) {
      T c = *cluster.map_shared_rank(&x.slot[slot], 0);
      for (int b = 1; b < static_cast<int>(cluster.num_blocks()); ++b)
        c = op(c, *cluster.map_shared_rank(&x.slot[slot], b));
      x.bc = c;
    }
    slot ^= 1;
    __syncthreads();
    r = x.bc;
  }
  return r;
}

// a / b from y = RN(1 / b): q = RN(a y) is within an ulp of a / b, the
// remainder a - b q is exact in an FMA, and RN(q + r y) is the correctly
// rounded quotient (Markstein's theorem) wherever a / b is 0 or a normal
// float; an infinite q stays. Two FMAs and a multiply, with no branch, in
// place of the IEEE division's reciprocal, refinement, range check and
// slow-path call. Where
// a / b is subnormal it may differ from the IEEE quotient by an ulp: a
// logit / T that small changes no expf(x / T - max) and a probability that
// small takes part only if top_p is within V * 2^-126 of the row's mass.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = a * y;
  const float r = fmaf(fmaf(-q, b, a), y, q);
  return isinf(q) ? q : r;
}

// floor(x * 2^sh) in 128 bits (x < 2^64; 0 for x = 0).
__device__ __forceinline__ u128 scale_up(u64 x, int sh) {
  if (x == 0) return 0;
  if (sh >= 0) return sh < 128 ? static_cast<u128>(x) << sh : ~static_cast<u128>(0);
  return -sh < 64 ? static_cast<u128>(x >> -sh) : 0;
}

// min(floor(left * 2^-sh), 2^64 - 1): a fixed-point mass in units of 2^sh.
__device__ __forceinline__ u64 to_units(u128 left, int sh) {
  if (sh >= 0) {
    const u128 r = sh < 128 ? left >> sh : 0;
    return r > ~0ull ? ~0ull : static_cast<u64>(r);
  }
  if (left == 0) return 0;
  return -sh >= 64 || (left >> (64 + sh)) != 0 ? ~0ull : static_cast<u64>(left << -sh);
}

// floor(top_p * 2^S) (top_p * 2^S is exact in f64).
__device__ __forceinline__ u128 fixed_limit(double top_p, int S) {
  const double x = ldexp(top_p, S);
  if (!(x > 0.0)) return 0;
  if (x >= 0x1p127) return ~static_cast<u128>(0) >> 1;
  const double h = floor(ldexp(x, -64));
  return (static_cast<u128>(static_cast<u64>(h)) << 64) |
         static_cast<u64>(x - ldexp(h, 64));
}

__device__ __forceinline__ u64 shfl_idx(u64 v, int l) { return __shfl_sync(0xffffffffu, v, l); }
__device__ __forceinline__ u128 shfl_idx(u128 v, int l) {
  return (static_cast<u128>(shfl_idx(static_cast<u64>(v >> 64), l)) << 64) |
         shfl_idx(static_cast<u64>(v), l);
}
__device__ __forceinline__ u64 shfl_up(u64 v, int o) { return __shfl_up_sync(0xffffffffu, v, o); }
__device__ __forceinline__ u128 shfl_up(u128 v, int o) {
  return (static_cast<u128>(shfl_up(static_cast<u64>(v >> 64), o)) << 64) |
         shfl_up(static_cast<u64>(v), o);
}

// One radix level's choice, by one warp: the lowest non-empty bin in [lo,
// hi] whose mass above (the bins past it) is at most `room`. The warp walks
// down from `hi` in chunks of 32 * K bins (lane l takes bins top - K l - j),
// with a suffix sum carried from chunk to chunk, and stops once the mass
// above the next chunk exceeds `room`: no bin below can qualify, as the mass
// above a bin only grows downwards. `mass(b, sum_m, m)` gives bin b's
// mantissa sum and its mass in the unit T.
template <int K, typename T, typename MassFn>
__device__ Pick<T> warp_pick(int lo, int hi, T room, MassFn mass) {
  const int lane = threadIdx.x & 31;
  Pick<T> r{-1, 0, 0};
  for (int top = hi; top >= lo; top -= 32 * K) {
    u64 sm[K];
    T f[K], tot = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int b = top - K * lane - j;
      sm[j] = 0;
      f[j] = 0;
      if (b >= lo) mass(b, sm[j], f[j]);
      tot += f[j];
    }
    T x = tot;   // prefix over the lanes: the higher bins come first
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = shfl_up(x, o);
      if (lane >= o) x += y;
    }
    T g = r.total + x - tot;
    int cand = -1;
    T cand_gt = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (sm[j] != 0 && g <= room) {
        cand = top - K * lane - j;
        cand_gt = g;
      }
      g += f[j];
    }
    const unsigned m = __ballot_sync(0xffffffffu, cand >= 0);
    if (m) {   // the last lane with a candidate holds the lowest bin
      const int l = 31 - __clz(m);
      r.bin = __shfl_sync(0xffffffffu, cand, l);
      r.gt = shfl_idx(cand_gt, l);
    }
    r.total += shfl_idx(x, 31);
    if (r.total > room) break;
  }
  return r;
}

template <int ITEMS, bool FROM_LOGITS, bool CLUSTER>
__global__ void __launch_bounds__(kThreads)
top_p_kernel(const float* __restrict__ in, float* __restrict__ out, int V, double top_p,
             float temperature) {
  extern __shared__ __align__(16) unsigned char smem[];
  Scratch& s = *reinterpret_cast<Scratch*>(smem);
  int slot_f = 0, slot_d = 0, slot_2 = 0, slot_4 = 0;
  int csize = 1, rank = 0;
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    csize = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
  }
  const int row_id = blockIdx.x / csize;
  const int stride = kThreads * csize;
  const int first = rank * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = in + static_cast<int64_t>(row_id) * V;
  for (int b = threadIdx.x; b < kBins; b += kThreads) s.hist[b] = make_uint2(0, 0);
  if (threadIdx.x < kLevels) s.range[threadIdx.x] = make_int2(INT_MAX, -1);

  // Columns first + i * stride, i < ITEMS, in registers; columns past V
  // hold 0, which is inert in every pass (never above the floor or lo, and
  // max(x, 0) = x for probabilities; the JAX kernel pads the same way).
  // Cluster route: columns from `tail` on (V > 262144 only) are read again
  // in each pass through `value`.
  const int tail = first + ITEMS * stride;
  float mx = -FLT_MAX, sden = 1.f;
  float inv_t = 1.f, hi = 0.f;
  auto value = [&](int c) {   // a column past the registers (cluster route, V > 262144)
    const float v = row[c];
    return FROM_LOGITS ? div_rn(expf(div_rn(v, temperature, inv_t) - mx), sden, hi) : v;
  };
  float p[ITEMS];
  auto for_each = [&](auto&& f) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) f(p[i]);
    if constexpr (CLUSTER) {
      for (int c = tail; c < V; c += stride) f(value(c));
    }
  };
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {   // every load issued before any use
    const int c = first + i * stride;
    p[i] = c < V ? row[c] : 0.f;
  }

  // 1. The row's max (and softmax), and a lower bound on its sum.
  float total_lb;
  if constexpr (FROM_LOGITS) {
    inv_t = 1.f / temperature;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      p[i] = first + i * stride < V ? div_rn(p[i], temperature, inv_t) : -FLT_MAX;
      mx = fmaxf(mx, p[i]);
    }
    if constexpr (CLUSTER) {
      for (int c = tail; c < V; c += stride) mx = fmaxf(mx, div_rn(row[c], temperature, inv_t));
    }
    mx = row_reduce<CLUSTER>(mx, s.xf, slot_f, Max());
    double sd = 0.0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      p[i] = expf(p[i] - mx);   // padding: expf(-FLT_MAX - max) = 0
      sd += p[i];
    }
    if constexpr (CLUSTER) {
      for (int c = tail; c < V; c += stride) sd += expf(div_rn(row[c], temperature, inv_t) - mx);
    }
    sden = static_cast<float>(row_reduce<CLUSTER>(sd, s.xd, slot_d, Sum()));
    hi = 1.f / sden;             // expf(0) / s: the largest p
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) p[i] = div_rn(p[i], sden, hi);
    total_lb = 1.f - 0x1p-20f;   // sum(p) >= (1 - 2^-23)(1 - 2^-24) > this
  } else {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      mx = fmaxf(mx, p[i]);
      sum += p[i];
    }
    if constexpr (CLUSTER) {
      for (int c = tail; c < V; c += stride) {
        const float v = row[c];
        mx = fmaxf(mx, v);
        sum += v;
      }
    }
    const float2 r = row_reduce<CLUSTER>(make_float2(mx, sum), s.x2, slot_2, MaxSum());
    hi = r.x;
    total_lb = r.y * (1.f - 0x1p-12f);   // f32 summation error is < 2^-16 of it
  }

  // The floor: f(L) >= sum - V * L > top_p, so c* > L. Each thread lists
  // its values above it in shared memory as runs of equal values (value,
  // count): a uniform or tied row lists a run, not a value, at a time.
  const float floor_v = total_lb > top_p
      ? static_cast<float>(0.5 * (static_cast<double>(total_lb) - top_p) / V) : 0.f;
  int n_list = 0;
  unsigned count = 0;
  float last = -1.f;   // no probability
  for_each([&](float v) {   // no branch: a slot not yet complete is rewritten
    const bool take = v > floor_v, fresh = take && v != last;
    n_list += fresh;
    count = fresh ? 1u : count + take;
    last = take ? v : last;
    const int k = n_list == 0 ? kSlots : min(n_list - 1, kSlots);
    s.list[k][threadIdx.x] = last;
    s.count[k][threadIdx.x] = static_cast<uint16_t>(count);
  });
  // Every value of this thread above the floor, as (value, times): its
  // list, or (it overflowed) its registers.
  const bool listed = n_list <= kSlots;
  auto for_above = [&](auto&& f) {
    if (listed) {
      for (int k = 0; k < n_list; ++k) f(s.list[k][threadIdx.x], s.count[k][threadIdx.x]);
    } else {
      for_each([&](float v) { if (v > floor_v) f(v, 1u); });
    }
  };

  // 2. c* by radix select.
  const int e_hi = static_cast<int>(__float_as_uint(hi) >> 23) - 126;
  const int S = 126 - (32 - __clz(V)) - (e_hi > 0 ? e_hi : 0);
  const u128 limit = fixed_limit(top_p, S);
  u128 above = 0;
  unsigned prefix = 0;
  int e1 = 0;
  bool zero = false;
  // A level's sum of bin b over the cluster's ranks (all reads in flight at
  // once).
  auto bin_sum = [&](const uint2* h, int b) -> u64 {
    if constexpr (CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      uint2 v[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        v[r] = r < csize ? *cluster.map_shared_rank(&h[b], r) : make_uint2(0, 0);
      u64 t = 0;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) t += v[r].x + (static_cast<u64>(v[r].y) << 12);
      return t;
    } else {
      return h[b].x + (static_cast<u64>(h[b].y) << 12);
    }
  };
#pragma unroll
  for (int lv = 0; lv < kLevels; ++lv) {
    const int shift = level_shift(lv), nbits = level_bits(lv);
    uint2* h = s.hist + level_offset(lv);
    // The level's occupied range: each thread's lowest and highest bin,
    // then one atomic a warp.
    unsigned b_lo = ~0u, b_hi = 0;
    for_above([&](float v, unsigned times) {
      const unsigned bits = __float_as_uint(v);
      if ((bits >> (shift + nbits)) != prefix) return;
      const unsigned b = (bits >> shift) & ((1u << nbits) - 1);
      b_lo = min(b_lo, b);
      b_hi = max(b_hi, b);
      // the 24-bit mantissa, as two 12-bit halves (a 64-bit shared atomic
      // is a CAS loop on sm_90)
      const unsigned m = (bits & 0x7FFFFFu) | (bits >= 0x800000u ? 0x800000u : 0u);
      atomicAdd(&h[b].x, (m & 0xFFFu) * times);
      atomicAdd(&h[b].y, (m >> 12) * times);
    });
    if (lv > 0) {
      b_lo = __reduce_min_sync(kFull, b_lo);
      b_hi = __reduce_max_sync(kFull, b_hi);
      if ((threadIdx.x & 31) == 0 && b_lo <= b_hi) {
        atomicMin(&s.range[lv].x, static_cast<int>(b_lo));
        atomicMax(&s.range[lv].y, static_cast<int>(b_hi));
      }
    }
    if constexpr (CLUSTER) cg::this_cluster().sync(); else __syncthreads();
    if (lv == 0) {
      // Level 0 in 128-bit fixed point, by warp 0 from the top exponent
      // down, 32 exponents a chunk: lane l takes exponent E = top - l, its 8
      // bins (their mantissa sums share the unit 2^(max(E, 1) - 150 + S)),
      // and the mass of the higher exponents from a prefix over the lanes.
      // Values above the floor have exponents from the floor's to max(p)'s,
      // on every rank.
      if (warp == 0) {
        const int e_lo = floor_v > 0.f ? static_cast<int>(__float_as_uint(floor_v) >> 23) : 0;
        Pick<u128> r{-1, 0, 0};
        for (int top = static_cast<int>(__float_as_uint(hi) >> 23); top >= e_lo; top -= 32) {
          const int e = top - lane, sh = (e > 1 ? e : 1) - 150 + S;
          u64 u[8], all = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {   // no branch: the reads are all in flight at once
            u[j] = bin_sum(h, 8 * (e > 0 ? e : 0) + j);
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {   // exponents below the floor's hold nothing
            u[j] = e >= e_lo ? u[j] : 0;
            all += u[j];
          }
          const u128 mass = scale_up(all, sh);
          u128 x = mass;   // prefix over the lanes: the higher exponents come first
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const u128 y = shfl_up(x, o);
            if (lane >= o) x += y;
          }
          const u128 g = r.total + x - mass;
          int cand = -1;
          u128 cand_gt = 0;
          if (all != 0 && g <= limit) {
            const u64 room = to_units(limit - g, sh);
            u64 ua = 0;   // the exponent's mass above bin j, in its unit
#pragma unroll
            for (int j = 7; j >= 0; --j) {
              if (u[j] != 0 && ua <= room) {
                cand = 8 * e + j;
                cand_gt = g + scale_up(ua, sh);
              }
              ua += u[j];
            }
          }
          const unsigned m = __ballot_sync(0xffffffffu, cand >= 0);
          if (m) {   // the last lane with a candidate holds the lowest bin
            const int l = 31 - __clz(m);
            r.bin = __shfl_sync(0xffffffffu, cand, l);
            r.gt = shfl_idx(cand_gt, l);
          }
          r.total += shfl_idx(x, 31);
          if (r.total > limit) break;
        }
        if (lane == 0) s.pick0 = r;
      }
      __syncthreads();
      const Pick<u128> r = s.pick0;
      if (floor_v == 0.f && r.total <= limit) {   // the whole mass fits: c* = 0
        zero = true;
        break;
      }
      above = r.gt;
      prefix = static_cast<unsigned>(r.bin);
      e1 = r.bin >> 3;
    } else {
      // Levels 1 and 2: one exponent, so sums of mantissas are the unit,
      // and `room` is the mass that still fits, in that unit.
      if (warp == 0) {
        int lo_bin = INT_MAX, hi_bin = -1;
        if constexpr (CLUSTER) {
          cg::cluster_group cluster = cg::this_cluster();
          for (int r = 0; r < csize; ++r) {
            const int2 g = *cluster.map_shared_rank(&s.range[lv], r);
            lo_bin = min(lo_bin, g.x);
            hi_bin = max(hi_bin, g.y);
          }
        } else {
          lo_bin = s.range[lv].x;
          hi_bin = s.range[lv].y;
        }
        const u64 room = to_units(limit - above, (e1 > 1 ? e1 : 1) - 150 + S);
        const Pick<u64> r = warp_pick<4>(lo_bin, hi_bin, room, [&](int b, u64& sm, u64& m) {
          sm = bin_sum(h, b);
          m = sm;
        });
        if (lane == 0) s.pick[lv] = r;
      }
      __syncthreads();
      const Pick<u64> r = s.pick[lv];
      const int sh = (e1 > 1 ? e1 : 1) - 150 + S;
      above += scale_up(r.gt, sh);
      prefix = (prefix << nbits) | static_cast<unsigned>(r.bin);
    }
  }
  const float cstar = zero ? 0.f : __uint_as_float(prefix);

  // 3. The bisection, replayed.
  float lo = 0.f, up = hi;
  for (int it = 0; it < kIters; ++it) {
    const float mid = 0.5f * (lo + up);
    if (mid < cstar) lo = mid; else up = mid;
  }

  // 4. Boundary resolution (sequoia_tpu/kernels/top_p.py::_resolve_boundary),
  // in one reduction: cand = min{p > lo} (c*, unless a value lies in (lo,
  // c*) or c* = 0), the value above it (the next distinct value above lo)
  // and the value below it (max{p <= lo}: none lies in (lo, cand)).
  const float big = FLT_MAX;
  float4 res = make_float4(-big, big, big, 0.f);   // (below, cand, above, -)
  for_each([&](float v) {
    if (v <= lo) {
      res.x = fmaxf(res.x, v);
    } else if (v < res.y) {
      res.z = res.y;
      res.y = v;
    } else if (v > res.y && v < res.z) {
      res.z = v;
    }
  });
  res = row_reduce<CLUSTER>(res, s.x4, slot_4, Resolve());
  if (rank == 0 && threadIdx.x == 0) {
    const float cand = res.y;
    const bool include_cand = cand >= cstar;   // f(cand) <= top_p
    const float below = res.x > -big ? res.x : 0.f;
    const float above_v = res.z < big ? res.z : cand * 2.f;
    float t_inc = 0.5f * (cand + below);
    t_inc = t_inc > below ? t_inc : cand;
    float t_exc = 0.5f * (cand + above_v);
    t_exc = t_exc > cand ? t_exc : above_v;
    out[row_id] = include_cand ? t_inc : t_exc;
  }
  if constexpr (CLUSTER) cg::this_cluster().sync();   // no rank leaves while another reads it
}

template <int ITEMS, bool FROM_LOGITS, bool CLUSTER>
cudaError_t set_smem() {
  static bool done = false;   // above 48 KB only after this attribute; once
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(top_p_kernel<ITEMS, FROM_LOGITS, CLUSTER>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 sizeof(Scratch));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

int cluster_blocks(int V) {
  const int per_block = kThreads * kItemsC;
  const int c = (V + per_block - 1) / per_block;
  return c < kMaxCluster ? c : kMaxCluster;
}

template <bool FROM_LOGITS>
cudaError_t launch(const float* in, float* out, int R, int V, double top_p,
                   float temperature, cudaStream_t stream) {
  const int items = (V + kThreads - 1) / kThreads;
  const dim3 grid(R), block(kThreads);
#define SEQ_TOP_P_CASE(N)                                                      \
  if (items <= N) {                                                            \
    const cudaError_t err = set_smem<N, FROM_LOGITS, false>();                 \
    if (err != cudaSuccess) return err;                                        \
    top_p_kernel<N, FROM_LOGITS, false><<<grid, block, sizeof(Scratch), stream>>>( \
        in, out, V, top_p, temperature);                                       \
    return cudaGetLastError();                                                 \
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

cudaLaunchConfig_t cluster_config(int R, int csize, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool FROM_LOGITS>
cudaError_t launch_cluster(const float* in, float* out, int R, int V, double top_p,
                           float temperature, cudaStream_t stream) {
  if (V > kMaxVocab) return cudaErrorInvalidValue;
  const cudaError_t err = set_smem<kItemsC, FROM_LOGITS, true>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(R, cluster_blocks(V), stream, attr);
  cfg.dynamicSmemBytes = sizeof(Scratch);
  return cudaLaunchKernelEx(&cfg, top_p_kernel<kItemsC, FROM_LOGITS, true>, in, out, V,
                            top_p, temperature);
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// logits [R, V] f32 -> out [R] f32 (threshold on softmax(logits / T)).
// cluster: 0 = one block per row (V <= 512 * 64), 1 = a cluster of blocks
// per row (V <= 2^23).
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

// An empty kernel of the grid the top-p kernels launch for R rows of V
// (cluster: their cluster shape): the launch floor chip_smoke.py times
// them against.
int sequoia_top_p_empty(int R, int V, int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!cluster) {
    empty_kernel<<<R, kThreads, 0, st>>>();
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(R, cluster_blocks(V), st, attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, empty_kernel));
}

}  // extern "C"
