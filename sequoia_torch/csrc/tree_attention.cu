// Tree attention over the main KV cache and the tree scratch, for Hopper.
//
// Replaces the Pallas kernel sequoia_tpu/kernels/tree_attention.py::
// tree_attention (_kernel): flash-style online-softmax attention of
// q [Q, H, D] over main k/v [M, Hkv, D] under a [Q, M] mask, continued over
// the tree scratch sk/sv [S, Hkv, D] under a [Q, S] mask; query head h reads
// KV head h / (H / Hkv). Numerics follow the JAX kernel: scores, running max
// and running sum in f32; masked scores are a finite -1e30, so a region that
// is fully masked for a row adds exactly zero once a live score arrives
// (no NaN); probabilities are rounded to V's dtype before the PV product,
// which accumulates in f32. Output [Q, H, D] in q's dtype.
//
// Bound on the H100: bytes. At the verify shape (Q = 64, H = Hkv = 32,
// D = 128, M = 256, S = 64, bf16) one layer must read about 4.2 MB of K/V
// (about 1.3 us at 3.35 TB/s) against about 0.17 GFLOP of dot products.
// Design, simple first: one block per (16-query tile, query head), 128
// threads, 8 per query row. Each block walks the main cache in 32-key tiles
// staged in shared memory (16-byte loads into registers, the next tile's
// loads in flight while the current one is computed; rows padded by one
// word so the 8 lanes of a row hit distinct banks), keeps its row
// statistics and its D / 8 output columns in registers, then does one more
// walk over the scratch rows.
// The dot products run on the CUDA cores in f32, not on the tensor cores,
// and every query tile re-reads its head's K/V (from L2 after the first).
// Later work: wgmma tiles, and skipping main tiles past the per-row prefix
// length. On this engine's path the main mask is always a per-row prefix
// (k < ts or k <= ts), so that skip saves the tiles past the committed
// length outright.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kQT = 16;              // query rows per block
constexpr int kLanes = 8;            // threads per query row
constexpr int kThreads = kQT * kLanes;
constexpr int kTK = 32;              // keys per shared-memory tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row stride in elements that makes consecutive rows start on consecutive
// 4-byte banks (odd word stride).
template <typename T, int D> struct Pad { static constexpr int kStride = D + 4 / int(sizeof(T)); };

template <typename T, int D>
struct Smem {
  float q[kQT][D + 1];
  T k[kTK][Pad<T, D>::kStride];
  T v[kTK][Pad<T, D>::kStride];
  float p[kQT][kTK + 1];
};

// Registers that carry one K tile and one V tile from device memory to
// shared memory: 16-byte loads, all issued before any is used, so a tile
// costs one memory latency, and the next tile's loads are in flight while
// the current tile is computed.
template <typename T, int D>
struct TileRegs {
  static constexpr int kVec = 16 / int(sizeof(T));   // elements per load
  static constexpr int kVecs = kTK * D / kVec;       // loads per tile and tensor
  static constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  uint4 k[kPer], v[kPer];

  __device__ void load(const T* __restrict__ kc, const T* __restrict__ vc,
                       int base, int len, int Hkv, int kh) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int vi = threadIdx.x + u * kThreads;
      const int e = vi * kVec, j = e / D, d = e % D, key = base + j;
      const bool ok = vi < kVecs && key < len;
      const int64_t off = (static_cast<int64_t>(key) * Hkv + kh) * D + d;
      k[u] = ok ? *reinterpret_cast<const uint4*>(kc + off) : make_uint4(0, 0, 0, 0);
      v[u] = ok ? *reinterpret_cast<const uint4*>(vc + off) : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ void store(Smem<T, D>& sm) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int vi = threadIdx.x + u * kThreads;
      if (vi >= kVecs) continue;
      const int e = vi * kVec, j = e / D, d = e % D;
      // Padded rows are 4-byte aligned, not 16: store word by word.
      const uint32_t* ks = reinterpret_cast<const uint32_t*>(&k[u]);
      const uint32_t* vs = reinterpret_cast<const uint32_t*>(&v[u]);
      uint32_t* kd = reinterpret_cast<uint32_t*>(&sm.k[j][d]);
      uint32_t* vd = reinterpret_cast<uint32_t*>(&sm.v[j][d]);
#pragma unroll
      for (int w = 0; w < 4; ++w) { kd[w] = ks[w]; vd[w] = vs[w]; }
    }
  }
};

// One region (main cache or scratch): `len` rows of [Hkv, D], mask [Q, len].
template <typename T, int D>
__device__ void attend_region(Smem<T, D>& sm, const T* __restrict__ kc,
                              const T* __restrict__ vc,
                              const uint8_t* __restrict__ mask, int len,
                              int q0, int Q, int Hkv, int kh, float scale,
                              float& m, float& l, float (&acc)[D / kLanes]) {
  const int tid = threadIdx.x;
  const int r = tid / kLanes, lane = tid % kLanes;
  const int q = q0 + r;
  constexpr int kCols = D / kLanes;
  constexpr int kKeys = kTK / kLanes;
  TileRegs<T, D> regs;
  if (len > 0) regs.load(kc, vc, 0, len, Hkv, kh);
  for (int base = 0; base < len; base += kTK) {
    __syncthreads();  // the previous tile's readers are done
    regs.store(sm);
    __syncthreads();
    if (base + kTK < len) regs.load(kc, vc, base + kTK, len, Hkv, kh);

    // Scores of this thread's kKeys keys: d outer, so the kKeys dot
    // products are independent chains and q[r][d] is read once.
    float s[kKeys];
#pragma unroll
    for (int c = 0; c < kKeys; ++c) s[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = sm.q[r][d];
#pragma unroll
      for (int c = 0; c < kKeys; ++c) s[c] += qd * to_f(sm.k[lane + kLanes * c][d]);
    }
    float tmax = kNeg;
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      const int key = base + lane + kLanes * c;
      const bool live = q < Q && key < len &&
                        mask[static_cast<int64_t>(q) * len + key] != 0;
      s[c] = live ? s[c] * scale : kNeg;
      tmax = fmaxf(tmax, s[c]);
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      const float p = expf(s[c] - m_new);
      psum += p;
      sm.p[r][lane + kLanes * c] = to_f(from_f<T>(p));  // probs in V's dtype
    }
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's 8 lanes share one warp
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kTK; ++j) {
      const float p = sm.p[r][j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] += p * to_f(sm.v[j][lane + kLanes * c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
tree_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ mask,
                      const T* __restrict__ sk, const T* __restrict__ sv,
                      const uint8_t* __restrict__ smask, T* __restrict__ out,
                      int Q, int H, int Hkv, int M, int S, float scale) {
  __shared__ Smem<T, D> sm;
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, kh = h / (H / Hkv);
  const int tid = threadIdx.x;
  for (int i = tid; i < kQT * D; i += kThreads) {
    const int rr = i / D, d = i % D, qq = q0 + rr;
    sm.q[rr][d] = qq < Q ? to_f(q[(static_cast<int64_t>(qq) * H + h) * D + d]) : 0.f;
  }
  // attend_region's first __syncthreads orders these stores before use.
  float m = kNeg, l = 0.f;
  float acc[D / kLanes];
#pragma unroll
  for (int c = 0; c < D / kLanes; ++c) acc[c] = 0.f;
  attend_region<T, D>(sm, k, v, mask, M, q0, Q, Hkv, kh, scale, m, l, acc);
  attend_region<T, D>(sm, sk, sv, smask, S, q0, Q, Hkv, kh, scale, m, l, acc);

  const int r = tid / kLanes, lane = tid % kLanes, qq = q0 + r;
  if (qq < Q) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < D / kLanes; ++c) {
      const int d = lane + kLanes * c;
      out[(static_cast<int64_t>(qq) * H + h) * D + d] = from_f<T>(acc[c] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   const void* sk, const void* sv, const void* smask, void* out,
                   int Q, int H, int Hkv, int D, int M, int S, float scale,
                   cudaStream_t stream) {
  const dim3 grid((Q + kQT - 1) / kQT, H), block(kThreads);
#define SEQ_TA_CASE(DD)                                                        \
  if (D == DD) {                                                               \
    tree_attention_kernel<T, DD><<<grid, block, 0, stream>>>(                  \
        static_cast<const T*>(q), static_cast<const T*>(k),                    \
        static_cast<const T*>(v), static_cast<const uint8_t*>(mask),           \
        static_cast<const T*>(sk), static_cast<const T*>(sv),                  \
        static_cast<const uint8_t*>(smask), static_cast<T*>(out), Q, H, Hkv,   \
        M, S, scale);                                                          \
    return cudaGetLastError();                                                 \
  }
  SEQ_TA_CASE(16)
  SEQ_TA_CASE(32)
  SEQ_TA_CASE(64)
  SEQ_TA_CASE(128)
#undef SEQ_TA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Masks are uint8 (torch.bool) [Q, M] and
// [Q, S]; S may be 0 (then sk, sv and smask are not read). Head dim D must be
// one of 16, 32, 64, 128; the wrapper checks it.
int sequoia_tree_attention(const void* q, const void* k, const void* v,
                           const void* mask, const void* sk, const void* sv,
                           const void* smask, void* out, int Q, int H, int Hkv,
                           int D, int M, int S, float scale, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k, v, mask, sk, sv, smask, out, Q,
                                          H, Hkv, D, M, S, scale, st));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(q, k, v, mask, sk, sv, smask,
                                                  out, Q, H, Hkv, D, M, S,
                                                  scale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
