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
// The main cache may also be quantized (sequoia_tpu/kvcache/cache.py::
// KVCache8 / KVCache4, which the JAX model reads through XLA einsums,
// core/model.py:263-338): int8 rows [M, Hkv, D], or int4 rows packed two to a
// byte, head-paired [M, Hkv/2, D] (byte [m, j, d]: head 2j low nibble, head
// 2j+1 high) or dsplit [M, Hkv, D/2] (byte d: dim d low, dim D/2 + d high),
// with f32 scales ks, vs [M, Hkv]. The integers are cast exactly to q's
// dtype; a main score is dot * scale * ks[m, kh] before the mask; a main
// probability is multiplied by vs[m, kh] before it is rounded to q's dtype
// for the PV product; the softmax still runs once over main and scratch. The
// scratch is always float. Rows never written have scale 0 and are masked.
// A tile's rows cross device memory as integers (a half or a quarter of the
// bf16 bytes) in 16-byte loads and are expanded on their way from registers
// to shared memory, so the score and PV loops are the float kernel's. (The
// kernel is not bound by bytes yet, so the expansion's instructions cost
// more than the smaller rows save: PERF.md has the times.)
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

// Formats of the main cache.
constexpr int kFloat = 0, kInt8 = 1, kInt4Head = 2, kInt4Dsplit = 3;

// dst[0], dst[1] = a, b (dst 4-byte aligned).
__device__ __forceinline__ void store2(float* dst, float a, float b) { dst[0] = a; dst[1] = b; }
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
// Byte i of the words `w` as a signed value; its nibbles, sign-extended.
__device__ __forceinline__ int byte_at(const uint32_t* w, int i) {
  return static_cast<int8_t>(w[i / 4] >> (8 * (i % 4)));
}
__device__ __forceinline__ int nib_lo(int b) {
  return static_cast<int8_t>(static_cast<uint32_t>(b) << 4) >> 4;
}
__device__ __forceinline__ int nib_hi(int b) { return b >> 4; }

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
// the current tile is computed. KV is the format in device memory; shared
// memory always holds T. A quantized tile also carries the scales of the
// keys whose scores this thread computes (keys lane + 8c of the tile).
template <typename T, int D, int KV>
struct TileRegs {
  // Bytes of one (key, head) row in device memory, and per load: a dsplit
  // row at D = 16 has 8 bytes, every other row 16 or more.
  static constexpr int kRowBytes = KV == kFloat ? D * int(sizeof(T)) : KV == kInt4Dsplit ? D / 2 : D;
  static constexpr int kVecBytes = kRowBytes < 16 ? kRowBytes : 16;
  static constexpr int kWords = kVecBytes / 4;
  static constexpr int kVecs = kTK * kRowBytes / kVecBytes;   // loads per tile and tensor
  static constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  static constexpr int kKeys = kTK / kLanes;
  uint32_t k[kPer][kWords], v[kPer][kWords];
  float ks[kKeys], vs[kKeys];

  // `hs` heads are stored per key and this block reads stored head `hh`
  // (head-paired int4: Hkv / 2 and kh / 2; otherwise Hkv and kh).
  __device__ void load(const uint8_t* __restrict__ kc, const uint8_t* __restrict__ vc,
                       const float* __restrict__ ksc, const float* __restrict__ vsc,
                       int base, int len, int hs, int hh, int Hkv, int kh) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int vi = threadIdx.x + u * kThreads;
      const int e = vi * kVecBytes, j = e / kRowBytes, b = e % kRowBytes, key = base + j;
      const bool ok = vi < kVecs && key < len;
      const int64_t off = (static_cast<int64_t>(key) * hs + hh) * kRowBytes + b;
      if constexpr (kWords == 4) {
        const uint4 zero = make_uint4(0, 0, 0, 0);
        const uint4 a = ok ? *reinterpret_cast<const uint4*>(kc + off) : zero;
        const uint4 c = ok ? *reinterpret_cast<const uint4*>(vc + off) : zero;
        k[u][0] = a.x; k[u][1] = a.y; k[u][2] = a.z; k[u][3] = a.w;
        v[u][0] = c.x; v[u][1] = c.y; v[u][2] = c.z; v[u][3] = c.w;
      } else {
        const uint2 zero = make_uint2(0, 0);
        const uint2 a = ok ? *reinterpret_cast<const uint2*>(kc + off) : zero;
        const uint2 c = ok ? *reinterpret_cast<const uint2*>(vc + off) : zero;
        k[u][0] = a.x; k[u][1] = a.y;
        v[u][0] = c.x; v[u][1] = c.y;
      }
    }
    if (KV != kFloat) {
      const int lane = threadIdx.x % kLanes;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int key = base + lane + kLanes * c;
        ks[c] = key < len ? ksc[static_cast<int64_t>(key) * Hkv + kh] : 0.f;
        vs[c] = key < len ? vsc[static_cast<int64_t>(key) * Hkv + kh] : 0.f;
      }
    }
  }

  // One loaded vector of row bytes [b, b + kVecBytes) into the row `dst`.
  __device__ static void expand(T* dst, const uint32_t* w, int b, int odd_head) {
    if constexpr (KV == kFloat) {
      // Padded rows are 4-byte aligned, not 16: store word by word.
      uint32_t* d = reinterpret_cast<uint32_t*>(dst + b / int(sizeof(T)));
#pragma unroll
      for (int i = 0; i < kWords; ++i) d[i] = w[i];
    } else {
#pragma unroll
      for (int i = 0; i < kVecBytes; i += 2) {
        const int b0 = byte_at(w, i), b1 = byte_at(w, i + 1);
        if (KV == kInt8) {
          store2(dst + b + i, float(b0), float(b1));
        } else if (KV == kInt4Head) {
          store2(dst + b + i, float(odd_head ? nib_hi(b0) : nib_lo(b0)),
                 float(odd_head ? nib_hi(b1) : nib_lo(b1)));
        } else {
          store2(dst + b + i, float(nib_lo(b0)), float(nib_lo(b1)));
          store2(dst + D / 2 + b + i, float(nib_hi(b0)), float(nib_hi(b1)));
        }
      }
    }
  }

  __device__ void store(Smem<T, D>& sm, int odd_head) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int vi = threadIdx.x + u * kThreads;
      if (vi >= kVecs) continue;
      const int e = vi * kVecBytes, j = e / kRowBytes, b = e % kRowBytes;
      expand(&sm.k[j][0], k[u], b, odd_head);
      expand(&sm.v[j][0], v[u], b, odd_head);
    }
  }
};

// One region (main cache or scratch): `len` rows in format KV (scales ksc,
// vsc [len, Hkv] when quantized), mask [Q, len].
template <typename T, int D, int KV>
__device__ void attend_region(Smem<T, D>& sm, const void* __restrict__ kc_,
                              const void* __restrict__ vc_,
                              const float* __restrict__ ksc, const float* __restrict__ vsc,
                              const uint8_t* __restrict__ mask, int len,
                              int q0, int Q, int Hkv, int kh, float scale,
                              float& m, float& l, float (&acc)[D / kLanes]) {
  const uint8_t* kc = static_cast<const uint8_t*>(kc_);
  const uint8_t* vc = static_cast<const uint8_t*>(vc_);
  const int hs = KV == kInt4Head ? Hkv / 2 : Hkv, hh = KV == kInt4Head ? kh / 2 : kh;
  const int odd_head = kh & 1;
  const int tid = threadIdx.x;
  const int r = tid / kLanes, lane = tid % kLanes;
  const int q = q0 + r;
  constexpr int kCols = D / kLanes;
  constexpr int kKeys = kTK / kLanes;
  TileRegs<T, D, KV> regs;
  if (len > 0) regs.load(kc, vc, ksc, vsc, 0, len, hs, hh, Hkv, kh);
  for (int base = 0; base < len; base += kTK) {
    __syncthreads();  // the previous tile's readers are done
    regs.store(sm, odd_head);
    float kscale[kKeys], vscale[kKeys];   // this tile's, before the next load overwrites them
#pragma unroll
    for (int c = 0; c < kKeys; ++c) {
      kscale[c] = KV != kFloat ? regs.ks[c] : 1.f;
      vscale[c] = KV != kFloat ? regs.vs[c] : 1.f;
    }
    __syncthreads();
    if (base + kTK < len) regs.load(kc, vc, ksc, vsc, base + kTK, len, hs, hh, Hkv, kh);

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
      s[c] = !live ? kNeg : KV != kFloat ? s[c] * scale * kscale[c] : s[c] * scale;
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
      // probs (main, quantized: times the row's V scale) in q's dtype
      sm.p[r][lane + kLanes * c] = to_f(from_f<T>(KV != kFloat ? p * vscale[c] : p));
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

template <typename T, int D, int KV>
__global__ void __launch_bounds__(kThreads)
tree_attention_kernel(const T* __restrict__ q, const void* __restrict__ k,
                      const void* __restrict__ v, const float* __restrict__ ks,
                      const float* __restrict__ vs, const uint8_t* __restrict__ mask,
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
  attend_region<T, D, KV>(sm, k, v, ks, vs, mask, M, q0, Q, Hkv, kh, scale, m, l, acc);
  attend_region<T, D, kFloat>(sm, sk, sv, nullptr, nullptr, smask, S, q0, Q, Hkv, kh, scale, m,
                              l, acc);

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

template <typename T, int KV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* mask, const void* sk, const void* sv,
                   const void* smask, void* out, int Q, int H, int Hkv, int D, int M, int S,
                   float scale, cudaStream_t stream) {
  const dim3 grid((Q + kQT - 1) / kQT, H), block(kThreads);
#define SEQ_TA_CASE(DD)                                                        \
  if (D == DD) {                                                               \
    tree_attention_kernel<T, DD, KV><<<grid, block, 0, stream>>>(              \
        static_cast<const T*>(q), k, v, static_cast<const float*>(ks),         \
        static_cast<const float*>(vs), static_cast<const uint8_t*>(mask),      \
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

template <typename T>
int launch_format(int kv_format, const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* mask, const void* sk, const void* sv,
                  const void* smask, void* out, int Q, int H, int Hkv, int D, int M, int S,
                  float scale, cudaStream_t st) {
  if (kv_format != kFloat && (ks == nullptr || vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define SEQ_TA_FORMAT(KV)                                                      \
  if (kv_format == KV)                                                         \
    return static_cast<int>(launch<T, KV>(q, k, v, ks, vs, mask, sk, sv, smask, out, Q, H, \
                                          Hkv, D, M, S, scale, st));
  SEQ_TA_FORMAT(kFloat)
  SEQ_TA_FORMAT(kInt8)
  SEQ_TA_FORMAT(kInt4Head)
  SEQ_TA_FORMAT(kInt4Dsplit)
#undef SEQ_TA_FORMAT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype (of q, the scratch and the output): 0 = float32, 1 = bfloat16.
// kv_format of the main cache k, v: 0 = the same float type [M, Hkv, D];
// 1 = int8 [M, Hkv, D]; 2 = int4 head-paired [M, Hkv/2, D] (Hkv even);
// 3 = int4 dsplit [M, Hkv, D/2]; 1..3 with float32 scales ks, vs [M, Hkv]
// (else not read). Masks are uint8 (torch.bool) [Q, M] and [Q, S]; S may be 0
// (then sk, sv and smask are not read). Head dim D must be one of 16, 32, 64,
// 128; the wrapper checks it.
int sequoia_tree_attention(const void* q, const void* k, const void* v, const void* ks,
                           const void* vs, const void* mask, const void* sk,
                           const void* sv, const void* smask, void* out, int Q, int H,
                           int Hkv, int D, int M, int S, float scale, int dtype,
                           int kv_format, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_format == kInt4Head && Hkv % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_format<float>(kv_format, q, k, v, ks, vs, mask, sk, sv, smask, out, Q, H,
                                Hkv, D, M, S, scale, st);
  if (dtype == 1)
    return launch_format<__nv_bfloat16>(kv_format, q, k, v, ks, vs, mask, sk, sv, smask, out,
                                        Q, H, Hkv, D, M, S, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
