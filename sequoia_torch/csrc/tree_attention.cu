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
//
// Bound on the H100: bytes. At the verify shape (Q = 64, H = Hkv = 32,
// D = 128, M = 256, S = 64, bf16) one layer must read about 4.2 MB of K/V
// (about 1.3 us at 3.35 TB/s) against about 0.17 GFLOP of dot products.
// Two routes:
//
// bf16 (the engine's dtype): tensor cores, key splits, a prefix skip.
// - A block is one 16-query tile of one query head, 4 warps. It first scans
//   its tile's mask rows (16-byte loads where aligned) into bits in shared
//   memory and finds, for main and scratch apart, the last key that any of
//   its valid rows attends; tiles past that extent are not read. On the
//   engine's path the main mask is a per-row prefix (k < ts, k <= ts, the
//   causal prefill), so this skips the cache past the committed length
//   without a host sync. Exception: if a valid row attends no key at all,
//   the block walks everything, since such a row gets the mean of all V
//   rows (as the plain version and the JAX kernel give it).
// - The extent's 16-key tiles (main first, then scratch) are cut into
//   gridDim.z * 4 contiguous runs, one per warp; gridDim.z (the wrapper's
//   split count) adds blocks where ceil(Q/16) * H alone leaves SMs idle.
//   Each warp streams its run through a 2-stage cp.async ring of its own
//   (zero-filled past the region's end), computes S = Q K^T and P V with
//   mma.sync m16n8k16 (bf16 in, f32 accumulate; q's A fragments come from
//   the block's query tile in shared memory and K's B fragments from the
//   stage through ldmatrix, V's through ldmatrix.trans; P's f32 C fragments
//   become the A operand in registers) and keeps f32
//   partials (m, l, acc[16 x D]). A quantized main tile lands packed at the
//   end of its stage and is expanded in place to the bf16 rows that
//   TileRegs::expand would write (a prmt and an f32 or bf16x2 subtraction
//   per value, 16-byte stores), so every format shares one compute core and
//   the float format's stages: 3 blocks of 4 warps (at most 168 registers a
//   thread, __launch_bounds__) fit on an SM.
// - The 4 warps merge in shared memory; with one split the block writes
//   the output, otherwise an f32 workspace (the wrapper's) takes each
//   block's partial and tree_attention_merge_kernel combines them:
//   out = sum_z e^(m_z - m*) acc_z / max(sum_z e^(m_z - m*) l_z, 1e-30).
// - Shared-memory rows are D + 8 elements: 16-byte aligned for cp.async and
//   ldmatrix, and the 8 rows of one ldmatrix fall on distinct banks.
//
// f32 (the card-against-CPU checks only; tensor cores would change f32's
// numerics): the first design, on the CUDA cores in f32. One block per
// (16-query tile, query head), 128 threads, 8 per query row; it walks the
// whole main cache, then the scratch, in 32-key tiles staged in shared
// memory (16-byte loads into registers, the next tile's loads in flight
// while the current one is computed; rows padded by one word so the 8 lanes
// of a row hit distinct banks); a quantized tile's integers are expanded on
// their way from registers to shared memory.

#include "common.cuh"

namespace {

using namespace sq;

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
      // Past the region's end: no key (-inf), so a row that attends nothing
      // averages the real rows only.
      s[c] = key >= len ? -INFINITY
             : !live    ? kNeg
             : KV != kFloat ? s[c] * scale * kscale[c] : s[c] * scale;
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

// ---------------------------------------------------------------------------
// bf16 route: tensor cores, key splits, prefix skip.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;                 // warps per block, each a run of key tiles
constexpr int kTcThreads = kWarps * 32;
constexpr int kKT = 16;                   // keys per warp tile

template <int D, int KV>
struct TcLayout {
  static constexpr int kStride = D + 8;                  // bf16 elements per shared row
  static constexpr int kTileBytes = kKT * kStride * 2;   // one K or V tile
  // Per warp: 2 stages of (K, V); a quantized main cache adds 2 stages of
  // (ks, vs) for 16 keys.
  static constexpr int kScales = 4 * kTileBytes;
  static constexpr int kWarpBytes = kScales + (KV != kFloat ? 2 * 2 * kKT * 4 : 0);
  // (Per block, after the warps: the query tile [16][kStride], then the mask
  // bits.) Raw bytes of one stored (key, head) row and per cp.async (a dsplit row
  // at D = 16 has 8 bytes). A quantized tile lands packed at the end of its
  // stage and is expanded in place to bf16 rows.
  static constexpr int kRowBytes = KV == kFloat ? 2 * D : KV == kInt4Dsplit ? D / 2 : D;
  static constexpr int kVec = kRowBytes < 16 ? kRowBytes : 16;
  static constexpr int kRaw = kTileBytes - kKT * kRowBytes;   // offset of the packed rows
  static constexpr int kVecs = kKT * kRowBytes / kVec;        // raw vectors per tile
};

// 4 nibbles (the low nibble of each byte of `n`, high nibbles zero) as two
// bf16x2: the bf16 with bits 0x4300 | (v + 8) is 128 + v + 8, exactly; one
// bf16x2 subtraction of 136 gives v.
__device__ __forceinline__ void int4x4_to_bf16(uint32_t n, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = n ^ 0x08080808u;
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t a = __byte_perm(u, 0x43u, 0x4140), b = __byte_perm(u, 0x43u, 0x4342);
  const __nv_bfloat162 x = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a), bias);
  const __nv_bfloat162 y = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&b), bias);
  lo = *reinterpret_cast<const uint32_t*>(&x);
  hi = *reinterpret_cast<const uint32_t*>(&y);
}

// A quantized tile, packed at `buf + kRaw`, expanded in place to bf16 rows
// [16][kStride] (the same values as TileRegs::expand): `load` takes this
// lane's packed vectors into registers; after a __syncwarp (every lane has
// loaded) `store` writes their rows over the packed bytes.
template <int D, int KV>
struct RawTile {
  using L = TcLayout<D, KV>;
  static constexpr int kW = L::kVec / 4, kPer = (L::kVecs + 31) / 32;
  uint32_t w[kPer][kW];

  __device__ __forceinline__ void load(const unsigned char* buf, int lane) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = lane + 32 * u;
      if (i < L::kVecs) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(buf + L::kRaw + i * L::kVec);
#pragma unroll
        for (int x = 0; x < kW; ++x) w[u][x] = src[x];
      }
    }
  }

  __device__ __forceinline__ void store(unsigned char* buf, int lane, int odd_head) const {
    bf16* rows = reinterpret_cast<bf16*>(buf);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = lane + 32 * u;
      if (i >= L::kVecs) continue;
      const int e = i * L::kVec, j = e / L::kRowBytes, b = e % L::kRowBytes;
      bf16* dst = rows + j * L::kStride;
      uint32_t lo[2 * kW], hi[2 * kW];   // bf16x2 words of dims b.. (and D/2 + b..)
#pragma unroll
      for (int x = 0; x < kW; ++x) {
        if (KV == kInt8) {
          int8x4_to_bf16(w[u][x], lo[2 * x], lo[2 * x + 1]);
        } else if (KV == kInt4Head) {
          int4x4_to_bf16(odd_head ? (w[u][x] >> 4) & 0x0F0F0F0Fu : w[u][x] & 0x0F0F0F0Fu,
                         lo[2 * x], lo[2 * x + 1]);
        } else {
          int4x4_to_bf16(w[u][x] & 0x0F0F0F0Fu, lo[2 * x], lo[2 * x + 1]);
          int4x4_to_bf16((w[u][x] >> 4) & 0x0F0F0F0Fu, hi[2 * x], hi[2 * x + 1]);
        }
      }
#pragma unroll
      for (int x = 0; x < kW; x += 2) {
        *reinterpret_cast<uint4*>(dst + b + 4 * x) = make_uint4(lo[2 * x], lo[2 * x + 1],
                                                                lo[2 * x + 2], lo[2 * x + 3]);
        if (KV == kInt4Dsplit)
          *reinterpret_cast<uint4*>(dst + D / 2 + b + 4 * x) =
              make_uint4(hi[2 * x], hi[2 * x + 1], hi[2 * x + 2], hi[2 * x + 3]);
      }
    }
  }
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Bits of mask row `row` for keys [k0, k0 + 32) (those below len).
__device__ __forceinline__ uint32_t mask_word(const uint8_t* __restrict__ row, int k0, int len) {
  uint32_t word = 0;
  if (k0 + 32 <= len && (reinterpret_cast<uintptr_t>(row + k0) & 15) == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(row + k0);
    const uint4 a = p[0], b = p[1];
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t y = __vcmpne4(w[i], 0u);   // 0xff in each nonzero byte
      word |= ((y & 1u) | ((y >> 7) & 2u) | ((y >> 14) & 4u) | ((y >> 21) & 8u)) << (4 * i);
    }
  } else {
    for (int j = 0; j < 32 && k0 + j < len; ++j) word |= uint32_t(row[k0 + j] != 0) << j;
  }
  return word;
}

template <int D, int KV>
__global__ void __launch_bounds__(kTcThreads, 3)   // 3 blocks of 4 warps per SM
tree_attention_tc_kernel(const bf16* __restrict__ q, const void* __restrict__ k,
                         const void* __restrict__ v, const float* __restrict__ ks,
                         const float* __restrict__ vs, const uint8_t* __restrict__ mask,
                         const bf16* __restrict__ sk, const bf16* __restrict__ sv,
                         const uint8_t* __restrict__ smask, bf16* __restrict__ out,
                         float* __restrict__ part, int Q, int H, int Hkv, int M, int S,
                         float scale) {
  using L = TcLayout<D, KV>;
  constexpr int kStride = L::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ext[2];
  __shared__ unsigned s_alive;
  __shared__ float s_m[kWarps][kQT], s_l[kWarps][kQT];

  const int q0 = blockIdx.x * kQT, h = blockIdx.y, kh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mw = (M + 31) / 32, bw = mw + (S + 31) / 32;
  bf16* qs = reinterpret_cast<bf16*>(smem + kWarps * L::kWarpBytes);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + kWarps * L::kWarpBytes + L::kTileBytes);

  // 1. The query tile (rows past Q zero); the tile's mask rows as bits; the
  //    last live key of each region over the valid rows; which rows attend
  //    some key.
  for (int i = tid; i < kQT * D / 8; i += kTcThreads) {
    const int r = i / (D / 8), ch = i % (D / 8);
    const int qq = min(q0 + r, Q - 1);
    cp_async(qs + r * kStride + ch * 8, q + ((static_cast<int64_t>(qq) * H + h) * D + ch * 8),
             q0 + r < Q, 16);
  }
  cp_commit();
  if (tid == 0) { s_ext[0] = 0; s_ext[1] = 0; s_alive = 0u; }
  __syncthreads();
  for (int i = tid; i < kQT * bw; i += kTcThreads) {
    const int r = i / bw, w = i % bw, qq = q0 + r;
    const bool in_main = w < mw;
    const int len = in_main ? M : S, k0 = (in_main ? w : w - mw) * 32;
    uint32_t word = 0;
    if (qq < Q) word = mask_word((in_main ? mask : smask) + static_cast<int64_t>(qq) * len, k0, len);
    bits[i] = word;
    if (word) {
      atomicMax(&s_ext[in_main ? 0 : 1], k0 + 32 - __clz(word));
      atomicOr(&s_alive, 1u << r);
    }
  }
  cp_wait<0>();
  __syncthreads();
  int ext_m = s_ext[0], ext_s = s_ext[1];
  const int nvalid = min(kQT, Q - q0);
  const unsigned valid = (1u << nvalid) - 1u;
  if ((s_alive & valid) != valid) { ext_m = M; ext_s = S; }   // a row attends nothing
  const int ntm = (ext_m + kKT - 1) / kKT, nt = ntm + (ext_s + kKT - 1) / kKT;
  const int slots = gridDim.z * kWarps, slot = blockIdx.z * kWarps + warp;
  const int t_begin = static_cast<int>(static_cast<int64_t>(nt) * slot / slots);
  const int t_end = static_cast<int>(static_cast<int64_t>(nt) * (slot + 1) / slots);

  // 2. The warp's run of tiles. In the mma fragments a lane holds rows g and
  //    g + 8 and, of each 8 keys or dims, c and c + 1.
  const int g = lane >> 2, c = (lane & 3) * 2;
  unsigned char* wsm = smem + warp * L::kWarpBytes;
  auto stage_k = [&](int s) { return reinterpret_cast<bf16*>(wsm + (2 * s) * L::kTileBytes); };
  auto stage_v = [&](int s) { return reinterpret_cast<bf16*>(wsm + (2 * s + 1) * L::kTileBytes); };
  float* scl = reinterpret_cast<float*>(wsm + L::kScales);   // [stage][ks, vs][16]
  const int odd_head = kh & 1;

  auto issue = [&](int t, int s) {
    const bool in_main = t < ntm;
    const int base = (in_main ? t : t - ntm) * kKT;
    unsigned char* dk = reinterpret_cast<unsigned char*>(stage_k(s));
    unsigned char* dv = reinterpret_cast<unsigned char*>(stage_v(s));
    if (KV != kFloat && in_main) {
      // The 16 keys' scales (first: 32 scattered words, the slowest loads of
      // the group), then the raw rows, packed [16][kRowBytes] at kRaw.
      {
        const int key = base + (lane & 15);
        const bool ok = key < M;
        const float* src = (lane < 16 ? ks : vs) + (ok ? static_cast<int64_t>(key) * Hkv + kh : 0);
        cp_async(scl + s * 2 * kKT + lane, src, ok, 4);
      }
      const int hs = KV == kInt4Head ? Hkv / 2 : Hkv, hh = KV == kInt4Head ? kh / 2 : kh;
      const uint8_t* kc = static_cast<const uint8_t*>(k);
      const uint8_t* vc = static_cast<const uint8_t*>(v);
#pragma unroll
      for (int i = lane; i < L::kVecs; i += 32) {
        const int e = i * L::kVec, j = e / L::kRowBytes, b = e % L::kRowBytes, key = base + j;
        const bool ok = key < M;
        const int64_t off = (static_cast<int64_t>(ok ? key : 0) * hs + hh) * L::kRowBytes + b;
        cp_async(dk + L::kRaw + e, kc + off, ok, L::kVec);
        cp_async(dv + L::kRaw + e, vc + off, ok, L::kVec);
      }
    } else {
      const bf16* kc = in_main ? static_cast<const bf16*>(k) : sk;
      const bf16* vc = in_main ? static_cast<const bf16*>(v) : sv;
      const int len = in_main ? M : S;
      constexpr int kChunks = D / 8;   // 16-byte chunks per row
#pragma unroll
      for (int i = lane; i < kKT * kChunks; i += 32) {
        const int j = i / kChunks, ch = i % kChunks, key = base + j;
        const bool ok = key < len;
        const int64_t off = (static_cast<int64_t>(ok ? key : 0) * Hkv + kh) * D + ch * 8;
        cp_async(dk + (j * kStride + ch * 8) * 2, kc + off, ok, 16);
        cp_async(dv + (j * kStride + ch * 8) * 2, vc + off, ok, 16);
      }
    }
    cp_commit();
  };

  float m_0 = kNeg, m_1 = kNeg, l_0 = 0.f, l_1 = 0.f;   // rows g, g + 8
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (t_begin < t_end) issue(t_begin, 0);
  for (int t = t_begin; t < t_end; ++t) {
    const int s = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      issue(t + 1, s ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();   // every lane's copies of stage s have landed
    const bool in_main = t < ntm;
    const bool quant = KV != kFloat && in_main;
    const int base = (in_main ? t : t - ntm) * kKT, len = in_main ? M : S;
    const bf16* kt = stage_k(s);
    const bf16* vt = stage_v(s);
    if (quant) {   // expand the packed K and V rows in place
      unsigned char* kraw = reinterpret_cast<unsigned char*>(stage_k(s));
      unsigned char* vraw = reinterpret_cast<unsigned char*>(stage_v(s));
      RawTile<D, KV> rk, rv;
      rk.load(kraw, lane);
      rv.load(vraw, lane);
      __syncwarp();
      rk.store(kraw, lane, odd_head);
      rv.store(vraw, lane, odd_head);
      __syncwarp();
    }

    // S = Q K^T: two 8-key n-tiles; q's A fragments and K's B fragments
    // through ldmatrix.
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const bf16* qp = qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;
    const bf16* kp = kt + ((lane & 7) + ((lane >> 4) << 3)) * kStride + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a, qp + kk * 16);
      ldsm_x4(b, kp + kk * 16);
      mma_bf16(sc[0], a, b[0], b[1]);
      mma_bf16(sc[1], a, b[2], b[3]);
    }

    // Scale, mask, online softmax. Keys past the region's end are -inf
    // (no key at all); masked keys the finite -1e30.
    const int word = (in_main ? 0 : mw) + (base >> 5), sh = base & 31;
    const uint32_t bits0 = bits[g * bw + word] >> sh, bits1 = bits[(g + 8) * bw + word] >> sh;
    const float* tks = scl + s * 2 * kKT;
    float tmax0 = kNeg, tmax1 = kNeg;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + c + e;
        float x0 = sc[n][e], x1 = sc[n][2 + e];
        if (base + col >= len) {
          x0 = x1 = -INFINITY;
        } else {
          x0 = (bits0 >> col) & 1u ? (quant ? x0 * scale * tks[col] : x0 * scale) : kNeg;
          x1 = (bits1 >> col) & 1u ? (quant ? x1 * scale * tks[col] : x1 * scale) : kNeg;
        }
        sc[n][e] = x0;
        sc[n][2 + e] = x1;
        tmax0 = fmaxf(tmax0, x0);
        tmax1 = fmaxf(tmax1, x1);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xffffffffu, tmax0, o));
      tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xffffffffu, tmax1, o));
    }
    const float mn0 = fmaxf(m_0, tmax0), mn1 = fmaxf(m_1, tmax1);
    const float alpha0 = expf(m_0 - mn0), alpha1 = expf(m_1 - mn1);
    m_0 = mn0;
    m_1 = mn1;
    float psum0 = 0.f, psum1 = 0.f;
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = expf(sc[n][e] - mn0);
        p[2 + e] = expf(sc[n][2 + e] - mn1);
        psum0 += p[e];
        psum1 += p[2 + e];
        if (quant) {   // the row's V scale, before the rounding
          const float w = tks[kKT + n * 8 + c + e];
          p[e] *= w;
          p[2 + e] *= w;
        }
      }
      pa[2 * n] = bf16x2(p[0], p[1]);       // row g, keys n*8 + c, +1
      pa[2 * n + 1] = bf16x2(p[2], p[3]);   // row g + 8
    }
    l_0 = l_0 * alpha0 + psum0;
    l_1 = l_1 * alpha1 + psum1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // acc += P V: P's fragments as the A operand (keys 0-7 then 8-15).
    const uint32_t a[4] = {pa[0], pa[1], pa[2], pa[3]};
    const bf16* vp = vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldsm_x4_trans(b, vp + dn * 16);
      mma_bf16(acc[2 * dn], a, b[0], b[1]);
      mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
    }
    __syncwarp();   // stage s is free for the next issue
  }

  // 3. Merge the 4 warps in shared memory (the stages are free now).
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_0 += __shfl_xor_sync(0xffffffffu, l_0, o);
    l_1 += __shfl_xor_sync(0xffffffffu, l_1, o);
  }
  __syncthreads();
  if ((lane & 3) == 0) {
    s_m[warp][g] = m_0;
    s_m[warp][g + 8] = m_1;
    s_l[warp][g] = l_0;
    s_l[warp][g + 8] = l_1;
  }
  __syncthreads();
  float ms0 = kNeg, ms1 = kNeg;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    ms0 = fmaxf(ms0, s_m[w][g]);
    ms1 = fmaxf(ms1, s_m[w][g + 8]);
  }
  const float e0 = expf(m_0 - ms0), e1 = expf(m_1 - ms1);
  constexpr int kAccStride = D + 8;   // floats; float2 stores of a half warp hit 32 banks
  float* macc = reinterpret_cast<float*>(smem);   // [kWarps][kQT][kAccStride]
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float* p0 = macc + (warp * kQT + g) * kAccStride + n * 8 + c;
    float* p1 = p0 + 8 * kAccStride;
    *reinterpret_cast<float2*>(p0) = make_float2(acc[n][0] * e0, acc[n][1] * e0);
    *reinterpret_cast<float2*>(p1) = make_float2(acc[n][2] * e1, acc[n][3] * e1);
  }
  __syncthreads();
  const int z = blockIdx.z, Z = gridDim.z;
  for (int i = tid; i < kQT * D / 2; i += kTcThreads) {
    const int r = i / (D / 2), d = (i % (D / 2)) * 2, qq = q0 + r;
    if (qq >= Q) continue;
    float ms = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ms = fmaxf(ms, s_m[w][r]);
    float lsum = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lsum += expf(s_m[w][r] - ms) * s_l[w][r];
      const float2 x = *reinterpret_cast<const float2*>(macc + (w * kQT + r) * kAccStride + d);
      a0 += x.x;
      a1 += x.y;
    }
    const int64_t qh = static_cast<int64_t>(qq) * H + h;
    if (Z == 1) {
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      *reinterpret_cast<uint32_t*>(out + qh * D + d) = bf16x2(a0 * inv, a1 * inv);
    } else {
      // part: acc [Z, Q*H, D], then (m, l) [Z, Q*H, 2].
      const int64_t QH = static_cast<int64_t>(Q) * H;
      *reinterpret_cast<float2*>(part + (z * QH + qh) * D + d) = make_float2(a0, a1);
      if (d == 0)
        *reinterpret_cast<float2*>(part + Z * QH * D + (z * QH + qh) * 2) = make_float2(ms, lsum);
    }
  }
}

// out[qh, d] from the Z splits' partials (see the kernel's `part`).
__global__ void tree_attention_merge_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                                            int Z, int64_t QH, int D) {
  const int64_t n = QH * (D / 2);
  const float* ml = part + Z * QH * D;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t qh = i / (D / 2);
    const int d = static_cast<int>(i % (D / 2)) * 2;
    float ms = kNeg;
    for (int z = 0; z < Z; ++z) ms = fmaxf(ms, ml[(z * QH + qh) * 2]);
    float lsum = 0.f, a0 = 0.f, a1 = 0.f;
    for (int z = 0; z < Z; ++z) {
      const float2 st = *reinterpret_cast<const float2*>(ml + (z * QH + qh) * 2);
      const float w = expf(st.x - ms);
      const float2 x = *reinterpret_cast<const float2*>(part + (z * QH + qh) * D + d);
      lsum += w * st.y;
      a0 += w * x.x;
      a1 += w * x.y;
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    *reinterpret_cast<uint32_t*>(out + qh * D + d) = bf16x2(a0 * inv, a1 * inv);
  }
}

template <int D, int KV>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* mask, const void* sk, const void* sv,
                      const void* smask, void* out, void* part, int Q, int H, int Hkv, int M,
                      int S, int splits, float scale, cudaStream_t stream) {
  using L = TcLayout<D, KV>;
  const int bytes =
      kWarps * L::kWarpBytes + L::kTileBytes + kQT * ((M + 31) / 32 + (S + 31) / 32) * 4;
  // 227 KB per block, less the kernel's static shared memory (under 1 KB).
  constexpr int kMaxBytes = 226 * 1024;
  if (bytes > kMaxBytes || splits < 1 || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  auto kern = tree_attention_tc_kernel<D, KV>;
  static int allowed = 48 * 1024;   // dynamic shared memory the kernel may take
  if (bytes > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    allowed = bytes;
  }
  const dim3 grid((Q + kQT - 1) / kQT, H, splits);
  kern<<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const uint8_t*>(mask),
      static_cast<const bf16*>(sk), static_cast<const bf16*>(sv),
      static_cast<const uint8_t*>(smask), static_cast<bf16*>(out), static_cast<float*>(part), Q,
      H, Hkv, M, S, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int64_t QH = static_cast<int64_t>(Q) * H;
  const int64_t n = QH * (D / 2);
  const int blocks = static_cast<int>(n < 256 * 1024 ? (n + 255) / 256 : 1024);
  tree_attention_merge_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float*>(part),
                                                          static_cast<bf16*>(out), splits, QH, D);
  return cudaGetLastError();
}

template <int KV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const void* mask, const void* sk, const void* sv,
                       const void* smask, void* out, int Q, int H, int Hkv, int D, int M, int S,
                       float scale, cudaStream_t stream) {
  const dim3 grid((Q + kQT - 1) / kQT, H), block(kThreads);
#define SEQ_TA_CASE(DD)                                                        \
  if (D == DD) {                                                               \
    tree_attention_kernel<float, DD, KV><<<grid, block, 0, stream>>>(          \
        static_cast<const float*>(q), k, v, static_cast<const float*>(ks),     \
        static_cast<const float*>(vs), static_cast<const uint8_t*>(mask),      \
        static_cast<const float*>(sk), static_cast<const float*>(sv),          \
        static_cast<const uint8_t*>(smask), static_cast<float*>(out), Q, H,    \
        Hkv, M, S, scale);                                                     \
    return cudaGetLastError();                                                 \
  }
  SEQ_TA_CASE(16)
  SEQ_TA_CASE(32)
  SEQ_TA_CASE(64)
  SEQ_TA_CASE(128)
#undef SEQ_TA_CASE
  return cudaErrorInvalidValue;
}

template <int KV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* ks,
                        const void* vs, const void* mask, const void* sk, const void* sv,
                        const void* smask, void* out, void* part, int Q, int H, int Hkv, int D,
                        int M, int S, int splits, float scale, cudaStream_t stream) {
#define SEQ_TA_CASE(DD)                                                                 \
  if (D == DD)                                                                          \
    return launch_tc<DD, KV>(q, k, v, ks, vs, mask, sk, sv, smask, out, part, Q, H, Hkv, \
                             M, S, splits, scale, stream);
  SEQ_TA_CASE(16)
  SEQ_TA_CASE(32)
  SEQ_TA_CASE(64)
  SEQ_TA_CASE(128)
#undef SEQ_TA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (of q, the scratch and the output): 0 = float32 (the CUDA-core
// route; `part` and `splits` are not read), 1 = bfloat16 (the tensor-core
// route). kv_format of the main cache k, v: 0 = the same float type
// [M, Hkv, D]; 1 = int8 [M, Hkv, D]; 2 = int4 head-paired [M, Hkv/2, D]
// (Hkv even); 3 = int4 dsplit [M, Hkv, D/2]; 1..3 with float32 scales ks, vs
// [M, Hkv] (else not read). Masks are uint8 (torch.bool) [Q, M] and [Q, S];
// S may be 0 (then sk, sv and smask are not read). Head dim D must be one of
// 16, 32, 64, 128; the wrapper checks it. bf16: `splits` blocks share each
// (16-query tile, head); with more than one, `part` is an f32 workspace of
// splits * Q * H * (D + 2) floats.
int sequoia_tree_attention(const void* q, const void* k, const void* v, const void* ks,
                           const void* vs, const void* mask, const void* sk,
                           const void* sv, const void* smask, void* out, void* part, int Q,
                           int H, int Hkv, int D, int M, int S, int splits, float scale,
                           int dtype, int kv_format, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_format == kInt4Head && Hkv % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_format != kFloat && (ks == nullptr || vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define SEQ_TA_FORMAT(KV)                                                                    \
  if (kv_format == KV) {                                                                     \
    if (dtype == 0)                                                                          \
      return static_cast<int>(launch_f32<KV>(q, k, v, ks, vs, mask, sk, sv, smask, out, Q, H, \
                                             Hkv, D, M, S, scale, st));                      \
    if (dtype == 1)                                                                          \
      return static_cast<int>(launch_bf16<KV>(q, k, v, ks, vs, mask, sk, sv, smask, out,     \
                                              part, Q, H, Hkv, D, M, S, splits, scale, st)); \
  }
  SEQ_TA_FORMAT(kFloat)
  SEQ_TA_FORMAT(kInt8)
  SEQ_TA_FORMAT(kInt4Head)
  SEQ_TA_FORMAT(kInt4Dsplit)
#undef SEQ_TA_FORMAT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
