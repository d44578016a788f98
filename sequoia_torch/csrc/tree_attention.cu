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
// D = 128, M = 256, S = 64) one layer must read about 4.2 MB of K/V in bf16
// (about 1.3 us at 3.35 TB/s) and twice that in f32, against about 0.17
// GFLOP of dot products (f32 on the tensor cores as three TF32 passes:
// about 1 us at 495 TFLOP/s). Both routes share one decomposition:
// - A block is one 16-query tile of one query head, W warps (bf16 4, f32
//   8). It first scans
//   its tile's mask rows (16-byte loads where aligned) into bits in shared
//   memory and finds, for main and scratch apart, the last key that any of
//   its valid rows attends; tiles past that extent are not read. On the
//   engine's path the main mask is a per-row prefix (k < ts, k <= ts, the
//   causal prefill), so this skips the cache past the committed length
//   without a host sync. Exception: if a valid row attends no key at all,
//   the block walks everything, since such a row gets the mean of all V
//   rows (as the plain version and the JAX kernel give it).
// - The extent's 16-key tiles (main first, then scratch) are cut into
//   gridDim.z * W contiguous runs, one per warp; gridDim.z (the wrapper's
//   split count) adds blocks where ceil(Q/16) * H alone leaves SMs idle.
//   Each warp streams its run through a cp.async ring of its own (bf16: 2
//   stages of 16 keys; f32: 4 of 8; zero-filled past the region's end) and
//   keeps f32 partials (m, l, acc[16 x D]) in the mma accumulator layout,
//   which both routes share.
// - The W warps merge in shared memory; with one split the block writes
//   the output, otherwise an f32 workspace (the wrapper's) takes each
//   block's partial and tree_attention_merge_kernel combines them:
//   out = sum_z e^(m_z - m*) acc_z / max(sum_z e^(m_z - m*) l_z, 1e-30).
// - Slots (the batched engine's, sequoia_tpu/engine/batched.py, where the
//   Pallas call gains a grid axis under jax.vmap): B independent problems,
//   each operand a contiguous [B, ...] block of the single shapes above
//   (q [B, Q, H, D], main rows [B, M, ...], scales [B, M, Hkv], masks
//   [B, Q, M] and [B, Q, S], scratch [B, S, Hkv, D]). The grid's y axis is
//   b * H + h: a block offsets its slot's operands and otherwise runs the
//   single problem, its own prefix skip included. The output and the split
//   partials are laid out over the B * Q query rows. B = 1 is the single
//   call.
//
// bf16 (tree_attention_tc_kernel): a stage is 16 keys; S = Q K^T and P V on
// mma.sync m16n8k16 (bf16 in, f32 accumulate; q's A fragments from the
// block's query tile in shared memory and K's B fragments from the stage
// through ldmatrix, V's through ldmatrix.trans; P's f32 C fragments become
// the A operand in registers). A quantized main tile lands packed at the end
// of its stage and is expanded in place to bf16 rows (a prmt and an f32 or
// bf16x2 subtraction per value, 16-byte stores), so every format shares one
// compute core and the float format's stages: 3 blocks of 4 warps (at most
// 168 registers a thread, __launch_bounds__) fit on an SM. Shared rows are
// D + 8 elements: 16-byte aligned for cp.async and ldmatrix, and the 8 rows
// of one ldmatrix fall on distinct banks.
//
// f32 (tree_attention_f32_kernel): f32-accurate products on the TF32 tensor
// cores, 3xTF32 on mma.sync m16n8k8: each f32 operand x is split into
// hi = rna_tf32(x) and lo = rna_tf32(x - hi) (x - hi is exact; hi + lo
// keeps x to 2^-22 |x|), and a.b = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi (the
// dropped a_lo.b_lo is below 2^-22 |a b|). The tensor cores sum f32 by
// truncation, so each chain is kept short: S's 16 x 8 tile sums into six
// accumulators (the three products, even and odd k steps), added in f32 at
// the end; each 8-key step's P V goes into a zeroed accumulator (3 mma)
// that one FMA folds into acc (acc * alpha + pv). P stays f32 (split like
// the other operands). Integer rows expand exactly to f32, so a quantized
// main tile has lo = 0 and skips that product. An f32 stage is 8 keys (one
// n tile of S, one k step of P V); the run of 16-key tiles is walked in
// halves, each its own online-softmax step. A warp's step is bound by its
// own latency (mma chains, the splits), not by its loads (a 4-stage ring
// ran no faster than 2 on an H100), so a block has 8 warps: the rings (8
// warps x 2 stages x (K, V) of 8 x (D + 4) floats), the query tile's hi
// and lo planes and the mask bits take 152 KB at D = 128, one block per
// SM, and the wrapper's split count keeps the grid to one wave of them (at
// the verify shape one split of 4-warp blocks beat three by 1.7x: a
// second wave and the merge cost more than shorter runs saved). Rows are D + 4
// floats (16-byte aligned; ldmatrix, which moves 32-bit elements as b16
// pairs, gives q's A and K's B fragments; V's B fragment, a column,
// comes from scalar loads at rows 2c and 2c + 1, on distinct banks). A
// tf32 A fragment holds keys c and c + 4 where S's C fragment holds 2c and
// 2c + 1: the k step of P V reads its 8 keys in the order 0, 2, 4, 6, 1,
// 3, 5, 7, and V's rows follow it. Quantized rows land packed at the end
// of the stage and expand in place, as on the bf16 route.

#include "common.cuh"

namespace {

using namespace sq;
using bf16 = __nv_bfloat16;

constexpr int kQT = 16;                   // query rows per block
constexpr int kWarps = 4;                 // bf16: warps per block, each a run of key tiles
constexpr int kF32Warps = 8;              // f32: the same
constexpr int kKT = 16;                   // keys per tile of a run
constexpr int kKH = 8;                    // keys per f32 stage (half a tile)
constexpr int kF32Stages = 2;             // the f32 route's cp.async ring
constexpr float kNeg = -1e30f;

// Formats of the main cache.
constexpr int kFloat = 0, kInt8 = 1, kInt4Head = 2, kInt4Dsplit = 3;

// ---------------------------------------------------------------------------
// Shared by both routes: the mask scan and the merges.
// ---------------------------------------------------------------------------

template <int W>   // warps per block
struct BlockShared {
  int ext[2];                             // last live key + 1: main, scratch
  unsigned alive;                         // rows that attend some key
  float m[W][kQT], l[W][kQT];             // the warps' partials, for the merge
};

// This warp's run of 16-key tiles: tiles [0, ntm) are main, [ntm, nt)
// scratch; the warp takes [t_begin, t_end).
struct Run {
  int ntm, t_begin, t_end;
};

// The tile's mask rows as bits [kQT][bw] in `bits` (bw = words of main,
// then of scratch); the last live key of each region over the valid rows;
// which rows attend some key; then this warp's run (of gridDim.z * W).
// Waits for the block's cp.async groups (the query tile) and ends with a
// __syncthreads.
template <int W>
__device__ __forceinline__ Run scan_masks(const uint8_t* __restrict__ mask,
                                          const uint8_t* __restrict__ smask, uint32_t* bits,
                                          BlockShared<W>& sh, int q0, int Q, int M, int S) {
  constexpr int kThreads = W * 32;
  const int tid = threadIdx.x, warp = tid / 32;
  const int mw = (M + 31) / 32, bw = mw + (S + 31) / 32;
  if (tid == 0) { sh.ext[0] = 0; sh.ext[1] = 0; sh.alive = 0u; }
  __syncthreads();
  for (int i = tid; i < kQT * bw; i += kThreads) {
    const int r = i / bw, w = i % bw, qq = q0 + r;
    const bool in_main = w < mw;
    const int len = in_main ? M : S, k0 = (in_main ? w : w - mw) * 32;
    uint32_t word = 0;
    if (qq < Q) word = mask_word((in_main ? mask : smask) + static_cast<int64_t>(qq) * len, k0, len);
    bits[i] = word;
    if (word) {
      atomicMax(&sh.ext[in_main ? 0 : 1], k0 + 32 - __clz(word));
      atomicOr(&sh.alive, 1u << r);
    }
  }
  cp_wait<0>();
  __syncthreads();
  int ext_m = sh.ext[0], ext_s = sh.ext[1];
  const int nvalid = min(kQT, Q - q0);
  const unsigned valid = (1u << nvalid) - 1u;
  if ((sh.alive & valid) != valid) { ext_m = M; ext_s = S; }   // a row attends nothing
  const int ntm = (ext_m + kKT - 1) / kKT, nt = ntm + (ext_s + kKT - 1) / kKT;
  const int slots = gridDim.z * W, slot = blockIdx.z * W + warp;
  return {ntm, static_cast<int>(static_cast<int64_t>(nt) * slot / slots),
          static_cast<int>(static_cast<int64_t>(nt) * (slot + 1) / slots)};
}

// out[0], out[1] = a, b in the output type.
__device__ __forceinline__ void store_pair(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* out, float a, float b) {
  *reinterpret_cast<uint32_t*>(out) = bf16x2(a, b);
}

// The block's W warps merged in shared memory (from `smem`, whose stages are
// free once every warp is here), then the output (one split) or the block's
// partial in `part`. acc is the mma C layout: acc[n] holds rows g (0, 1) and
// g + 8 (2, 3), dims n * 8 + c, c + 1.
template <int D, int W, typename T>
__device__ __forceinline__ void merge_block(const float (&acc)[D / 8][4], float m_0, float m_1,
                                            float l_0, float l_1, unsigned char* smem,
                                            BlockShared<W>& sh, T* __restrict__ out,
                                            float* __restrict__ part, int q0, int Q, int H,
                                            int h, int b) {
  constexpr int kThreads = W * 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_0 += __shfl_xor_sync(0xffffffffu, l_0, o);
    l_1 += __shfl_xor_sync(0xffffffffu, l_1, o);
  }
  __syncthreads();
  if ((lane & 3) == 0) {
    sh.m[warp][g] = m_0;
    sh.m[warp][g + 8] = m_1;
    sh.l[warp][g] = l_0;
    sh.l[warp][g + 8] = l_1;
  }
  __syncthreads();
  float ms0 = kNeg, ms1 = kNeg;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    ms0 = fmaxf(ms0, sh.m[w][g]);
    ms1 = fmaxf(ms1, sh.m[w][g + 8]);
  }
  const float e0 = expf(m_0 - ms0), e1 = expf(m_1 - ms1);
  constexpr int kAccStride = D + 8;   // floats; float2 stores of a half warp hit 32 banks
  float* macc = reinterpret_cast<float*>(smem);   // [W][kQT][kAccStride]
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float* p0 = macc + (warp * kQT + g) * kAccStride + n * 8 + c;
    float* p1 = p0 + 8 * kAccStride;
    *reinterpret_cast<float2*>(p0) = make_float2(acc[n][0] * e0, acc[n][1] * e0);
    *reinterpret_cast<float2*>(p1) = make_float2(acc[n][2] * e1, acc[n][3] * e1);
  }
  __syncthreads();
  const int z = blockIdx.z, Z = gridDim.z;
  for (int i = tid; i < kQT * D / 2; i += kThreads) {
    const int r = i / (D / 2), d = (i % (D / 2)) * 2, qq = q0 + r;
    if (qq >= Q) continue;
    float ms = kNeg;
#pragma unroll
    for (int w = 0; w < W; ++w) ms = fmaxf(ms, sh.m[w][r]);
    float lsum = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      lsum += expf(sh.m[w][r] - ms) * sh.l[w][r];
      const float2 x = *reinterpret_cast<const float2*>(macc + (w * kQT + r) * kAccStride + d);
      a0 += x.x;
      a1 += x.y;
    }
    const int64_t qh = (static_cast<int64_t>(b) * Q + qq) * H + h;   // over all slots
    if (Z == 1) {
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
      store_pair(out + qh * D + d, a0 * inv, a1 * inv);
    } else {
      // part: acc [Z, B*Q*H, D], then (m, l) [Z, B*Q*H, 2] (gridDim.y = B*H).
      const int64_t QH = static_cast<int64_t>(gridDim.y) * Q;
      *reinterpret_cast<float2*>(part + (z * QH + qh) * D + d) = make_float2(a0, a1);
      if (d == 0)
        *reinterpret_cast<float2*>(part + Z * QH * D + (z * QH + qh) * 2) = make_float2(ms, lsum);
    }
  }
}

// out[qh, d] from the Z splits' partials (see merge_block's `part`).
template <typename T>
__global__ void tree_attention_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
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
    store_pair(out + qh * D + d, a0 * inv, a1 * inv);
  }
}

// Scale, mask and the online-softmax update of one row pair's scores
// x[n][e] (rows g: e = 0, 1; g + 8: e = 2, 3; keys n * 8 + c + (e & 1)),
// in place: keys past the region's end are -inf (no key at all), masked
// keys the finite -1e30; quantized main scores times ks (`ksc`, per key of
// the tile). Returns the rescale factors of the rows' running sums and
// accumulators, and leaves the probabilities in x (their sum in l_0, l_1).
template <int N>
__device__ __forceinline__ void online_softmax(float (&x)[N][4], uint32_t bits0, uint32_t bits1,
                                               int base, int len, int c, float scale,
                                               const float* ksc, float& m_0, float& m_1,
                                               float& l_0, float& l_1, float& alpha0,
                                               float& alpha1) {
  float tmax0 = kNeg, tmax1 = kNeg;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n * 8 + c + e;
      float x0 = x[n][e], x1 = x[n][2 + e];
      if (base + col >= len) {
        x0 = x1 = -INFINITY;
      } else {
        x0 = (bits0 >> col) & 1u ? (ksc ? x0 * scale * ksc[col] : x0 * scale) : kNeg;
        x1 = (bits1 >> col) & 1u ? (ksc ? x1 * scale * ksc[col] : x1 * scale) : kNeg;
      }
      x[n][e] = x0;
      x[n][2 + e] = x1;
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
  alpha0 = expf(m_0 - mn0);
  alpha1 = expf(m_1 - mn1);
  m_0 = mn0;
  m_1 = mn1;
  float psum0 = 0.f, psum1 = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[n][e] = expf(x[n][e] - mn0);
      x[n][2 + e] = expf(x[n][2 + e] - mn1);
      psum0 += x[n][e];
      psum1 += x[n][2 + e];
    }
  }
  l_0 = l_0 * alpha0 + psum0;
  l_1 = l_1 * alpha1 + psum1;
}

// This block's slot b = blockIdx.y / H and query head h = blockIdx.y % H,
// and the element offsets of the slot's operands (`row_bytes`: bytes per
// main-cache key over its stored heads).
struct Slot {
  int b, h;
  int64_t q, kv, scales, mask, scr, smask;
};

__device__ __forceinline__ Slot slot_of_block(int Q, int H, int Hkv, int D, int M, int S,
                                              int row_bytes) {
  const int b = blockIdx.y / H;
  const int64_t s = b;
  return {b, static_cast<int>(blockIdx.y % H), s * Q * H * D, s * M * row_bytes, s * M * Hkv,
          s * Q * M, s * S * Hkv * D, s * Q * S};
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync m16n8k16, 16-key stages.
// ---------------------------------------------------------------------------

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

// A quantized tile, packed at `buf + kRaw`, expanded in place to bf16 rows
// [16][kStride] (the integers cast exactly): `load` takes this lane's
// packed vectors into registers; after a __syncwarp (every lane has loaded)
// `store` writes their rows over the packed bytes.
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

template <int D, int KV>
__global__ void __launch_bounds__(kWarps * 32, 3)   // 3 blocks of 4 warps per SM
tree_attention_tc_kernel(const bf16* __restrict__ q, const void* __restrict__ k,
                         const void* __restrict__ v, const float* __restrict__ ks,
                         const float* __restrict__ vs, const uint8_t* __restrict__ mask,
                         const bf16* __restrict__ sk, const bf16* __restrict__ sv,
                         const uint8_t* __restrict__ smask, bf16* __restrict__ out,
                         float* __restrict__ part, int Q, int H, int Hkv, int M, int S,
                         float scale) {
  using L = TcLayout<D, KV>;
  constexpr int kStride = L::kStride, kThreads = kWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ BlockShared<kWarps> sh;

  const Slot slot = slot_of_block(Q, H, Hkv, D, M, S,
                                  (KV == kInt4Head ? Hkv / 2 : Hkv) * L::kRowBytes);
  const int b = slot.b, h = slot.h;
  q += slot.q;
  k = static_cast<const unsigned char*>(k) + slot.kv;
  v = static_cast<const unsigned char*>(v) + slot.kv;
  if (KV != kFloat) {
    ks += slot.scales;
    vs += slot.scales;
  }
  mask += slot.mask;
  sk += slot.scr;
  sv += slot.scr;
  smask += slot.smask;
  const int q0 = blockIdx.x * kQT, kh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mw = (M + 31) / 32, bw = mw + (S + 31) / 32;
  bf16* qs = reinterpret_cast<bf16*>(smem + kWarps * L::kWarpBytes);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + kWarps * L::kWarpBytes + L::kTileBytes);

  // 1. The query tile (rows past Q zero), in flight while the masks are scanned.
  for (int i = tid; i < kQT * D / 8; i += kThreads) {
    const int r = i / (D / 8), ch = i % (D / 8);
    const int qq = min(q0 + r, Q - 1);
    cp_async(qs + r * kStride + ch * 8, q + ((static_cast<int64_t>(qq) * H + h) * D + ch * 8),
             q0 + r < Q, 16);
  }
  cp_commit();
  const Run run = scan_masks(mask, smask, bits, sh, q0, Q, M, S);
  const int ntm = run.ntm, t_begin = run.t_begin, t_end = run.t_end;

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

    const int word = (in_main ? 0 : mw) + (base >> 5), sh5 = base & 31;
    const float* tks = scl + s * 2 * kKT;
    float alpha0, alpha1;
    online_softmax(sc, bits[g * bw + word] >> sh5, bits[(g + 8) * bw + word] >> sh5, base, len,
                   c, scale, quant ? tks : nullptr, m_0, m_1, l_0, l_1, alpha0, alpha1);
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float* p = sc[n];
      if (quant) {   // the row's V scale, before the rounding
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float w = tks[kKT + n * 8 + c + e];
          p[e] *= w;
          p[2 + e] *= w;
        }
      }
      pa[2 * n] = bf16x2(p[0], p[1]);       // row g, keys n*8 + c, +1
      pa[2 * n + 1] = bf16x2(p[2], p[3]);   // row g + 8
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // acc += P V: P's fragments as the A operand (keys 0-7 then 8-15).
    const bf16* vp = vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 8;
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn) {
      uint32_t b[4];
      ldsm_x4_trans(b, vp + dn * 16);
      mma_bf16(acc[2 * dn], pa, b[0], b[1]);
      mma_bf16(acc[2 * dn + 1], pa, b[2], b[3]);
    }
    __syncwarp();   // stage s is free for the next issue
  }

  // 3. Merge the 4 warps, then the output or the block's partial.
  merge_block<D>(acc, m_0, m_1, l_0, l_1, smem, sh, out, part, q0, Q, H, h, b);
}

// ---------------------------------------------------------------------------
// f32 route: 3xTF32 on mma.sync m16n8k8, 8-key stages.
// ---------------------------------------------------------------------------

template <int D, int KV>
struct F32Layout {
  static constexpr int kStride = D + 4;                  // floats per shared row
  static constexpr int kHalfBytes = kKH * kStride * 4;   // one K or V stage
  // Per warp: kF32Stages stages of (K, V); a quantized main cache adds as
  // many of (ks, vs) for 8 keys. Per block, after the warps: the query
  // tile's hi and lo planes [16][kStride] each, then the mask bits.
  static constexpr int kScales = 2 * kF32Stages * kHalfBytes;
  static constexpr int kWarpBytes = kScales + (KV != kFloat ? kF32Stages * 2 * kKH * 4 : 0);
  static constexpr int kQBytes = kQT * kStride * 4;
  static constexpr int kRowBytes = KV == kFloat ? 4 * D : KV == kInt4Dsplit ? D / 2 : D;
  static constexpr int kVec = kRowBytes < 16 ? kRowBytes : 16;
  static constexpr int kRaw = kHalfBytes - kKH * kRowBytes;   // offset of the packed rows
  static constexpr int kVecs = kKH * kRowBytes / kVec;
};

// A quantized 8-key stage, packed at `buf + kRaw`, expanded in place to f32
// rows [8][kStride] (the integers cast exactly), as RawTile does for bf16.
template <int D, int KV>
struct RawTileF32 {
  using L = F32Layout<D, KV>;
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
    float* rows = reinterpret_cast<float*>(buf);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = lane + 32 * u;
      if (i >= L::kVecs) continue;
      const int e = i * L::kVec, j = e / L::kRowBytes, b = e % L::kRowBytes;
      float4* dst = reinterpret_cast<float4*>(rows + j * L::kStride + b);
#pragma unroll
      for (int x = 0; x < kW; ++x) {
        const uint32_t word = w[u][x];
        if (KV == kInt8) {
          dst[x] = bytes_to_f32(word ^ 0x80808080u, 8388736.f);
        } else if (KV == kInt4Head) {
          const uint32_t n = odd_head ? (word >> 4) & 0x0F0F0F0Fu : word & 0x0F0F0F0Fu;
          dst[x] = bytes_to_f32(n ^ 0x08080808u, 8388616.f);
        } else {
          dst[x] = bytes_to_f32((word & 0x0F0F0F0Fu) ^ 0x08080808u, 8388616.f);
          dst[D / 8 + x] = bytes_to_f32(((word >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8388616.f);
        }
      }
    }
  }
};

template <int D, int KV>
__global__ void __launch_bounds__(kF32Warps * 32, 1)   // 1 block of 8 warps per SM
tree_attention_f32_kernel(const float* __restrict__ q, const void* __restrict__ k,
                          const void* __restrict__ v, const float* __restrict__ ks,
                          const float* __restrict__ vs, const uint8_t* __restrict__ mask,
                          const float* __restrict__ sk, const float* __restrict__ sv,
                          const uint8_t* __restrict__ smask, float* __restrict__ out,
                          float* __restrict__ part, int Q, int H, int Hkv, int M, int S,
                          float scale) {
  using L = F32Layout<D, KV>;
  constexpr int kStride = L::kStride, W = kF32Warps, kThreads = W * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ BlockShared<W> sh;

  const Slot slot = slot_of_block(Q, H, Hkv, D, M, S,
                                  (KV == kInt4Head ? Hkv / 2 : Hkv) * L::kRowBytes);
  const int b = slot.b, h = slot.h;
  q += slot.q;
  k = static_cast<const unsigned char*>(k) + slot.kv;
  v = static_cast<const unsigned char*>(v) + slot.kv;
  if (KV != kFloat) {
    ks += slot.scales;
    vs += slot.scales;
  }
  mask += slot.mask;
  sk += slot.scr;
  sv += slot.scr;
  smask += slot.smask;
  const int q0 = blockIdx.x * kQT, kh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int mw = (M + 31) / 32, bw = mw + (S + 31) / 32;
  float* qhi = reinterpret_cast<float*>(smem + W * L::kWarpBytes);
  float* qlo = qhi + kQT * kStride;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + W * L::kWarpBytes + 2 * L::kQBytes);

  // 1. The query tile (rows past Q zero) lands in the first warp's stages
  //    while the masks are scanned, then splits into its hi and lo planes.
  float* qraw = reinterpret_cast<float*>(smem);
  for (int i = tid; i < kQT * D / 4; i += kThreads) {
    const int r = i / (D / 4), ch = i % (D / 4);
    const int qq = min(q0 + r, Q - 1);
    cp_async(qraw + r * kStride + ch * 4, q + ((static_cast<int64_t>(qq) * H + h) * D + ch * 4),
             q0 + r < Q, 16);
  }
  cp_commit();
  const Run run = scan_masks(mask, smask, bits, sh, q0, Q, M, S);
  const int ntm = run.ntm, h_begin = 2 * run.t_begin, h_end = 2 * run.t_end;
  for (int i = tid; i < kQT * D; i += kThreads) {
    const int o = (i / D) * kStride + i % D;
    uint32_t hi, lo;
    split_tf32(qraw[o], hi, lo);
    qhi[o] = __uint_as_float(hi);
    qlo[o] = __uint_as_float(lo);
  }
  __syncthreads();   // the planes are written and the first warp's stages free

  // 2. The warp's run, in 8-key steps (two per 16-key tile). In the mma
  //    fragments a lane holds rows g and g + 8; of S's 8 keys 2c' and
  //    2c' + 1 (c' = lane & 3), of each 8 dims of acc c and c + 1.
  const int g = lane >> 2, cq = lane & 3, c = cq * 2;
  unsigned char* wsm = smem + warp * L::kWarpBytes;
  auto stage_k = [&](int s) { return reinterpret_cast<float*>(wsm + (2 * s) * L::kHalfBytes); };
  auto stage_v = [&](int s) { return reinterpret_cast<float*>(wsm + (2 * s + 1) * L::kHalfBytes); };
  float* scl = reinterpret_cast<float*>(wsm + L::kScales);   // [stage][ks, vs][8]
  const int odd_head = kh & 1;
  // Step hs covers keys base .. base + 7 of the main cache (tile < ntm) or the scratch.
  auto step_base = [&](int hs) {
    const int t = hs >> 1;
    return (t < ntm ? t : t - ntm) * kKT + (hs & 1) * kKH;
  };

  auto issue = [&](int hs, int s) {
    const bool in_main = (hs >> 1) < ntm;
    const int base = step_base(hs);
    unsigned char* dk = reinterpret_cast<unsigned char*>(stage_k(s));
    unsigned char* dv = reinterpret_cast<unsigned char*>(stage_v(s));
    if (KV != kFloat && in_main) {
      // The 8 keys' scales (first: scattered words), then the raw rows,
      // packed [8][kRowBytes] at kRaw.
      if (lane < 2 * kKH) {
        const int key = base + (lane & (kKH - 1));
        const bool ok = key < M;
        const float* src = (lane < kKH ? ks : vs) + (ok ? static_cast<int64_t>(key) * Hkv + kh : 0);
        cp_async(scl + s * 2 * kKH + lane, src, ok, 4);
      }
      const int hs_ = KV == kInt4Head ? Hkv / 2 : Hkv, hh = KV == kInt4Head ? kh / 2 : kh;
      const uint8_t* kc = static_cast<const uint8_t*>(k);
      const uint8_t* vc = static_cast<const uint8_t*>(v);
#pragma unroll
      for (int i = lane; i < L::kVecs; i += 32) {
        const int e = i * L::kVec, j = e / L::kRowBytes, b = e % L::kRowBytes, key = base + j;
        const bool ok = key < M;
        const int64_t off = (static_cast<int64_t>(ok ? key : 0) * hs_ + hh) * L::kRowBytes + b;
        cp_async(dk + L::kRaw + e, kc + off, ok, L::kVec);
        cp_async(dv + L::kRaw + e, vc + off, ok, L::kVec);
      }
    } else {
      const float* kc = in_main ? static_cast<const float*>(k) : sk;
      const float* vc = in_main ? static_cast<const float*>(v) : sv;
      const int len = in_main ? M : S;
      constexpr int kChunks = D / 4;   // 16-byte chunks per row
#pragma unroll
      for (int i = lane; i < kKH * kChunks; i += 32) {
        const int j = i / kChunks, ch = i % kChunks, key = base + j;
        const bool ok = key < len;
        const int64_t off = (static_cast<int64_t>(ok ? key : 0) * Hkv + kh) * D + ch * 4;
        cp_async(dk + (j * kStride + ch * 4) * 4, kc + off, ok, 16);
        cp_async(dv + (j * kStride + ch * 4) * 4, vc + off, ok, 16);
      }
    }
    cp_commit();
  };

  float m_0 = kNeg, m_1 = kNeg, l_0 = 0.f, l_1 = 0.f;   // rows g, g + 8
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // ldmatrix lane addresses. q's A fragment for dims 8kk..8kk+7: matrices
  // (rows 0-7, dims +0..3), (rows 8-15, +0..3), (rows 0-7, +4..7), (rows
  // 8-15, +4..7). K's B fragments of two k steps: keys 0-7 at dims +0, +4,
  // +8, +12.
  const int qo = ((lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 4;
  const int ko = (lane & 7) * kStride + (lane >> 3) * 4;

  // The ring: step hs in stage (hs - h_begin) % kF32Stages, issued
  // kF32Stages - 1 steps ahead (one commit group a step, empty past the run).
#pragma unroll
  for (int i = 0; i < kF32Stages - 1; ++i) {
    if (h_begin + i < h_end) issue(h_begin + i, i);
    else cp_commit();
  }
  for (int hs = h_begin; hs < h_end; ++hs) {
    const int s = (hs - h_begin) % kF32Stages;
    const int next = hs + kF32Stages - 1;   // into the stage step hs - 1 has freed
    if (next < h_end) issue(next, (next - h_begin) % kF32Stages);
    else cp_commit();
    cp_wait<kF32Stages - 1>();
    __syncwarp();   // every lane's copies of stage s have landed
    const bool in_main = (hs >> 1) < ntm;
    const bool quant = KV != kFloat && in_main;
    const int base = step_base(hs), len = in_main ? M : S;
    if (base < len) {   // (a step wholly past the region's end changes nothing)
      float* kt = stage_k(s);
      float* vt = stage_v(s);
      if (quant) {   // expand the packed K and V rows in place
        RawTileF32<D, KV> rk, rv;
        rk.load(reinterpret_cast<unsigned char*>(kt), lane);
        rv.load(reinterpret_cast<unsigned char*>(vt), lane);
        __syncwarp();
        rk.store(reinterpret_cast<unsigned char*>(kt), lane, odd_head);
        rv.store(reinterpret_cast<unsigned char*>(vt), lane, odd_head);
        __syncwarp();
      }

      // S = Q K^T [16 x 8]: q_hi.k_hi, q_hi.k_lo (none for integer rows)
      // and q_lo.k_hi, each in two accumulators (even and odd k steps).
      float shh[2][4] = {}, shl[2][4] = {}, slh[2][4] = {};
#pragma unroll
      for (int kp = 0; kp < D / 16; ++kp) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + ko + kp * 16);
#pragma unroll
        for (int z = 0; z < 2; ++z) {
          const int kk = 2 * kp + z;
          uint32_t ah[4], al[4], bh[2], bl[2];
          ldsm_x4(ah, qhi + qo + kk * 8);
          ldsm_x4(al, qlo + qo + kk * 8);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (quant) bh[e] = kb[2 * z + e];
            else split_tf32(__uint_as_float(kb[2 * z + e]), bh[e], bl[e]);
          }
          mma_tf32(shh[z], ah, bh[0], bh[1]);
          if (!quant) mma_tf32(shl[z], ah, bl[0], bl[1]);
          mma_tf32(slh[z], al, bh[0], bh[1]);
        }
      }
      float sc[1][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sc[0][i] = (shh[0][i] + shh[1][i]) + ((shl[0][i] + shl[1][i]) + (slh[0][i] + slh[1][i]));

      const int word = (in_main ? 0 : mw) + (base >> 5), sh5 = base & 31;
      const float* tks = scl + s * 2 * kKH;
      float alpha0, alpha1;
      online_softmax(sc, bits[g * bw + word] >> sh5, bits[(g + 8) * bw + word] >> sh5, base,
                     len, c, scale, quant ? tks : nullptr, m_0, m_1, l_0, l_1, alpha0, alpha1);
      float* p = sc[0];
      if (quant) {   // the row's V scale
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] *= tks[kKH + c + e];
          p[2 + e] *= tks[kKH + c + e];
        }
      }
      // P as the A operand of the k step: k index cq is key 2cq (p[0], p[2]),
      // cq + 4 key 2cq + 1 (p[1], p[3]).
      uint32_t ph[4], pl[4];
      split_tf32(p[0], ph[0], pl[0]);
      split_tf32(p[2], ph[1], pl[1]);
      split_tf32(p[1], ph[2], pl[2]);
      split_tf32(p[3], ph[3], pl[3]);

      // acc = acc * alpha + P V, 8 dims an n tile; V's B fragment is
      // V[key 2cq][8n + g] and V[key 2cq + 1][8n + g].
      const float* vp = vt + (2 * cq) * kStride + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float v0 = vp[n * 8], v1 = vp[kStride + n * 8];
        uint32_t vh[2], vl[2];
        if (quant) {
          vh[0] = __float_as_uint(v0);
          vh[1] = __float_as_uint(v1);
        } else {
          split_tf32(v0, vh[0], vl[0]);
          split_tf32(v1, vh[1], vl[1]);
        }
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(pv, ph, vh[0], vh[1]);
        if (!quant) mma_tf32(pv, ph, vl[0], vl[1]);
        mma_tf32(pv, pl, vh[0], vh[1]);
        acc[n][0] = fmaf(acc[n][0], alpha0, pv[0]);
        acc[n][1] = fmaf(acc[n][1], alpha0, pv[1]);
        acc[n][2] = fmaf(acc[n][2], alpha1, pv[2]);
        acc[n][3] = fmaf(acc[n][3], alpha1, pv[3]);
      }
    }
    __syncwarp();   // stage s is free for the next issue
  }

  // 3. Merge the 8 warps, then the output or the block's partial.
  merge_block<D>(acc, m_0, m_1, l_0, l_1, smem, sh, out, part, q0, Q, H, h, b);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The kernel over a (query tile, slot x head, split) grid with `bytes` of dynamic
// shared memory (`allowed`: what the kernel may already take), then, with
// more than one split, the merge of the partials.
template <typename T, int W, typename Kernel>
cudaError_t launch_split(Kernel kern, int bytes, int& allowed, const void* q, const void* k,
                         const void* v, const void* ks, const void* vs, const void* mask,
                         const void* sk, const void* sv, const void* smask, void* out,
                         void* part, int B, int Q, int H, int Hkv, int D, int M, int S,
                         int splits, float scale, cudaStream_t stream) {
  // 227 KB per block, less the kernel's static shared memory (under 1 KB).
  constexpr int kMaxBytes = 226 * 1024;
  if (bytes > kMaxBytes || splits < 1 || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (bytes > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    allowed = bytes;
  }
  const dim3 grid((Q + kQT - 1) / kQT, B * H, splits);
  kern<<<grid, W * 32, bytes, stream>>>(
      static_cast<const T*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(sk), static_cast<const T*>(sv), static_cast<const uint8_t*>(smask),
      static_cast<T*>(out), static_cast<float*>(part), Q, H, Hkv, M, S, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int64_t QH = static_cast<int64_t>(B) * Q * H;
  const int64_t n = QH * (D / 2);
  const int blocks = static_cast<int>(n < 256 * 1024 ? (n + 255) / 256 : 1024);
  tree_attention_merge_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(part),
                                                             static_cast<T*>(out), splits, QH, D);
  return cudaGetLastError();
}

template <int D, int KV>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* mask, const void* sk, const void* sv,
                      const void* smask, void* out, void* part, int B, int Q, int H, int Hkv,
                      int M, int S, int splits, float scale, cudaStream_t stream) {
  using L = TcLayout<D, KV>;
  const int bytes =
      kWarps * L::kWarpBytes + L::kTileBytes + kQT * ((M + 31) / 32 + (S + 31) / 32) * 4;
  static int allowed = 48 * 1024;   // dynamic shared memory the kernel may take
  return launch_split<bf16, kWarps>(tree_attention_tc_kernel<D, KV>, bytes, allowed, q, k, v,
                                    ks, vs, mask, sk, sv, smask, out, part, B, Q, H, Hkv, D, M,
                                    S, splits, scale, stream);
}

template <int D, int KV>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const void* mask, const void* sk, const void* sv,
                       const void* smask, void* out, void* part, int B, int Q, int H, int Hkv,
                       int M, int S, int splits, float scale, cudaStream_t stream) {
  using L = F32Layout<D, KV>;
  const int bytes =
      kF32Warps * L::kWarpBytes + 2 * L::kQBytes + kQT * ((M + 31) / 32 + (S + 31) / 32) * 4;
  static int allowed = 48 * 1024;
  return launch_split<float, kF32Warps>(tree_attention_f32_kernel<D, KV>, bytes, allowed, q, k,
                                        v, ks, vs, mask, sk, sv, smask, out, part, B, Q, H, Hkv,
                                        D, M, S, splits, scale, stream);
}

template <int KV>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* mask, const void* sk, const void* sv,
                   const void* smask, void* out, void* part, int B, int Q, int H, int Hkv, int D,
                   int M, int S, int splits, float scale, cudaStream_t stream) {
#define SEQ_TA_CASE(DD)                                                                        \
  if (D == DD)                                                                                 \
    return dtype == 0 ? launch_f32<DD, KV>(q, k, v, ks, vs, mask, sk, sv, smask, out, part, B, \
                                           Q, H, Hkv, M, S, splits, scale, stream)             \
                      : launch_tc<DD, KV>(q, k, v, ks, vs, mask, sk, sv, smask, out, part, B,  \
                                          Q, H, Hkv, M, S, splits, scale, stream);
  SEQ_TA_CASE(16)
  SEQ_TA_CASE(32)
  SEQ_TA_CASE(64)
  SEQ_TA_CASE(128)
#undef SEQ_TA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (of q, the scratch and the output): 0 = float32 (3xTF32), 1 =
// bfloat16. kv_format of the main cache k, v: 0 = the same float type
// [M, Hkv, D]; 1 = int8 [M, Hkv, D]; 2 = int4 head-paired [M, Hkv/2, D]
// (Hkv even); 3 = int4 dsplit [M, Hkv, D/2]; 1..3 with float32 scales ks, vs
// [M, Hkv] (else not read). Masks are uint8 (torch.bool) [Q, M] and [Q, S];
// S may be 0 (then sk, sv and smask are not read). Head dim D must be one of
// 16, 32, 64, 128; the wrapper checks it. `splits` blocks share each
// (16-query tile, head); with more than one, `part` is an f32 workspace of
// splits * B * Q * H * (D + 2) floats. B >= 1 slots: every operand is B
// contiguous blocks of the shapes above (q [B, Q, H, D], k [B, M, ...],
// ks [B, M, Hkv], masks [B, Q, M] and [B, Q, S], sk [B, S, Hkv, D], out
// [B, Q, H, D]), each slot its own problem.
int sequoia_tree_attention(const void* q, const void* k, const void* v, const void* ks,
                           const void* vs, const void* mask, const void* sk,
                           const void* sv, const void* smask, void* out, void* part, int B,
                           int Q, int H, int Hkv, int D, int M, int S, int splits, float scale,
                           int dtype, int kv_format, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_format == kInt4Head && Hkv % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_format != kFloat && (ks == nullptr || vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || static_cast<int64_t>(B) * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
#define SEQ_TA_FORMAT(KV)                                                                     \
  if (kv_format == KV)                                                                        \
    return static_cast<int>(launch<KV>(dtype, q, k, v, ks, vs, mask, sk, sv, smask, out, part, \
                                       B, Q, H, Hkv, D, M, S, splits, scale, st));
  SEQ_TA_FORMAT(kFloat)
  SEQ_TA_FORMAT(kInt8)
  SEQ_TA_FORMAT(kInt4Head)
  SEQ_TA_FORMAT(kInt4Dsplit)
#undef SEQ_TA_FORMAT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
