// Tree attention over a slot axis on Hopper: the batched engine's launch at
// Q > 16 queries a slot (kernels/tree_attention.py routes Q <= 16, the AR
// step, the draft root and narrow grow levels, to tree_attention.cu).
//
// Replaces the Pallas kernel sequoia_tpu/kernels/tree_attention.py::
// tree_attention (:109-190, def at :111, pallas_call at :157) as the batched engine runs
// it: under jax.vmap over the slots (sequoia_tpu/engine/batched.py:268-273),
// which gives the call a grid axis. It computes what tree_attention.cu's
// slot-axis launch computes, with that file's numerics: scores, running max
// and running sum in f32; masked scores the finite -1e30 (a region with no
// live key adds zero, a row that attends nothing gets the mean of V); the
// probabilities rounded to V's dtype before P V, which accumulates in f32;
// int8 / int4 rows cast exactly, a main score times ks, a main probability
// times vs before it is rounded. Operands: q [B, Q, H, D]; the main cache
// k, v [B, M, Hkv, D] (int8 the same; int4 head-paired [B, M, Hkv/2, D],
// dsplit [B, M, Hkv, D/2]) with f32 scales [B, M, Hkv]; masks [B, Q, M],
// [B, Q, S]; scratch [B, S, Hkv, D]; out [B, Q, H, D].
//
// Bound on the H100: bytes. At the batched verify (B = 8, Q = 64, H = Hkv =
// 32, D = 128, M = 512, S = 64, prefixes of 40-380 keys) one layer must read
// about 36 MB of K/V in bf16 (about 11 us at 3.35 TB/s), twice that in f32,
// against about 2.3 GFLOP of products (2.3 us at 989 TFLOP/s bf16; as three
// TF32 passes, f32 takes 14 us at 495 TFLOP/s).
//
// Design. A work item is (slot, KV head, 64-row tile). Its rows are the
// Q x g (query, query head) pairs of one KV head, query-major (row r is
// query r / g, head kh * g + r % g), so every query row of the tile and
// the g query heads of the KV head use each staged K/V tile: a tile is read
// from device memory once and an int8 / int4 tile is expanded once (the
// 16-query blocks of tree_attention.cu read and expanded it ceil(Q / 16) x g
// times). A block is one work item, and walks all of the item's keys: no
// key splits, no workspace, no merge. kernels/tree_attention.py sends a
// call here only where the work items fill the card (3/4 of one an SM at
// least); fewer go to tree_attention.cu's slot grid, whose key splits fill
// it. A block is a consumer warpgroup (warps 0-3, 16 rows a warp) and
// producer warps after it around a ring of K/V stages, each with a "full"
// mbarrier (one arrival a producer thread, plus TMA's bytes) and an
// "empty" one (one arrival a consumer warp).
// - All threads first scan the tile's mask rows and find, for main and
//   scratch apart, the last key any valid row attends: the slot's own
//   prefix skip, found on the device (no host read). A valid row that
//   attends nothing makes the block walk everything, as the plain version
//   gives such a row the mean of all V rows.
// - The mask bits the consumers read take a fixed room of shared memory,
//   whatever M: where the 64 rows' bits of the whole walk fit kWhole keys
//   (the batched verify's 576), that scan keeps them all; past it, the
//   producers write each K/V tile's bits into its stage beside K and V
//   (each such tile costs its mask's loads once more).
// - bf16 (tree_attention_sm90_bf16): a tile is 64 keys. S = Q K^T runs on
//   wgmma m64n64k16 (q's A fragments in registers, loaded once; K K-major in
//   shared memory), P V on wgmma m64nDk16 with P's accumulator fragments
//   rounded to bf16 as the A operand in registers and V read MN-major
//   (transposed) as it lands. Tiles land in the swizzle of their row width
//   (128 / 64 / 32 bytes; a 128-dim row is two 64-dim column blocks). A
//   float tile (the float cache, the scratch) arrives by TMA (3-D tensor
//   maps over [B, rows, Hkv * D]: keys past the region's end are zeros); a
//   packed int8 / int4 tile arrives by cp.async into a raw slot of the
//   producer lane that expands it (double-buffered: tile i + 1's bytes are
//   in flight while tile i is expanded), is expanded once to bf16 into the
//   stage's swizzle, and is handed over behind fence.proxy.async. One
//   producer warp issues a float tile's TMA (lane 0; the others scan its
//   mask; 3 stages in flight), two expand packed tiles (2 stages beside
//   their raw slots): two blocks of 160 / 192
//   threads fit on an SM at 168 registers a thread (ptxas allocates a
//   kernel's registers for its launch bounds: setmaxnreg cannot lift the
//   consumers past them, and a producer warpgroup held them to 128, with
//   spills at D = 128).
// - f32 (tree_attention_sm90_f32): 3xTF32 (tree_attention.cu's scheme and
//   chains) on mma.sync m16n8k8 against the shared tile. wgmma tf32 wants V
//   K-major and its accumulator in one chain per tile; mma.sync keeps the
//   8-key k steps' short zeroed P V chains and needs no transposed copy. A
//   tile is 16 keys, split once by a producer warpgroup into TF32 hi and lo
//   planes (an integer row: hi only, its lo is zero and its products are
//   skipped); all threads split the query tile once into its planes. A
//   float cache's tiles go to one consumer warpgroup, a tile one step:
//   there the shared-memory reads of the query planes bound a step (a
//   second warpgroup, reading them again, was slower). A packed cache's
//   tiles go to two, warpgroup h taking keys 8 h .. 8 h + 7 of each tile
//   into a partial of its own, combined in shared memory at the end: two
//   warps an SM sub-partition hide mma.sync's latency (one warpgroup took
//   0.146 ms at the batched verify, two 0.119). One block an SM: the
//   planes, raw slots and query planes fill its shared memory.
// - Each wgmma batch is fenced, committed and waited for before its
//   accumulators are read; P's fragments are read once more after their
//   wgmmas, which keeps their registers from being reused while in flight
//   (ptxas serializes every wgmma of a kernel otherwise: C7513).

#include "qmm_sm90.cuh"   // common.cuh, sm90::encode (cuTensorMapEncodeTiled)

namespace {

using namespace sq;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;            // rows of a work item: 4 consumer warps of 16
constexpr int kConsumers = 128;      // the consumer warpgroup: threads 0-127
constexpr int kMaxStages = 3;        // K/V stages the producers and consumers share
constexpr int kBarProducers = 2;     // named barrier of the producers
constexpr float kNeg = -1e30f;
constexpr int kFloat = 0, kInt8 = 1, kInt4Head = 2, kInt4Dsplit = 3;

// mbar_wait that traps after about 10 s (2e10 cycles) of waiting: a broken
// handshake fails its launch instead of hanging the card.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  }
}

// The most keys (main padded to whole KT-key tiles, then the scratch) whose
// mask bits a block keeps for its whole walk: 8 KB of bf16's two blocks an
// SM, 32 KB of f32's one.
template <int KT>
constexpr int kWhole = KT == 64 ? 1024 : 4096;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const uint8_t* mask;
  const void* sk;
  const void* sv;
  const uint8_t* smask;
  void* out;
  int Q, H, Hkv, M, S;
  int words;                         // 32-bit words of a row's whole bits, or 0: a tile's
  float scale;
};

struct Shared {
  uint64_t full[kMaxStages], empty[kMaxStages];
  int ext[2];                        // last live key + 1: main, scratch
  unsigned alive[2];                 // rows (0-31, 32-63) that attend some key
};

// This block's work item: slot b, KV head kh (g query heads each), rows
// [r0, r0 + 64) of the slot's Q * g; its walk: main tiles [0, ntm), then
// scratch tiles, nt in all.
struct Item {
  int b, kh, g, r0, rows;
  int ntm, nt;
};

__device__ __forceinline__ Item item_of_block(const Args& a) {
  Item it;
  it.b = blockIdx.y / a.Hkv;
  it.kh = blockIdx.y % a.Hkv;
  it.g = a.H / a.Hkv;
  it.r0 = blockIdx.x * kRows;
  it.rows = a.Q * it.g;
  it.ntm = it.nt = 0;
  return it;
}

// Element offset of tile row r's query row in q and out (-1: past the rows).
__device__ __forceinline__ int64_t row_offset(const Args& a, const Item& it, int r, int D) {
  const int R = it.r0 + r;
  if (R >= it.rows) return -1;
  return ((static_cast<int64_t>(it.b) * a.Q + R / it.g) * a.H + it.kh * it.g + R % it.g) * D;
}

// 16 mask bytes (keys k0 .. k0 + 15 of a row of `len`, those below len) as
// 16 bits; `p` the row's 16-byte load, where the row allows one.
__device__ __forceinline__ uint32_t mask_bits16(const uint8_t* row, int k0, int len, uint4 p,
                                                bool loaded) {
  uint32_t bits = 0;
  if (loaded) {
    const uint32_t w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t y = __vcmpne4(w[i], 0u);   // 0xff in each nonzero byte
      bits |= ((y & 1u) | ((y >> 7) & 2u) | ((y >> 14) & 4u) | ((y >> 21) & 8u)) << (4 * i);
    }
  } else {
    for (int j = 0; j < 16 && k0 + j < len; ++j) bits |= uint32_t(row[k0 + j] != 0) << j;
  }
  return bits;
}

// The tile's mask rows, 16-key chunks a thread, kScanLoads of them in
// flight at once (the scan is the launch's fixed cost: one load round a
// chunk cost a verify block some 7 us): the last key any valid row attends
// in each region, and this work item's walk of KT-key tiles; with a.words,
// every row's bits into `bits` ([64][2 words] 16-bit chunks: main padded
// to whole tiles, then the scratch). Ends with a __syncthreads.
constexpr int kScanLoads = 8;

template <int KT>
__device__ __forceinline__ void scan_masks(const Args& a, Item& it, Shared& sh, uint16_t* bits) {
  const int mc = (a.M + KT - 1) / KT * (KT / 16);            // main's 16-key chunks, padded
  const int cw = mc + (a.S + KT - 1) / KT * (KT / 16);       // a row's
  if (threadIdx.x == 0) {
    sh.ext[0] = sh.ext[1] = 0;
    sh.alive[0] = sh.alive[1] = 0u;
  }
  __syncthreads();
  const uint8_t* mask = a.mask + static_cast<int64_t>(it.b) * a.Q * a.M;
  const uint8_t* smask = a.smask + static_cast<int64_t>(it.b) * a.Q * a.S;
  int ext[2] = {0, 0};            // this thread's, then its warp's: one atomic each a warp
  unsigned alive[2] = {0u, 0u};
  const int total = kRows * cw, step = blockDim.x * kScanLoads;
  for (int i0 = threadIdx.x; i0 < total; i0 += step) {
    uint4 p[kScanLoads];
    bool loaded[kScanLoads];
    const uint8_t* row[kScanLoads];
#pragma unroll
    for (int u = 0; u < kScanLoads; ++u) {   // every chunk's load first
      const int i = i0 + u * blockDim.x, r = i / cw, w = i % cw, R = it.r0 + r;
      const bool in_main = w < mc;
      const int len = in_main ? a.M : a.S, k0 = (in_main ? w : w - mc) * 16;
      row[u] = nullptr;
      loaded[u] = false;
      if (i < total && R < it.rows && k0 < len) {
        row[u] = (in_main ? mask : smask) + static_cast<int64_t>(R / it.g) * len;
        loaded[u] = k0 + 16 <= len && (reinterpret_cast<uintptr_t>(row[u] + k0) & 15) == 0;
        if (loaded[u]) p[u] = *reinterpret_cast<const uint4*>(row[u] + k0);
      }
    }
#pragma unroll
    for (int u = 0; u < kScanLoads; ++u) {
      const int i = i0 + u * blockDim.x, r = i / cw, w = i % cw;
      if (i >= total) break;
      const bool in_main = w < mc;
      const int len = in_main ? a.M : a.S, k0 = (in_main ? w : w - mc) * 16;
      const uint32_t b16 = row[u] ? mask_bits16(row[u], k0, len, p[u], loaded[u]) : 0u;
      if (a.words) bits[r * 2 * a.words + w] = static_cast<uint16_t>(b16);
      if (b16) {
        ext[in_main ? 0 : 1] = max(ext[in_main ? 0 : 1], k0 + 32 - __clz(b16));
        alive[r >> 5] |= 1u << (r & 31);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    ext[j] = __reduce_max_sync(0xFFFFFFFFu, ext[j]);
    alive[j] = __reduce_or_sync(0xFFFFFFFFu, alive[j]);
  }
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      atomicMax(&sh.ext[j], ext[j]);
      atomicOr(&sh.alive[j], alive[j]);
    }
  }
  __syncthreads();
  int ext_m = sh.ext[0], ext_s = sh.ext[1];
  const int nvalid = min(kRows, it.rows - it.r0);
  const unsigned v0 = nvalid >= 32 ? 0xFFFFFFFFu : (1u << nvalid) - 1u;
  const unsigned v1 = nvalid >= 64 ? 0xFFFFFFFFu : nvalid > 32 ? (1u << (nvalid - 32)) - 1u : 0u;
  if ((sh.alive[0] & v0) != v0 || (sh.alive[1] & v1) != v1) {   // a row attends nothing
    ext_m = a.M;
    ext_s = a.S;
  }
  it.ntm = (ext_m + KT - 1) / KT;
  it.nt = it.ntm + (ext_s + KT - 1) / KT;
}

// Walk tile t's mask bits for the consumers: the first of a row's 16-bit
// chunks, and the chunks between rows (the whole walk's bits, or stage s's).
template <int KT>
__device__ __forceinline__ const uint16_t* tile_bits_at(const Args& a, const Item& it, int t,
                                                        const uint16_t* whole,
                                                        const uint16_t* stage, int& stride) {
  if (!a.words) {
    stride = KT / 16;
    return stage;
  }
  stride = 2 * a.words;
  return whole + (t < it.ntm ? t : (a.M + KT - 1) / KT + t - it.ntm) * (KT / 16);
}

// Walk tile t's mask bits (keys [base, base + KT) of the main region or
// the scratch, zero past its end) of the 64 rows into `dst`, [64][KT / 16]
// 16-bit chunks; scanner p of NS takes chunks p, p + NS, ..., all its loads
// in flight at once.
template <int KT, int NS>
__device__ __forceinline__ void tile_bits(const Args& a, const Item& it, int t, uint16_t* dst,
                                          int p) {
  constexpr int kChunks = kRows * KT / 16, kLoads = (kChunks + NS - 1) / NS;
  const bool in_main = t < it.ntm;
  const int len = in_main ? a.M : a.S, base = (in_main ? t : t - it.ntm) * KT;
  const uint8_t* m = in_main ? a.mask + static_cast<int64_t>(it.b) * a.Q * a.M
                             : a.smask + static_cast<int64_t>(it.b) * a.Q * a.S;
  uint4 v[kLoads];
  bool loaded[kLoads];
  const uint8_t* row[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = p + u * NS, R = it.r0 + i / (KT / 16), k0 = base + (i % (KT / 16)) * 16;
    row[u] = nullptr;
    loaded[u] = false;
    if (i < kChunks && R < it.rows && k0 < len) {
      row[u] = m + static_cast<int64_t>(R / it.g) * len;
      loaded[u] = k0 + 16 <= len && (reinterpret_cast<uintptr_t>(row[u] + k0) & 15) == 0;
      if (loaded[u]) v[u] = *reinterpret_cast<const uint4*>(row[u] + k0);
    }
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = p + u * NS, k0 = base + (i % (KT / 16)) * 16;
    if (i < kChunks)
      dst[i] = static_cast<uint16_t>(row[u] ? mask_bits16(row[u], k0, len, v[u], loaded[u]) : 0u);
  }
}

// Scale, mask and the online-softmax update of one row pair's scores
// x[n][e] (rows g: e = 0, 1; g + 8: e = 2, 3; keys n * 8 + c + (e & 1)), in
// place: keys past the region's end are -inf (no key at all), masked keys
// the finite -1e30; quantized main scores times ks (`ksc`, per key of the
// tile). Scores are kept in base 2 (`scale2` = scale * log2 e; exp2f is one
// MUFU operation and a few more where expf takes a dozen). Returns the
// rescale factors of the rows' running sums and accumulators, and leaves
// the probabilities in x (their sum in l_0, l_1).
template <int N, typename Bits>
__device__ __forceinline__ void softmax_step(float (&x)[N][4], Bits bits0, Bits bits1, int base,
                                             int len, int c, float scale2, const float* ksc,
                                             float& m_0, float& m_1, float& l_0, float& l_1,
                                             float& alpha0, float& alpha1) {
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
        const float s = ksc ? scale2 * ksc[col] : scale2;
        x0 = (bits0 >> col) & 1u ? x0 * s : kNeg;
        x1 = (bits1 >> col) & 1u ? x1 * s : kNeg;
      }
      x[n][e] = x0;
      x[n][2 + e] = x1;
      tmax0 = fmaxf(tmax0, x0);
      tmax1 = fmaxf(tmax1, x1);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    tmax0 = fmaxf(tmax0, __shfl_xor_sync(0xFFFFFFFFu, tmax0, o));
    tmax1 = fmaxf(tmax1, __shfl_xor_sync(0xFFFFFFFFu, tmax1, o));
  }
  const float mn0 = fmaxf(m_0, tmax0), mn1 = fmaxf(m_1, tmax1);
  alpha0 = exp2f(m_0 - mn0);
  alpha1 = exp2f(m_1 - mn1);
  m_0 = mn0;
  m_1 = mn1;
  float psum0 = 0.f, psum1 = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      x[n][e] = exp2f(x[n][e] - mn0);
      x[n][2 + e] = exp2f(x[n][2 + e] - mn1);
      psum0 += x[n][e];
      psum1 += x[n][2 + e];
    }
  }
  l_0 = l_0 * alpha0 + psum0;
  l_1 = l_1 * alpha1 + psum1;
}

__device__ __forceinline__ void store2(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* out, float a, float b) {
  *reinterpret_cast<uint32_t*>(out) = bf16x2(a, b);
}

// The sums of a quad's l (each lane's holds its own keys).
__device__ __forceinline__ void quad_sum(float& l_0, float& l_1) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l_0 += __shfl_xor_sync(0xFFFFFFFFu, l_0, o);
    l_1 += __shfl_xor_sync(0xFFFFFFFFu, l_1, o);
  }
}

// The first consumer warpgroup's end (l summed over the quad): acc / l
// into the output rows. acc is the mma C layout: acc[n] holds rows g (0, 1)
// and g + 8 (2, 3), dims n * 8 + c, c + 1.
template <int D, typename T>
__device__ __forceinline__ void finish(const float (&acc)[D / 8][4], float l_0, float l_1,
                                       const Args& a, const Item& it) {
  const int cw = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = (lane & 3) * 2, ra = 16 * cw + g, rb = ra + 8;
  T* out = static_cast<T*>(a.out);
  const int64_t oa = row_offset(a, it, ra, D), ob = row_offset(a, it, rb, D);
  const float ia = 1.f / fmaxf(l_0, 1e-30f), ib = 1.f / fmaxf(l_1, 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (oa >= 0) store2(out + oa + n * 8 + c, acc[n][0] * ia, acc[n][1] * ia);
    if (ob >= 0) store2(out + ob + n * 8 + c, acc[n][2] * ib, acc[n][3] * ib);
  }
}

// Keys [base, base + KT) of K and V, rows of RowBytes bytes `stride` bytes
// apart (`kc`, `vc` at key 0 of this head), into `raw`: K [KT][RowBytes],
// then V; keys at or past `len` are zeros. Producer p of NP copies vectors
// p, p + NP, ... (and expands the same ones).
template <int KT, int RowBytes, int NP>
__device__ __forceinline__ void copy_rows(uint8_t* raw, const uint8_t* kc, const uint8_t* vc,
                                          int64_t stride, int base, int len, int p) {
  constexpr int kVec = RowBytes < 16 ? RowBytes : 16, kVecs = KT * RowBytes / kVec;
#pragma unroll
  for (int i = p; i < kVecs; i += NP) {
    const int e = i * kVec, key = base + e / RowBytes;
    const bool ok = key < len;
    const int64_t off = static_cast<int64_t>(ok ? key : 0) * stride + e % RowBytes;
    cp_async(raw + e, kc + off, ok, kVec);
    cp_async(raw + KT * RowBytes + e, vc + off, ok, kVec);
  }
}

// The KT keys' scales, ks then vs, into `dst` (producer p of NP: p, p + NP, ...).
template <int KT, int NP>
__device__ __forceinline__ void copy_scales(float* dst, const Args& a, const Item& it, int base,
                                            int p) {
#pragma unroll
  for (int i = p; i < 2 * KT; i += NP) {
    const int key = base + i % KT;
    const bool ok = key < a.M;
    const float* src = (i < KT ? a.ks : a.vs) +
                       (static_cast<int64_t>(it.b) * a.M + (ok ? key : 0)) * a.Hkv + it.kh;
    cp_async(dst + i, src, ok, 4);
  }
}

// The main cache's packed rows of this head: base pointers at key 0 and the
// bytes between keys (int4 head-paired: the pair's shared bytes).
template <int KV, int RowBytes>
__device__ __forceinline__ void packed_rows(const Args& a, const Item& it, const uint8_t*& kc,
                                            const uint8_t*& vc, int64_t& stride) {
  const int hs = KV == kInt4Head ? a.Hkv / 2 : a.Hkv, hh = KV == kInt4Head ? it.kh / 2 : it.kh;
  stride = static_cast<int64_t>(hs) * RowBytes;
  const int64_t off = static_cast<int64_t>(it.b) * a.M * stride + hh * RowBytes;
  kc = static_cast<const uint8_t*>(a.k) + off;
  vc = static_cast<const uint8_t*>(a.v) + off;
}

// ---------------------------------------------------------------------------
// bf16: wgmma, 64-key tiles
// ---------------------------------------------------------------------------

template <int D, int KV>
struct Bf16Cfg {
  static constexpr int kKT = 64;                          // keys a tile: S's wgmma N
  static constexpr int kRB = D * 2 < 128 ? D * 2 : 128;   // bytes of a swizzled row
  static constexpr int kSwz = kRB / 16 - 1;               // its 16-byte chunks XOR (row bits)
  static constexpr int kLayout = kRB == 128 ? 1 : kRB == 64 ? 2 : 3;   // descriptor swizzle
  static constexpr int kBlock = kKT * kRB;                // a column block: kRB / 2 dims
  static constexpr int kTile = kKT * D * 2;               // K or V
  static constexpr int kStage = 2 * kTile;
  // TMA-fed float tiles: 3 stages in flight; packed ones 2, beside their
  // raw slots (two blocks an SM either way).
  static constexpr int kStages = KV == kFloat ? 3 : 2;
  // Producer warps: one issues a float tile's TMA; two expand a packed
  // tile. Two blocks an SM at up to 168 registers a thread.
  static constexpr int kProducers = KV == kFloat ? 32 : 64;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kRowBytes = KV == kInt4Dsplit ? D / 2 : D;   // a packed main row
  static constexpr int kScales = KV == kFloat ? 0 : 2 * kKT * 4;    // ks, vs of a tile
  static constexpr int kRaw = KV == kFloat ? 0 : 2 * kKT * kRowBytes + kScales;
  static constexpr int kStageBits = kRows * kKT / 8;               // a tile's mask bits
  // Dynamic shared memory (1024-aligned): the stages, their scales, two raw
  // slots, then the whole walk's mask bits or the stages'.
  static constexpr int kScalesOff = kStages * kStage;
  static constexpr int kRawOff = kScalesOff + kStages * kScales;
  static constexpr int kBitsOff = kRawOff + 2 * kRaw;
};

// Byte offset of (key j, byte x of its D * 2) in a tile of column blocks in
// the swizzle TMA writes: within a 1024-aligned block, bits 4.. of the
// offset XOR-ed with its bits 7.. (128 B: the row % 8; 64 B: (row / 2) % 4;
// 32 B: (row / 4) % 2).
template <class C>
__device__ __forceinline__ int swz_off(int j, int x) {
  const int o = j * C::kRB + x % C::kRB;
  return (x / C::kRB) * C::kBlock + (o ^ (((o >> 7) & C::kSwz) << 4));
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets,
// swizzle layout (1: 128 B, 2: 64 B, 3: 32 B).
template <int Layout>
__device__ __forceinline__ uint64_t make_desc(const void* p, int lbo, int sbo) {
  return ((smem_u32(p) & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(Layout) << 62);
}

// K for S's k step kk (dims 16 kk ..): K-major, 8-key core groups 8 rows
// apart; the step's 32 bytes inside the row are a start offset.
template <class C>
__device__ __forceinline__ uint64_t k_desc(const uint8_t* k, int kk) {
  const int x = 32 * kk;
  return make_desc<C::kLayout>(k + (x / C::kRB) * C::kBlock + x % C::kRB, 16, 8 * C::kRB);
}
// V for P V's k step j (keys 16 j ..): MN-major (dims contiguous), the
// next 64 dims one column block further (LBO), 8-key groups 8 rows apart.
template <class C>
__device__ __forceinline__ uint64_t v_desc(const uint8_t* v, int j) {
  return make_desc<C::kLayout>(v + j * 16 * C::kRB, C::kBlock, 8 * C::kRB);
}

// D[64 x N] += A[64 x 16] * B[16 x N], bf16, B MN-major (imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[8], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// A packed tile (raw: K [64][kRowBytes], V, then ks, vs), this producer's
// vectors (of NP producers), expanded exactly to bf16 into the stage's
// swizzle; its scales into `scales`.
template <int D, int KV, int NP>
__device__ __forceinline__ void expand_bf16(uint8_t* stage, float* scales, const uint8_t* raw,
                                            int odd, int p) {
  using C = Bf16Cfg<D, KV>;
  constexpr int kVec = C::kRowBytes < 16 ? C::kRowBytes : 16, kW = kVec / 4;
  constexpr int kVecs = C::kKT * C::kRowBytes / kVec;
#pragma unroll 4
  for (int i = p; i < kVecs; i += NP) {
    const int e = i * kVec, j = e / C::kRowBytes, bb = e % C::kRowBytes;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const uint8_t* src = raw + kv * C::kKT * C::kRowBytes + e;
      uint8_t* tile = stage + kv * C::kTile;
      uint32_t w[kW], lo[2 * kW], hi[2 * kW];
#pragma unroll
      for (int x = 0; x < kW; ++x) w[x] = reinterpret_cast<const uint32_t*>(src)[x];
#pragma unroll
      for (int x = 0; x < kW; ++x) {
        if (KV == kInt8) {
          int8x4_to_bf16(w[x], lo[2 * x], lo[2 * x + 1]);
        } else if (KV == kInt4Head) {
          int4x4_to_bf16(odd ? (w[x] >> 4) & 0x0F0F0F0Fu : w[x] & 0x0F0F0F0Fu, lo[2 * x],
                         lo[2 * x + 1]);
        } else {
          int4x4_to_bf16(w[x] & 0x0F0F0F0Fu, lo[2 * x], lo[2 * x + 1]);
          int4x4_to_bf16((w[x] >> 4) & 0x0F0F0F0Fu, hi[2 * x], hi[2 * x + 1]);
        }
      }
      // dims bb .. (dsplit: and D / 2 + bb ..), 8 a 16-byte chunk
#pragma unroll
      for (int ch = 0; ch < kW / 2; ++ch) {
        *reinterpret_cast<uint4*>(tile + swz_off<C>(j, (bb + 8 * ch) * 2)) =
            make_uint4(lo[4 * ch], lo[4 * ch + 1], lo[4 * ch + 2], lo[4 * ch + 3]);
        if (KV == kInt4Dsplit)
          *reinterpret_cast<uint4*>(tile + swz_off<C>(j, (D / 2 + bb + 8 * ch) * 2)) =
              make_uint4(hi[4 * ch], hi[4 * ch + 1], hi[4 * ch + 2], hi[4 * ch + 3]);
      }
    }
  }
#pragma unroll
  for (int i = p; i < 2 * C::kKT; i += NP)
    scales[i] = reinterpret_cast<const float*>(raw + 2 * C::kKT * C::kRowBytes)[i];
}

template <int D, int KV>
__global__ void __launch_bounds__((Bf16Cfg<D, KV>::kThreads), 2)
tree_attention_sm90_bf16(const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap skmap,
                         const __grid_constant__ CUtensorMap svmap, const Args a) {
  using C = Bf16Cfg<D, KV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ Shared sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&sh.full[s], C::kProducers);
      mbar_init(&sh.empty[s], 4);
    }
    fence_mbar_init();
  }
  Item it = item_of_block(a);
  // Consumer warp cw holds rows ra = 16 cw + g and rb = ra + 8 of the tile;
  // its q A fragments (k steps of 16 dims; rows past the tile's: 0) are
  // loaded while the masks are scanned.
  const int g = lane >> 2, c = (lane & 3) * 2, ra = 16 * warp + g, rb = ra + 8;
  uint32_t qa[D / 16][4];
  if (warp < 4) {
    const bf16* q = static_cast<const bf16*>(a.q);
    const int64_t oa = row_offset(a, it, ra, D), ob = row_offset(a, it, rb, D);
    auto ld = [&](int64_t off, int d) -> uint32_t {
      return off < 0 ? 0u : *reinterpret_cast<const uint32_t*>(q + off + d);
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = ld(oa, 16 * kk + c);
      qa[kk][1] = ld(ob, 16 * kk + c);
      qa[kk][2] = ld(oa, 16 * kk + 8 + c);
      qa[kk][3] = ld(ob, 16 * kk + 8 + c);
    }
  }
  uint16_t* whole = reinterpret_cast<uint16_t*>(smem + C::kBitsOff);
  scan_masks<C::kKT>(a, it, sh, whole);
  const int n = it.nt;
  auto stage = [&](int s) { return smem + s * C::kStage; };
  auto bits = [&](int s) { return whole + s * C::kStageBits / 2; };
  auto scales = [&](int s) { return reinterpret_cast<float*>(smem + C::kScalesOff + s * C::kScales); };

  if (warp >= 4) {
    // Producers: a float tile by TMA (thread 0 also announces its bytes), a
    // packed one through the threads' raw slots, expanded.
    constexpr int NP = C::kProducers;
    const int p = threadIdx.x - kConsumers;
    const uint8_t *kc = nullptr, *vc = nullptr;
    int64_t stride = 0;
    if (KV != kFloat) packed_rows<KV, C::kRowBytes>(a, it, kc, vc, stride);
    auto packed = [&](int i) { return KV != kFloat && i < n && i < it.ntm; };
    auto fetch = [&](int i) {   // tile i's packed rows and scales into raw slot i % 2
      if (packed(i)) {
        uint8_t* raw = smem + C::kRawOff + (i & 1) * C::kRaw;
        const int base = i * C::kKT;
        copy_rows<C::kKT, C::kRowBytes, NP>(raw, kc, vc, stride, base, a.M, p);
        copy_scales<C::kKT, NP>(reinterpret_cast<float*>(raw + 2 * C::kKT * C::kRowBytes), a,
                                it, base, p);
      }
      cp_commit();
    };
    if (p == 0 && a.S > 0) {
      prefetch_tensormap(&skmap);
      prefetch_tensormap(&svmap);
    }
    if (p == 0 && KV == kFloat) {
      prefetch_tensormap(&kmap);
      prefetch_tensormap(&vmap);
    }
    fetch(0);
    for (int i = 0; i < n; ++i) {
      const int s = i % C::kStages;
      named_barrier(kBarProducers, NP);   // every producer is done with raw slot (i + 1) % 2
      fetch(i + 1);
      if (i >= C::kStages) wait_phase(&sh.empty[s], ((i / C::kStages) & 1) ^ 1);
      if (packed(i)) {
        if (!a.words) tile_bits<C::kKT, NP>(a, it, i, bits(s), p);
        cp_wait<1>();   // this thread's copies of tile i have landed
        expand_bf16<D, KV, NP>(stage(s), scales(s), smem + C::kRawOff + (i & 1) * C::kRaw,
                               it.kh & 1, p);
        fence_proxy_async();   // the stage is read by wgmma, through the async proxy
        mbar_arrive(&sh.full[s]);
      } else if (p == 0) {   // a float tile: its TMA first, the others scan its mask
        const bool in_main = i < it.ntm;
        const int base = (in_main ? i : i - it.ntm) * C::kKT;
        mbar_arrive_expect_tx(&sh.full[s], C::kStage);
#pragma unroll
        for (int cb = 0; cb < D * 2 / C::kRB; ++cb) {
          const int d0 = it.kh * D + cb * (C::kRB / 2);
          tma_load_3d(stage(s) + cb * C::kBlock, in_main ? &kmap : &skmap, &sh.full[s], d0, base,
                      it.b);
          tma_load_3d(stage(s) + C::kTile + cb * C::kBlock, in_main ? &vmap : &svmap,
                      &sh.full[s], d0, base, it.b);
        }
      } else {
        if (!a.words) tile_bits<C::kKT, NP - 1>(a, it, i, bits(s), p - 1);
        mbar_arrive(&sh.full[s]);
      }
    }
    cp_wait<0>();
    return;
  }

  // Consumers.
  const float scale2 = a.scale * 1.4426950408889634f;
  float m_0 = kNeg, m_1 = kNeg, l_0 = 0.f, l_1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int s = i % C::kStages;
    const bool in_main = i < it.ntm, quant = KV != kFloat && in_main;
    const int base = (in_main ? i : i - it.ntm) * C::kKT, len = in_main ? a.M : a.S;
    const uint8_t* kt = stage(s);
    const uint8_t* vt = kt + C::kTile;
    wait_phase(&sh.full[s], (i / C::kStages) & 1);

    float x[8][4];   // S [64 x 64]: this thread's rows ra, rb, keys n * 8 + c, + 1
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs(reinterpret_cast<float(&)[32]>(x), qa[kk], k_desc<C>(kt, kk));
    wgmma_commit();
    wgmma_wait<0>();

    const float* tks = scales(s);
    float alpha0, alpha1;
    int rs;
    const uint16_t* tb = tile_bits_at<C::kKT>(a, it, i, whole, bits(s), rs);   // 64 keys a row
    softmax_step(x, *reinterpret_cast<const uint64_t*>(tb + ra * rs),
                 *reinterpret_cast<const uint64_t*>(tb + rb * rs), base, len, c, scale2,
                 quant ? tks : nullptr, m_0, m_1, l_0, l_1, alpha0, alpha1);
    uint32_t pa[4][4];   // P as the A operand of k step j: keys 16 j + (0-7, 8-15)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (quant) {   // the key's V scale, before the rounding
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float w = tks[C::kKT + j * 8 + c + e];
          x[j][e] *= w;
          x[j][2 + e] *= w;
        }
      }
      pa[j / 2][2 * (j & 1)] = bf16x2(x[j][0], x[j][1]);       // row ra
      pa[j / 2][2 * (j & 1) + 1] = bf16x2(x[j][2], x[j][3]);   // row rb
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      acc[d][0] *= alpha0;
      acc[d][1] *= alpha0;
      acc[d][2] *= alpha1;
      acc[d][3] *= alpha1;
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_rs_tb(reinterpret_cast<float(&)[D / 2]>(acc), pa[j], v_desc<C>(vt, j));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_reg(pa[j][e]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.empty[s]);   // stage s is free
  }
  quad_sum(l_0, l_1);
  finish<D, bf16>(acc, l_0, l_1, a, it);
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on mma.sync m16n8k8, 16-key tiles
// ---------------------------------------------------------------------------

template <int D, int KV>
struct F32Cfg {
  static constexpr int kKT = 16;                          // keys a tile: two n tiles of S
  static constexpr int kStride = D + 4;                   // floats a shared row
  static constexpr int kPlane = kKT * kStride * 4;        // one of K hi, K lo, V hi, V lo
  static constexpr int kStage = 4 * kPlane;
  static constexpr int kStages = 2;
  static constexpr int kMainRowBytes = KV == kFloat ? 4 * D : KV == kInt4Dsplit ? D / 2 : D;
  static constexpr int kScales = 2 * kKT * 4;
  static constexpr int kRaw = 2 * kKT * 4 * D + kScales;  // the largest tile: f32 rows
  static constexpr int kRawSlots = 3;                     // tiles in flight to the producers
  static constexpr int kQPlane = kRows * kStride * 4;
  static constexpr int kStageBits = kRows * kKT / 8;      // a tile's mask bits
  // Dynamic shared memory: the stages, their scales, the raw slots, the
  // query tile's hi and lo planes, then the whole walk's mask bits or the
  // stages'.
  static constexpr int kScalesOff = kStages * kStage;
  static constexpr int kRawOff = kScalesOff + kStages * kScales;
  static constexpr int kQOff = kRawOff + kRawSlots * kRaw;
  static constexpr int kBitsOff = kQOff + 2 * kQPlane;
  static_assert(kRows * D * 4 + 2 * kRows * 4 <= kStages * kStage,
                "the second half's partial fits the stages");
};

// A tile (raw: K [16][RowBytes], V, in format TKV: f32 rows for kFloat),
// this producer's vectors (of NP producers), into the stage's planes (K hi,
// K lo, V hi, V lo [16][D + 4]): f32 split into TF32 hi and lo; integers
// cast exactly (hi only: their lo is zero and never read).
template <int D, int TKV, int RowBytes, int NP>
__device__ __forceinline__ void expand_f32(float* planes, const uint8_t* raw, int odd, int p) {
  constexpr int kKT = 16, kStride = D + 4;
  constexpr int kVec = RowBytes < 16 ? RowBytes : 16, kW = kVec / 4;
  constexpr int kVecs = kKT * RowBytes / kVec;
#pragma unroll
  for (int i = p; i < kVecs; i += NP) {
    const int e = i * kVec, j = e / RowBytes, bb = e % RowBytes;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      uint32_t w[kW];
#pragma unroll
      for (int x = 0; x < kW; ++x)
        w[x] = reinterpret_cast<const uint32_t*>(raw + kv * kKT * RowBytes + e)[x];
      float* hi = planes + (2 * kv) * kKT * kStride + j * kStride;
      if (TKV == kFloat) {   // 4 floats: dims bb / 4 ..
        uint32_t h[4], l[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) split_tf32(__uint_as_float(w[x]), h[x], l[x]);
        float* lo = hi + kKT * kStride;
        *reinterpret_cast<uint4*>(hi + bb / 4) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + bb / 4) = make_uint4(l[0], l[1], l[2], l[3]);
      } else {
#pragma unroll
        for (int x = 0; x < kW; ++x) {
          float4* dst = reinterpret_cast<float4*>(hi + bb + 4 * x);
          if (TKV == kInt8) {
            *dst = bytes_to_f32(w[x] ^ 0x80808080u, 8388736.f);
          } else if (TKV == kInt4Head) {
            const uint32_t nib = odd ? (w[x] >> 4) & 0x0F0F0F0Fu : w[x] & 0x0F0F0F0Fu;
            *dst = bytes_to_f32(nib ^ 0x08080808u, 8388616.f);
          } else {
            *dst = bytes_to_f32((w[x] & 0x0F0F0F0Fu) ^ 0x08080808u, 8388616.f);
            *reinterpret_cast<float4*>(hi + D / 2 + bb + 4 * x) =
                bytes_to_f32(((w[x] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 8388616.f);
          }
        }
      }
    }
  }
}

// The consumers: float tiles one warpgroup, each tile one 16-key step (two
// n tiles of S, two k steps of P V), where shared-memory reads of the
// query planes bound the step; packed tiles (no lo planes) two warpgroups,
// warpgroup h taking keys 8 h .. 8 h + 7 of every tile into a partial of
// its own, combined before `finish`: two warps an SM sub-partition hide
// mma.sync's latency. A producer warpgroup either way.
template <int KV>
struct F32Split {
  static constexpr int kGroups = KV == kFloat ? 1 : 2;   // consumer warpgroups
  static constexpr int kNT = 2 / kGroups;                 // 8-key n tiles of a step
  static constexpr int kConsumerThreads = kGroups * kConsumers;
  static constexpr int kProducers = 128;
  static constexpr int kThreads = kConsumerThreads + kProducers;
};
constexpr int kBarHalves = 3;        // named barrier of the two consumer warpgroups

template <int D, int KV>
__global__ void __launch_bounds__((F32Split<KV>::kThreads), 1)
tree_attention_sm90_f32(const Args a) {
  using C = F32Cfg<D, KV>;
  using W = F32Split<KV>;
  constexpr int kStride = C::kStride, kKT = C::kKT, NT = W::kNT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ Shared sh;
  float* qhi = reinterpret_cast<float*>(smem + C::kQOff);
  float* qlo = qhi + kRows * kStride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&sh.full[s], W::kProducers);
      mbar_init(&sh.empty[s], W::kConsumerThreads / 32);
    }
    fence_mbar_init();
  }
  Item it = item_of_block(a);
  // The query tile's hi and lo planes (rows past the tile's: zero), visible
  // after scan_masks' barriers.
  for (int i = threadIdx.x; i < kRows * D / 4; i += W::kThreads) {
    const int r = i / (D / 4), d = (i % (D / 4)) * 4;
    const int64_t off = row_offset(a, it, r, D);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (off >= 0) x = *reinterpret_cast<const float4*>(static_cast<const float*>(a.q) + off + d);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(qhi + r * kStride + d) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(qlo + r * kStride + d) = make_uint4(l[0], l[1], l[2], l[3]);
  }
  uint16_t* whole = reinterpret_cast<uint16_t*>(smem + C::kBitsOff);
  scan_masks<kKT>(a, it, sh, whole);
  const int n = it.nt;
  auto bits = [&](int s) { return whole + s * C::kStageBits / 2; };
  auto planes = [&](int s) { return reinterpret_cast<float*>(smem + s * C::kStage); };
  auto scales = [&](int s) { return reinterpret_cast<float*>(smem + C::kScalesOff + s * C::kScales); };
  auto raw = [&](int i) { return smem + C::kRawOff + (i % C::kRawSlots) * C::kRaw; };

  if (warp >= W::kConsumerThreads / 32) {
    // Producers: every tile through this thread's raw slot, split into planes.
    constexpr int NP = W::kProducers;
    const int p = threadIdx.x - W::kConsumerThreads;
    const uint8_t *kc = nullptr, *vc = nullptr;
    int64_t stride = 0;
    if (KV != kFloat) packed_rows<KV, C::kMainRowBytes>(a, it, kc, vc, stride);
    const int64_t fstride = static_cast<int64_t>(a.Hkv) * D * 4;   // f32 rows, main or scratch
    const int64_t moff = (static_cast<int64_t>(it.b) * a.M * a.Hkv + it.kh) * D;
    const int64_t soff = (static_cast<int64_t>(it.b) * a.S * a.Hkv + it.kh) * D;
    auto fetch = [&](int i) {   // tile i into raw slot i % kRawSlots
      if (i < n) {
        if (i < it.ntm && KV != kFloat) {
          copy_rows<kKT, C::kMainRowBytes, NP>(raw(i), kc, vc, stride, i * kKT, a.M, p);
          copy_scales<kKT, NP>(reinterpret_cast<float*>(raw(i) + 2 * kKT * C::kMainRowBytes), a,
                               it, i * kKT, p);
        } else if (i < it.ntm) {
          copy_rows<kKT, 4 * D, NP>(raw(i),
                                    reinterpret_cast<const uint8_t*>(static_cast<const float*>(a.k) + moff),
                                    reinterpret_cast<const uint8_t*>(static_cast<const float*>(a.v) + moff),
                                    fstride, i * kKT, a.M, p);
        } else {
          copy_rows<kKT, 4 * D, NP>(raw(i),
                                    reinterpret_cast<const uint8_t*>(static_cast<const float*>(a.sk) + soff),
                                    reinterpret_cast<const uint8_t*>(static_cast<const float*>(a.sv) + soff),
                                    fstride, (i - it.ntm) * kKT, a.S, p);
        }
      }
      cp_commit();
    };
    for (int j = 0; j + 1 < C::kRawSlots; ++j) fetch(j);
    for (int i = 0; i < n; ++i) {
      const int s = i % C::kStages;
      // Every producer is done with the raw slot of tile i - 1, which tile
      // i + kRawSlots - 1 takes: a thread's vectors lie elsewhere in an f32
      // tile than in a packed one.
      named_barrier(kBarProducers, NP);
      fetch(i + C::kRawSlots - 1);
      if (i >= C::kStages) wait_phase(&sh.empty[s], ((i / C::kStages) & 1) ^ 1);
      if (!a.words) tile_bits<kKT, NP>(a, it, i, bits(s), p);
      cp_wait<C::kRawSlots - 1>();   // this thread's copies of tile i have landed
      if (i < it.ntm && KV != kFloat) {
        expand_f32<D, KV, C::kMainRowBytes, NP>(planes(s), raw(i), it.kh & 1, p);
#pragma unroll
        for (int k = p; k < 2 * kKT; k += NP)
          scales(s)[k] = reinterpret_cast<const float*>(raw(i) + 2 * kKT * C::kMainRowBytes)[k];
      } else {
        expand_f32<D, kFloat, 4 * D, NP>(planes(s), raw(i), 0, p);
      }
      mbar_arrive(&sh.full[s]);
    }
    cp_wait<0>();
    return;
  }

  // Consumers: warp w of warpgroup h = warp / 4 holds rows ra = 16 w + g and
  // rb = ra + 8, and keys 8 NT h .. 8 NT h + 8 NT - 1 of every tile. In the
  // mma fragments a lane holds, of each n tile's 8 keys, 2 cq and 2 cq + 1,
  // of each 8 dims of acc c and c + 1.
  const int h = warp / 4, cw = warp % 4, g = lane >> 2, cq = lane & 3, c = cq * 2;
  const int ra = 16 * cw + g, rb = ra + 8, k0 = 8 * NT * h;
  // ldmatrix lane offsets: q's A fragment for dims 8 kk ..: (rows 0-7, +0),
  // (8-15, +0), (0-7, +4), (8-15, +4) of the warp's rows; K's B fragments of
  // two k steps: an n tile's keys at dims +0, +4, +8, +12.
  const int qo = (16 * cw + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + (lane >> 4) * 4;
  const int ko = (k0 + (lane & 7)) * kStride + (lane >> 3) * 4;
  const float scale2 = a.scale * 1.4426950408889634f;
  float m_0 = kNeg, m_1 = kNeg, l_0 = 0.f, l_1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int s = i % C::kStages;
    const bool in_main = i < it.ntm, quant = KV != kFloat && in_main;
    const int base = (in_main ? i : i - it.ntm) * kKT, len = in_main ? a.M : a.S;
    const float* khi = planes(s);
    const float* klo = khi + kKT * kStride;
    const float* vhi = klo + kKT * kStride;
    const float* vlo = vhi + kKT * kStride;
    wait_phase(&sh.full[s], (i / C::kStages) & 1);

    // S = Q K^T [16 x 8 NT]: per n tile q_hi.k_hi, q_hi.k_lo (none for
    // integer rows) and q_lo.k_hi, each in two accumulators (even and odd
    // k steps), added in f32 at the end.
    float shh[NT][2][4] = {}, shl[NT][2][4] = {}, slh[NT][2][4] = {};
#pragma unroll
    for (int kp = 0; kp < D / 16; ++kp) {
      uint32_t kbh[NT][4], kbl[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        ldsm_x4(kbh[nt], khi + nt * 8 * kStride + ko + kp * 16);
        if (!quant) ldsm_x4(kbl[nt], klo + nt * 8 * kStride + ko + kp * 16);
      }
#pragma unroll
      for (int z = 0; z < 2; ++z) {
        const int kk = 2 * kp + z;
        uint32_t ah[4], al[4];
        ldsm_x4(ah, qhi + qo + kk * 8);
        ldsm_x4(al, qlo + qo + kk * 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_tf32(shh[nt][z], ah, kbh[nt][2 * z], kbh[nt][2 * z + 1]);
          if (!quant) mma_tf32(shl[nt][z], ah, kbl[nt][2 * z], kbl[nt][2 * z + 1]);
          mma_tf32(slh[nt][z], al, kbh[nt][2 * z], kbh[nt][2 * z + 1]);
        }
      }
    }
    float x[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[nt][e] = (shh[nt][0][e] + shh[nt][1][e]) +
                   ((shl[nt][0][e] + shl[nt][1][e]) + (slh[nt][0][e] + slh[nt][1][e]));

    int rs;
    const uint16_t* tb = tile_bits_at<kKT>(a, it, i, whole, bits(s), rs);   // 16 keys a row
    const float* tks = scales(s) + k0;   // this step's keys: ks, and vs kKT further
    float alpha0, alpha1;
    softmax_step(x, uint32_t(tb[ra * rs]) >> k0, uint32_t(tb[rb * rs]) >> k0, base + k0, len, c,
                 scale2, quant ? tks : nullptr, m_0, m_1, l_0, l_1, alpha0, alpha1);
    // P as the A operand of n tile nt's k step: k index cq is key 2 cq
    // (x[nt][0], [2]), cq + 4 key 2 cq + 1 ([1], [3]); V's rows follow.
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* pr = x[nt];
      if (quant) {   // the key's V scale
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pr[e] *= tks[kKT + nt * 8 + c + e];
          pr[2 + e] *= tks[kKT + nt * 8 + c + e];
        }
      }
      split_tf32(pr[0], ph[nt][0], pl[nt][0]);
      split_tf32(pr[2], ph[nt][1], pl[nt][1]);
      split_tf32(pr[1], ph[nt][2], pl[nt][2]);
      split_tf32(pr[3], ph[nt][3], pl[nt][3]);
    }
    // acc = acc * alpha + P V, 8 dims an n tile: a zeroed accumulator takes
    // each k step's p_hi.v_hi, p_hi.v_lo, p_lo.v_hi in turn.
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int o = (k0 + nt * 8 + 2 * cq) * kStride + dn * 8 + g;
        const uint32_t v0 = __float_as_uint(vhi[o]), v1 = __float_as_uint(vhi[o + kStride]);
        mma_tf32(pv, ph[nt], v0, v1);
        if (!quant)
          mma_tf32(pv, ph[nt], __float_as_uint(vlo[o]), __float_as_uint(vlo[o + kStride]));
        mma_tf32(pv, pl[nt], v0, v1);
      }
      acc[dn][0] = fmaf(acc[dn][0], alpha0, pv[0]);
      acc[dn][1] = fmaf(acc[dn][1], alpha0, pv[1]);
      acc[dn][2] = fmaf(acc[dn][2], alpha1, pv[2]);
      acc[dn][3] = fmaf(acc[dn][3], alpha1, pv[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.empty[s]);   // stage s is free
  }

  quad_sum(l_0, l_1);
  if (W::kGroups == 2) {
    // The two halves' partials combined in warpgroup 0: warpgroup 1 leaves
    // its acc, m and l in the stages.
    float* half = reinterpret_cast<float*>(smem);   // [kRows][D], then m, l [kRows]
    named_barrier(kBarHalves, W::kConsumerThreads);   // both are done with the stages
    if (h == 1) {
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        store2(half + ra * D + dn * 8 + c, acc[dn][0], acc[dn][1]);
        store2(half + rb * D + dn * 8 + c, acc[dn][2], acc[dn][3]);
      }
      if (cq == 0) {
        half[kRows * D + ra] = m_0;
        half[kRows * D + rb] = m_1;
        half[kRows * D + kRows + ra] = l_0;
        half[kRows * D + kRows + rb] = l_1;
      }
    }
    named_barrier(kBarHalves, W::kConsumerThreads);
    if (h == 1) return;
    const float ma = half[kRows * D + ra], mb = half[kRows * D + rb];
    const float na = fmaxf(m_0, ma), nb = fmaxf(m_1, mb);
    const float w0a = exp2f(m_0 - na), w1a = exp2f(ma - na);
    const float w0b = exp2f(m_1 - nb), w1b = exp2f(mb - nb);
    l_0 = w0a * l_0 + w1a * half[kRows * D + kRows + ra];
    l_1 = w0b * l_1 + w1b * half[kRows * D + kRows + rb];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const float2 ya = *reinterpret_cast<const float2*>(half + ra * D + dn * 8 + c);
      const float2 yb = *reinterpret_cast<const float2*>(half + rb * D + dn * 8 + c);
      acc[dn][0] = w0a * acc[dn][0] + w1a * ya.x;
      acc[dn][1] = w0a * acc[dn][1] + w1a * ya.y;
      acc[dn][2] = w0b * acc[dn][2] + w1b * yb.x;
      acc[dn][3] = w0b * acc[dn][3] + w1b * yb.y;
    }
    m_0 = na;
    m_1 = nb;
  }
  finish<D, float>(acc, l_0, l_1, a, it);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Sets the kernel's dynamic shared memory limit once it needs more than
// `allowed` (227 KB a block at most).
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int bytes, int& allowed) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    allowed = bytes;
  }
  return cudaSuccess;
}

// The mask bits' words of a row kept whole (0: a tile's in its stage) and
// their bytes, for KT-key tiles and Stages stages.
template <int KT, int Stages>
int bits_room(Args& a) {
  const int keys = ((a.M + KT - 1) / KT + (a.S + KT - 1) / KT) * KT;
  a.words = keys <= kWhole<KT> ? (keys + 63) / 64 * 2 : 0;
  return a.words ? kRows * a.words * 4 : Stages * kRows * KT / 8;
}

// Grid (64-row tiles, slot x KV head): one block a work item.
inline dim3 grid_of(const Args& a, int B) {
  return dim3((a.Q * (a.H / a.Hkv) + kRows - 1) / kRows, B * a.Hkv);
}

// A 3-D tensor map over bf16 rows [B][rows][Hkv * D], boxes of 64 rows by
// one column block (kRB / 2 dims) in the block's swizzle.
template <class C>
bool encode_rows(CUtensorMap* map, const void* base, int B, int rows, int Hkv, int D) {
  const uint64_t row = static_cast<uint64_t>(Hkv) * D * 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Hkv) * D, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {row, row * rows};
  const cuuint32_t box[3] = {C::kRB / 2, C::kKT, 1};
  const CUtensorMapSwizzle swz = C::kRB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : C::kRB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return sm90::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 3, dims, strides, box, swz);
}

template <int D, int KV>
cudaError_t launch_bf16(Args a, int B, cudaStream_t st) {
  using C = Bf16Cfg<D, KV>;
  const int smem = 1024 + C::kBitsOff + bits_room<C::kKT, C::kStages>(a);
  static int allowed = 48 * 1024;
  cudaError_t e = allow_smem(tree_attention_sm90_bf16<D, KV>, smem, allowed);
  if (e != cudaSuccess) return e;
  CUtensorMap maps[4];
  memset(maps, 0, sizeof(maps));
  bool ok = true;
  if (KV == kFloat)
    ok = encode_rows<C>(&maps[0], a.k, B, a.M, a.Hkv, D) &&
         encode_rows<C>(&maps[1], a.v, B, a.M, a.Hkv, D);
  if (a.S > 0)
    ok = ok && encode_rows<C>(&maps[2], a.sk, B, a.S, a.Hkv, D) &&
         encode_rows<C>(&maps[3], a.sv, B, a.S, a.Hkv, D);
  if (!ok) return cudaErrorInvalidValue;
  tree_attention_sm90_bf16<D, KV><<<grid_of(a, B), C::kThreads, smem, st>>>(maps[0], maps[1],
                                                                         maps[2], maps[3], a);
  return cudaGetLastError();
}

template <int D, int KV>
cudaError_t launch_f32(Args a, int B, cudaStream_t st) {
  using C = F32Cfg<D, KV>;
  const int smem = 1024 + C::kBitsOff + bits_room<C::kKT, C::kStages>(a);
  static int allowed = 48 * 1024;
  cudaError_t e = allow_smem(tree_attention_sm90_f32<D, KV>, smem, allowed);
  if (e != cudaSuccess) return e;
  tree_attention_sm90_f32<D, KV><<<grid_of(a, B), F32Split<KV>::kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int KV>
cudaError_t launch(const Args& a, int dtype, int B, int D, cudaStream_t st) {
#define SEQ_SM90_CASE(DD) \
  if (D == DD) return dtype == 0 ? launch_f32<DD, KV>(a, B, st) : launch_bf16<DD, KV>(a, B, st);
  SEQ_SM90_CASE(16)
  SEQ_SM90_CASE(32)
  SEQ_SM90_CASE(64)
  SEQ_SM90_CASE(128)
#undef SEQ_SM90_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The operands of sequoia_tree_attention's slot-axis call (tree_attention.cu:
// q, the main cache k, v in kv_format 0..3 with scales ks, vs for 1..3, the
// masks, the scratch sk, sv (S may be 0), out), B slots, head dim D in 16,
// 32, 64, 128 (the wrapper checks it); dtype 0 = float32 (3xTF32 on
// mma.sync), 1 = bfloat16 (wgmma). One block a work item: no workspace.
int sequoia_tree_attention_sm90(const void* q, const void* k, const void* v, const void* ks,
                                const void* vs, const void* mask, const void* sk,
                                const void* sv, const void* smask, void* out, int B, int Q, int H,
                                int Hkv, int D, int M, int S, float scale, int dtype,
                                int kv_format, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_format == kInt4Head && Hkv % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_format != kFloat && (ks == nullptr || vs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((dtype != 0 && dtype != 1) || B < 1 || Q < 1 || Hkv < 1 || H % Hkv ||
      static_cast<int64_t>(B) * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
               static_cast<const uint8_t*>(mask), sk, sv, static_cast<const uint8_t*>(smask),
               out, Q, H, Hkv, M, S, 0, scale};
#define SEQ_SM90_FORMAT(KV) \
  if (kv_format == KV) return static_cast<int>(launch<KV>(a, dtype, B, D, st));
  SEQ_SM90_FORMAT(kFloat)
  SEQ_SM90_FORMAT(kInt8)
  SEQ_SM90_FORMAT(kInt4Head)
  SEQ_SM90_FORMAT(kInt4Dsplit)
#undef SEQ_SM90_FORMAT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
