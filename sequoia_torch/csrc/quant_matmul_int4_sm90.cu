// Packed-int4 weight matmuls on Hopper's wgmma + TMA, one kernel for both
// weight layouts and three activation types:
//   bf16 x: out[R, N] = (x[R, K] @ w[K, N]) * scale[N], f32 accumulation,
//     cast once;
//   f32 x, as its three bf16 planes [3, R, K] (x = b0 + b1 + b2 exactly;
//     split_bf16x3.cu, the kernel launched right before): the same product,
//     each plane's products exact on the bf16 tensor cores;
//   int8 x8 (w4a8): out = float(x8[R, K] @ w) * sx[r] * scale[n], in that
//     order, the product exact in int32 (x8 and sx come from the activation
//     quantizer of quant_matmul_a8.cu, the kernel launched right before);
// with q[K/2, N] int8 half-split packed: byte [k, n] holds w[k, n] in its
// low nibble and w[K/2 + k, n] in its high nibble, both signed (0x8 is -8).
// Replaces the Pallas kernels sequoia_tpu/kernels/quant_matmul.py::
// quant_matmul bits=4 (_kernel_int4, its "shift" and "float" unpacks compute
// the same numbers; _kernel_int4_w4a8 for unpack="w4a8") and
// ::quant_matmul_tiled (_kernel_int4_tiled: the same product over
// q[ceil(N / 128), K/2, 128], panel n holding columns [128 n, 128 n + 128),
// zero past N; bf16 or f32 x, as in JAX). The nibble -> bf16 conversion is
// exact, so the bf16-x (and plane) products are the plain version's and only
// the order of the f32 sums differs; w4a8 equals its plain version bit for
// bit. f32 x replaces the port's first, CUDA-core kernel for it.
//
// Bound on the H100: the weight stream at the rows of a tree verify. At
// (K, N) = (4096, 11008) the packed weight is 22.5 MB, 0.0067 ms at 3.35
// TB/s; 2*R*K*N operations pass it near R = 74 at the bf16 peak of 989
// TFLOP/s and near R = 148 at the int8 peak of 1979 TOP/s (w4a8).
//
// Design: the block, ring and cluster structure of quant_matmul_int8_sm90.cu
// (its file note; the shared pieces are in qmm_sm90.cuh). What differs:
// - A and B are swapped as there (out^T = W^T x^T): the int4 weight tile is
//   wgmma's register A operand, x the K-major B operand in shared memory, R
//   wgmma's N; one block holds all R <= 256 rows of its 128 columns, so the
//   weight crosses device memory once. R > 256 runs ceil(R / 256) row tiles.
// - One stage is 64 packed q rows (64 x 128 bytes). They carry the logical
//   k [kp, kp + 64) in their low nibbles and [K/2 + kp, ..) in their high
//   nibbles, so the stage holds two x boxes of one 2-D tensor map of x, at
//   columns kp and K/2 + kp, each RT rows of 64 k: 128 bytes in the 128-byte
//   swizzle (bf16), 64 bytes in the 64-byte swizzle (x8). Where K/2 is not a
//   multiple of 64, the low box of the last stage reaches into the high half
//   of x; those columns meet the zero q rows past K/2, which TMA fills.
// - M-row g of a warp is weight column c = 2g of its 16 and row g + 8 is
//   column c + 1, as in the int8 kernel, so a lane needs the 16-bit column
//   pair (c, c + 1) of each q row it reads. Read as a matrix of 16-bit
//   elements, that is what ldmatrix .trans delivers: one ldmatrix.x4.trans
//   reads 32 q rows of the warp's 16 columns (lanes 8m .. 8m + 7 address
//   the 16-byte row chunks of 8-row matrix m) and leaves in register m of
//   lane (g, t) the word [q[a][c], q[a][c + 1], q[b][c], q[b][c + 1]] of the
//   rows a, b that lanes 8m + 2t, 8m + 2t + 1 addressed. Each activation
//   type picks the rows and builds the fragments (ldm_row, fragments):
//   - bf16 (k16 steps, 16 q rows): lane 8m + i addresses row 8m + i, so
//     register m holds the k pair (2t, 2t + 1) + 8m; P, P >> 4, P >> 8 and
//     P >> 12 then hold, at bits 0-3 and 16-19, that pair's low nibbles of
//     column c, its high nibbles, c + 1's low and c + 1's high: four
//     fragment registers of the two wgmmas of a k step (low box, high box).
//     Each becomes a bf16x2 in two instructions (nibbles_bf16): the nibble u
//     goes into the mantissa of bf16 128.0, (u ^ 8) | 0x4300 = 128 + (v + 8)
//     for the signed value v, and one fma.rn.bf16x2 subtracts 136, exactly.
//   - int8 (k32 steps, 32 q rows): an s8 fragment register holds 4
//     consecutive k of one column, k 4t .. 4t + 3 (+ 16 for a2, a3). Lane
//     8m + 2t' + s addresses row 16 (m / 2) + 4t' + 2 ((t' / 2) ^ (m % 2))
//     + s: registers 0 and 1 hold rows 4t .. 4t + 3 (in the order 0, 1 for
//     t < 2, swapped for t >= 2), registers 2 and 3 those rows + 16, and
//     each 8-lane phase still reads 8 distinct 16-byte bank groups. Two prmt
//     per register pair gather column c's and column c + 1's 4 bytes; the
//     masks (w << 4) & 0xF0F0F0F0 and w & 0xF0F0F0F0 make each nibble a
//     signed byte of 16 v, exactly, for the low and the high wgmma. The
//     int32 sum is then 16 acc, |16 acc| <= 16 * 127 * 8 * K < 2^31 for K
//     <= 132104, and one arithmetic shift by 4 before the epilogue gives acc
//     exactly (each cluster rank's partial is a multiple of 16 too). About
//     16 instructions a lane for a k step's two fragments, against 44 for
//     the two bf16 k steps that cover the same 32 rows.
// - Stage depth: 64-row stages (one descriptor layout, one copy path per
//   type); the ring fills a 216 KB budget, up to 16 stages. bf16: RT <= 16
//   16, RT 32 13, RT 64 9, RT 128 5, RT 256 3 (72 KB a stage). x8 boxes
//   are half the bytes: RT <= 32 16, RT 64 13, RT 128 9, RT 256 5 (40 KB).
// - The fragments of a batch of k steps (a whole stage; half of one at RT =
//   256 for bf16, where 128 accumulators leave fewer registers) are built
//   first, the ldmatrix loads ahead of the conversions, each step's two
//   fragments in registers of their own; each step's wgmmas form one commit
//   group, and the previous batch's groups are waited for once per batch
//   and its fragments read once more (`live`), so that ptxas never rewrites
//   a register that a wgmma in flight reads (C7513).
// - The tiled layout is a 3-D tensor map over q [nt, K/2, 128] with the box
//   [1, 64, 128]: a box never crosses into the next panel, rows past K/2
//   arrive as zeros, and block column tile y reads panel y. The logical N
//   comes from the scale; the last panel's columns past N are computed on
//   the stored zeros and not written.
// - K split over a 1-4-block cluster with the DSMEM reduction, the producer
//   warp's masked copies where TMA cannot address the tensors (K % 8 (bf16)
//   or K % 16 (x8) != 0, or N % 16 != 0 row-major), the CUDA-graph capture:
//   as in the int8 kernel, chosen before the launch. w4a8 above 128 rows
//   may take 128-row tiles instead of 256 (kernels/quant_matmul.py::
//   sm90_tiling): where N = 4096, 64 tiles in clusters of 2 fill 128 SMs
//   in one wave, against 32 tiles in clusters of 3 on 96 SMs, and halve
//   each block's x8 stream and epilogue tile.
// - w4a8 is a programmatic dependent launch after the quantizer, as the
//   int8 kernel's w8a8 instantiation: barrier set-up, tensor-map prefetch
//   and the weight boxes of the first kPdlStages stages overlap the quantizer;
//   the producer waits for its grid before the first x8 box, each consumer
//   before it reads sx. The planes instantiation is one after the split.
// - f32 x, the planes instantiation (XPlanes): the bf16 one with kP = 3
//   boxes of each half a stage (two 3-D TMA boxes over [3, R, K], each
//   half's planes back to back); each k step's two fragments are built once
//   and each feeds one wgmma per plane, into the same accumulator. Six x
//   boxes a stage cap the row tile at kMaxRTPlanes = 64 (4 stages of 56 KB
//   in a 224 KB budget; 128 rows would leave 2); R > 64 runs several row
//   tiles, the later ones reading the weight from L2. Bound: 3 bf16 passes,
//   or the bytes (the int8 kernel's file note; PERF.md §6).

#include "qmm_sm90.cuh"

namespace {

using namespace sq;
using namespace sq::sm90;

constexpr int kSmemBudget = 216 * 1024;
constexpr int kKp = 64;          // packed q rows per stage
constexpr int kLdsmRows = 32;    // q rows of one ldmatrix.x4.trans

// The two nibbles at bits 0-3 and 16-19 of w (unsigned u, standing for the
// signed v = (u ^ 8) - 8) as a bf16x2, exactly: 0x4300 | (u ^ 8) is the bf16
// 128 + v + 8, and 1.0 * that - 136.0 is v.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t w) {
  const uint32_t b = (w & 0x000F000Fu) ^ 0x43084308u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(b), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// bf16 activations: wgmma k16, f32 accumulation, x boxes of 64 k in the
// 128-byte swizzle.
struct XBf16 {
  using Acc = float;
  static constexpr bool kA8 = false;
  static constexpr int kP = 1;                       // x planes
  static constexpr bool kDep = false;                // x is the output of the kernel before
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr int kItem = 2;                    // bytes per x element
  static constexpr int kXRow = 128;                  // bytes per x box row
  static constexpr int kStepRows = 16;               // packed rows per wgmma k step
  __device__ __forceinline__ static uint64_t desc(const void* tile) { return desc_k128(tile); }
  __device__ __forceinline__ static int swz_x(int row, int byte) { return swz(row, byte); }
  // The q row (of an ldmatrix's 32) whose 16-byte chunk lane `lane` addresses.
  __device__ __forceinline__ static int ldm_row(int lane) { return lane; }
  // The A fragments of B k steps from B / 2 ldmatrix results: register
  // 2 (j % 2) + e of result j / 2 is P[e] of step j (q rows 2t and 2t + 1
  // of the step, + 8e, at columns col and col + 1: [q[k][col],
  // q[k][col + 1], q[k + 1][col], q[k + 1][col + 1]]). a[j][0] feeds the
  // low x box, a[j][1] the high one: a0 = M-row g (column col), k 2t and
  // 2t + 1; a1 = M-row g + 8 (col + 1); a2, a3 the same at k + 8.
  template <int B>
  __device__ __forceinline__ static void fragments(const uint32_t (&r)[B / 2][4], int,
                                                   uint32_t (&a)[B][2][4]) {
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t w = r[j / 2][2 * (j % 2) + e];
        a[j][0][2 * e] = nibbles_bf16(w);
        a[j][1][2 * e] = nibbles_bf16(w >> 4);
        a[j][0][2 * e + 1] = nibbles_bf16(w >> 8);
        a[j][1][2 * e + 1] = nibbles_bf16(w >> 12);
      }
  }
};

// int8 activations (w4a8): wgmma k32 s8 x s8, s32 accumulation of 16 acc,
// x8 boxes of 64 k in the 64-byte swizzle.
struct XS8 {
  using Acc = int;
  static constexpr bool kA8 = true;
  static constexpr int kP = 1;
  static constexpr bool kDep = true;                 // the quantizer's x8 and sx
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapSwizzle kSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr int kItem = 1;
  static constexpr int kXRow = 64;
  static constexpr int kStepRows = 32;
  __device__ __forceinline__ static uint64_t desc(const void* tile) { return desc_k64(tile); }
  __device__ __forceinline__ static int swz_x(int row, int byte) { return swz64(row, byte); }
  // Matrix m = lane / 8, its row i = lane % 8 = 2t' + s (see the file note).
  __device__ __forceinline__ static int ldm_row(int lane) {
    const int m = lane / 8, tt = (lane % 8) / 2, s = lane % 2;
    return 16 * (m / 2) + 4 * tt + 2 * ((tt >> 1) ^ (m & 1)) + s;
  }
  // The A fragments of B k steps, one ldmatrix result each: registers 0, 1
  // hold q rows 4t .. 4t + 3 of the step (0 = rows 4t, 4t + 1 for t < 2, 4t
  // + 2, 4t + 3 for t >= 2), registers 2, 3 the same 16 rows further. a0 =
  // M-row g (column col), k 4t .. 4t + 3; a1 = M-row g + 8 (col + 1); a2, a3
  // at k + 16. a[j][0]: 16 x the low nibbles, a[j][1]: 16 x the high ones.
  template <int B>
  __device__ __forceinline__ static void fragments(const uint32_t (&r)[B][4], int t,
                                                   uint32_t (&a)[B][2][4]) {
    const uint32_t s0 = t < 2 ? 0x6420u : 0x2064u;   // column col: bytes 0 and 2 of each
    const uint32_t s1 = t < 2 ? 0x7531u : 0x3175u;   // column col + 1: bytes 1 and 3
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const uint32_t w[4] = {__byte_perm(r[j][0], r[j][1], s0), __byte_perm(r[j][0], r[j][1], s1),
                             __byte_perm(r[j][2], r[j][3], s0), __byte_perm(r[j][2], r[j][3], s1)};
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        a[j][0][l] = (w[l] << 4) & 0xF0F0F0F0u;
        a[j][1][l] = w[l] & 0xF0F0F0F0u;
      }
    }
  }
};

// f32 activations as three bf16 planes [3, R, K] (split_bf16x3.cu): the
// bf16 instantiation with kP boxes of each half a stage, every plane's
// wgmma reading the same fragment.
struct XPlanes : XBf16 {
  static constexpr int kP = kPlanes;
  static constexpr bool kDep = true;                 // the split's planes
};

template <class X, int RT>
struct Cfg {
  static constexpr int kBoxBytes = RT * X::kXRow;    // one x box: RT rows of 64 k
  // the low-half boxes (one a plane), then the high-half ones
  static constexpr int kXBytes = 2 * X::kP * kBoxBytes;
  static constexpr int kQBytes = kKp * kRowBytes;    // q tile: kKp rows of kBM bytes
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kStages =
      min_int((X::kP > 1 ? kPlanesSmemBudget : kSmemBudget) / kStageBytes, kMaxStages);
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static constexpr int kChunkN = RT < 64 ? RT : 64;  // wgmma N of one instruction
  static constexpr int kChunks = RT / kChunkN;
  static constexpr int kSteps = kKp / X::kStepRows;  // k steps per stage
  // k steps whose fragments are built together
  static constexpr int kBatch = !X::kA8 && RT >= 256 ? 2 : kSteps;
  static constexpr int kBatches = kSteps / kBatch;   // batches per stage
  static constexpr int kLdsm = kBatch * X::kStepRows / kLdsmRows;   // ldmatrix.x4 per batch
  static_assert(X::kXRow / X::kItem == kKp, "an x box row holds the stage's k");
  static_assert(kStages >= 3, "two stages in flight while one is read");
  static_assert(RT * kTileStride * 4 <= kStages * kStageBytes,
                "the output tile reuses the stages");
};

struct Params {
  const void* x;         // [R, K] bf16 or x8 int8; planes: [3, R, K] bf16
  const int8_t* q;       // [K/2, N], or the panels [ceil(N / 128), K/2, 128]
  const float* sx;       // [R] (x8)
  const float* scale;    // [N]
  void* out;             // [R, N] f32 or bf16
  int R, K, N;
  int stages_per_split;  // K stages of each cluster rank
  int out_bf16;
  int tma;               // 1: TMA loads; 0: the producer warp copies (unaligned shapes)
  int tiled;             // 1: q is the panel layout
};

// The producer warp's copy of one stage where TMA cannot address the
// tensors: the same bytes in the same swizzled layouts, zero outside them
// (here the low box stops at K/2 too).
template <class X, int RT>
__device__ void copy_stage(uint8_t* xs, uint8_t* qs, const Params& p, int kp, int r0, int n0,
                           int lane) {
  using C = Cfg<X, RT>;
  constexpr int kWords = X::kXRow / 4, kPer = 4 / X::kItem;
  const int Kq = p.K / 2;
  for (int i = lane; i < 2 * X::kP * RT * kWords; i += 32) {
    const int box = i / (RT * kWords), j = i % (RT * kWords);
    const int half = box / X::kP, pl = box % X::kP;
    const int r = j / kWords, b = (j % kWords) * 4, row = r0 + r, k = kp + b / X::kItem;
    uint32_t v = 0;
    if (row < p.R) {
      const uint8_t* src =
          static_cast<const uint8_t*>(p.x) +
          ((static_cast<int64_t>(pl) * p.R + row) * p.K + half * Kq) * X::kItem;
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (k + e < Kq) {
          uint32_t w = 0;
          memcpy(&w, src + (k + e) * X::kItem, X::kItem);
          v |= w << (8 * X::kItem * e);
        }
    }
    *reinterpret_cast<uint32_t*>(xs + box * C::kBoxBytes + X::swz_x(r, b)) = v;
  }
  const int ncols = p.tiled ? kBM : p.N - n0;
  constexpr int kQWords = kRowBytes / 4;
  for (int i = lane; i < kKp * kQWords; i += 32) {
    const int kr = i / kQWords, b = (i % kQWords) * 4, k = kp + kr;
    uint32_t v = 0;
    if (k < Kq) {
      const int8_t* src = p.tiled ? p.q + (static_cast<int64_t>(blockIdx.y) * Kq + k) * kBM
                                  : p.q + static_cast<int64_t>(k) * p.N + n0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (b + j < ncols) v |= uint32_t(static_cast<uint8_t>(src[b + j])) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(qs + swz(kr, b)) = v;
  }
}

template <class X, int RT>
__global__ void __launch_bounds__(kThreadsW, 1)
qmm4_sm90(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
          const Params p) {
  using C = Cfg<X, RT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  cg::cluster_group cluster = cg::this_cluster();
  const int n0 = blockIdx.y * kBM, r0 = blockIdx.z * RT;
  const int nk = (p.K / 2 + kKp - 1) / kKp;
  const int s_begin = static_cast<int>(cluster.block_rank()) * p.stages_per_split;
  const int nst = max(0, min(nk, s_begin + p.stages_per_split) - s_begin);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    if (p.tma) {
      prefetch_tensormap(&xmap);
      prefetch_tensormap(&qmap);
    }
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp < 4) {
    // Producer warpgroup: warp 0 keeps the ring full (TMA: lane 0 alone;
    // copies: the whole warp), then joins the epilogue's cluster barriers.
    setmaxnreg_dec<kProducerRegs>();
    const bool loader = warp == 0 && (lane == 0 || !p.tma);
    auto load_q = [&](uint8_t* qs, uint64_t* bar, int kp) {
      if (p.tiled) tma_load_3d(qs, &qmap, bar, 0, kp, blockIdx.y);
      else tma_load_2d(qs, &qmap, bar, n0, kp);
    };
    int pre = 0;   // stages whose weight box went out before the wait (x8, planes)
    if constexpr (X::kDep) {
      if (loader) {
        if (p.tma) {
          pre = min(nst, kPdlStages);
          for (int s = 0; s < pre; ++s) {
            mbar_arrive_expect_tx(&full[s], C::kStageBytes);
            load_q(smem + s * C::kStageBytes + C::kXBytes, &full[s], (s_begin + s) * kKp);
          }
        }
        grid_dep_wait();   // x8 and sx are the quantizer's output, the planes the split's
      }
    }
    for (int s = 0; loader && s < nst; ++s) {
      const int slot = s % C::kStages;
      if (s >= C::kStages) mbar_wait(&empty[slot], ((s / C::kStages) & 1) ^ 1);
      uint8_t* xs = smem + slot * C::kStageBytes;
      uint8_t* qs = xs + C::kXBytes;
      const int kp = (s_begin + s) * kKp;
      if (p.tma) {
        if (s >= pre) mbar_arrive_expect_tx(&full[slot], C::kStageBytes);
        if (X::kP > 1) {   // each half's box of every plane
          tma_load_3d(xs, &xmap, &full[slot], kp, r0, 0);
          tma_load_3d(xs + X::kP * C::kBoxBytes, &xmap, &full[slot], p.K / 2 + kp, r0, 0);
        } else {
          tma_load_2d(xs, &xmap, &full[slot], kp, r0);
          tma_load_2d(xs + C::kBoxBytes, &xmap, &full[slot], p.K / 2 + kp, r0);
        }
        if (s >= pre) load_q(qs, &full[slot], kp);
      } else {
        copy_stage<X, RT>(xs, qs, p, kp, r0, n0, lane);
        fence_proxy_async();   // x is read by wgmma, through the async proxy
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[slot]);
      }
    }
    __syncwarp();
    cluster.sync();
    cluster.sync();
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const float4 sc = epilogue_scale(p.scale, n0, p.N);
  if constexpr (X::kA8) grid_dep_wait();   // sx is read in the epilogue
  const int wg = warp / 4 - 1, g = lane / 4, t = lane % 4;
  const int col = 64 * wg + 16 * (warp % 4) + 2 * g;   // the lane's columns col, col + 1
  // ldmatrix.x4.trans: lane l gives the address of q row X::ldm_row(l) of
  // the 32, at the 16 bytes of the warp's 16 columns (8 column pairs). The
  // 32 rows start at a multiple of 8 and the swizzle depends only on
  // row % 8.
  const int ldm_off = swz(X::ldm_row(lane), col - 2 * g);
  typename X::Acc acc[C::kChunks][C::kChunkN / 2];
#pragma unroll
  for (int j = 0; j < C::kChunks; ++j)
#pragma unroll
    for (int i = 0; i < C::kChunkN / 2; ++i) {
      acc[j][i] = 0;
      fence_reg(acc[j][i]);
    }
  uint32_t fr[2][C::kBatch][2][4] = {};
  uint32_t live = 0;
  // Batch i: k steps ks0 .. ks0 + kBatch - 1 of stage i / kBatches.
  auto batch = [&](int i, uint32_t (&a)[C::kBatch][2][4], uint32_t (&prev)[C::kBatch][2][4]) {
    const int s = i / C::kBatches, ks0 = (i % C::kBatches) * C::kBatch;
    const int slot = s % C::kStages;
    if (ks0 == 0) mbar_wait(&full[slot], (s / C::kStages) & 1);
    const uint8_t* xs = smem + slot * C::kStageBytes;
    const uint8_t* qs = xs + C::kXBytes + ks0 * X::kStepRows * kRowBytes;
    uint32_t r[C::kLdsm][4];
#pragma unroll
    for (int l = 0; l < C::kLdsm; ++l)
      ldsm_x4_trans(r[l], qs + ldm_off + l * kLdsmRows * kRowBytes);
    X::template fragments<C::kBatch>(r, t, a);
    // The box of half hh and plane pl; k step j of the batch: 32 bytes of
    // each x row further (16 bf16, 32 x8)
    uint64_t d[2][X::kP];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int pl = 0; pl < X::kP; ++pl) {
        d[hh][pl] = X::desc(xs + (hh * X::kP + pl) * C::kBoxBytes) + 2 * ks0;
        fence_reg(d[hh][pl]);
      }
#pragma unroll
    for (int j = 0; j < C::kBatch; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int l = 0; l < 4; ++l) fence_reg(a[j][hh][l]);
      wgmma_fence();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int pl = 0; pl < X::kP; ++pl)   // every plane reads the half's fragment
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)   // x rows [64c, 64c + 64)
            wgmma_rs(acc[c], a[j][hh], d[hh][pl] + 2 * j + ((c * 64 * X::kXRow) >> 4));
      wgmma_commit();
    }
    wgmma_wait<C::kBatch>();
    // The previous batch's fragments are read once more after its wgmmas
    // are known to be done (see the file note).
#pragma unroll
    for (int j = 0; j < C::kBatch; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int l = 0; l < 4; ++l) live ^= prev[j][hh][l];
    if (i > 0 && ks0 == 0 && lane == 0) mbar_arrive(&empty[(s - 1) % C::kStages]);
  };
  const int nb = nst * C::kBatches;
  for (int i = 0; i < nb; i += 2) {
    batch(i, fr[0], fr[1]);
    if (i + 1 < nb) batch(i + 1, fr[1], fr[0]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < C::kChunks; ++j)
#pragma unroll
    for (int i = 0; i < C::kChunkN / 2; ++i) {
      fence_reg(acc[j][i]);
      if constexpr (X::kA8) acc[j][i] >>= 4;   // the products were 16 x the nibbles
    }

  cluster_epilogue<RT, C::kChunks, C::kChunkN>(cluster, acc, live, smem, col, t, r0, n0, p.R,
                                                p.N, sc, X::kA8 ? p.sx : nullptr, p.out,
                                                p.out_bf16);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <class X, int RT>
cudaError_t set_smem() {
  static bool done = false;   // above 48 KB only after this attribute; once
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm4_sm90<X, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<X, RT>::kSmem);
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

template <class X, int RT>
cudaError_t launch(const Params& p, int splits, bool pdl, cudaStream_t st) {
  using C = Cfg<X, RT>;
  cudaError_t err = set_smem<X, RT>();
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, qmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&qmap, 0, sizeof(qmap));
  if (p.tma) {
    const uint64_t Kq = p.K / 2, xrow = static_cast<uint64_t>(p.K) * X::kItem;
    bool ok;
    if (X::kP > 1) {   // [P, R, K] bf16, boxes [P, RT, 64]: a half's planes back to back
      const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.K), static_cast<cuuint64_t>(p.R),
                                  X::kP};
      const cuuint64_t strides[2] = {xrow, xrow * p.R};
      const cuuint32_t box[3] = {X::kXRow / X::kItem, RT, X::kP};
      ok = encode(&xmap, X::kMapType, p.x, 3, dims, strides, box, X::kSwizzle);
    } else {
      ok = encode_2d(&xmap, X::kMapType, p.x, p.K, p.R, xrow, X::kXRow / X::kItem, RT,
                     X::kSwizzle);
    }
    if (p.tiled) {
      const cuuint64_t dims[3] = {kBM, Kq, static_cast<cuuint64_t>((p.N + kBM - 1) / kBM)};
      const cuuint64_t strides[2] = {kBM, Kq * kBM};
      const cuuint32_t box[3] = {kBM, kKp, 1};
      ok = ok && encode(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, 3, dims, strides, box);
    } else {
      ok = ok && encode_2d(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, p.N, Kq, p.N, kBM, kKp);
    }
    if (!ok) return cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      launch_config(splits, p.N, p.R, RT, C::kSmem, st, attr, X::kDep && pdl);
  return cudaLaunchKernelEx(&cfg, qmm4_sm90<X, RT>, xmap, qmap, p);
}

template <class X, int RT>
int clusters(int splits) {
  if (set_smem<X, RT>() != cudaSuccess) return -1;
  return max_clusters(reinterpret_cast<const void*>(qmm4_sm90<X, RT>), splits, RT,
                      Cfg<X, RT>::kSmem);
}

// Row tiles up to 256; the planes instantiation up to kMaxRTPlanes (six x
// boxes a stage: 4 stages of 56 KB at 64 rows).
constexpr int kMaxRTPlanes = 64;

template <class X>
int dispatch(const Params& p, int rt, int splits, bool pdl, cudaStream_t st) {
  switch (rt) {
    case 8: return launch<X, 8>(p, splits, pdl, st);
    case 16: return launch<X, 16>(p, splits, pdl, st);
    case 32: return launch<X, 32>(p, splits, pdl, st);
    case 64: return launch<X, 64>(p, splits, pdl, st);
  }
  if constexpr (X::kP > 1) {
    return cudaErrorInvalidValue;
  } else {
    return rt == 128 ? launch<X, 128>(p, splits, pdl, st) : launch<X, 256>(p, splits, pdl, st);
  }
}

template <class X>
int dispatch_clusters(int rt, int splits) {
  switch (rt) {
    case 8: return clusters<X, 8>(splits);
    case 16: return clusters<X, 16>(splits);
    case 32: return clusters<X, 32>(splits);
    case 64: return clusters<X, 64>(splits);
  }
  if constexpr (X::kP > 1) {
    return -1;
  } else {
    return rt == 128 ? clusters<X, 128>(splits) : clusters<X, 256>(splits);
  }
}

}  // namespace

extern "C" {

// x (xtype kXBf16: bfloat16 [R, K]; kXS8: int8 x8 [R, K] with sx [R]
// float32; kXPlanes: the bfloat16 planes [3, R, K] of f32 x,
// split_bf16x3.cu; K even), q int8 packed [K/2, N] (tiled = 0) or panels
// [ceil(N / 128), K/2, 128] (tiled = 1, not with x8), scale float32 [N], out
// [R, N] (out_dtype 0 = float32, 1 = bfloat16); row tiles of `rt` rows (8,
// 16, .., 256; planes up to kMaxRTPlanes); K split over a cluster of
// `splits` (1..4) blocks. x and q 16-byte aligned; the wrapper checks
// shapes, types and alignment and picks rt and splits. TMA when the strides
// allow it (see the file note). pdl = 1 (x8, planes): a programmatic
// dependent launch after the kernel that wrote x.
int sequoia_qmm4_sm90(const void* x, const void* q, const void* sx, const void* scale, void* out,
                      int R, int K, int N, int tiled, int xtype, int rt, int splits,
                      int out_dtype, int pdl, void* stream) {
  const bool a8 = xtype == kXS8;
  if (R <= 0 || K <= 0 || K % 2 || N <= 0 || splits < 1 || splits > kMaxSplit ||
      out_dtype < 0 || out_dtype > 1 || xtype < kXBf16 || xtype > kXPlanes ||
      (a8 && (sx == nullptr || tiled)) || rt < 8 ||
      rt > (xtype == kXPlanes ? kMaxRTPlanes : kMaxRT) || (rt & (rt - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.sx = static_cast<const float*>(sx);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.R = R;
  p.K = K;
  p.N = N;
  const int nk = (K / 2 + kKp - 1) / kKp;
  p.stages_per_split = (nk + splits - 1) / splits;
  p.out_bf16 = out_dtype;
  p.tiled = tiled != 0;
  p.tma = (tiled || N % 16 == 0) && K % (a8 ? 16 : 8) == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a8) return dispatch<XS8>(p, rt, splits, pdl != 0, st);
  if (xtype == kXPlanes) return dispatch<XPlanes>(p, rt, splits, pdl != 0, st);
  return dispatch<XBf16>(p, rt, splits, false, st);
}

// Clusters of `splits` blocks of the kernel (x type `xtype`) for row tile
// `rt` that the card holds at once (cudaOccupancyMaxActiveClusters);
// negative on error.
int sequoia_qmm4_sm90_max_clusters(int xtype, int rt, int splits) {
  if (splits < 1 || splits > kMaxSplit) return -1;
  if (xtype == kXS8) return dispatch_clusters<XS8>(rt, splits);
  if (xtype == kXPlanes) return dispatch_clusters<XPlanes>(rt, splits);
  return dispatch_clusters<XBf16>(rt, splits);
}

}  // extern "C"
