// Packed-int4 weight matmuls with bf16 activations on Hopper's wgmma + TMA,
// one kernel for both weight layouts:
//   out[R, N] = (x[R, K] @ w[K, N]) * scale[N], f32 accumulation, cast once,
// with q[K/2, N] int8 half-split packed: byte [k, n] holds w[k, n] in its
// low nibble and w[K/2 + k, n] in its high nibble, both signed (0x8 is -8).
// Replaces the Pallas kernels sequoia_tpu/kernels/quant_matmul.py::
// quant_matmul bits=4 (_kernel_int4, its "shift" and "float" unpacks compute
// the same numbers) and ::quant_matmul_tiled (_kernel_int4_tiled: the same
// product over q[ceil(N / 128), K/2, 128], panel n holding columns
// [128 n, 128 n + 128), zero past N). The nibble -> bf16 conversion is
// exact, so the products are the plain version's; only the order of the f32
// sums differs.
//
// Bound on the H100: the weight stream at the rows of a tree verify. At
// (K, N) = (4096, 11008) the packed weight is 22.5 MB, 0.0067 ms at 3.35
// TB/s; 2*R*K*N operations at the bf16 peak of 989 TFLOP/s pass it near
// R = 74.
//
// Design: the block, ring and cluster structure of quant_matmul_int8_sm90.cu
// (its file note; the shared pieces are in qmm_sm90.cuh). What differs:
// - A and B are swapped as there (out^T = W^T x^T): the int4 weight tile is
//   wgmma's register A operand, x the K-major B operand in shared memory, R
//   wgmma's N; one block holds all R <= 256 rows of its 128 columns, so the
//   weight crosses device memory once.
// - One stage is 64 packed q rows (64 x 128 bytes). They carry the logical
//   k [kp, kp + 64) in their low nibbles and [K/2 + kp, ..) in their high
//   nibbles, so the stage holds two x boxes of one 2-D tensor map of x, at
//   columns kp and K/2 + kp, each RT rows of 128 bytes in the 128-byte
//   swizzle. Where K/2 is not a multiple of 64, the low box of the last
//   stage reaches into the high half of x; those columns meet the zero q
//   rows past K/2, which TMA fills.
// - M-row g of a warp is weight column c = 2g of its 16 and row g + 8 is
//   column c + 1, as in the int8 kernel, so a lane needs, per pair of k
//   rows, the 16-bit column pair (c, c + 1) of both rows. Read as a matrix
//   of 16-bit elements, that is what ldmatrix .trans delivers: one
//   ldmatrix.x4.trans per two k steps (lanes 8m .. 8m + 7 address the
//   16-byte row chunks of the warp's columns in 8-row matrix m) leaves in
//   each register P = [q[k][c], q[k][c + 1], q[k + 1][c], q[k + 1][c + 1]]
//   (k = 2t of the matrix), conflict-free in the swizzle. P, P >> 4, P >> 8
//   and P >> 12 then hold, at bits 0-3 and 16-19, the k pair of column c's
//   low nibbles, c's high, c + 1's low and c + 1's high: four fragment
//   registers of the two wgmmas of a k step (low box, high box). Each
//   becomes a bf16x2 in two instructions (nibbles_bf16): the nibble u goes
//   into the mantissa of bf16 128.0, (u ^ 8) | 0x4300 = 128 + (v + 8) for
//   the signed value v, and one fma.rn.bf16x2 subtracts 136, exactly. About
//   22 instructions a lane for a k step's two fragments, where the int8
//   kernel's 16-bit loads and f32 conversion spend about 28 on one.
// - Stage depth: all row tiles take 64-row stages in the 128-byte swizzle
//   (one descriptor layout, one copy path); the ring fills a 216 KB budget,
//   up to 16 stages: RT <= 16 16, RT 32 13, RT 64 9, RT 128 5, RT 256 3
//   (72 KB a stage; 32-row stages in the 64-byte swizzle would give 5 of 36
//   KB at the same bytes in flight).
// - The fragments of a batch of k steps (a whole stage; half of one at RT =
//   256, where 128 accumulators leave fewer registers) are built first, the
//   ldmatrix loads ahead of the conversions, each step's two fragments in
//   registers of their own; each step's wgmmas form one commit group, and
//   the previous batch's groups are waited for once per batch and its
//   fragments read once more (`live`), so that ptxas never rewrites a
//   register that a wgmma in flight reads (C7513).
// - The tiled layout is a 3-D tensor map over q [nt, K/2, 128] with the box
//   [1, 64, 128]: a box never crosses into the next panel, rows past K/2
//   arrive as zeros, and block column tile y reads panel y. The logical N
//   comes from the scale; the last panel's columns past N are computed on
//   the stored zeros and not written.
// - K split over a 1-4-block cluster with the DSMEM reduction, the producer
//   warp's masked copies where TMA cannot address the tensors (K % 8 != 0,
//   or N % 16 != 0 row-major), the CUDA-graph capture: as in the int8
//   kernel, chosen before the launch.
// - The activation type is a template parameter (XBf16): w4a8 follows as a
//   second instantiation with x8 boxes of 128 k, s32 accumulation and a
//   fragment builder that sign-extends the nibbles into bytes.

#include "qmm_sm90.cuh"

namespace {

using namespace sq;
using namespace sq::sm90;

constexpr int kSmemBudget = 216 * 1024;
constexpr int kKp = 64;          // packed q rows per stage

// The two nibbles at bits 0-3 and 16-19 of w (unsigned u, standing for the
// signed v = (u ^ 8) - 8) as a bf16x2, exactly: 0x4300 | (u ^ 8) is the bf16
// 128 + v + 8, and 1.0 * that - 136.0 is v.
__device__ __forceinline__ uint32_t nibbles_bf16(uint32_t w) {
  const uint32_t b = (w & 0x000F000Fu) ^ 0x43084308u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(b), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// bf16 activations: wgmma k16, f32 accumulation.
struct XBf16 {
  using Acc = float;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kItem = 2;                    // bytes per x element
  static constexpr int kStepK = 16;                  // packed rows per wgmma k step
  // The A fragments of one k step from its two words P (P[e]: q rows 2t
  // and 2t + 1 of the step, + 8 e, at columns col and col + 1: [q[k][col],
  // q[k][col + 1], q[k + 1][col], q[k + 1][col + 1]]): lo against the low x
  // box, hi against the high one. a0 = M-row g (column col), k 2t and
  // 2t + 1; a1 = M-row g + 8 (col + 1); a2, a3 the same at k + 8.
  __device__ __forceinline__ static void fragments(const uint32_t (&P)[2], uint32_t (&lo)[4],
                                                   uint32_t (&hi)[4]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t w = P[e];
      lo[2 * e] = nibbles_bf16(w);
      hi[2 * e] = nibbles_bf16(w >> 4);
      lo[2 * e + 1] = nibbles_bf16(w >> 8);
      hi[2 * e + 1] = nibbles_bf16(w >> 12);
    }
  }
};

template <class X, int RT>
struct Cfg {
  static constexpr int kBoxBytes = RT * kRowBytes;   // one x box: RT rows of 128 bytes
  static constexpr int kXBytes = 2 * kBoxBytes;      // the low-half and the high-half box
  static constexpr int kQBytes = kKp * kRowBytes;    // q tile: kKp rows of kBM bytes
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kStages = min_int(kSmemBudget / kStageBytes, kMaxStages);
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static constexpr int kChunkN = RT < 64 ? RT : 64;  // wgmma N of one instruction
  static constexpr int kChunks = RT / kChunkN;
  static constexpr int kSteps = kKp / X::kStepK;     // k steps per stage
  static constexpr int kBatch = RT >= 256 ? 2 : kSteps;   // k steps whose fragments are built together
  static constexpr int kBatches = kSteps / kBatch;   // batches per stage
  static_assert(kRowBytes / X::kItem == kKp, "an x box row holds the stage's k");
  static_assert(kStages >= 3, "two stages in flight while one is read");
  static_assert(RT * kTileStride * 4 <= kStages * kStageBytes,
                "the output tile reuses the stages");
};

struct Params {
  const void* x;         // [R, K]
  const int8_t* q;       // [K/2, N], or the panels [ceil(N / 128), K/2, 128]
  const float* scale;    // [N]
  void* out;             // [R, N] f32 or bf16
  int R, K, N;
  int stages_per_split;  // K stages of each cluster rank
  int out_bf16;
  int tma;               // 1: TMA loads; 0: the producer warp copies (unaligned shapes)
  int tiled;             // 1: q is the panel layout
};

// The producer warp's copy of one stage where TMA cannot address the
// tensors: the same bytes in the same swizzled layout, zero outside them
// (here the low box stops at K/2 too).
template <class X, int RT>
__device__ void copy_stage(uint8_t* xs, uint8_t* qs, const Params& p, int kp, int r0, int n0,
                           int lane) {
  using C = Cfg<X, RT>;
  constexpr int kWords = kRowBytes / 4, kPer = 4 / X::kItem;
  const int Kq = p.K / 2;
  for (int i = lane; i < 2 * RT * kWords; i += 32) {
    const int half = i / (RT * kWords), j = i % (RT * kWords);
    const int r = j / kWords, b = (j % kWords) * 4, row = r0 + r, k = kp + b / X::kItem;
    uint32_t v = 0;
    if (row < p.R) {
      const uint8_t* src = static_cast<const uint8_t*>(p.x) +
                           (static_cast<int64_t>(row) * p.K + half * Kq) * X::kItem;
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (k + e < Kq) {
          uint32_t w = 0;
          memcpy(&w, src + (k + e) * X::kItem, X::kItem);
          v |= w << (8 * X::kItem * e);
        }
    }
    *reinterpret_cast<uint32_t*>(xs + half * C::kBoxBytes + swz(r, b)) = v;
  }
  const int ncols = p.tiled ? kBM : p.N - n0;
  for (int i = lane; i < kKp * kWords; i += 32) {
    const int kr = i / kWords, b = (i % kWords) * 4, k = kp + kr;
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
    for (int s = 0; warp == 0 && s < nst && (lane == 0 || !p.tma); ++s) {
      const int slot = s % C::kStages;
      if (s >= C::kStages) mbar_wait(&empty[slot], ((s / C::kStages) & 1) ^ 1);
      uint8_t* xs = smem + slot * C::kStageBytes;
      uint8_t* qs = xs + C::kXBytes;
      const int kp = (s_begin + s) * kKp;
      if (p.tma) {
        mbar_arrive_expect_tx(&full[slot], C::kStageBytes);
        tma_load_2d(xs, &xmap, &full[slot], kp, r0);
        tma_load_2d(xs + C::kBoxBytes, &xmap, &full[slot], p.K / 2 + kp, r0);
        if (p.tiled) tma_load_3d(qs, &qmap, &full[slot], 0, kp, blockIdx.y);
        else tma_load_2d(qs, &qmap, &full[slot], n0, kp);
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
  const int wg = warp / 4 - 1, g = lane / 4, t = lane % 4;
  const int col = 64 * wg + 16 * (warp % 4) + 2 * g;   // the lane's columns col, col + 1
  // ldmatrix.x4.trans: lanes 8m .. 8m + 7 give the row addresses of matrix
  // m, rows k0 + 8m + lane % 8 of the 16 bytes of the warp's 16 columns
  // (8 column pairs); lane (g, t) then holds, of matrix m, rows 2t and 2t + 1
  // of column pair g: the word P of q rows k0 + 8m + 2t, + 1 at col, col + 1.
  // k0 is a multiple of 8 and the swizzle depends only on row % 8.
  const int ldm_off = swz(lane % 8, col - 2 * g) + (lane / 8) * 8 * kRowBytes;
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
    const uint8_t* qs = xs + C::kXBytes + ks0 * X::kStepK * kRowBytes;
    uint32_t P[C::kBatch][2];   // step j: matrices 2j, 2j + 1 (rows 16 j, 16 j + 8)
#pragma unroll
    for (int j = 0; j < C::kBatch; j += 2) {
      uint32_t r[4];
      ldsm_x4_trans(r, qs + ldm_off + j * X::kStepK * kRowBytes);
      P[j][0] = r[0];
      P[j][1] = r[1];
      P[j + 1][0] = r[2];
      P[j + 1][1] = r[3];
    }
#pragma unroll
    for (int j = 0; j < C::kBatch; ++j) X::fragments(P[j], a[j][0], a[j][1]);
    uint64_t d[2] = {desc_k128(xs) + 2 * ks0, desc_k128(xs + C::kBoxBytes) + 2 * ks0};
    fence_reg(d[0]);
    fence_reg(d[1]);
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
        for (int c = 0; c < C::kChunks; ++c)   // x rows [64c, 64c + 64): 8 KB further
          wgmma_rs(acc[c], a[j][hh], d[hh] + 2 * j + ((c * 64 * kRowBytes) >> 4));
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
    for (int i = 0; i < C::kChunkN / 2; ++i) fence_reg(acc[j][i]);

  cluster_epilogue<RT, C::kChunks, C::kChunkN>(cluster, acc, live, smem, col, t, r0, n0, p.R,
                                                p.N, sc, nullptr, p.out, p.out_bf16);
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
cudaError_t launch(const Params& p, int splits, cudaStream_t st) {
  using C = Cfg<X, RT>;
  cudaError_t err = set_smem<X, RT>();
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, qmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&qmap, 0, sizeof(qmap));
  if (p.tma) {
    const uint64_t Kq = p.K / 2;
    bool ok = encode_2d(&xmap, X::kMapType, p.x, p.K, p.R,
                        static_cast<uint64_t>(p.K) * X::kItem, kRowBytes / X::kItem, RT);
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
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(splits, p.N, p.R, RT, C::kSmem, st, attr);
  return cudaLaunchKernelEx(&cfg, qmm4_sm90<X, RT>, xmap, qmap, p);
}

template <class X, int RT>
int clusters(int splits) {
  if (set_smem<X, RT>() != cudaSuccess) return -1;
  return max_clusters(reinterpret_cast<const void*>(qmm4_sm90<X, RT>), splits, RT,
                      Cfg<X, RT>::kSmem);
}

template <class X>
int dispatch(const Params& p, int splits, cudaStream_t st) {
  switch (row_tile(p.R)) {
    case 8: return launch<X, 8>(p, splits, st);
    case 16: return launch<X, 16>(p, splits, st);
    case 32: return launch<X, 32>(p, splits, st);
    case 64: return launch<X, 64>(p, splits, st);
    case 128: return launch<X, 128>(p, splits, st);
    default: return launch<X, 256>(p, splits, st);
  }
}

template <class X>
int dispatch_clusters(int rt, int splits) {
  switch (rt) {
    case 8: return clusters<X, 8>(splits);
    case 16: return clusters<X, 16>(splits);
    case 32: return clusters<X, 32>(splits);
    case 64: return clusters<X, 64>(splits);
    case 128: return clusters<X, 128>(splits);
    default: return clusters<X, 256>(splits);
  }
}

}  // namespace

extern "C" {

// x bfloat16 [R, K] (K even), q int8 packed [K/2, N] (tiled = 0) or panels
// [ceil(N / 128), K/2, 128] (tiled = 1), scale float32 [N], out [R, N]
// (out_dtype 0 = float32, 1 = bfloat16); K split over a cluster of `splits`
// (1..4) blocks. x and q 16-byte aligned; the wrapper checks shapes, types
// and alignment. TMA when the strides allow it (see the file note).
int sequoia_qmm4_sm90(const void* x, const void* q, const void* scale, void* out, int R, int K,
                      int N, int tiled, int splits, int out_dtype, void* stream) {
  if (R <= 0 || K <= 0 || K % 2 || N <= 0 || splits < 1 || splits > kMaxSplit ||
      out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.R = R;
  p.K = K;
  p.N = N;
  const int nk = (K / 2 + kKp - 1) / kKp;
  p.stages_per_split = (nk + splits - 1) / splits;
  p.out_bf16 = out_dtype;
  p.tiled = tiled != 0;
  p.tma = (tiled || N % 16 == 0) && K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(q) % 16 == 0;
  return dispatch<XBf16>(p, splits, static_cast<cudaStream_t>(stream));
}

// Clusters of `splits` blocks of the kernel for row tile `rt` that the card
// holds at once (cudaOccupancyMaxActiveClusters); negative on error.
int sequoia_qmm4_sm90_max_clusters(int rt, int splits) {
  if (splits < 1 || splits > kMaxSplit) return -1;
  return dispatch_clusters<XBf16>(rt, splits);
}

}  // extern "C"
