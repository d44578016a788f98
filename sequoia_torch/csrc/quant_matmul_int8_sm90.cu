// int8-weight matmuls on Hopper's wgmma + TMA, one templated kernel with
// three instantiations:
//   weight-only: out[R, N] = (x[R, K] bf16 @ q[K, N] int8) * scale[N], f32
//     accumulation, cast once (replaces the Pallas kernel
//     sequoia_tpu/kernels/quant_matmul.py::quant_matmul bits=8, _kernel_int8);
//   weight-only with f32 x (the planes instantiation): the same product of
//     x f32, given as its three bf16 planes [3, R, K] (x = b0 + b1 + b2
//     exactly; split_bf16x3.cu, the kernel launched right before), so that
//     every product runs exact on the bf16 tensor cores (replaces
//     _kernel_int8 at f32 x, and the port's first, CUDA-core kernel);
//   w8a8: out = float(x8[R, K] @ q[K, N]) * sx[r] * scale[n], in that order,
//     the int8 product exact in int32 (the w8a8 route of
//     sequoia_tpu/quant/qtensor.py::_matmul_w8a8, an XLA int8 dot there; x8
//     and sx come from the activation quantizer of quant_matmul_a8.cu,
//     the kernel launched right before this one).
// q keeps JAX's [K, N] layout; nothing is re-laid out at load time.
//
// Bound on the H100: the weight stream. At (K, N) = (4096, 11008) the int8
// weight is 45 MB, 0.0135 ms at 3.35 TB/s; 2*R*K*N bf16 operations pass the
// bytes only near R = 148 (int8 operations near R = 295; f32 x, three bf16
// passes, near R = 49).
//
// Design: the weight is streamed once for every R <= 256.
// - A and B are swapped: out^T[N, R] = W^T[N, K] x^T[K, R]. The weight tile
//   is wgmma's 64-row A operand, in registers; x (or x8) [R, K] is the B
//   operand, K-major in shared memory, as wgmma wants it for bf16 and s8
//   alike; R is wgmma's N (8..256). One block covers all R rows (up to 256)
//   of its 128 output columns, so each weight byte crosses device memory
//   once. R > 256 runs ceil(R / 256) row tiles (grid z).
// - A block is one producer warpgroup and two consumer warpgroups (64
//   weight columns each); setmaxnreg moves the producer's registers to the
//   consumers (40 / 232), which the 256-row tile's 128 accumulators need.
//   The producer's lane 0 keeps a ring of up to 16 stages full with TMA
//   (one stage: 64 k of bf16 x or 128 k of x8, i.e. 128-byte rows of x, and
//   the matching 128-byte rows of q), each completion counted on the
//   stage's "full" mbarrier; every consumer warp arrives on its "empty"
//   mbarrier once the wgmmas that read the stage have completed. Both tiles
//   land in the 128-byte swizzle, which the wgmma descriptor of x reads
//   directly and which puts q's 16-bit reads on distinct banks (bf16; s8's
//   are at most 2-way).
// - The A fragment (per warp, the mma.sync A layout of its 16 rows) needs
//   k-pairs (bf16) or k-quads (s8) of one weight column, and q keeps a
//   column's k in different rows. M-row g of a warp is weight column 2g of
//   its 16 and row g + 8 column 2g + 1, so one 16-bit load per k row holds
//   both of a lane's columns; prmt byte permutes transpose those loads into
//   the fragment. bf16: each byte then becomes an exact bf16 (the 2^23
//   trick, int8x4_to_bf16); s8 takes the bytes as they are.
// - Each k step's fragment has registers of its own, fenced, and its wgmmas
//   form one commit group; a stage's groups run while the next stage's
//   fragments are built, and the previous stage's are waited for once per
//   stage. ptxas serializes every wgmma of the kernel if a register that a
//   wgmma in flight reads is rewritten, which the allocator otherwise does
//   for a fragment read by a single wgmma: the fragments are read once more
//   after their wgmmas are done, which keeps them in registers of their own.
// - K is split across the 1-4 blocks of a thread-block cluster where the
//   column tiles alone would leave SMs idle: the largest split whose
//   clusters all fit on the card in one wave (kernels/quant_matmul.py::
//   split_cluster, from the card's cluster occupancy). Each block stages its
//   partial [R, 128] tile in its own shared memory; after a cluster barrier,
//   rank b reduces the rows r with r % split == b over the ranks in rank
//   order through distributed shared memory, applies the scale (and sx) and
//   stores whole row segments. No device-memory workspace, no second launch.
// - TMA needs 16-byte strides: N % 16 == 0 for q, and K % 8 (bf16) or
//   K % 16 (int8) for x. Other shapes (no model of the repo has one) take the
//   same kernel with the producer warp copying the stages itself, masked,
//   into the same swizzled layout; the choice is made before the launch.
// - Capturable in a CUDA graph: the tensor maps are encoded on the host per
//   call and passed by value (__grid_constant__), the shared-memory
//   attribute is set once per instantiation, nothing synchronizes.
// - w8a8 and planes: a programmatic dependent launch after the quantizer
//   or the split (which trigger their dependents as they start). The
//   producer sets up the barriers, prefetches the tensor maps and issues
//   the weight boxes of the first kPdlStages ring stages while that kernel
//   still runs; then it waits for its grid (grid_dep_wait) before the first
//   x box, and each w8a8 consumer before it reads sx. The bf16
//   instantiation launches and loads as before.
// - f32 x, the planes instantiation (P = 3): a stage holds the weight tile
//   and one x tile per plane, all three in one 3-D TMA box over [3, R, K];
//   each consumer builds a k step's fragment once, as for bf16 x, and
//   issues one wgmma per plane into the same accumulator, in plane order,
//   in the step's commit group. A product of a plane's bf16 value and an
//   integer |w| <= 128 has at most 16 significant bits, so it is exact in
//   f32: only the tensor cores' f32 summation, which truncates, differs
//   from the plain version (1e-5 to 3e-5 of the largest |output| against
//   an f64 product on the H100; PERF.md §6). Three x tiles a stage leave
//   fewer stages, so the row tile stops at kMaxRTPlanes = 128 (4 stages of
//   56 KB in a 224 KB budget; a cap of 64 was slower at 5 of the 8 7B
//   shapes and R in {128, 256}, 16% summed over them, on an H100 80GB
//   HBM3); R = 256 runs two row tiles, the second reading the weight from L2.

#include "qmm_sm90.cuh"

namespace {

using namespace sq;
using namespace sq::sm90;

constexpr int kSmemBudget = 200 * 1024;

// P: x planes a stage (1, or kPlanes for f32 x split into bf16 planes).
template <bool A8, int P, int RT>
struct Cfg {
  static constexpr bool kDep = A8 || P > 1;          // x is the output of the kernel before
  static constexpr int kKB = A8 ? 128 : 64;          // k per stage: 128 bytes of an x row
  static constexpr int kPlaneBytes = RT * kRowBytes; // one plane's x tile: RT rows
  static constexpr int kXBytes = P * kPlaneBytes;
  static constexpr int kQBytes = kKB * kRowBytes;    // q tile: kKB rows of kBM bytes
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kStages =
      min_int((P > 1 ? kPlanesSmemBudget : kSmemBudget) / kStageBytes, kMaxStages);
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static constexpr int kChunkN = RT < 64 ? RT : 64;  // wgmma N of one instruction
  static constexpr int kChunks = RT / kChunkN;
  static constexpr int kSteps = 4;                   // wgmma k steps per stage (16 or 32 k)
  static_assert(kStages >= 4, "at least three stages in flight");
  static_assert(RT * kTileStride * 4 <= kStages * kStageBytes,
                "the output tile reuses the stages");
};

struct Params {
  const void* x;         // [R, K] bf16 (weight-only) or int8 (w8a8); planes: [3, R, K] bf16
  const int8_t* q;       // [K, N]
  const float* sx;       // [R] (w8a8)
  const float* scale;    // [N]
  void* out;             // [R, N] f32 or bf16
  int R, K, N;
  int stages_per_split;  // K stages of each cluster rank
  int out_bf16;
  int tma;               // 1: TMA loads; 0: the producer warp copies (unaligned shapes)
};

// The producer warp's copy of one stage where TMA cannot address the
// tensors: the same bytes in the same swizzled layout, zero outside them.
template <bool A8, int P, int RT>
__device__ void copy_stage(uint8_t* xs, uint8_t* qs, const Params& p, int k0, int r0, int n0,
                           int lane) {
  using C = Cfg<A8, P, RT>;
  constexpr int kWords = RT * (kRowBytes / 4);    // of one plane's tile
  for (int i = lane; i < P * kWords; i += 32) {
    const int pl = P > 1 ? i / kWords : 0, j = P > 1 ? i % kWords : i;
    const int r = j / (kRowBytes / 4), b = (j % (kRowBytes / 4)) * 4, row = r0 + r;
    const int64_t src_row = static_cast<int64_t>(pl) * p.R + row;   // plane pl's row
    uint32_t v = 0;
    if (row < p.R) {
      if (A8) {
        const int8_t* src = static_cast<const int8_t*>(p.x) + src_row * p.K;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + b + e < p.K) v |= uint32_t(static_cast<uint8_t>(src[k0 + b + e])) << (8 * e);
      } else {
        const uint16_t* src = static_cast<const uint16_t*>(p.x) + src_row * p.K;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + b / 2 + e < p.K) v |= uint32_t(src[k0 + b / 2 + e]) << (16 * e);
      }
    }
    *reinterpret_cast<uint32_t*>(xs + pl * C::kPlaneBytes + swz(r, b)) = v;
  }
  for (int i = lane; i < C::kKB * (kRowBytes / 4); i += 32) {
    const int kr = i / (kRowBytes / 4), b = (i % (kRowBytes / 4)) * 4, k = k0 + kr;
    uint32_t v = 0;
    if (k < p.K) {
      const int8_t* src = p.q + static_cast<int64_t>(k) * p.N + n0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + b + j < p.N) v |= uint32_t(static_cast<uint8_t>(src[b + j])) << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(qs + swz(kr, b)) = v;
  }
}

// Byte offsets, in a stage's q tile, of the lane's 16-bit loads (columns
// col and col + 1): row r0 + d with r0 = 2t (bf16, d < 2) or 4t (s8, d < 4)
// is at off[d], and the rows 8 (bf16) or 16 (s8) apart that load_a also
// reads are whole multiples of 8 rows further: the swizzle depends only on
// row % 8, so they are off[d] plus a constant.
template <bool A8>
struct AOffsets {
  static constexpr int kN = A8 ? 4 : 2;
  int off[kN];
  __device__ __forceinline__ AOffsets(int col, int t) {
#pragma unroll
    for (int d = 0; d < kN; ++d) off[d] = swz(kN * t + d, col);
  }
};

// The A fragment of k step ks of a stage for the lane's two weight columns
// col, col+1 (M-rows g and g+8 of its warp) from the stage's q tile `qs`.
// bf16 (16 k): a0 = row g, k 2t..2t+1; a1 = row g+8; a2, a3 the same at
// k + 8. s8 (32 k): a0 = row g, k 4t..4t+3; a1 = row g+8; a2, a3 at k + 16.
// A 16-bit load at (k, col) holds q[k][col] (low byte) and q[k][col + 1].
template <bool A8>
__device__ __forceinline__ void load_a(const uint8_t* qs, const AOffsets<A8>& o, int ks,
                                       uint32_t (&a)[4]) {
  auto h = [&](int d, int rows) -> uint32_t {   // row (kN t + d + rows)
    return *reinterpret_cast<const uint16_t*>(qs + o.off[d] + rows * kRowBytes);
  };
  if (!A8) {
    // [q[k][col], q[k+1][col], q[k][col+1], q[k+1][col+1]], k = 16 ks + 2t
    const uint32_t p0 = __byte_perm(h(0, 16 * ks), h(1, 16 * ks), 0x5140);
    const uint32_t p8 = __byte_perm(h(0, 16 * ks + 8), h(1, 16 * ks + 8), 0x5140);
    int8x4_to_bf16(p0, a[0], a[1]);
    int8x4_to_bf16(p8, a[2], a[3]);
  } else {
    const int k = 32 * ks;   // + 4t
    const uint32_t l01 = __byte_perm(h(0, k), h(1, k), 0x5140);
    const uint32_t l23 = __byte_perm(h(2, k), h(3, k), 0x5140);
    const uint32_t u01 = __byte_perm(h(0, k + 16), h(1, k + 16), 0x5140);
    const uint32_t u23 = __byte_perm(h(2, k + 16), h(3, k + 16), 0x5140);
    a[0] = __byte_perm(l01, l23, 0x5410);   // column col, k .. k+3
    a[1] = __byte_perm(l01, l23, 0x7632);   // column col + 1
    a[2] = __byte_perm(u01, u23, 0x5410);
    a[3] = __byte_perm(u01, u23, 0x7632);
  }
}

template <bool A8, int P, int RT>
__global__ void __launch_bounds__(kThreadsW, 1)
qmm8_sm90(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
          const Params p) {
  using C = Cfg<A8, P, RT>;
  using Acc = typename std::conditional<A8, int, float>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.y * kBM, r0 = blockIdx.z * RT;
  const int nk = (p.K + C::kKB - 1) / C::kKB;
  const int s_begin = rank * p.stages_per_split;
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
    // copies: the whole warp). It gives most of its registers to the
    // consumers and joins only the epilogue's two cluster barriers.
    setmaxnreg_dec<kProducerRegs>();
    const bool loader = warp == 0 && (lane == 0 || !p.tma);
    int pre = 0;   // stages whose weight box went out before the wait (w8a8, planes)
    if constexpr (C::kDep) {
      if (loader) {
        if (p.tma) {
          pre = min(nst, kPdlStages);
          for (int s = 0; s < pre; ++s) {
            uint8_t* qs = smem + s * C::kStageBytes + C::kXBytes;
            mbar_arrive_expect_tx(&full[s], C::kStageBytes);
            tma_load_2d(qs, &qmap, &full[s], n0, (s_begin + s) * C::kKB);
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
      const int k0 = (s_begin + s) * C::kKB;
      if (p.tma) {
        if (s >= pre) mbar_arrive_expect_tx(&full[slot], C::kStageBytes);
        if (P > 1) tma_load_3d(xs, &xmap, &full[slot], k0, r0, 0);   // every plane's box
        else tma_load_2d(xs, &xmap, &full[slot], k0, r0);
        if (s >= pre) tma_load_2d(qs, &qmap, &full[slot], n0, k0);
      } else {
        copy_stage<A8, P, RT>(xs, qs, p, k0, r0, n0, lane);
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
  if constexpr (A8) grid_dep_wait();   // sx is read in the epilogue
  const int wg = warp / 4 - 1, g = lane / 4, t = lane % 4;
  const int col = 64 * wg + 16 * (warp % 4) + 2 * g;   // the lane's columns col, col + 1
  const AOffsets<A8> offs(col, t);
  Acc acc[C::kChunks][C::kChunkN / 2];
#pragma unroll
  for (int j = 0; j < C::kChunks; ++j)
#pragma unroll
    for (int i = 0; i < C::kChunkN / 2; ++i) {
      acc[j][i] = 0;
      fence_reg(acc[j][i]);
    }
  // A stage: the fragments of its k steps are built first (all loads in
  // flight at once), each into registers of its own (a stage's four and the
  // previous stage's four may both feed wgmmas in flight); then each is
  // fenced and its wgmmas form one commit group, so that nothing but wgmmas
  // lies between a fence and its commit. After the stage's four groups are
  // issued, the previous stage's are waited for and its slot released.
  uint32_t af[2][C::kSteps][4];
  uint32_t live = 0;
  auto stage = [&](int s, uint32_t (&a)[C::kSteps][4], uint32_t (&prev)[C::kSteps][4]) {
    const int slot = s % C::kStages;
    mbar_wait(&full[slot], (s / C::kStages) & 1);
    const uint8_t* xs = smem + slot * C::kStageBytes;
    uint64_t dsc[C::kSteps][P][C::kChunks];
    const uint64_t d0 = desc_k128(xs);
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks)
#pragma unroll
      for (int pl = 0; pl < P; ++pl)
#pragma unroll
        for (int j = 0; j < C::kChunks; ++j) {   // plane pl, x rows [64j, 64j + 64), k bytes 32 ks
          dsc[ks][pl][j] = d0 + ((pl * C::kPlaneBytes + j * 64 * kRowBytes) >> 4) + 2 * ks;
          fence_reg(dsc[ks][pl][j]);
        }
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks) load_a<A8>(xs + C::kXBytes, offs, ks, a[ks]);
    // Each k step: one fragment, read by the wgmmas of every plane (exact
    // products: the planes' bf16 values times the weight's integers).
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(a[ks][i]);
      wgmma_fence();
#pragma unroll
      for (int pl = 0; pl < P; ++pl)
#pragma unroll
        for (int j = 0; j < C::kChunks; ++j) wgmma_rs(acc[j], a[ks], dsc[ks][pl][j]);
      wgmma_commit();
    }
    wgmma_wait<C::kSteps>();
    // The previous stage's fragments are read once more (into `live`) after
    // its wgmmas are known to be done, so that the register allocator keeps
    // every fragment in flight in registers of its own: one rewritten under
    // a wgmma in flight makes ptxas serialize all wgmmas.
#pragma unroll
    for (int ks = 0; ks < C::kSteps; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) live ^= prev[ks][i];
    if (s > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % C::kStages]);
  };
  for (int s = 0; s < nst; s += 2) {
    stage(s, af[0], af[1]);
    if (s + 1 < nst) stage(s + 1, af[1], af[0]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < C::kChunks; ++j)
#pragma unroll
    for (int i = 0; i < C::kChunkN / 2; ++i) fence_reg(acc[j][i]);

  cluster_epilogue<RT, C::kChunks, C::kChunkN>(cluster, acc, live, smem, col, t, r0, n0, p.R,
                                                p.N, sc, p.sx, p.out, p.out_bf16);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <bool A8, int P, int RT>
cudaError_t set_smem() {
  static bool done = false;   // above 48 KB only after this attribute; once
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm8_sm90<A8, P, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<A8, P, RT>::kSmem);
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

template <bool A8, int P, int RT>
cudaError_t launch(const Params& p, int splits, bool pdl, cudaStream_t st) {
  using C = Cfg<A8, P, RT>;
  cudaError_t err = set_smem<A8, P, RT>();
  if (err != cudaSuccess) return err;
  CUtensorMap xmap, qmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&qmap, 0, sizeof(qmap));
  if (p.tma) {
    const uint64_t xrow = static_cast<uint64_t>(p.K) * (A8 ? 1 : 2);
    bool ok;
    if (P > 1) {   // [P, R, K] bf16, boxes [P, RT, 64]: the stage's planes back to back
      const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.K), static_cast<cuuint64_t>(p.R),
                                  P};
      const cuuint64_t strides[2] = {xrow, xrow * p.R};
      const cuuint32_t box[3] = {C::kKB, RT, P};
      ok = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, 3, dims, strides, box);
    } else {
      ok = encode_2d(&xmap, A8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     p.x, p.K, p.R, xrow, C::kKB, RT);
    }
    ok = ok && encode_2d(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, p.N, p.K, p.N, kBM, C::kKB);
    if (!ok) return cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      launch_config(splits, p.N, p.R, RT, C::kSmem, st, attr, C::kDep && pdl);
  return cudaLaunchKernelEx(&cfg, qmm8_sm90<A8, P, RT>, xmap, qmap, p);
}

template <bool A8, int P, int RT>
int clusters(int splits) {
  if (set_smem<A8, P, RT>() != cudaSuccess) return -1;
  return max_clusters(reinterpret_cast<const void*>(qmm8_sm90<A8, P, RT>), splits, RT,
                      Cfg<A8, P, RT>::kSmem);
}

// Row tiles up to 256; the planes instantiation up to kMaxRTPlanes (three
// x tiles a stage: 4 stages of 56 KB at 128 rows).
constexpr int kMaxRTPlanes = 128;

template <bool A8, int P>
int dispatch(const Params& p, int rt, int splits, bool pdl, cudaStream_t st) {
  switch (rt) {
    case 8: return launch<A8, P, 8>(p, splits, pdl, st);
    case 16: return launch<A8, P, 16>(p, splits, pdl, st);
    case 32: return launch<A8, P, 32>(p, splits, pdl, st);
    case 64: return launch<A8, P, 64>(p, splits, pdl, st);
    case 128: return launch<A8, P, 128>(p, splits, pdl, st);
    default:
      if constexpr (P > 1) return cudaErrorInvalidValue;
      else return launch<A8, P, 256>(p, splits, pdl, st);
  }
}

template <bool A8, int P>
int dispatch_clusters(int rt, int splits) {
  switch (rt) {
    case 8: return clusters<A8, P, 8>(splits);
    case 16: return clusters<A8, P, 16>(splits);
    case 32: return clusters<A8, P, 32>(splits);
    case 64: return clusters<A8, P, 64>(splits);
    case 128: return clusters<A8, P, 128>(splits);
    default:
      if constexpr (P > 1) return -1;
      else return clusters<A8, P, 256>(splits);
  }
}

}  // namespace

extern "C" {

// x (xtype kXBf16: bfloat16 [R, K]; kXS8: int8 x8 [R, K] with sx [R]
// float32; kXPlanes: the bfloat16 planes [3, R, K] of f32 x,
// split_bf16x3.cu), q int8 [K, N], scale float32 [N], out [R, N] (out_dtype
// 0 = float32, 1 = bfloat16); row tiles of `rt` rows (8, 16, .., 256; planes
// up to kMaxRTPlanes); K split over a cluster of `splits` (1..4) blocks. x
// and q 16-byte aligned; the wrapper checks shapes, types and alignment and
// picks rt and splits. TMA when the strides allow it (see the file note).
// pdl = 1 (x8, planes): a programmatic dependent launch after the kernel
// that wrote x.
int sequoia_qmm8_sm90(const void* x, const void* q, const void* sx, const void* scale, void* out,
                      int R, int K, int N, int xtype, int rt, int splits, int out_dtype, int pdl,
                      void* stream) {
  const bool a8 = xtype == kXS8;
  if (R <= 0 || K <= 0 || N <= 0 || splits < 1 || splits > kMaxSplit || out_dtype < 0 ||
      out_dtype > 1 || xtype < kXBf16 || xtype > kXPlanes || (a8 && sx == nullptr) || rt < 8 ||
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
  const int kb = a8 ? 128 : 64;
  const int nk = (K + kb - 1) / kb;
  p.stages_per_split = (nk + splits - 1) / splits;
  p.out_bf16 = out_dtype;
  p.tma = N % 16 == 0 && K % (a8 ? 16 : 8) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a8) return dispatch<true, 1>(p, rt, splits, pdl != 0, st);
  if (xtype == kXPlanes) return dispatch<false, kPlanes>(p, rt, splits, pdl != 0, st);
  return dispatch<false, 1>(p, rt, splits, false, st);
}

// Clusters of `splits` blocks of the kernel (x type `xtype`) for row tile
// `rt` that the card holds at once (cudaOccupancyMaxActiveClusters);
// negative on error.
int sequoia_qmm8_sm90_max_clusters(int xtype, int rt, int splits) {
  if (splits < 1 || splits > kMaxSplit) return -1;
  if (xtype == kXS8) return dispatch_clusters<true, 1>(rt, splits);
  if (xtype == kXPlanes) return dispatch_clusters<false, kPlanes>(rt, splits);
  return dispatch_clusters<false, 1>(rt, splits);
}

}  // extern "C"
