// What the two wgmma + TMA quantized matmuls (quant_matmul_int8_sm90.cu,
// quant_matmul_int4_sm90.cu) share: the block geometry, the 128- and
// 64-byte swizzles, the tensor-map encoding and launch set-up on the host
// (with programmatic dependent launch for the int8-activation routes), and
// the consumers' epilogue, which reduces the K split of a cluster through
// distributed shared memory. The file notes of the two kernels describe
// the design.

#pragma once

#include <cuda.h>
#include <dlfcn.h>
#include <cooperative_groups.h>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace sq {
namespace sm90 {

namespace cg = cooperative_groups;

constexpr int kConsumers = 2;                        // warpgroups, 64 weight columns each
constexpr int kBM = 64 * kConsumers;                 // output columns per block
constexpr int kThreadsW = 128 * (kConsumers + 1);    // the producer warpgroup first
constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // 128 * 40 + 256 * 232 <= 65536
constexpr int kRowBytes = 128;                       // one swizzled tile row (= kBM bytes of q)
constexpr int kTileStride = kBM + 4;                 // words per row of the staged output tile
constexpr int kMaxStages = 16;                       // bytes in flight for the small row tiles
constexpr int kMaxRT = 256;
constexpr int kMaxSplit = 4;                         // blocks per cluster, each a slice of K
// Ring stages whose weight boxes an int8-activation route issues before it
// waits for the quantizer's grid. More delay the first x8 box behind them
// once the quantizer is done: in throwaway builds on an H100 80GB HBM3,
// two beat the whole ring (most at R = 1) and none at R = 1..256.
constexpr int kPdlStages = 2;
// The activation types of x, numbered as the C entries' `xtype`: bf16, int8
// x8 (w8a8, w4a8), or f32 x as three bf16 planes [3, R, K] (split_bf16x3.cu).
enum XType : int { kXBf16 = 0, kXS8 = 1, kXPlanes = 2 };
constexpr int kPlanes = 3;
// The planes instantiations' shared-memory budget: three x tiles a stage
// leave the 200-216 KB of the other instantiations one or two stages fewer
// (the row tiles they take still fit their stages: 4 at the largest).
constexpr int kPlanesSmemBudget = 224 * 1024;

constexpr int min_int(int a, int b) { return a < b ? a : b; }

// Byte offset of (row, byte) in a tile of 128-byte rows in the 128-byte
// swizzle: the row's 16-byte chunks are permuted by row % 8 (the tile is
// 1024-byte aligned), as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes them.
__device__ __forceinline__ int swz(int row, int byte) {
  return row * kRowBytes + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// The same for a tile of 64-byte rows in the 64-byte swizzle
// (CU_TENSOR_MAP_SWIZZLE_64B; the tile 512-byte aligned): the row's four
// 16-byte chunks are permuted by (row / 2) % 4.
__device__ __forceinline__ int swz64(int row, int byte) {
  return row * 64 + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15);
}

// The scales of the 4 output columns that this consumer thread stores in
// cluster_epilogue (the same columns for every row it stores: its stride
// is a multiple of kBM / 4 threads), loaded before the main loop so that
// their latency is hidden.
__device__ __forceinline__ float4 epilogue_scale(const float* scale, int n0, int N) {
  const int n = n0 + ((threadIdx.x - 128) % (kBM / 4)) * 4;
  return make_float4(n < N ? scale[n] : 0.f, n + 1 < N ? scale[n + 1] : 0.f,
                     n + 2 < N ? scale[n + 2] : 0.f, n + 3 < N ? scale[n + 3] : 0.f);
}

// The epilogue of the consumer warpgroups, after their last wgmma is done:
// the block's partial [RT, kBM] tile (D fragment: M-row g is column col,
// M-row g + 8 column col + 1, at r = 8 i + 2 t + e of each chunk) goes,
// transposed to [r][column], over the stages once both consumer warpgroups
// are done with them. After a cluster barrier, rank `rank` reduces rows r =
// rank, rank + csize, ... over the ranks in rank order, applies the scale
// (`sc`, from epilogue_scale; and sx: int8 activations) and stores 4
// columns per step. `live` is the consumers' fragment checksum, kept by a
// store that never runs.
template <int RT, int kChunks, int kChunkN, typename Acc>
__device__ __forceinline__ void cluster_epilogue(cg::cluster_group& cluster,
                                                 Acc (&acc)[kChunks][kChunkN / 2], uint32_t live,
                                                 uint8_t* smem, int col, int t, int r0, int n0,
                                                 int R, int N, float4 sc, const float* sx,
                                                 void* out, int out_bf16) {
  constexpr bool A8 = std::is_same<Acc, int>::value;
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  named_barrier(1, 4 * 32 * kConsumers);
  Acc* tile = reinterpret_cast<Acc*>(smem);   // [RT][kTileStride]
  if (R < 0) reinterpret_cast<uint32_t*>(tile)[threadIdx.x] = live;   // never: a use of `live`
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
#pragma unroll
    for (int i = 0; i < kChunkN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = j * kChunkN + 8 * i + 2 * t + e;
        Acc* dst = tile + r * kTileStride + col;
        dst[0] = acc[j][4 * i + e];
        dst[1] = acc[j][4 * i + 2 + e];
      }
  cluster.sync();   // every rank's tile is written and visible across the cluster

  const int rows = min(RT, R - r0);
  const int my_rows = rows > rank ? (rows - rank + csize - 1) / csize : 0;
  const bool vec = N % 4 == 0;
  using Vec = typename std::conditional<A8, int4, float4>::type;
#pragma unroll 2
  for (int i = threadIdx.x - 128; i < my_rows * (kBM / 4); i += 128 * kConsumers) {
    const int r = rank + (i / (kBM / 4)) * csize, c = (i % (kBM / 4)) * 4, n = n0 + c;
    if (n >= N) continue;
    // Every rank's 16 bytes are loaded first (one round of latency through
    // distributed shared memory), then added in rank order.
    Vec part[kMaxSplit];
#pragma unroll
    for (int b = 0; b < kMaxSplit; ++b)
      if (b < csize)
        part[b] = *reinterpret_cast<const Vec*>(cluster.map_shared_rank(tile, b) +
                                                r * kTileStride + c);
    Acc v[4] = {part[0].x, part[0].y, part[0].z, part[0].w};
#pragma unroll
    for (int b = 1; b < kMaxSplit; ++b)
      if (b < csize) {
        v[0] += part[b].x;
        v[1] += part[b].y;
        v[2] += part[b].z;
        v[3] += part[b].w;
      }
    const int64_t base = static_cast<int64_t>(r0 + r) * N + n;
    const float s[4] = {sc.x, sc.y, sc.z, sc.w};
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = A8 ? static_cast<float>(v[e]) * sx[r0 + r] * s[e] : static_cast<float>(v[e]) * s[e];
    if (vec && out_bf16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + base) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    } else if (vec) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + base) =
          make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) store_out(out, base + e, y[e], out_bf16);
    }
  }
  cluster.sync();   // no block leaves while another rank reads its tile
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeFn = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up in libcuda.so.1, which the CUDA runtime
// has loaded (no link against libcuda).
inline EncodeFn encoder() {
  static EncodeFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A tensor of `rank` (2 or 3) dimensions, innermost first (`dims`; `strides`:
// the byte strides of dimensions 1 .. rank-1), read in boxes `box` in the
// swizzle `swizzle`, zero-filled outside the tensor.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                   const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A 2-D row-major tensor [outer, inner] of `row_bytes` per row, boxes
// [box_outer, box_inner].
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                      uint64_t inner, uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
                      uint32_t box_outer,
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  return encode(map, type, base, 2, dims, strides, box, swizzle);
}

// A launch over `splits`-block clusters (grid x), kBM-column tiles (y) and
// RT-row tiles (z), with `smem` bytes of dynamic shared memory; `pdl`: a
// programmatic dependent launch (common.cuh, grid_dep_wait) after the
// kernel before it in the stream. `attr` holds two attributes.
inline cudaLaunchConfig_t launch_config(int splits, int N, int R, int RT, int smem,
                                        cudaStream_t st, cudaLaunchAttribute* attr,
                                        bool pdl = false) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kBM - 1) / kBM, (R + RT - 1) / RT);
  cfg.blockDim = dim3(kThreadsW);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  return cfg;
}

// Clusters of `splits` blocks of `kernel` (dynamic shared memory `smem`)
// that the card holds at once (cudaOccupancyMaxActiveClusters); -1 on error.
inline int max_clusters(const void* kernel, int splits, int RT, int smem) {
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = launch_config(splits, kBM, RT, RT, smem, nullptr, attr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
}

}  // namespace sm90
}  // namespace sq
