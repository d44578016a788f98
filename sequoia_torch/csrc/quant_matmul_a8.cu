// Quantized matmuls with int8 activations on the int8 tensor cores, and the
// per-row activation quantizer that feeds them, for Hopper.
//
// Replaces the Pallas kernel sequoia_tpu/kernels/quant_matmul.py::
// quant_matmul(unpack="w4a8") (_kernel_int4_w4a8):
//   x8[R, K] int8, sx[R] f32 = per-row quantization of x (below);
//   acc[R, N] = x8 @ w, exact in int32;
//   out = float(acc) * sx[r] * scale[n], in that order, cast once.
// q[K/2, N], half-split packed: byte [k, n] holds w[k, n] in its low nibble
// and w[K/2 + k, n] in its high nibble, both signed. The TPU kernel casts
// every K block's int32 partial to f32 and adds in f32; that equals one
// int32 sum while |acc| < 2^24, which holds for K <= 18000 (127 * 7 * K);
// this kernel sums in int32 over the whole K either way. Its int8-weight
// sibling (the w8a8 route of sequoia_tpu/quant/qtensor.py::_matmul_w8a8)
// runs on quant_matmul_int8_sm90.cu and takes x8 and sx from the quantizer
// here.
//
// The activation quantizer (JAX computes it with XLA ops, outside any
// kernel): sx = max(amax(|x|), 1e-8) / 127, x8 = clip(round(x / sx), +-127),
// with a true division and round-half-to-even, so that x8 and sx equal the
// JAX values bit for bit. One block per row, two passes over the row (the
// second from cache).
//
// Bound on the H100: bytes, as for the float-activation kernels (the weight
// stream) at the widths of a tree verify: 2*R*K*N operations at the int8
// peak of 1979 TOP/s pass the int4 weight bytes at R ~ 148.
// Measured times are in PERF.md.
//
// Design: one block of 4 warps per 16*MT-row by 128-column tile and K
// slice; 4 stages of 64 q rows in flight through cp.async; K split across
// blocks (kernels/quant_matmul.py::split_k) with int32 partials summed by a
// second kernel; the output tile staged through shared memory. Then:
// - mma.sync m16n8k32 (s8 x s8 -> s32). Its B fragment wants four
//   consecutive k of one column in one register, and q keeps a column's k in
//   four different rows: each lane loads the words of rows 4t .. 4t+3 (its
//   warp's columns 4g .. 4g+3) and transposes the 4x4 bytes with eight prmt
//   into the B registers of four n8 tiles (column 4c + j is column c of tile
//   j).
// - Those loads hit rows 144 bytes apart: q's 16-byte chunks are stored
//   swizzled (chunk ^ 2 in rows 8..15 of every 16) so that the four row
//   groups of a load fall on distinct banks.
// - int4: a nibble becomes an int8 without sign extension: (b << 4) & 0xF0
//   is 16 * low nibble as a signed byte, b & 0xF0 is 16 * high nibble. The
//   sum is 16 * acc (below 2^31 for K <= 18000) and is shifted back once.
// Later work: the s8 instantiation of quant_matmul_int4_sm90.cu (each 64-row
// block of a wide call streams its weight tile again, from L2 at best).

#include "common.cuh"

namespace {

using namespace sq;
using namespace sq::qmm;

constexpr int kRowsI = 64;               // q rows per stage

template <int MT>
struct SmemI {
  // x8 bytes per row and stage: 64 low-half + 64 high-half k.
  static constexpr int kXBytes = 128;
  static constexpr int kXStride = kXBytes + 16;
  alignas(16) uint8_t w[kRowsI * kWStride];
  alignas(16) int8_t x[16 * MT * kXStride];
};

// Byte offset, within a q row in shared memory, of the row's byte `col`.
__device__ __forceinline__ int swizzle(int row, int col) { return col ^ (((row >> 3) & 1) << 5); }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// b[j] = byte j of w[0], w[1], w[2], w[3] (low byte first).
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&b)[4]) {
  const uint32_t a01 = __byte_perm(w[0], w[1], 0x5140), a23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t c01 = __byte_perm(w[0], w[1], 0x7362), c23 = __byte_perm(w[2], w[3], 0x7362);
  b[0] = __byte_perm(a01, a23, 0x5410);
  b[1] = __byte_perm(a01, a23, 0x7632);
  b[2] = __byte_perm(c01, c23, 0x5410);
  b[3] = __byte_perm(c01, c23, 0x7632);
}

// Start copying one stage: q rows [kq0, kq0 + 64) of the block's 128 columns
// (`qt`: the block's first column in q row 0, `ldq` q's row stride, `ncols`
// its columns that exist), and the matching x8 columns of the block's 16*MT
// rows (int4: the low-half columns kq0.. and the high-half K/2 + kq0..).
// Rows, columns and k past the ends are zero.
template <int MT, bool VEC>
__device__ __forceinline__ void load_stage(SmemI<MT>& sm, const int8_t* __restrict__ qt,
                                           int ldq, int ncols, const int8_t* __restrict__ xg,
                                           int R, int K, int r0, int kq0, int kq_end) {
  using Sm = SmemI<MT>;
  constexpr int kWPer = kRowsI * kBN / 16 / kThreads;
#pragma unroll
  for (int i = 0; i < kWPer; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c / 8, col = (c % 8) * 16, kq = kq0 + row;
    const int8_t* src = qt + static_cast<int64_t>(kq) * ldq + col;
    uint8_t* dst = &sm.w[row * kWStride + swizzle(row, col)];
    if (VEC) {
      const bool ok = kq < kq_end && col < ncols;
      cp_async(dst, ok ? src : qt, ok, 16);
    } else {
      copy16_bytes(dst, src, kq < kq_end, col, ncols);
    }
  }
  constexpr int kPerRow = Sm::kXBytes / 16;
  constexpr int kXChunks = 16 * MT * kPerRow;
  constexpr int kXPer = (kXChunks + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c >= kXChunks) break;
    const int rr = c / kPerRow, ch = c % kPerRow, r = r0 + rr;
    const int kk = kq0 + (ch % 4) * 16;                     // the chunk's q row, for the bound
    const int k = (ch / 4) * (K / 2) + kk;                  // its x8 column
    const int8_t* src = xg + static_cast<int64_t>(r) * K + k;
    int8_t* dst = &sm.x[rr * Sm::kXStride + ch * 16];
    if (VEC) {
      const bool ok = r < R && kk < kq_end;
      cp_async(dst, ok ? src : xg, ok, 16);
    } else {
      copy16_bytes(reinterpret_cast<uint8_t*>(dst), src, r < R, kk, kq_end);
    }
  }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(kThreads)
quant_matmul_a8_mma(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                    const int8_t* __restrict__ q, const float* __restrict__ scale,
                    void* __restrict__ out, int* __restrict__ partial, int R, int K, int N,
                    int kq_per_split, int out_bf16) {
  using Sm = SmemI<MT>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Sm* bufs = reinterpret_cast<Sm*>(smem_raw);   // kStages stages
  const int Kq = K / 2;
  const int r0 = blockIdx.x * 16 * MT, n0 = blockIdx.y * kBN;
  const int kq_begin = blockIdx.z * kq_per_split;
  const int kq_end = min(kq_begin + kq_per_split, Kq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int8_t* qt = q + n0;
  const int ncols = N - n0;

  int acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    const int kq = kq_begin + st * kRowsI;
    if (kq < kq_end) load_stage<MT, VEC>(bufs[st], qt, N, ncols, x8, R, K, r0, kq, kq_end);
    cp_commit();
  }
  int it = 0;
  for (int kq0 = kq_begin; kq0 < kq_end; kq0 += kRowsI, ++it) {
    cp_wait<kStages - 2>();   // this thread's copies of stage `it` landed
    __syncthreads();                // everyone's; and stage it-1 is no longer read
    const int kq_next = kq0 + (kStages - 1) * kRowsI;
    if (kq_next < kq_end)
      load_stage<MT, VEC>(bufs[(it + kStages - 1) % kStages], qt, N, ncols, x8, R, K, r0,
                                kq_next, kq_end);
    cp_commit();
    const Sm& sm = bufs[it % kStages];
    const int wcol = warp * 32 + 4 * g;   // this lane's q word: columns 4g .. 4g+3 of the warp's 32

#pragma unroll
    for (int s = 0; s < kRowsI / 32; ++s) {   // 32-row steps of q
      // B registers of the four n8 tiles: k rows 4t..4t+3 and 16+4t..16+4t+3.
      uint32_t w[4], b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 32 * s + 4 * t + i;
        w[i] = *reinterpret_cast<const uint32_t*>(&sm.w[row * kWStride + swizzle(row, wcol)]);
      }
      transpose4(w, b0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 32 * s + 16 + 4 * t + i;
        w[i] = *reinterpret_cast<const uint32_t*>(&sm.w[row * kWStride + swizzle(row, wcol)]);
      }
      transpose4(w, b1);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        // A fragments: x8 bytes [kc, kc + 32) of the stage (the low half
        // pairs with the low nibbles, the high half with the high).
        const int kc = 32 * s + 64 * hf;
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int8_t* row = &sm.x[(m * 16 + g) * Sm::kXStride + kc + 4 * t];
          a[m][0] = *reinterpret_cast<const uint32_t*>(row);
          a[m][1] = *reinterpret_cast<const uint32_t*>(row + 8 * Sm::kXStride);
          a[m][2] = *reinterpret_cast<const uint32_t*>(row + 16);
          a[m][3] = *reinterpret_cast<const uint32_t*>(row + 8 * Sm::kXStride + 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // 16 * nibble as a signed byte
          const uint32_t f0 = hf == 0 ? (b0[j] << 4) & 0xF0F0F0F0u : b0[j] & 0xF0F0F0F0u;
          const uint32_t f1 = hf == 0 ? (b1[j] << 4) & 0xF0F0F0F0u : b1[j] & 0xF0F0F0F0u;
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_s8(acc[m][j], a[m], f0, f1);
        }
      }
    }
  }

  // The output tile goes through shared memory (the stages are free now), so
  // that whole row segments are stored. C fragment: rows g and g+8 of each row
  // tile, tile columns 2t and 2t+1; tile column c of tile j is the warp's
  // column 4c + j.
  cp_wait<0>();
  __syncthreads();
  int* tile = reinterpret_cast<int*>(smem_raw);   // [16*MT][kOutStride]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tile[(m * 16 + g + 8 * (i / 2)) * kOutStride + warp * 32 + 4 * (2 * t + i % 2) + j] =
            acc[m][j][i] >> 4;   // the sum is 16 * acc
  __syncthreads();
  const int rows = min(16 * MT, R - r0);
  int* part = partial != nullptr ? partial + static_cast<int64_t>(blockIdx.z) * R * N : nullptr;
  for (int e = threadIdx.x; e < rows * kBN; e += kThreads) {
    const int rr = e / kBN, c = e % kBN, n = n0 + c;
    if (n >= N) continue;
    const int64_t o = static_cast<int64_t>(r0 + rr) * N + n;
    const int v = tile[rr * kOutStride + c];
    if (part != nullptr) part[o] = v;
    else store_out(out, o, static_cast<float>(v) * sx[r0 + rr] * scale[n], out_bf16);
  }
}

// Sum of the K splits' int32 partials, rescaled, in the output type.
__global__ void quant_matmul_a8_reduce(const int* __restrict__ partial,
                                       const float* __restrict__ sx,
                                       const float* __restrict__ scale, void* __restrict__ out,
                                       int R, int N, int splits, int out_bf16) {
  const int64_t total = static_cast<int64_t>(R) * N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int s = 0;
  for (int z = 0; z < splits; ++z) s += partial[z * total + i];
  store_out(out, i, static_cast<float>(s) * sx[i / N] * scale[i % N], out_bf16);
}

template <int MT, bool VEC>
cudaError_t launch_mma(const int8_t* x8, const float* sx, const int8_t* q, const float* scale,
                       void* out, int* partial, int R, int K, int N, int splits,
                       int kq_per_split, int out_bf16, cudaStream_t stream) {
  const dim3 grid((R + 16 * MT - 1) / (16 * MT), (N + kBN - 1) / kBN, splits);
  constexpr int kSmem = kStages * static_cast<int>(sizeof(SmemI<MT>));
  static_assert(16 * MT * kOutStride * 4 <= kSmem, "the output tile reuses the stages");
  static bool smem_set = false;   // above 48 KB only after this attribute
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        quant_matmul_a8_mma<MT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  quant_matmul_a8_mma<MT, VEC><<<grid, kThreads, kSmem, stream>>>(
      x8, sx, q, scale, out, splits > 1 ? partial : nullptr, R, K, N, kq_per_split, out_bf16);
  return cudaGetLastError();
}

int launch(const int8_t* x8, const float* sx, const int8_t* q, const float* scale, void* out,
           int* partial, int R, int K, int N, int splits, int kq_per_split, int out_dtype,
           cudaStream_t st) {
  if (R <= 0 || N <= 0 || K <= 0 || K % 2 || out_dtype < 0 || out_dtype > 1 ||
      splits < 1 || (splits > 1 && (partial == nullptr || kq_per_split <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kq = K / 2;
  if (splits == 1) kq_per_split = Kq;   // one split: the tail stage is masked
  else if (kq_per_split % kRowsI) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need 16-byte row starts and whole 16-byte chunks of k.
  const bool vec = N % 16 == 0 && K % 16 == 0 && Kq % 16 == 0;
  cudaError_t err;
#define SEQ_QMM_CASE(MT)                                                                 \
  err = vec ? launch_mma<MT, true>(x8, sx, q, scale, out, partial, R, K, N, splits,       \
                                   kq_per_split, out_dtype, st)                          \
            : launch_mma<MT, false>(x8, sx, q, scale, out, partial, R, K, N, splits,      \
                                    kq_per_split, out_dtype, st);
  if (R <= 16) {
    SEQ_QMM_CASE(1)
  } else if (R <= 32) {
    SEQ_QMM_CASE(2)
  } else {
    SEQ_QMM_CASE(4)
  }
#undef SEQ_QMM_CASE
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(R) * N;
  quant_matmul_a8_reduce<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      partial, sx, scale, out, R, N, splits, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int kQThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_activations_kernel(const T* __restrict__ x, int8_t* __restrict__ x8,
                            float* __restrict__ sx, int K) {
  __shared__ float warp_max[kQThreads / 32];
  const T* row = x + static_cast<int64_t>(blockIdx.x) * K;
  int8_t* orow = x8 + static_cast<int64_t>(blockIdx.x) * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQThreads) amax = fmaxf(amax, fabsf(to_f(row[k])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = fmaxf(amax, 1e-8f) / 127.0f;   // a true division (no fast math)
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  for (int k = threadIdx.x; k < K; k += kQThreads) {
    const float v = fminf(fmaxf(rintf(to_f(row[k]) / s), -127.f), 127.f);   // half to even
    orow[k] = static_cast<int8_t>(static_cast<int>(v));
  }
}

}  // namespace

extern "C" {

// x [R, K] (x_dtype 0 = float32, 1 = bfloat16) -> x8 [R, K] int8, sx [R]
// float32: sx = max(amax |x|, 1e-8) / 127, x8 = clip(round(x / sx), +-127).
int sequoia_quantize_activations(const void* x, void* x8, void* sx, int R, int K, int x_dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0)
    quantize_activations_kernel<float><<<R, kQThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(x8), static_cast<float*>(sx), K);
  else if (x_dtype == 1)
    quantize_activations_kernel<__nv_bfloat16><<<R, kQThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(x8),
        static_cast<float*>(sx), K);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x8 [R, K] int8, sx [R] float32, q int8 packed [K/2, N] (bits 4 only),
// scale float32 [N], out [R, N] (out_dtype 0 = float32, 1 = bfloat16). With
// splits > 1, partial is an int32 workspace [splits, R, N] and each split
// covers kq_per_split q rows (a multiple of 64).
// x8 and q 16-byte aligned; the wrapper checks shapes, types and alignment.
int sequoia_quant_matmul_a8(const void* x8, const void* sx, const void* q, const void* scale,
                            void* out, void* partial, int R, int K, int N, int bits,
                            int splits, int kq_per_split, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x8p = static_cast<const int8_t*>(x8);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sxp = static_cast<const float*>(sx);
  const float* sc = static_cast<const float*>(scale);
  int* ws = static_cast<int*>(partial);
  if (bits == 4)   // bits = 8: quant_matmul_int8_sm90.cu
    return launch(x8p, sxp, qp, sc, out, ws, R, K, N, splits, kq_per_split, out_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
