// Fused dequantize + matmul for packed-int4 weights (and int8 weights with
// f32 activations), for Hopper.
//
// Replaces the Pallas kernel sequoia_tpu/kernels/quant_matmul.py::
// quant_matmul with bits=4 (_kernel_int4, both its "shift" and "float"
// unpack variants, which compute the same numbers), and serves bits=8
// (_kernel_int8) for f32 x on the CUDA cores; bf16 x at bits=8 runs the
// wgmma kernel of quant_matmul_int8_sm90.cu:
//   out[R, N] = (x[R, K] @ w[K, N]) * scale[1, N], f32 accumulation, cast to
//   the output type once at the end.
// int8: q[K, N] int8, w = q. int4: q[K/2, N] int8, half-split packed: byte
// [k, n] holds w[k, n] in its low nibble and w[K/2 + k, n] in its high
// nibble, both sign-extended (0x8 is -8). The nibble -> bf16 conversion is
// exact, so with bf16 x the products are those of the plain version and
// only the order of the f32 sums differs.
//
// Bound on the H100: bytes. At every shape of the 7B path (R = 1, 64, 128;
// (K, N) = (4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)) the
// weight bytes dominate: int8 moves K*N bytes (one 7B forward: 6.61 GB,
// 1.97 ms at 3.35 TB/s), int4 half of that (0.99 ms), against 2*R*K*N
// operations (0.86 TFLOP at R = 64, 0.87 ms at the bf16 tensor-core peak).
// On the CUDA cores (67 TFLOP/s f32) the same products would take 12.8 ms,
// so bf16 x runs on the tensor cores.
//
// Design, simple first:
// - One block of 4 warps computes a 16*MT-row by 128-column output tile over
//   one slice of K. The TPU's sequential K grid with a VMEM accumulator
//   becomes a K loop inside the block; where the output tiles alone give too
//   few blocks for 132 SMs (N = 4096 gives 32), K is split across blocks
//   (grid z): each split writes f32 partials to a workspace the wrapper
//   allocates, and a second small kernel sums them, applies the scale and
//   casts. The wrapper (kernels/quant_matmul.py::split_k) picks the split.
// - Each K stage (64 logical k) is copied to shared memory with 16-byte
//   cp.async, neighbouring threads on neighbouring columns: q as raw bytes,
//   x as bf16. Four stages rotate, so three are in flight while one is
//   computed: the weight stream needs many bytes in flight on each SM.
// - Warp-level mma.sync m16n8k16 (bf16 in, f32 accumulate). A warp owns 32
//   output columns as four n8 tiles, interleaved so that column 4*c + j is
//   column c of tile j: one 32-bit shared load of q then holds one byte for
//   each of the four tiles. Bytes become bf16 in registers (the 2^23 magic
//   number: byte into the low mantissa bits, one f32 subtract, the high half
//   of the f32 is the bf16), never in memory.
// - int4: a stage holds 32 packed rows, i.e. 32 low-half and 32 high-half
//   logical k; x's stage tile holds the matching columns of both halves.
// - Ragged R, K and N are masked with zeros in the loads and guards in the
//   stores; when N or K break 16-byte alignment the loads go byte by byte.
// - f32 x (the f32 test models) runs on the CUDA cores in full f32, one
//   thread per output column and eight rows, with no split: it keeps 1e-4
//   agreement, where bf16 tensor-core products would not.
// - The output tile is staged through shared memory, so that the partials
//   (or the scaled output) are stored as whole row segments.
// - The panel-tiled int4 layout (quant_matmul_tiled, replacing the Pallas
//   _kernel_int4_tiled): q[nt, K/2, 128], panel n holding columns
//   [128 n, 128 n + 128) as contiguous 128-byte rows. A block's 128 columns
//   are one panel, so the same block reads panel blockIdx.y at base
//   n * (K/2) * 128 with a row stride of 128 bytes where the row-major
//   layout has a stride of N. The logical N comes from the scale; the last
//   panel's columns past N are computed on the stored zeros and not written.
//   Nothing is padded or copied (the TPU wrapper pads q, x and the scale to
//   block multiples).
// Later work: int4 on the design of quant_matmul_int8_sm90.cu.

#include "common.cuh"

namespace {

using namespace sq;
using namespace sq::qmm;

constexpr int kBK = 64;                  // logical k per stage
constexpr int kXStride = kBK + 8;        // bf16 per x row in shared memory

// Byte j of `u` (an unsigned value in [0, 256)) as 2^23 + byte, minus `bias`.
__device__ __forceinline__ float magic(uint32_t u, int j, float bias) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)) - bias;
}
// Two small integer-valued floats as one bf16x2 (low half = a): their low
// 16 bits are zero, so the high halves are the exact bf16 values.
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

template <int MT>
struct Smem {
  static constexpr int kRows = kBK / 2;   // packed q rows per stage
  alignas(16) uint8_t w[kRows * kWStride];
  alignas(16) __nv_bfloat16 x[16 * MT * kXStride];
};

// Start copying one stage into `sm`: packed q rows [kq0, kq0 + kRows) of the
// block's 128 columns, and x's matching columns (the low-half columns kq0..
// and the high-half K/2 + kq0..) of the block's 16*MT rows. `qt` points
// at the block's first column in q row 0, `ldq` is q's row stride and `ncols`
// the number of its columns that exist. Rows, columns and k past the ends are
// zero. VEC: 16-byte cp.async, in flight until cp_async_wait; otherwise byte
// / element loads stored at once.
template <int MT, bool VEC>
__device__ __forceinline__ void load_stage(Smem<MT>& sm, const int8_t* __restrict__ qt,
                                           int ldq, int ncols,
                                           const __nv_bfloat16* __restrict__ xg, int R, int K,
                                           int r0, int kq0, int kq_end) {
  constexpr int kRows = Smem<MT>::kRows;
  constexpr int kWPer = kRows * kBN / 16 / kThreads;   // 16-byte pieces per thread
  constexpr int kXPer = 16 * MT * kBK / 8 / kThreads;
#pragma unroll
  for (int i = 0; i < kWPer; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int kq = kq0 + c / 8, col = (c % 8) * 16;
    const int8_t* src = qt + static_cast<int64_t>(kq) * ldq + col;
    uint8_t* dst = &sm.w[(c / 8) * kWStride + col];
    if (VEC) {
      const bool ok = kq < kq_end && col < ncols;
      cp_async(dst, ok ? src : qt, ok, 16);
    } else {
      copy16_bytes(dst, src, kq < kq_end, col, ncols);
    }
  }
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = r0 + c / 8, c8 = c % 8;
    const int kk = kq0 + (c8 % 4) * 8;      // the q row, for the bound check
    const int k = (c8 / 4) * (K / 2) + kk;  // the x column
    const __nv_bfloat16* src = xg + static_cast<int64_t>(r) * K + k;
    __nv_bfloat16* dst = &sm.x[(c / 8) * kXStride + c8 * 8];
    if (VEC) {
      const bool ok = r < R && kk < kq_end;
      cp_async(dst, ok ? src : xg, ok, 16);
    } else {
      uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (r < R && kk + e < kq_end)
          v[e / 2] |= uint32_t(__bfloat16_as_ushort(src[e])) << (16 * (e % 2));
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// A fragments of the MT row tiles at x columns [kc, kc + 16) of the stage.
template <int MT>
__device__ __forceinline__ void load_a(const Smem<MT>& sm, int kc, int g, int t,
                                       uint32_t (&a)[MT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const __nv_bfloat16* row = &sm.x[(m * 16 + g) * kXStride + kc + 2 * t];
    a[m][0] = *reinterpret_cast<const uint32_t*>(row);
    a[m][1] = *reinterpret_cast<const uint32_t*>(row + 8 * kXStride);
    a[m][2] = *reinterpret_cast<const uint32_t*>(row + 8);
    a[m][3] = *reinterpret_cast<const uint32_t*>(row + 8 * kXStride + 8);
  }
}

// w0..w3: the q words of rows 2t, 2t+1, 2t+8, 2t+9 of one 16-row k step,
// already offset so that each byte is an unsigned value (w + bias). For
// every n8 tile j: the bf16 B fragment, then the MMAs of all row tiles.
template <int MT>
__device__ __forceinline__ void mma_step(const uint32_t (&a)[MT][4], uint32_t w0,
                                         uint32_t w1, uint32_t w2, uint32_t w3, float bias,
                                         float (&acc)[MT][4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t b0 = pack_bf16x2(magic(w0, j, bias), magic(w1, j, bias));
    const uint32_t b1 = pack_bf16x2(magic(w2, j, bias), magic(w3, j, bias));
#pragma unroll
    for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j], a[m], b0, b1);
  }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(kThreads)
quant_matmul_mma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, void* __restrict__ out,
                 float* __restrict__ partial, int R, int K, int N, int kq_per_split,
                 int64_t panel_stride, int out_bf16) {
  using Sm = Smem<MT>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Sm* bufs = reinterpret_cast<Sm*>(smem_raw);   // kStages stages
  const int Kq = K / 2;
  const int r0 = blockIdx.x * 16 * MT, n0 = blockIdx.y * kBN;
  const int kq_begin = blockIdx.z * kq_per_split;
  const int kq_end = min(kq_begin + kq_per_split, Kq);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // Row-major q[Kq, N]: the block's columns start at n0, rows are N apart.
  // Panel-tiled q[nt, Kq, 128] (panel_stride = Kq * 128): panel blockIdx.y.
  const int8_t* qt = panel_stride ? q + blockIdx.y * panel_stride : q + n0;
  const int ldq = panel_stride ? kBN : N;
  const int ncols = panel_stride ? kBN : N - n0;

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;

  // kStages - 1 stages in flight ahead of the one computed.
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    const int kq = kq_begin + st * Sm::kRows;
    if (kq < kq_end)
      load_stage<MT, VEC>(bufs[st], qt, ldq, ncols, x, R, K, r0, kq, kq_end);
    cp_commit();
  }
  int it = 0;
  for (int kq0 = kq_begin; kq0 < kq_end; kq0 += Sm::kRows, ++it) {
    cp_wait<kStages - 2>();   // this thread's copies of stage `it` landed
    __syncthreads();                // everyone's; and stage it-1 is no longer read
    const int kq_next = kq0 + (kStages - 1) * Sm::kRows;
    if (kq_next < kq_end)
      load_stage<MT, VEC>(bufs[(it + kStages - 1) % kStages], qt, ldq, ncols, x, R, K, r0,
                          kq_next, kq_end);
    cp_commit();
    const Sm& sm = bufs[it % kStages];
    // This lane's q word: columns 4g .. 4g+3 of the warp's 32.
    const uint8_t* wl = sm.w + warp * 32 + 4 * g;

#pragma unroll
    for (int s = 0; s < 2; ++s) {   // 16-row steps of q
      const uint8_t* p = wl + (16 * s + 2 * t) * kWStride;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + kWStride);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 8 * kWStride);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 9 * kWStride);
      uint32_t a[MT][4];
      // nibble v -> v ^ 8 = v + 8 in [0, 16); low nibbles pair with x's
      // low-half columns (stage columns 0..31), high with 32..63.
      const uint32_t f0 = w0 ^ 0x88888888u, f1 = w1 ^ 0x88888888u;
      const uint32_t f2 = w2 ^ 0x88888888u, f3 = w3 ^ 0x88888888u;
      load_a<MT>(sm, 16 * s, g, t, a);
      mma_step<MT>(a, f0 & 0x0F0F0F0Fu, f1 & 0x0F0F0F0Fu, f2 & 0x0F0F0F0Fu,
                   f3 & 0x0F0F0F0Fu, 8388608.f + 8.f, acc);
      load_a<MT>(sm, 32 + 16 * s, g, t, a);
      mma_step<MT>(a, (f0 >> 4) & 0x0F0F0F0Fu, (f1 >> 4) & 0x0F0F0F0Fu,
                   (f2 >> 4) & 0x0F0F0F0Fu, (f3 >> 4) & 0x0F0F0F0Fu,
                   8388608.f + 8.f, acc);
    }
  }

  // The output tile goes through shared memory (the stages are free now), so
  // that each warp then stores whole 128-byte row segments: the C fragment's
  // own layout would scatter every store over eight rows.
  // C fragment: rows g and g+8 of each row tile, tile columns 2t and 2t+1;
  // tile column c of tile j is the warp's column 4c + j.
  cp_wait<0>();
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem_raw);   // [16*MT][kOutStride]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tile[(m * 16 + g + 8 * (i / 2)) * kOutStride + warp * 32 + 4 * (2 * t + i % 2) + j] =
            acc[m][j][i];
  __syncthreads();
  const int rows = min(16 * MT, R - r0);
  float* part = partial != nullptr ? partial + static_cast<int64_t>(blockIdx.z) * R * N : nullptr;
  for (int e = threadIdx.x; e < rows * kBN; e += kThreads) {
    const int rr = e / kBN, c = e % kBN, n = n0 + c;
    if (n >= N) continue;
    const int64_t o = static_cast<int64_t>(r0 + rr) * N + n;
    const float v = tile[rr * kOutStride + c];
    if (part != nullptr) part[o] = v;
    else store_out(out, o, v * scale[n], out_bf16);
  }
}

// Sum of the K splits' partials, times the scale, in the output type.
__global__ void quant_matmul_reduce(const float* __restrict__ partial,
                                    const float* __restrict__ scale, void* __restrict__ out,
                                    int R, int N, int splits, int out_bf16) {
  const int64_t total = static_cast<int64_t>(R) * N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[z * total + i];
  store_out(out, i, s * scale[i % N], out_bf16);
}

// f32 x on the CUDA cores: one thread per output column, kRowsF rows.
constexpr int kRowsF = 8;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quant_matmul_f32(const float* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, void* __restrict__ out, int R, int K,
                 int N, int64_t panel_stride, int out_bf16) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int r0 = blockIdx.y * kRowsF;
  if (n >= N) return;
  const int Kq = BITS == 8 ? K : K / 2;
  // This column in q row 0, and q's row stride (panels: see the file note).
  const int8_t* qn = panel_stride ? q + (n / kBN) * panel_stride + n % kBN : q + n;
  const int ldq = panel_stride ? kBN : N;
  float acc[kRowsF];
#pragma unroll
  for (int r = 0; r < kRowsF; ++r) acc[r] = 0.f;
  for (int k = 0; k < Kq; ++k) {
    const int b = qn[static_cast<int64_t>(k) * ldq];
    if (BITS == 8) {
      const float w = static_cast<float>(b);
#pragma unroll
      for (int r = 0; r < kRowsF; ++r)
        if (r0 + r < R) acc[r] = fmaf(x[static_cast<int64_t>(r0 + r) * K + k], w, acc[r]);
    } else {
      const float lo = static_cast<float>(static_cast<int>(static_cast<uint32_t>(b) << 28) >> 28);
      const float hi = static_cast<float>(b >> 4);
#pragma unroll
      for (int r = 0; r < kRowsF; ++r)
        if (r0 + r < R) {
          const float* xr = x + static_cast<int64_t>(r0 + r) * K;
          acc[r] = fmaf(xr[k], lo, acc[r]);
          acc[r] = fmaf(xr[Kq + k], hi, acc[r]);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsF; ++r)
    if (r0 + r < R) store_out(out, static_cast<int64_t>(r0 + r) * N + n, acc[r] * scale[n], out_bf16);
}

template <int MT, bool VEC>
cudaError_t launch_mma(const void* x, const void* q, const float* scale, void* out,
                       float* partial, int R, int K, int N, int splits, int kq_per_split,
                       int64_t panel_stride, int out_bf16, cudaStream_t stream) {
  const dim3 grid((R + 16 * MT - 1) / (16 * MT), (N + kBN - 1) / kBN, splits);
  constexpr int kSmem = kStages * static_cast<int>(sizeof(Smem<MT>));
  static_assert(16 * MT * kOutStride * 4 <= kSmem, "the output tile reuses the stages");
  static bool smem_set = false;   // above 48 KB only after this attribute
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        quant_matmul_mma<MT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  quant_matmul_mma<MT, VEC><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q), scale, out,
      splits > 1 ? partial : nullptr, R, K, N, kq_per_split, panel_stride, out_bf16);
  return cudaGetLastError();
}

// bf16 x through the int4 tensor-core kernel (and its K-split reduce).
int launch_int4_mma(const void* x, const void* q, const float* sc, void* out, void* partial,
                    int R, int K, int N, int splits, int kq_per_split, int out_dtype,
                    int64_t panel_stride, bool tiled, cudaStream_t st) {
  if (splits < 1 || (splits > 1 && (partial == nullptr || kq_per_split <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kq = K / 2;
  if (splits == 1) kq_per_split = Kq;   // one split: the tail stage is masked
  else if (kq_per_split % Smem<1>::kRows)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need 16-byte row starts: x rows always, q rows unless
  // they are 128-byte panel rows.
  const bool vec = (tiled || N % 16 == 0) && K % 16 == 0;
  float* ws = static_cast<float*>(partial);
  cudaError_t err;
#define SEQ_QMM_CASE(MT)                                                                \
  err = vec ? launch_mma<MT, true>(x, q, sc, out, ws, R, K, N, splits, kq_per_split,     \
                                   panel_stride, out_dtype, st)                         \
            : launch_mma<MT, false>(x, q, sc, out, ws, R, K, N, splits, kq_per_split,    \
                                    panel_stride, out_dtype, st);
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
  quant_matmul_reduce<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      ws, sc, out, R, N, splits, out_dtype);
  return static_cast<int>(cudaGetLastError());
}

// tiled: q is the panel layout [ceil(N / 128), K/2, 128] (int4 only).
template <int BITS>
int launch(const void* x, const void* q, const void* scale, void* out, void* partial,
           int R, int K, int N, int splits, int kq_per_split, int x_dtype, int out_dtype,
           bool tiled, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (R <= 0 || N <= 0 || K <= 0 || (BITS == 4 && K % 2) || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t panel_stride = tiled ? static_cast<int64_t>(K / 2) * kBN : 0;
  if (x_dtype == 0) {   // f32 x: CUDA cores, no split
    const dim3 grid((N + kThreads - 1) / kThreads, (R + kRowsF - 1) / kRowsF);
    quant_matmul_f32<BITS><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                                      static_cast<const int8_t*>(q), sc,
                                                      out, R, K, N, panel_stride, out_dtype);
    return static_cast<int>(cudaGetLastError());
  }
  // bf16 x: int4 here; int8 has its own kernel (quant_matmul_int8_sm90.cu).
  if (x_dtype != 1 || BITS != 4) return static_cast<int>(cudaErrorInvalidValue);
  return launch_int4_mma(x, q, sc, out, partial, R, K, N, splits, kq_per_split, out_dtype,
                         panel_stride, tiled, st);
}

}  // namespace

extern "C" {

// x [R, K] (x_dtype 0 = float32, 1 = bfloat16), q int8 ([K, N] or packed
// [K/2, N]), scale float32 [N], out [R, N] (out_dtype 0 = float32,
// 1 = bfloat16). int8 takes f32 x only. With bf16 x and splits > 1, partial
// is a float32 workspace [splits, R, N] and each split covers kq_per_split q
// rows (a multiple of the stage, 32). x and q 16-byte aligned; the wrapper
// checks shapes, types and alignment.
int sequoia_quant_matmul_int8(const void* x, const void* q, const void* scale, void* out,
                              void* partial, int R, int K, int N, int splits,
                              int kq_per_split, int x_dtype, int out_dtype, void* stream) {
  return launch<8>(x, q, scale, out, partial, R, K, N, splits, kq_per_split, x_dtype,
                   out_dtype, false, stream);
}

int sequoia_quant_matmul_int4(const void* x, const void* q, const void* scale, void* out,
                              void* partial, int R, int K, int N, int splits,
                              int kq_per_split, int x_dtype, int out_dtype, void* stream) {
  return launch<4>(x, q, scale, out, partial, R, K, N, splits, kq_per_split, x_dtype,
                   out_dtype, false, stream);
}

// The same product over the panel-tiled layout q [ceil(N / 128), K/2, 128]
// (panel n holds columns [128 n, 128 n + 128), zero past N); N is the logical
// width, the length of scale.
int sequoia_quant_matmul_int4_tiled(const void* x, const void* q, const void* scale,
                                    void* out, void* partial, int R, int K, int N,
                                    int splits, int kq_per_split, int x_dtype,
                                    int out_dtype, void* stream) {
  return launch<4>(x, q, scale, out, partial, R, K, N, splits, kq_per_split, x_dtype,
                   out_dtype, true, stream);
}

}  // extern "C"
