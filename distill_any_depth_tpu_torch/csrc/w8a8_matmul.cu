// W8A8 GEMM with dynamic per-row activation quantization, for Hopper (sm_90a).
//
// Replaces the TPU kernel distill_any_depth_tpu/ops/quant_matmul.py::_w8a8_2d
// (body _kernel): x @ w (+ b) with dynamic per-row int8 activations and
// per-output-channel int8 weights, int32 accumulation, an fp32 dequant
// epilogue.
//
//   x [M, K] bf16 or fp32, wq [N, K] int8 (a Linear's [out, in] weight
//   quantized per output channel), ws [N] fp32, bias [N] fp32 or none
//   ->  out [M, N] in x's type
//
// Numerics, exactly those of _kernel (and of ops/quant.py's plain version):
//   s_m    = max(max_k |x_mk|, 1e-8) / 127     true division (__fdiv_rn)
//   q_mk   = round_half_even(x_mk / s_m)         true division, __float2int_rn
//   acc_mn = sum_k q_mk * wq_nk                  int32, exact: |acc| <= K * 127^2
//   out_mn = ((float(acc) * s_m) * ws_n) [+ b_n], rounded once to the output type
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn), so nvcc
// cannot contract them into an FMA; no bias means no add (-0 stays -0). A NaN
// in a row makes its scale NaN, as the plain version's amax does. The int32
// sum is exact in any order, so the tiling does not change a bit.
//
// Bound at the ViT-L 518^2 bs8 shapes (M = 10960, bf16 in and out): qkv
// (K 1024, N 3072) 69.0 GOP, 34.8 us at 1979 TOP/s int8, against 92 MB
// moved (27.5 us at 3.35 TB/s); fc1 and fc2 46.5 us, operation-bound; proj
// 13.7 us, byte-bound (cli/kernel_bounds.py). The bound is the function's:
// x read once, out written once, whatever the two launches below move.
//
// Design, two launches on the caller's stream:
//   1. quantize_rows: one block of 128 threads per row reads the row once
//      into registers (K <= 4096; a longer row's tail is read again), reduces
//      its amax and writes xq [M, K] int8 and xs [M] fp32 to a workspace the
//      caller allocates. Each element is quantized once per call (the TPU
//      kernel quantizes each row tile once, at its first column tile). The
//      quotient is taken as x * (1 / s_m), which rounds to the same integer
//      as the true quotient unless it lies within 1e-4 of a half-integer (it
//      is at most 2.3e-5 from it for |q| <= 127.5); there the true division
//      decides.
//   2. gemm: one block of three warpgroups per 128 x 256 output tile, the
//      grid's fast axis over N. Warpgroup 0 is the producer: one thread
//      streams 128-byte K chunks of xq (128 rows) and wq (256 rows) by TMA
//      (2-D maps, 128-byte swizzle, zero fill past M, N and K) through a
//      ring of four 48 KB stages with full and empty mbarriers, while its
//      other warps stage the tile's column scales and biases in shared
//      memory for the epilogue. Warpgroups 1 and 2 own 64 rows each and run
//      wgmma m64n256k32 s8.s8 -> s32 on both operands from shared memory
//      (K-major, hopper_tiles.cuh's desc_sw128), keeping one chunk's
//      products in flight while they release the previous stage, then
//      dequantize the int32 accumulators in registers into the stages'
//      shared memory and write each 64 x 256 tile out in 16-byte row pieces
//      (a 4-byte store from the accumulator layout touches 8 rows a warp).
// The int8 copy of x makes one round trip through device memory (at K = 4096
// a row tile's 64 x 4096 int8 would not fit in shared memory anyway).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_tiles.cuh"

namespace {

using namespace dad_hopper;

constexpr float kEps = 1e-8f;

// ------------------------------------------------------------------ 1. row quantization
constexpr int kQuantThreads = 128;  // one block per row
constexpr int kQuantCache = 4;      // 8-element units a thread holds (K <= 4096 in registers)

// Eight consecutive elements of x as raw 16-byte words (bf16: one, fp32: two).
template <typename T>
__device__ __forceinline__ void load8(uint4 (&r)[2], const T* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  r[0] = __ldg(q);
  if constexpr (sizeof(T) == 4) r[1] = __ldg(q + 1);
}

template <typename T>
__device__ __forceinline__ void to_float8(float (&f)[8], const uint4 (&r)[2]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r[0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
    const float* p = reinterpret_cast<const float*>(&r[0]);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = p[i];
  }
}

// round_half_even(f / s) with inv = 1 / s: the product's integer unless it
// is near a tie (see the header); NaN gives 0 on both paths.
__device__ __forceinline__ int quant1(float f, float s, float inv) {
  const float r = __fmul_rn(f, inv);
  if (fabsf(__fsub_rn(r, floorf(r)) - 0.5f) < 1e-4f) return __float2int_rn(__fdiv_rn(f, s));
  return __float2int_rn(r);
}

// Four int8 values round_half_even(f / s), packed little-endian.
__device__ __forceinline__ uint32_t quant4(const float* f, float s, float inv) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out |= (static_cast<uint32_t>(quant1(f[j], s, inv)) & 0xffu) << (8 * j);
  return out;
}

// One block per row: the row's first 8 * kQuantCache * 128 elements are
// read once into registers, the rest (K > 4096) read again for the second
// pass.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                  int k) {
  __shared__ uint32_t warp_max[kQuantThreads / 32];
  const long row = blockIdx.x;
  const T* xr = x + row * k;
  const int units = k / 8;
  // |x| as bits orders like the floats, NaN above +inf
  uint32_t amax = 0u;
  uint4 raw[kQuantCache][2];
#pragma unroll
  for (int i = 0; i < kQuantCache; ++i) {
    const int u = threadIdx.x + i * kQuantThreads;
    if (u < units) {
      float f[8];
      load8<T>(raw[i], xr + 8 * u);
      to_float8<T>(f, raw[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = max(amax, __float_as_uint(f[e]) & 0x7fffffffu);
    }
  }
  for (int u = threadIdx.x + kQuantCache * kQuantThreads; u < units; u += kQuantThreads) {
    uint4 r[2];
    float f[8];
    load8<T>(r, xr + 8 * u);
    to_float8<T>(f, r);
#pragma unroll
    for (int e = 0; e < 8; ++e) amax = max(amax, __float_as_uint(f[e]) & 0x7fffffffu);
  }
  amax = __reduce_max_sync(0xffffffffu, amax);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQuantThreads / 32; ++w) amax = max(amax, warp_max[w]);
  const float a = __uint_as_float(amax);
  const float s = __fdiv_rn(a < kEps ? kEps : a, 127.f);
  const float inv = __frcp_rn(s);
  if (threadIdx.x == 0) xs[row] = s;
  int8_t* qr = xq + row * k;
#pragma unroll
  for (int i = 0; i < kQuantCache; ++i) {
    const int u = threadIdx.x + i * kQuantThreads;
    if (u < units) {
      float f[8];
      to_float8<T>(f, raw[i]);
      *reinterpret_cast<uint2*>(qr + 8 * u) = make_uint2(quant4(f, s, inv), quant4(f + 4, s, inv));
    }
  }
  for (int u = threadIdx.x + kQuantCache * kQuantThreads; u < units; u += kQuantThreads) {
    uint4 r[2];
    float f[8];
    load8<T>(r, xr + 8 * u);
    to_float8<T>(f, r);
    *reinterpret_cast<uint2*>(qr + 8 * u) = make_uint2(quant4(f, s, inv), quant4(f + 4, s, inv));
  }
}

// ------------------------------------------------------------------ 2. int8 GEMM
constexpr int kBM = 128;  // output rows of a tile: two consumer warpgroups of 64
constexpr int kBN = 256;  // output columns of a tile
constexpr int kBK = 128;  // K bytes of a stage: one swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr int kA = kBM * kBK, kB = kBN * kBK;  // bytes of a stage's tiles
// the stages, the tile's column scales and biases, the barriers
constexpr size_t kSmem = 1024 /* alignment slack */ + (size_t)kStages * (kA + kB) +
                         2 * kBN * sizeof(float) + (2 * kStages + 1) * sizeof(uint64_t);
static_assert(2 * 64 * (kBN + 4) * sizeof(float) <= (size_t)kStages * (kA + kB),
              "the epilogue stages both output tiles in the stages' memory");

template <typename T>
__device__ __forceinline__ void store2(T* p, float y0, float y1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
  }
}



template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_wgmma(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
               const float* __restrict__ xs, const float* __restrict__ ws,
               const float* __restrict__ bias, T* __restrict__ out, int m, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  uint8_t* a_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* b_s = a_s + kStages * kA;
  float* ws_s = reinterpret_cast<float*>(b_s + kStages * kB);  // kBN column scales
  float* bias_s = ws_s + kBN;                                   // kBN biases
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + kBN);
  uint64_t* empty = full + kStages;
  uint64_t* cols_full = empty + kStages;

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int chunks = (k + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(cols_full, 96);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: thread 0 streams the K chunks of xq and wq; warps 1-3
    // stage the block's column scales and biases for the epilogue
    setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) {
      for (int c = threadIdx.x - 32; c < kBN; c += 96) {
        const int col = n0 + c;
        ws_s[c] = col < n ? ws[col] : 0.f;
        bias_s[c] = col < n && bias != nullptr ? bias[col] : 0.f;
      }
      mbar_arrive(cols_full);
    } else if (threadIdx.x == 0) {
      for (int kc = 0; kc < chunks; ++kc) {
        const int st = kc % kStages, round = kc / kStages;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        mbar_arrive_expect_tx(&full[st], kA + kB);
        tma_load_2d(a_s + st * kA, &x_map, &full[st], kc * kBK, m0);
        tma_load_2d(b_s + st * kB, &w_map, &full[st], kc * kBK, n0);
      }
    }
    return;
  }

  // ---- consumers: 64 rows x kBN columns each
  setmaxnreg_inc<232>();
  const int w = threadIdx.x / 128 - 1;
  // (warp wi, lane 4g + t) holds rows 16wi + g (+8) and columns 8j + 2t (+1)
  // of its warpgroup's 64 rows
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wi = (threadIdx.x & 127) >> 5;
  float s[2];
  long rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = m0 + w * 64 + wi * 16 + g + 8 * r;
    s[r] = rows[r] < m ? xs[rows[r]] : 0.f;
  }
  int32_t acc[kBN / 2];
#pragma unroll
  for (int e = 0; e < kBN / 2; ++e) acc[e] = 0;
  for (int kc = 0; kc < chunks; ++kc) {
    const int st = kc % kStages;
    mbar_wait(&full[st], (kc / kStages) & 1);
    const uint64_t a = desc_sw128(a_s + st * kA + w * 64 * kBK);
    const uint64_t b = desc_sw128(b_s + st * kB);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) wgmma_s8<kBN>(acc, a + 2 * kk, b + 2 * kk, kc + kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's products are done: release its stage
    fence_regs(acc);
    if (kc > 0 && lane == 0) mbar_arrive(&empty[(kc - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue: ((acc * s_m) * ws_n) [+ b_n], one rounding to T, staged
  // in the stages' shared memory (once both warpgroups' products are done)
  // and written out in 16-byte row pieces
  mbar_wait(cols_full, 0);
  bar_sync(1, 256);
  // a warpgroup's 64 x kBN tile, rows padded by 16 bytes so that the
  // accumulator-order writes hit distinct banks
  constexpr int kPitch = kBN + 16 / (int)sizeof(T);
  T* tile = reinterpret_cast<T*>(a_s) + w * 64 * kPitch;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float w0 = ws_s[c], w1 = ws_s[c + 1];
    const float b0 = bias_s[c], b1 = bias_s[c + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * r]), s[r]), w0);
      float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * r + 1]), s[r]), w1);
      if (bias != nullptr) {
        y0 = __fadd_rn(y0, b0);
        y1 = __fadd_rn(y1, b1);
      }
      store2<T>(tile + (wi * 16 + g + 8 * r) * kPitch + c, y0, y1);
    }
  }
  bar_sync(2 + w, 128);
  constexpr int kPiece = 16 / (int)sizeof(T);  // elements of a 16-byte piece
  const bool vector = (long)n * sizeof(T) % 16 == 0;
  const int tid = threadIdx.x & 127;
  for (int i = tid; i < 64 * (kBN / kPiece); i += 128) {
    const int rl = i / (kBN / kPiece), c = (i % (kBN / kPiece)) * kPiece;
    const long row = m0 + w * 64 + rl;
    const int col = n0 + c;
    if (row >= m || col >= n) continue;
    const T* src = tile + rl * kPitch + c;
    T* dst = out + row * n + col;
    if (vector && col + kPiece <= n) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kPiece && col + e < n; ++e) dst[e] = src[e];
    }
  }
}

template <typename T>
int launch_gemm(const CUtensorMap& x_map, const void* wq, const float* xs, const float* ws,
                const float* bias, void* out, int m, int n, int k, cudaStream_t stream) {
  CUtensorMap w_map;
  if (int err = make_map_2d_s8(&w_map, wq, n, k, kBN)) return err;
  cudaError_t e = cudaFuncSetAttribute(gemm_wgmma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_wgmma<T><<<grid, kThreads, kSmem, stream>>>(x_map, w_map, xs, ws, bias,
                                                   static_cast<T*>(out), m, n, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wq, const float* ws, const float* bias, void* out,
           int8_t* xq, float* xs, int m, int n, int k, cudaStream_t stream) {
  quantize_rows<T><<<m, kQuantThreads, 0, stream>>>(static_cast<const T*>(x), xq, xs, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap x_map;
  if (int err = make_map_2d_s8(&x_map, xq, m, k, kBM)) return err;
  return launch_gemm<T>(x_map, wq, xs, ws, bias, out, m, n, k, stream);
}

}  // namespace

// dtype (of x and out): 0 = bfloat16, 1 = float32. bias may be null. xq
// ([M, K] int8) and xs ([M] fp32) are the caller's workspace. Needs K a
// multiple of 16, N even, and x, wq, xq, out 16-byte aligned. Returns a
// cudaError_t (0 = success); -1 for an argument the kernels do not take.
extern "C" int dad_w8a8_matmul(const void* x, const void* wq, const void* ws, const void* bias,
                               void* out, void* xq, void* xs, int m, int n, int k, int dtype,
                               void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 2 || (m + kBM - 1) / kBM > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(xs);
  if (dtype == 0) return launch<__nv_bfloat16>(x, wq, w, b, out, q, s, m, n, k, st);
  if (dtype == 1) return launch<float>(x, wq, w, b, out, q, s, m, n, k, st);
  return -1;
}
