// W8A8 GEMM with the activations quantized inside the kernel, for Hopper (sm_90a).
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
// in a row makes its scale NaN, as the plain version's amax does.
//
// Bound at the ViT-L 518^2 bs8 shapes (M = 10960, bf16 in and out): qkv
// (K 1024, N 3072) 69.0 GOP, 34.8 us at 1979 TOP/s int8, against 92 MB
// moved (27.5 us at 3.35 TB/s); fc1 and fc2 46.5 us, operation-bound; proj
// 13.7 us, byte-bound (cli/kernel_bounds.py).
//
// Design: one block of 8 warps per 128 x 128 output tile, the grid's fast
// axis over N so that the blocks of one row tile run together and share x in
// L2. A prologue reduces the row amax of the block's 128 rows over all of K
// (warp w owns rows 16w..16w+15, 16-byte loads across the row); the K loop
// then takes 64-column chunks: each thread loads its 4 x 8 elements of x
// into registers one chunk ahead, divides them by their row scale and stores
// the int8 values into a double-buffered shared tile, while the matching
// [128 x 64] int8 weight chunk arrives by cp.async (zero-filled past N and
// K). Warps compute 64 x 32 sub-tiles with ldmatrix and
// mma.sync.m16n8k32.s8.s8.s32. What it re-reads: every block of a row tile
// reads that tile of x twice (prologue and loop) and requantizes it, once for
// each of the N / 128 column tiles (24 for qkv), where the TPU kernel
// quantizes each row tile once; the weights are read once per row tile.
// wgmma, TMA, a scale pass shared across a cluster are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128, kBN = 128;  // output tile
constexpr int kBK = 64;              // K chunk (int8 bytes per row)
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kRow = kBK + 16;  // padded smem row: the 8 rows of an ldmatrix hit distinct banks
constexpr float kEps = 1e-8f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x32] * b[32x8], int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight consecutive elements of x as raw 16-byte words (bf16: one, fp32: two).
template <typename T>
__device__ __forceinline__ void load8(uint4 (&r)[2], const T* p, bool ok) {
  const uint4 z = make_uint4(0, 0, 0, 0);
  const uint4* q = reinterpret_cast<const uint4*>(p);
  r[0] = ok ? __ldg(q) : z;
  if constexpr (sizeof(T) == 4) r[1] = ok ? __ldg(q + 1) : z;
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

// Four int8 values round_half_even(f / s), packed little-endian.
__device__ __forceinline__ uint32_t quant4(const float* f, float s) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out |= (static_cast<uint32_t>(__float2int_rn(__fdiv_rn(f[j], s))) & 0xffu) << (8 * j);
  return out;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float y0, float y1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    w8a8_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ ws, const float* __restrict__ bias, T* __restrict__ out,
                int m, int n, int k) {
  __shared__ __align__(16) int8_t as[2][kBM * kRow];
  __shared__ __align__(16) int8_t bs[2][kBN * kRow];
  __shared__ float xs[kBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;

  // ---- prologue: row scales. |x| as bits orders like the floats, NaN above +inf.
  const int units = k / 8;
#pragma unroll 1
  for (int r0 = 0; r0 < 16; r0 += 4) {
    uint32_t amax[4] = {0u, 0u, 0u, 0u};
    for (int u = lane; u < units; u += 32) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long row = m0 + warp * 16 + r0 + r;
        uint4 raw[2];
        float f[8];
        load8<T>(raw, x + row * k + 8 * u, row < m);
        to_float8<T>(f, raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) amax[r] = max(amax[r], __float_as_uint(f[i]) & 0x7fffffffu);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float a = __uint_as_float(__reduce_max_sync(0xffffffffu, amax[r]));
      if (lane == 0) xs[warp * 16 + r0 + r] = __fdiv_rn(a < kEps ? kEps : a, 127.f);
    }
  }
  __syncthreads();

  // ---- this thread's share of each chunk: 4 units of 8 x-elements (rows
  // tid/8 + 32i, columns 8 (tid%8)) and 2 16-byte weight pieces
  const int arow = tid >> 3, acol = 8 * (tid & 7);
  float sx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sx[i] = xs[arow + 32 * i];
  uint4 ra[4][2];

  auto load_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long row = m0 + arow + 32 * i;
      load8<T>(ra[i], x + row * k + k0 + acol, row < m && k0 + acol < k);
    }
  };
  auto store_a = [&](int st) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[8];
      to_float8<T>(f, ra[i]);
      *reinterpret_cast<uint2*>(&as[st][(arow + 32 * i) * kRow + acol]) =
          make_uint2(quant4(f, sx[i]), quant4(f + 4, sx[i]));
    }
  };
  auto load_b = [&](int st, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kThreads * i;
      const int row = c >> 2, col = 16 * (c & 3);
      const bool ok = n0 + row < n && k0 + col < k;
      cp_async16(&bs[st][row * kRow + col], ok ? wq + (long)(n0 + row) * k + k0 + col : wq,
                 ok ? 16 : 0);
    }
  };

  const int wm = warp >> 2, wn = warp & 3;  // this warp's 64 x 32 sub-tile
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int chunks = (k + kBK - 1) / kBK;
  load_a(0);
  load_b(0, 0);
  store_a(0);
  cp_async_wait_all();
  __syncthreads();
#pragma unroll 1
  for (int kc = 0; kc < chunks; ++kc) {
    const int st = kc & 1;
    const bool next = kc + 1 < chunks;
    if (next) {
      load_a((kc + 1) * kBK);
      load_b(st ^ 1, (kc + 1) * kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(a[mt], &as[st][(wm * 64 + mt * 16 + (lane & 15)) * kRow + kk + (lane >> 4) * 16]);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4(b[np], &bs[st][(wn * 32 + np * 16 + (lane & 7) + (lane >> 4) * 8) * kRow + kk +
                               ((lane >> 3) & 1) * 16]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)], b[nt >> 1][2 * (nt & 1) + 1]);
    }
    if (next) store_a(st ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // ---- epilogue: ((acc * s_m) * ws_n) [+ b_n], one rounding to T
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + 2 * t;  // n is even, so col < n covers col + 1
    if (col >= n) continue;
    const float w0 = ws[col], w1 = ws[col + 1];
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = wm * 64 + mt * 16 + g + 8 * r;
        const long row = m0 + lr;
        if (row >= m) continue;
        const float s = xs[lr];
        float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * r]), s), w0);
        float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * r + 1]), s), w1);
        if (bias != nullptr) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
        store2<T>(out + row * n + col, y0, y1);
      }
  }
}

template <typename T>
int launch(const void* x, const void* wq, const float* ws, const float* bias, void* out, int m,
           int n, int k, cudaStream_t stream) {
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  w8a8_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                 static_cast<const int8_t*>(wq), ws, bias,
                                                 static_cast<T*>(out), m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x and out): 0 = bfloat16, 1 = float32. bias may be null. Needs K
// a multiple of 16, N even, and x, wq, out 16-byte aligned. Returns a
// cudaError_t (0 = success); -1 for an argument the kernel does not take.
extern "C" int dad_w8a8_matmul(const void* x, const void* wq, const void* ws, const void* bias,
                               void* out, int m, int n, int k, int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 2 || (m + kBM - 1) / kBM > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return launch<__nv_bfloat16>(x, wq, w, b, out, m, n, k, st);
  if (dtype == 1) return launch<float>(x, wq, w, b, out, m, n, k, st);
  return -1;
}
