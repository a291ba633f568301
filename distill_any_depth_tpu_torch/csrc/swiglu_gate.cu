// The SwiGLU gate for Hopper (sm_90a): out = silu(x1) * x2, read straight
// from the packed output of the FFN's w12 projection, x12 [M, 2h] = [x1 | x2],
// and its backward, dx12 = [g x2 silu'(x1) | g silu(x1)].
//
// Replaces no TPU kernel: the JAX package leaves `jax.nn.silu(x1) * x2` to
// XLA, which fuses it into one pass. ATen runs it as two kernels over the
// strided halves (row stride 2h): F.silu(x1) writes an [M, h] temporary that
// the product reads back, 5 M h elements moved where 3 M h are needed, both
// through ATen's non-vectorized path, since neither half is contiguous.
//
// Bound: bytes (a few flops an element). The forward reads x1 and x2 once
// and writes out once: 3 M h elements. ViT-g at 518^2 bs8 (M = 10960, h =
// 4096, bf16): 269 MB, 80.4 us at 3.35 TB/s. The backward reads g, x1 and x2
// and writes dx1 and dx2: 5 M h elements.
//
// Design: one pass, 16 bytes a load. Each step of a grid-stride loop takes
// one 16-byte vector of x1 (8 bf16 or 4 fp32, row r, columns c..), the
// matching vector of x2 (columns h + c..), computes in fp32, rounds once to
// the output type and writes one 16-byte vector. The grid fills every SM at
// full occupancy (8 blocks of 256 threads), so each SM keeps 64 KB of loads
// in flight, above what the memory's latency asks for. A row width that is
// not a multiple of the vector, or a pointer that is not 16-byte aligned,
// takes the scalar loop: the same arithmetic, one element a step. Indices are
// 32-bit where the work fits, as at every shape the models run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One 16-byte vector of T as fp32 values, and back.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  float v[N];

  __device__ __forceinline__ void load(const T* p) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_float(e[i]);
  }

  __device__ __forceinline__ void store(T* p) const {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_float<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

__device__ __forceinline__ float sigmoid(float a) { return 1.f / (1.f + __expf(-a)); }

// ATen's silu: x / (1 + exp(-x))
__device__ __forceinline__ float gate(float a, float b) { return a / (1.f + __expf(-a)) * b; }

// d/da and d/db of silu(a) * b times g; silu'(a) = s (1 + a (1 - s)), as
// ATen's silu backward
__device__ __forceinline__ void gate_grad(float g, float a, float b, float& da, float& db) {
  const float s = sigmoid(a);
  da = g * b * (s * (1.f + a * (1.f - s)));
  db = g * (a * s);
}

// x12 [rows, 2h] -> out [rows, h]; `step` elements a thread step, and
// `width` = h / step steps a row.
template <typename T, typename I, bool kVec>
__global__ void __launch_bounds__(kThreads)
    swiglu_gate_fwd_kernel(const T* __restrict__ x12, T* __restrict__ out, I rows, I width) {
  constexpr I step = kVec ? Vec<T>::N : 1;
  const I h = width * step;
  const I total = rows * width;
  for (I i = blockIdx.x * (I)kThreads + threadIdx.x; i < total; i += (I)gridDim.x * kThreads) {
    const I r = i / width;
    const I c = (i - r * width) * step;
    const T* a = x12 + r * 2 * h + c;
    if constexpr (kVec) {
      Vec<T> x1, x2;
      x1.load(a);
      x2.load(a + h);
#pragma unroll
      for (int k = 0; k < Vec<T>::N; ++k) x1.v[k] = gate(x1.v[k], x2.v[k]);
      x1.store(out + r * h + c);
    } else {
      out[r * h + c] = from_float<T>(gate(to_float(a[0]), to_float(a[h])));
    }
  }
}

// g [rows, h], x12 [rows, 2h] -> dx12 [rows, 2h]
template <typename T, typename I, bool kVec>
__global__ void __launch_bounds__(kThreads)
    swiglu_gate_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x12,
                           T* __restrict__ dx12, I rows, I width) {
  constexpr I step = kVec ? Vec<T>::N : 1;
  const I h = width * step;
  const I total = rows * width;
  for (I i = blockIdx.x * (I)kThreads + threadIdx.x; i < total; i += (I)gridDim.x * kThreads) {
    const I r = i / width;
    const I c = (i - r * width) * step;
    const I in = r * 2 * h + c;
    if constexpr (kVec) {
      Vec<T> gv, x1, x2;
      gv.load(g + r * h + c);
      x1.load(x12 + in);
      x2.load(x12 + in + h);
#pragma unroll
      for (int k = 0; k < Vec<T>::N; ++k) gate_grad(gv.v[k], x1.v[k], x2.v[k], x1.v[k], x2.v[k]);
      x1.store(dx12 + in);
      x2.store(dx12 + in + h);
    } else {
      float da, db;
      gate_grad(to_float(g[r * h + c]), to_float(x12[in]), to_float(x12[in + h]), da, db);
      dx12[in] = from_float<T>(da);
      dx12[in + h] = from_float<T>(db);
    }
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int blocks_for(long long work, int sms) {
  const long long want = (work + kThreads - 1) / kThreads;
  const long long most = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
  return (int)(want < most ? want : most);
}

// Picks the vector or scalar loop and 32- or 64-bit indices, and launches.
template <typename T, typename Launch>
int dispatch(bool vec_ok, long long rows, long long h, int sms, Launch launch) {
  const bool vec = vec_ok && h % Vec<T>::N == 0;
  const long long width = vec ? h / Vec<T>::N : h;
  // the largest index a loop forms: 2 h rows, plus a grid's stride past the end
  const bool narrow = rows * 2 * h + (long long)sms * kBlocksPerSm * kThreads < (1ll << 31);
  const int blocks = blocks_for(rows * width, sms);
  if (vec) {
    if (narrow) launch(std::integral_constant<bool, true>(), (uint32_t)0, blocks, width);
    else launch(std::integral_constant<bool, true>(), (uint64_t)0, blocks, width);
  } else {
    if (narrow) launch(std::integral_constant<bool, false>(), (uint32_t)0, blocks, width);
    else launch(std::integral_constant<bool, false>(), (uint64_t)0, blocks, width);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* x12, void* out, long long rows, long long h, int sms, cudaStream_t st) {
  const T* x = static_cast<const T*>(x12);
  T* o = static_cast<T*>(out);
  return dispatch<T>(aligned(x12) && aligned(out), rows, h, sms,
                     [&](auto vec, auto idx, int blocks, long long width) {
                       using I = decltype(idx);
                       swiglu_gate_fwd_kernel<T, I, decltype(vec)::value>
                           <<<blocks, kThreads, 0, st>>>(x, o, (I)rows, (I)width);
                     });
}

template <typename T>
int bwd(const void* g, const void* x12, void* dx12, long long rows, long long h, int sms,
        cudaStream_t st) {
  const T* gp = static_cast<const T*>(g);
  const T* x = static_cast<const T*>(x12);
  T* d = static_cast<T*>(dx12);
  return dispatch<T>(aligned(g) && aligned(x12) && aligned(dx12), rows, h, sms,
                     [&](auto vec, auto idx, int blocks, long long width) {
                       using I = decltype(idx);
                       swiglu_gate_bwd_kernel<T, I, decltype(vec)::value>
                           <<<blocks, kThreads, 0, st>>>(gp, x, d, (I)rows, (I)width);
                     });
}

}  // namespace

// dtype: 0 bf16, 1 fp32. sms: the card's SM count (sizes the grid). Returns
// the launch's CUDA error, -1 for arguments the kernels do not take.
extern "C" int dad_swiglu_gate_fwd(const void* x12, void* out, long long rows, long long h,
                                   int dtype, int sms, void* stream) {
  if (rows < 0 || h <= 0) return -1;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<__nv_bfloat16>(x12, out, rows, h, sms, st);
  if (dtype == 1) return fwd<float>(x12, out, rows, h, sms, st);
  return -1;
}

extern "C" int dad_swiglu_gate_bwd(const void* g, const void* x12, void* dx12, long long rows,
                                   long long h, int dtype, int sms, void* stream) {
  if (rows < 0 || h <= 0) return -1;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<__nv_bfloat16>(g, x12, dx12, rows, h, sms, st);
  if (dtype == 1) return bwd<float>(g, x12, dx12, rows, h, sms, st);
  return -1;
}
