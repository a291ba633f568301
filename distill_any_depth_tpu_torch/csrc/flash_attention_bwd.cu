// Packed-QKV softmax attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel distill_any_depth_tpu/ops/flash_attention.py
// ::_packed_bwd_impl (body _packed_bwd_kernel): d(qkv) of the forward in
// flash_attention.cu, written straight into the packed layout.
//
//   qkv [B, N, 3*H*D], out [B, N, H*D], g = d(out) [B, N, H*D],
//   lse [B, H, N] fp32 (from the forward)  ->  dqkv [B, N, 3*H*D]
//   (dq, dk, dv in the q|k|v column blocks, head-major inside each)
//
// Numerics follow _packed_bwd_kernel: fp32 scores s = (q.k)*D^-1/2;
// probabilities p = exp(s - lse) rounded to the input type before the dV
// product; t = p*(dP - delta) rounded to the input type before the dQ and dK
// products; fp32 accumulation of dK/dV across q tiles and of dQ across key
// tiles; the D^-1/2 of dQ and dK applied to the fp32 sums. Unlike the TPU
// kernel, which recomputes the row max and sum per q tile and corrects the
// sum for its 8-row key pad in closed form (NaN when every real logit of a
// row is below about -50), keys at or past N are masked with -inf (dQ pass)
// or touch only rows that are never stored (dK/dV pass), and p comes from
// the forward's lse, which is finite for every real row.
//
// Bound at the ViT-B 392^2 bs16 training shape (B=16, N=785, H=12, D=64,
// bf16): the five N x N x D products, 10*B*H*N^2*D = 75.7 GFLOP, take
// 76.6 us at 989 TFLOP/s; qkv, out and g read once and dqkv written once,
// about 155 MB, take 46 us at 3.35 TB/s: compute-bound.
//
// Design (deterministic, no atomics), three launches on the caller's stream:
//   1. delta[b, h, i] = sum_d g . out over the row's 64 columns, fp32;
//   2. dK/dV: one block of 4 warps per (64-key tile, head, batch), each warp
//      owning 16 keys; q tiles stream through shared memory. Per q tile:
//      S^T = K Q^T, P^T = exp(S^T - lse), dP^T = V dO^T, dV += P^T dO,
//      dK += (P^T (dP^T - delta)) Q: four products;
//   3. dQ: one block per (64-row q tile, head, batch), each warp owning 16
//      q rows; key tiles stream through shared memory. Per key tile:
//      S = Q K^T, P, dP = dO V^T, dQ += (P (dP - delta)) K: three products.
// Seven products where the bound counts five: S and dP are computed in
// both passes. bf16 runs the products on mma.sync m16n8k16; fp32 runs the
// same tiles with scalar FMAs (attention_tiles.cuh), for the tight checks.

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

using namespace dad_attn;

// ---- 1. delta: attention_tiles.cuh's delta_kernel

template <typename T>
struct Smem {
  T* a;       // dK/dV: K   | dQ: Q
  T* b;       // dK/dV: V   | dQ: dO
  T* c;       // dK/dV: Q   | dQ: K
  T* d;       // dK/dV: dO  | dQ: V
  float* lse;    // dK/dV: lse of the q tile's rows (+inf past N)
  float* delta;  // dK/dV: delta of the q tile's rows (0 past N)
  float* pw;     // fp32 path: this warp's P staging
};

template <typename T>
__device__ __forceinline__ Smem<T> carve(unsigned char* smem) {
  constexpr int kRow = row_elems<T>();
  Smem<T> s;
  s.a = reinterpret_cast<T*>(smem);
  s.b = s.a + kTile * kRow;
  s.c = s.b + kTile * kRow;
  s.d = s.c + kTile * kRow;
  s.lse = reinterpret_cast<float*>(s.d + kTile * kRow);
  s.delta = s.lse + kTile;
  s.pw = s.delta + kTile + (threadIdx.x >> 5) * 16 * kProw;
  return s;
}

template <typename T>
size_t smem_bytes() {
  size_t bytes = (size_t)4 * kTile * row_elems<T>() * sizeof(T) + 2 * kTile * sizeof(float);
  if (sizeof(T) == 4) bytes += (size_t)kWarps * 16 * kProw * sizeof(float);
  return bytes;
}

// ---- 2. dK, dV for one 64-key tile of one head
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dqkv, int n, int heads, float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> sm = carve<T>(smem);
  T *ks = sm.a, *vs = sm.b, *qs = sm.c, *dos = sm.d;

  const int c = heads * kD;
  const long stride = 3L * c;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* base = qkv + (long)b * n * stride;
  const T* gbase = g + (long)b * n * c;
  const float* lse_b = lse + ((long)b * heads + h) * n;
  const float* delta_b = delta + ((long)b * heads + h) * n;
  const int t = threadIdx.x & 3;

  load_tile<T>(ks, base, k0, n, stride, c + h * kD);
  load_tile<T>(vs, base, k0, n, stride, 2 * c + h * kD);

  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  const int n_tiles = (n + kTile - 1) / kTile;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile<T>(qs, base, q0, n, stride, h * kD);
    load_tile<T>(dos, gbase, q0, n, c, h * kD);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool ok = q0 + i < n;
      sm.lse[i] = ok ? lse_b[q0 + i] : INFINITY;  // p = 0 for rows past N
      sm.delta[i] = ok ? delta_b[q0 + i] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 q rows
    float p[8][4], dp[8][4];
    zero(p);
    zero(dp);
    if constexpr (kBf16) {
      uint32_t af[4][4];
      load_a_frags(af, ks);
      mma_nt(p, af, qs);
      load_a_frags(af, vs);
      mma_nt(dp, af, dos);
    } else {
      fma_nt(p, reinterpret_cast<const float*>(ks), reinterpret_cast<const float*>(qs));
      fma_nt(dp, reinterpret_cast<const float*>(vs), reinterpret_cast<const float*>(dos));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int q = 8 * j + 2 * t + (e & 1);
        p[j][e] = round_to<T>(expf(p[j][e] * scale - sm.lse[q]));
      }

    // dV += P^T dO
    if constexpr (kBf16) {
      uint32_t pf[8][2];
      to_bf16(pf, p);
      mma_nn(dv, pf, dos);
    } else {
      fma_nn(dv, p, sm.pw, reinterpret_cast<const float*>(dos));
    }

    // dK += (P^T (dP^T - delta)) Q
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int q = 8 * j + 2 * t + (e & 1);
        p[j][e] *= dp[j][e] - sm.delta[q];
      }
    if constexpr (kBf16) {
      uint32_t pf[8][2];
      to_bf16(pf, p);
      mma_nn(dk, pf, qs);
    } else {
      fma_nn(dk, p, sm.pw, reinterpret_cast<const float*>(qs));
    }
  }
  T* dst = dqkv + (long)b * n * stride;
  store_rows<T>(dst, dk, k0, n, stride, c + h * kD, scale);
  store_rows<T>(dst, dv, k0, n, stride, 2 * c + h * kD, 1.f);
}

// ---- 3. dQ for one 64-row q tile of one head
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ qkv, const T* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dqkv, int n, int heads, float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> sm = carve<T>(smem);
  T *qs = sm.a, *dos = sm.b, *ks = sm.c, *vs = sm.d;

  const int c = heads * kD;
  const long stride = 3L * c;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* base = qkv + (long)b * n * stride;
  const float* lse_b = lse + ((long)b * heads + h) * n;
  const float* delta_b = delta + ((long)b * heads + h) * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g_row = lane >> 2, t = lane & 3;

  load_tile<T>(qs, base, q0, n, stride, h * kD);
  load_tile<T>(dos, g + (long)b * n * c, q0, n, c, h * kD);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g_row + 8 * r;
    row_lse[r] = row < n ? lse_b[row] : INFINITY;  // p = 0 for rows past N
    row_delta[r] = row < n ? delta_b[row] : 0.f;
  }

  uint32_t qf[4][4], df[4][4];  // bf16 fragments of this warp's q and dO rows
  float dq[8][4];
  zero(dq);
  const int n_tiles = (n + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T>(ks, base, k0, n, stride, c + h * kD);
    load_tile<T>(vs, base, k0, n, stride, 2 * c + h * kD);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 q rows x 64 keys
    float p[8][4], dp[8][4];
    zero(p);
    zero(dp);
    if constexpr (kBf16) {
      if (kt == 0) {
        load_a_frags(qf, qs);
        load_a_frags(df, dos);
      }
      mma_nt(p, qf, ks);
      mma_nt(dp, df, vs);
    } else {
      fma_nt(p, reinterpret_cast<const float*>(qs), reinterpret_cast<const float*>(ks));
      fma_nt(dp, reinterpret_cast<const float*>(dos), reinterpret_cast<const float*>(vs));
    }
    // P = exp(S - lse), zero for keys past N; T = P (dP - delta)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int r = e >> 1;
        float pe = key < n ? round_to<T>(expf(p[j][e] * scale - row_lse[r])) : 0.f;
        p[j][e] = pe * (dp[j][e] - row_delta[r]);
      }
    // dQ += T K
    if constexpr (kBf16) {
      uint32_t pf[8][2];
      to_bf16(pf, p);
      mma_nn(dq, pf, ks);
    } else {
      fma_nn(dq, p, sm.pw, reinterpret_cast<const float*>(ks));
    }
  }
  store_rows<T>(dqkv + (long)b * n * stride, dq, q0, n, stride, h * kD, scale);
}

template <typename T>
int launch(const void* qkv, const void* out, const void* g, const float* lse, float* delta,
           void* dqkv, int batch, int n, int heads, float scale, cudaStream_t stream) {
  const T* qkv_t = static_cast<const T*>(qkv);
  const T* g_t = static_cast<const T*>(g);
  T* dqkv_t = static_cast<T*>(dqkv);
  cudaError_t err = launch_delta<T>(static_cast<const T*>(out), g_t, delta, batch, n, heads,
                                    stream);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = smem_bytes<T>();
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  err = cudaFuncSetAttribute(dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T><<<grid, kThreads, smem, stream>>>(qkv_t, g_t, lse, delta, dqkv_t, n, heads,
                                                   scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T><<<grid, kThreads, smem, stream>>>(qkv_t, g_t, lse, delta, dqkv_t, n, heads,
                                                 scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. delta is fp32 scratch of B*H*N floats.
// Returns a cudaError_t (0 = success); -1 for an argument the kernels do
// not take.
extern "C" int dad_packed_attention_bwd(const void* qkv, const void* out, const void* g,
                                        const void* lse, void* delta, void* dqkv, int batch,
                                        int n, int heads, int head_dim, int dtype, float scale,
                                        void* stream) {
  if (head_dim != kD || n <= 0 || batch <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch<__nv_bfloat16>(qkv, out, g, l, dl, dqkv, batch, n, heads, scale, st);
  if (dtype == 1) return launch<float>(qkv, out, g, l, dl, dqkv, batch, n, heads, scale, st);
  return -1;
}
