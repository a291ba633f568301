// Packed-QKV softmax attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel distill_any_depth_tpu/ops/flash_attention.py
// ::_packed_fwd_impl (body _packed_kernel): bias-free attention read straight
// from the fused-QKV GEMM output.
//
//   qkv [B, N, 3*H*D] (column order q|k|v, head, dim)  ->  out [B, N, H*D]
//   and, when asked (training), the row log-sum-exp lse [B, H, N] fp32
//
// Numerics follow _packed_kernel: fp32 scores (q.k)*D^-1/2 and row max,
// exp(s - m) rounded to the input type before the PV product, an fp32 sum of
// the rounded values, fp32 PV accumulation, division by the sum after PV.
// Keys at or past N are masked with a true -inf in both the max and the sum
// (no closed-form pad correction, which cancels when every real logit of a
// row is strongly negative). lse = m + log(sum) is what the backward
// (flash_attention_bwd.cu) recomputes the probabilities from.
//
// Bound at the ViT-B 392^2 bs8 shape (B=8, N=785, H=12, D=64, bf16):
// 4*B*H*N^2*D = 15.1 GFLOP (15.3 us at 989 TFLOP/s) against 38.6 MB moved
// (11.5 us at 3.35 TB/s): compute-bound on the tensor cores.
//
// Design: one block of 4 warps per (q tile of 64 rows, head, batch); each
// warp owns 16 q rows. K/V tiles of 64 keys stream through shared memory
// (cp.async, zero-filled past N) with an online softmax, since K+V of one
// head (~200 KB in bf16) do not fit beside the q tile. bf16 runs the two
// products on the tensor cores with mma.sync m16n8k16 (fp32 accumulate);
// fp32 runs the same tiles, masks and softmax with scalar FMAs over the same
// accumulator ownership, so both types share everything but the products
// (attention_tiles.cuh). wgmma, TMA and warp specialisation are left for
// later work.

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

using namespace dad_attn;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    packed_attn_kernel(const T* __restrict__ qkv, T* __restrict__ out, float* __restrict__ lse,
                       int n, int heads, float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kRow = row_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kTile * kRow;
  T* vs = ks + kTile * kRow;
  float* ps = reinterpret_cast<float*>(vs + kTile * kRow);  // fp32 path only

  const int c = heads * kD;
  const long stride = 3L * c;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* base = qkv + (long)b * n * stride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair

  load_tile<T>(qs, base, q0, n, stride, h * kD);

  uint32_t qf[4][4];  // bf16 q fragments: 4 k-steps of 16 dims
  float o[8][4];
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int n_tiles = (n + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T>(ks, base, k0, n, stride, c + h * kD);
    load_tile<T>(vs, base, k0, n, stride, 2 * c + h * kD);
    cp_async_wait_all();
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
    zero(s);
    if constexpr (kBf16) {
      if (kt == 0) load_a_frags(qf, qs);
      mma_nt(s, qf, ks);
    } else {
      fma_nt(s, reinterpret_cast<const float*>(qs), reinterpret_cast<const float*>(ks));
    }

    // ---- scale, mask keys >= n, online softmax (rows g and g+8)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int key = k0 + 8 * j + 2 * t + (e & 1);
        float v = key < n ? s[j][e] * scale : -INFINITY;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      float m_new = fmaxf(m_run[r], mx[r]);
      // every tile holds at least one real key, so m_new is finite; guard anyway
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m_run[r] - m_use[r]);  // exp(-inf) = 0 on the first tile
      m_run[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
    uint32_t pf[8][2];  // bf16 P packed in accumulator order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p0 = expf(s[j][0] - m_use[0]);
      float p1 = expf(s[j][1] - m_use[0]);
      float p2 = expf(s[j][2] - m_use[1]);
      float p3 = expf(s[j][3] - m_use[1]);
      if constexpr (kBf16) {
        pf[j][0] = pack_bf16(p0, p1);
        pf[j][1] = pack_bf16(p2, p3);
        __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&pf[j][0]);
        __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&pf[j][1]);
        psum[0] += __low2float(lo) + __high2float(lo);
        psum[1] += __low2float(hi) + __high2float(hi);
      } else {
        s[j][0] = p0; s[j][1] = p1; s[j][2] = p2; s[j][3] = p3;
        psum[0] += p0 + p1;
        psum[1] += p2 + p3;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // ---- O += P V
    if constexpr (kBf16) {
      mma_nn(o, pf, vs);
    } else {
      fma_nn(o, s, ps + warp * 16 * kProw, reinterpret_cast<const float*>(vs));
    }
  }

  // ---- normalise and store rows g, g+8 of this warp (and their lse)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    float inv = 1.f / l_run[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][2 * r] *= inv;
      o[j][2 * r + 1] *= inv;
    }
    int row = q0 + warp * 16 + g + 8 * r;
    if (lse != nullptr && t == 0 && row < n)
      lse[((long)b * heads + h) * n + row] = m_run[r] + logf(l_run[r]);
  }
  store_rows<T>(out + (long)b * n * c, o, q0, n, c, h * kD, 1.f);
}

template <typename T>
int launch(const void* qkv, void* out, float* lse, int batch, int n, int heads, float scale,
           cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  size_t smem = (size_t)3 * kTile * row_elems<T>() * sizeof(T);
  if (!kBf16) smem += (size_t)kWarps * 16 * kProw * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(packed_attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTile - 1) / kTile, heads, batch);
  packed_attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, n, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. lse may be null (inference). Returns a
// cudaError_t (0 = success); -1 for an argument the kernel does not take.
extern "C" int dad_packed_attention(const void* qkv, void* out, void* lse, int batch, int n,
                                    int heads, int head_dim, int dtype, float scale,
                                    void* stream) {
  if (head_dim != kD || n <= 0 || batch <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return launch<__nv_bfloat16>(qkv, out, l, batch, n, heads, scale, st);
  if (dtype == 1) return launch<float>(qkv, out, l, batch, n, heads, scale, st);
  return -1;
}
