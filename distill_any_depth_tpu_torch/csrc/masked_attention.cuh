// Masked softmax attention forward, shared by the additive-bias kernel
// (flash_attention_bias.cu) and the banded window kernel
// (flash_attention_banded.cu), for sm_90a.
//
//   q, k, v [B, N, H, D] with rows `stride` elements apart and batches
//   `batch_stride` apart (head h at column h*D): three separate tensors, or
//   the q|k|v thirds of the fused-QKV GEMM output read in place
//   ->  out [B, N, H*D] contiguous, and, if asked, the row log-sum-exp
//       lse [B, H, N] fp32 for the backward (masked_attention_bwd.cuh)
//
// The Mask policy (attention_masks.cuh) supplies the additive term of each
// score and the range of 64-key tiles a q tile visits.
//
// Numerics follow the JAX package's _attn_kernel / _banded_kernel: fp32
// scores (q.k)*D^-1/2 + term, an online softmax over 64-key tiles with
// exp(s - m) rounded to the input type before both the row sum and the PV
// product, fp32 accumulation, division by the sum after PV. Keys at or past
// N are a true -inf. The -inf guards of _banded_kernel keep a row whose
// keys so far are all masked at m = -inf without a NaN: its exponentials are
// taken against 0 and are exactly 0, and its correction factor is 0. A row
// with no unmasked key at all is written as 0, and its lse as +inf, so that
// the backward's recomputed probabilities exp(s - lse) are exactly 0 there
// (the JAX _banded_kernel_lse).
//
// A key tile whose term is -inf for every row of the q tile adds exactly
// nothing, so the block skips it before loading its K and V (the window
// mask leaves 49 of 1369 keys of a row at 518^2).
//
// Design: one block of 4 warps per (q tile of 64 rows, head, batch), each
// warp owning 16 q rows; K/V tiles stream through shared memory (cp.async,
// zero-filled past N); bf16 on the tensor cores with mma.sync m16n8k16,
// fp32 as scalar FMAs over the same accumulator ownership
// (attention_tiles.cuh). The terms of a tile are staged (coalesced) and read
// into registers before its K/V, so the skip decision is one
// __syncthreads_or, which is also the barrier that retires the previous K/V
// tile.
#pragma once

#include <type_traits>

#include "attention_masks.cuh"

namespace dad_attn {

template <typename T, typename Mask>
size_t masked_attn_smem() {
  size_t smem = (size_t)3 * kTile * row_elems<T>() * sizeof(T) + Mask::kScratch;
  if (!std::is_same<T, __nv_bfloat16>::value) smem += (size_t)kWarps * 16 * kProw * sizeof(float);
  return smem;
}

template <typename T, typename Mask>
__global__ void __launch_bounds__(kThreads)
    masked_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, float* __restrict__ lse, long stride,
                       long batch_stride, int n, int heads, float scale, const Mask mask) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kRow = row_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kTile * kRow;
  T* vs = ks + kTile * kRow;
  unsigned char* scratch = reinterpret_cast<unsigned char*>(vs + kTile * kRow);
  float* ps = reinterpret_cast<float*>(scratch + Mask::kScratch);  // fp32 path only

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long boff = (long)b * batch_stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair
  const int rl = warp * 16 + g;  // this thread's rows: rl and rl + 8 of the tile
  const typename Mask::Row rows[2] = {mask.row(q0 + rl), mask.row(q0 + rl + 8)};

  load_tile<T>(qs, q + boff, q0, n, stride, h * kD);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[4][4];  // bf16 q fragments: 4 k-steps of 16 dims
  if constexpr (kBf16) load_a_frags(qf, qs);

  float o[8][4];
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int2 span = mask.tiles(q0);
  for (int kt = span.x; kt <= span.y; ++kt) {
    if (!mask.tile_live(q0, kt)) continue;
    const int k0 = kt * kTile;
    // ---- the additive terms of this thread's scores; skip a dead tile.
    // The scratch of the last tile was read before the last
    // __syncthreads_or, so it may be overwritten here.
    mask.stage(scratch, q0, k0);
    __syncthreads();
    float s[8][4];
    bool live = false;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int kl = 8 * j + 2 * t + (e & 1);
        float a = k0 + kl < n ? mask.at(scratch, rows[e >> 1], rl + 8 * (e >> 1), kl)
                              : -INFINITY;
        s[j][e] = a;
        live |= a != -INFINITY;
      }
    if (!__syncthreads_or(live)) continue;  // also: every warp is done with the last K/V
    load_tile<T>(ks, k + boff, k0, n, stride, h * kD);
    load_tile<T>(vs, v + boff, k0, n, stride, h * kD);
    cp_async_wait_all();
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 keys, plus the terms
    float acc[8][4];
    zero(acc);
    if constexpr (kBf16) {
      mma_nt(acc, qf, ks);
    } else {
      fma_nt(acc, reinterpret_cast<const float*>(qs), reinterpret_cast<const float*>(ks));
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = acc[j][e] * scale + s[j][e];
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }

    // ---- online softmax (rows g and g+8), with the -inf guards
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m_run[r] - m_use[r]);  // 0 while the row had no live key
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
    float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][2 * r] *= inv;
      o[j][2 * r + 1] *= inv;
    }
    const int row = q0 + rl + 8 * r;
    if (lse != nullptr && t == 0 && row < n)
      lse[((long)b * heads + h) * n + row] = l_run[r] > 0.f ? m_run[r] + logf(l_run[r])
                                                            : INFINITY;
  }
  const int c = heads * kD;
  store_rows<T>(out + (long)b * n * c, o, q0, n, c, h * kD, 1.f);
}

// Launch masked_attn_kernel<T, Mask> over (q tiles, heads, batch) on
// `stream` (lse may be null: inference); returns a cudaError_t (0 =
// success).
template <typename T, typename Mask>
int launch_masked(const void* q, const void* k, const void* v, void* out, float* lse,
                  long stride, long batch_stride, int batch, int n, int heads, float scale,
                  const Mask& mask, cudaStream_t stream) {
  size_t smem = masked_attn_smem<T, Mask>();
  cudaError_t err = cudaFuncSetAttribute(masked_attn_kernel<T, Mask>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTile - 1) / kTile, heads, batch);
  masked_attn_kernel<T, Mask><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, stride, batch_stride, n, heads, scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace dad_attn
