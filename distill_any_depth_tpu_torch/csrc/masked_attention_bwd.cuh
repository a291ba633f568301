// Masked softmax attention backward, shared by the additive-bias kernel
// (flash_attention_bias_bwd.cu, kernel 6) and the banded window kernel
// (flash_attention_banded_bwd.cu, kernel 8), for sm_90a.
//
//   q, k, v [B, N, H, D] with rows `stride` elements apart and batches
//   `batch_stride` apart (views into the fused-QKV output, or separate),
//   out, g = d(out) [B, N, H*D] contiguous, lse [B, H, N] fp32 from the
//   forward (masked_attention.cuh)
//   ->  dq, dk, dv with rows `dstride` elements apart and batches
//       `dbatch_stride` apart (the q|k|v thirds of one packed d(qkv))
//
// Numerics follow kernel 3 (flash_attention_bwd.cu) and the JAX
// _banded_tile_grads: fp32 scores s = (q.k)*D^-1/2 + term, probabilities
// p = exp(s - lse) from the forward's lse in fp32, rounded to the input type
// before the dV product; t = p*(dP - delta) rounded to the input type before
// the dQ and dK products, delta = rowsum(g * out); fp32 accumulation; the
// D^-1/2 of dQ and dK applied to the fp32 sums. A masked score is -inf and
// its p exactly 0; a row with no live key has lse = +inf, so its p is 0 for
// every key. (The JAX dense _bwd_kernel recomputes deferred-divide
// probabilities from the row max instead; in fp32 the two agree.)
//
// Design (deterministic, no atomics), three launches on the caller's stream,
// as kernel 3's:
//   1. delta (attention_tiles.cuh);
//   2. dK/dV: one block of 4 warps per (64-key tile, head, batch), each warp
//      owning 16 keys; the q tiles of Mask::inv_tiles stream through shared
//      memory, and a q tile that Mask::tile_live or the staged terms show
//      to be masked for all 64 keys is skipped before its Q and dO load. Per
//      live q tile: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
//      dK += (P^T (dP^T - delta)) Q;
//   3. dQ: one block per (64-row q tile, head, batch), each warp owning 16
//      q rows; the live key tiles of Mask::tiles stream through shared
//      memory. Per live key tile: S = Q K^T, dP = dO V^T,
//      dQ += (P (dP - delta)) K.
// bf16 runs the products on mma.sync m16n8k16; fp32 runs the same tiles
// with scalar FMAs (attention_tiles.cuh). The terms of a tile are staged in
// shared memory once and read twice: for the skip decision (one
// __syncthreads_or) and for the probabilities.
#pragma once

#include <type_traits>

#include "attention_masks.cuh"

namespace dad_attn {

template <typename T, typename Mask>
size_t masked_bwd_smem() {
  size_t bytes = (size_t)4 * kTile * row_elems<T>() * sizeof(T) + 2 * kTile * sizeof(float)
                 + Mask::kScratch;
  if (sizeof(T) == 4) bytes += (size_t)kWarps * 16 * kProw * sizeof(float);
  return bytes;
}

// Shared memory of both passes: four 64-row tiles, the q tile's lse and
// delta (dK/dV pass), the mask's scratch, and the fp32 path's P staging.
template <typename T, typename Mask>
struct BwdSmem {
  T *a, *b, *c, *d;
  float *lse, *delta;
  unsigned char* scratch;
  float* pw;
  __device__ explicit BwdSmem(unsigned char* smem) {
    constexpr int kRow = row_elems<T>();
    a = reinterpret_cast<T*>(smem);
    b = a + kTile * kRow;
    c = b + kTile * kRow;
    d = c + kTile * kRow;
    lse = reinterpret_cast<float*>(d + kTile * kRow);
    delta = lse + kTile;
    scratch = reinterpret_cast<unsigned char*>(delta + kTile);
    pw = reinterpret_cast<float*>(scratch + Mask::kScratch) + (threadIdx.x >> 5) * 16 * kProw;
  }
};

// ---- 2. dK, dV for one 64-key tile of one head
template <typename T, typename Mask>
__global__ void __launch_bounds__(kThreads)
    masked_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ g, const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk_out,
                       T* __restrict__ dv_out, long stride, long batch_stride, long dstride,
                       long dbatch_stride, int n, int heads, float scale, const Mask mask) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem<T, Mask> sm(smem);
  T *ks = sm.a, *vs = sm.b, *qs = sm.c, *dos = sm.d;

  const int kt = blockIdx.x, k0 = kt * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = heads * kD;
  const long boff = (long)b * batch_stride;
  const T* gb = g + (long)b * n * c;
  const float* lse_b = lse + ((long)b * heads + h) * n;
  const float* delta_b = delta + ((long)b * heads + h) * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int rl = warp * 16 + (lane >> 2);  // this thread's keys: rl and rl + 8 of the tile
  const typename Mask::Key keys[2] = {mask.key(k0 + rl), mask.key(k0 + rl + 8)};

  load_tile<T>(ks, k + boff, k0, n, stride, h * kD);
  load_tile<T>(vs, v + boff, k0, n, stride, h * kD);
  cp_async_wait_all();

  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  const int2 span = mask.inv_tiles(k0);
  for (int qt = span.x; qt <= span.y; ++qt) {
    const int q0 = qt * kTile;
    if (!mask.tile_live(q0, kt)) continue;
    __syncthreads();  // every warp is done with the previous tile's Q, dO and terms
    mask.stage_t(sm.scratch, q0, k0);
    __syncthreads();
    bool live = false;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        live |= mask.at_t(sm.scratch, keys[e >> 1], rl + 8 * (e >> 1), 8 * j + 2 * t + (e & 1))
                != -INFINITY;
    if (!__syncthreads_or(live)) continue;
    load_tile<T>(qs, q + boff, q0, n, stride, h * kD);
    load_tile<T>(dos, gb, q0, n, c, h * kD);
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
        const int ql = 8 * j + 2 * t + (e & 1);
        const float term = mask.at_t(sm.scratch, keys[e >> 1], rl + 8 * (e >> 1), ql);
        p[j][e] = round_to<T>(expf(p[j][e] * scale + term - sm.lse[ql]));
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
      for (int e = 0; e < 4; ++e) p[j][e] *= dp[j][e] - sm.delta[8 * j + 2 * t + (e & 1)];
    if constexpr (kBf16) {
      uint32_t pf[8][2];
      to_bf16(pf, p);
      mma_nn(dk, pf, qs);
    } else {
      fma_nn(dk, p, sm.pw, reinterpret_cast<const float*>(qs));
    }
  }
  store_rows<T>(dk_out + (long)b * dbatch_stride, dk, k0, n, dstride, h * kD, scale);
  store_rows<T>(dv_out + (long)b * dbatch_stride, dv, k0, n, dstride, h * kD, 1.f);
}

// ---- 3. dQ for one 64-row q tile of one head
template <typename T, typename Mask>
__global__ void __launch_bounds__(kThreads)
    masked_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq_out, long stride,
                     long batch_stride, long dstride, long dbatch_stride, int n, int heads,
                     float scale, const Mask mask) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem<T, Mask> sm(smem);
  T *qs = sm.a, *dos = sm.b, *ks = sm.c, *vs = sm.d;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = heads * kD;
  const long boff = (long)b * batch_stride;
  const float* lse_b = lse + ((long)b * heads + h) * n;
  const float* delta_b = delta + ((long)b * heads + h) * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int rl = warp * 16 + (lane >> 2);  // this thread's rows: rl and rl + 8 of the tile
  const typename Mask::Row rows[2] = {mask.row(q0 + rl), mask.row(q0 + rl + 8)};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl + 8 * r;
    row_lse[r] = row < n ? lse_b[row] : INFINITY;  // p = 0 for rows past N
    row_delta[r] = row < n ? delta_b[row] : 0.f;
  }

  load_tile<T>(qs, q + boff, q0, n, stride, h * kD);
  load_tile<T>(dos, g + (long)b * n * c, q0, n, c, h * kD);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[4][4], df[4][4];  // bf16 fragments of this warp's q and dO rows
  if constexpr (kBf16) {
    load_a_frags(qf, qs);
    load_a_frags(df, dos);
  }

  float dq[8][4];
  zero(dq);
  const int2 span = mask.tiles(q0);
  for (int kt = span.x; kt <= span.y; ++kt) {
    if (!mask.tile_live(q0, kt)) continue;
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile and terms
    mask.stage(sm.scratch, q0, k0);
    __syncthreads();
    bool live = false;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * j + 2 * t + (e & 1);
        live |= k0 + kl < n && mask.at(sm.scratch, rows[e >> 1], rl + 8 * (e >> 1), kl)
                                   != -INFINITY;
      }
    if (!__syncthreads_or(live)) continue;
    load_tile<T>(ks, k + boff, k0, n, stride, h * kD);
    load_tile<T>(vs, v + boff, k0, n, stride, h * kD);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 q rows x 64 keys
    float p[8][4], dp[8][4];
    zero(p);
    zero(dp);
    if constexpr (kBf16) {
      mma_nt(p, qf, ks);
      mma_nt(dp, df, vs);
    } else {
      fma_nt(p, reinterpret_cast<const float*>(qs), reinterpret_cast<const float*>(ks));
      fma_nt(dp, reinterpret_cast<const float*>(dos), reinterpret_cast<const float*>(vs));
    }
    // P = exp(S - lse), zero for masked keys and keys past N; T = P (dP - delta)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * j + 2 * t + (e & 1);
        const int r = e >> 1;
        const float term = k0 + kl < n ? mask.at(sm.scratch, rows[r], rl + 8 * r, kl)
                                       : -INFINITY;
        const float pe = round_to<T>(expf(p[j][e] * scale + term - row_lse[r]));
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
  store_rows<T>(dq_out + (long)b * dbatch_stride, dq, q0, n, dstride, h * kD, scale);
}

// The three launches of the backward on `stream`; returns a cudaError_t (0
// = success). delta: fp32 scratch of B*H*N floats.
template <typename T, typename Mask>
int launch_masked_bwd(const void* q, const void* k, const void* v, const void* out,
                      const void* g, const float* lse, float* delta, void* dq, void* dk, void* dv,
                      long stride, long batch_stride, long dstride, long dbatch_stride,
                      int batch, int n, int heads, float scale, const Mask& mask,
                      cudaStream_t stream) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(g);
  cudaError_t err = launch_delta<T>(static_cast<const T*>(out), gt, delta, batch, n, heads,
                                    stream);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = masked_bwd_smem<T, Mask>();
  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  err = cudaFuncSetAttribute(masked_dkdv_kernel<T, Mask>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  masked_dkdv_kernel<T, Mask><<<grid, kThreads, smem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), stride, batch_stride,
      dstride, dbatch_stride, n, heads, scale, mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(masked_dq_kernel<T, Mask>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  masked_dq_kernel<T, Mask><<<grid, kThreads, smem, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), stride, batch_stride, dstride,
      dbatch_stride, n, heads, scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace dad_attn
