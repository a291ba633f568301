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
// as kernel 3's: 1. delta (attention_tiles.cuh); 2. dK/dV: a block owns keys
// and streams the q tiles of the mask's inverse band (Mask::inv_tiles); per
// live q tile S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += (P^T (dP^T -
// delta)) Q; 3. dQ: a block owns q rows and streams the key tiles of the
// band (Mask::tiles); per live key tile S = Q K^T, dP = dO V^T, dQ += (P (dP
// - delta)) K. A tile dead for some of a block's rows adds exact zeros, so
// the sums do not depend on which dead tiles a mask policy skips: kernel 8
// equals kernel 6 with the window bias bit for bit.
//
// bf16 (hopper_tiles.cuh, kernel 3's design): one block of three warpgroups
// per 128 owned rows, head and batch. Warpgroup 0 is the producer: it walks
// the mask's span, decides each 64-row streamed tile's liveness for the 128
// owned rows (Mask::any_live: the bias's tile marks, or the window's key
// segments) and never loads a dead tile; thread 0 loads the owned tiles
// once and each live tile's pair (K and V, or Q and dO) by TMA from 3-D maps
// over the strided q, k, v and over g, with the bias terms of the tile pair
// (BiasMask: from a [N', N'] fp32 copy of the bias written first, N' = N
// rounded up to 128, since an odd N's bias rows are no TMA stride),
// through a ring of three stages with full and empty mbarriers; in pass 2
// its threads also stage the q rows' lse and delta. Each stage carries its
// tile index (-1 after the last live tile).
// Warpgroups 1 and 2 own 64 rows each and run every product on wgmma: S and
// dP from shared memory (both operands K-major), the gradient products with
// the rounded P or T from registers and the streamed tile read MN-major,
// issuing the next live tile's S and dP before this tile's gradient products
// and computing the next P and T while those run. The mask term comes from
// registers (the window's grid coordinates of the accumulator's row and
// column, stepped along a thread's columns) or from the stage's bias boxes:
// no per-tile barrier of the block.
//
// fp32 keeps the scalar-FMA kernels over attention_tiles.cuh's 64-row tiles
// (4 warps), with the terms staged per tile in shared memory and the dead
// tiles skipped by Mask::tile_live and a __syncthreads_or; they hold the
// tight fp32 checks.
#pragma once

#include <type_traits>

#include "attention_masks.cuh"
#include "hopper_tiles.cuh"

namespace dad_attn {

template <typename Mask>
size_t masked_bwd_smem() {
  return (size_t)4 * kTile * row_elems<float>() * sizeof(float) + 2 * kTile * sizeof(float) +
         Mask::kScratch + (size_t)kWarps * 16 * kProw * sizeof(float);
}

// Shared memory of both fp32 passes: four 64-row tiles, the q tile's lse and
// delta (dK/dV pass), the mask's scratch, and the P staging.
template <typename Mask>
struct BwdSmem {
  float *a, *b, *c, *d;
  float *lse, *delta;
  unsigned char* scratch;
  float* pw;
  __device__ explicit BwdSmem(unsigned char* smem) {
    constexpr int kRow = row_elems<float>();
    a = reinterpret_cast<float*>(smem);
    b = a + kTile * kRow;
    c = b + kTile * kRow;
    d = c + kTile * kRow;
    lse = d + kTile * kRow;
    delta = lse + kTile;
    scratch = reinterpret_cast<unsigned char*>(delta + kTile);
    pw = reinterpret_cast<float*>(scratch + Mask::kScratch) + (threadIdx.x >> 5) * 16 * kProw;
  }
};

// ------------------------------------------------------------------ fp32, scalar FMA
// ---- 2. dK, dV for one 64-key tile of one head
template <typename Mask>
__global__ void __launch_bounds__(kThreads)
    masked_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ g,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk_out, float* __restrict__ dv_out, long stride,
                       long batch_stride, long dstride, long dbatch_stride, int n,
                       int heads, float scale, const Mask mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem<Mask> sm(smem);
  float *ks = sm.a, *vs = sm.b, *qs = sm.c, *dos = sm.d;

  const int kt = blockIdx.x, k0 = kt * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = heads * kD;
  const long boff = (long)b * batch_stride;
  const float* gb = g + (long)b * n * c;
  const float* lse_b = lse + ((long)b * heads + h) * n;
  const float* delta_b = delta + ((long)b * heads + h) * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int rl = warp * 16 + (lane >> 2);  // this thread's keys: rl and rl + 8 of the tile
  const typename Mask::Key keys[2] = {mask.key(k0 + rl), mask.key(k0 + rl + 8)};

  load_tile<float>(ks, k + boff, k0, n, stride, h * kD);
  load_tile<float>(vs, v + boff, k0, n, stride, h * kD);
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
    load_tile<float>(qs, q + boff, q0, n, stride, h * kD);
    load_tile<float>(dos, gb, q0, n, c, h * kD);
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
    fma_nt(p, ks, qs);
    fma_nt(dp, vs, dos);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + 2 * t + (e & 1);
        const float term = mask.at_t(sm.scratch, keys[e >> 1], rl + 8 * (e >> 1), ql);
        p[j][e] = expf(p[j][e] * scale + term - sm.lse[ql]);
      }

    // dV += P^T dO
    fma_nn(dv, p, sm.pw, dos);

    // dK += (P^T (dP^T - delta)) Q
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= dp[j][e] - sm.delta[8 * j + 2 * t + (e & 1)];
    fma_nn(dk, p, sm.pw, qs);
  }
  store_rows<float>(dk_out + (long)b * dbatch_stride, dk, k0, n, dstride, h * kD, scale);
  store_rows<float>(dv_out + (long)b * dbatch_stride, dv, k0, n, dstride, h * kD, 1.f);
}

// ---- 3. dQ for one 64-row q tile of one head
template <typename Mask>
__global__ void __launch_bounds__(kThreads)
    masked_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq_out, long stride,
                     long batch_stride, long dstride, long dbatch_stride, int n, int heads,
                     float scale, const Mask mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem<Mask> sm(smem);
  float *qs = sm.a, *dos = sm.b, *ks = sm.c, *vs = sm.d;

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

  load_tile<float>(qs, q + boff, q0, n, stride, h * kD);
  load_tile<float>(dos, g + (long)b * n * c, q0, n, c, h * kD);
  cp_async_wait_all();
  __syncthreads();

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
    load_tile<float>(ks, k + boff, k0, n, stride, h * kD);
    load_tile<float>(vs, v + boff, k0, n, stride, h * kD);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 q rows x 64 keys
    float p[8][4], dp[8][4];
    zero(p);
    zero(dp);
    fma_nt(p, qs, ks);
    fma_nt(dp, dos, vs);
    // P = exp(S - lse), zero for masked keys and keys past N; T = P (dP - delta)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 8 * j + 2 * t + (e & 1);
        const int r = e >> 1;
        const float term = k0 + kl < n ? mask.at(sm.scratch, rows[r], rl + 8 * r, kl)
                                       : -INFINITY;
        const float pe = expf(p[j][e] * scale + term - row_lse[r]);
        p[j][e] = pe * (dp[j][e] - row_delta[r]);
      }
    // dQ += T K
    fma_nn(dq, p, sm.pw, ks);
  }
  store_rows<float>(dq_out + (long)b * dbatch_stride, dq, q0, n, dstride, h * kD, scale);
}

}  // namespace dad_attn

// ------------------------------------------------------------------ bf16, wgmma
namespace dad_masked_wg {

using namespace dad_hopper;
using bf16 = __nv_bfloat16;
using dad_attn::kD;

constexpr int kWgRows = 64;                // owned rows of a consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kBM = kWgRows * kConsumers;  // owned rows of a block
constexpr int kBN = 64;                    // streamed rows of a stage
constexpr int kStages = 3;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBox = 64 * kD;              // elements of one TMA box (8 KB)

// Shared memory: two owned operands of kBM rows, kStages stages of two
// streamed tiles and of the mask's terms (1024-byte aligned TMA boxes), the
// barriers, each stage's lse and delta rows (pass 2) and streamed tile index.
template <typename Mask>
struct Smem {
  static constexpr size_t kBytes =
      1024 /* alignment slack */ + (size_t)(2 * kBM + 2 * kStages * kBN) * kD * 2 +
      (size_t)kStages * Mask::kStageFloats * sizeof(float) +
      (1 + 2 * kStages) * sizeof(uint64_t) + (size_t)kStages * 2 * kBN * sizeof(float) +
      kStages * sizeof(int);
  bf16 *own_a, *own_b;  // dK/dV: K, V | dQ: Q, dO   (kBM rows)
  bf16 *str_a, *str_b;  // dK/dV: Q, dO | dQ: K, V   (kStages x kBN rows)
  float* terms;         // kStages x Mask::kStageFloats
  uint64_t *own_full, *full, *empty;
  float *lse, *delta;   // dK/dV: lse and delta of the streamed q rows
  int* tile;            // kStages: the streamed tile of each stage, -1 after the last
  __device__ explicit Smem(unsigned char* raw) {
    own_a = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    own_b = own_a + kBM * kD;
    str_a = own_b + kBM * kD;
    str_b = str_a + kStages * kBox;
    terms = reinterpret_cast<float*>(str_b + kStages * kBox);
    own_full = reinterpret_cast<uint64_t*>(terms + kStages * Mask::kStageFloats);
    full = own_full + 1;
    empty = full + kStages;
    lse = reinterpret_cast<float*>(empty + kStages);
    delta = lse + kStages * kBN;
    tile = reinterpret_cast<int*>(delta + kStages * kBN);
  }
};

// Store rows g and g+8 of this warp's 16 rows of a warpgroup accumulator,
// times `scale`, into columns [col, col+64) of rows `stride` apart; rows at
// or past n are skipped.
__device__ __forceinline__ void store_acc(bf16* base, const float (&acc)[32], int row0, int n,
                                          long stride, int col, float scale) {
  const int cq = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    bf16* dst = base + (long)row * stride + col;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * cq) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The streamed tile of sequence position i, once its stage is in; -1 past
// the last live tile.
template <typename S>
__device__ __forceinline__ int next_tile(const S& sm, int i) {
  const int st = i % kStages;
  mbar_wait(&sm.full[st], (i / kStages) & 1);
  return sm.tile[st];
}

// Issue S = A1 B1^T and dP = A2 B2^T of stage st (64 owned rows x 64
// streamed rows), A1, A2 the owned tiles and B1, B2 the streamed ones.
template <typename S>
__device__ __forceinline__ void issue_ss(float (&s)[32], float (&dp)[32], uint64_t a1,
                                         uint64_t a2, const S& sm, int st) {
  const uint64_t b1 = desc_sw128(sm.str_a + st * kBox), b2 = desc_sw128(sm.str_b + st * kBox);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_ss_n64(s, a1 + 2 * kk, b1 + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_ss_n64(dp, a2 + 2 * kk, b2 + 2 * kk, kk);
  wgmma_commit();
}

// Issue acc += F B for the 64 streamed rows of a tile read MN-major, F given
// as bf16 pairs in accumulator order (f[2j] row g, f[2j + 1] row g + 8).
__device__ __forceinline__ void issue_rs(float (&acc)[32], const uint32_t (&f)[16],
                                         const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t a[4] = {f[4 * kk], f[4 * kk + 1], f[4 * kk + 2], f[4 * kk + 3]};
    wgmma_rs_n64(acc, a, desc_sw128(tile + kk * 16 * kD), 1);
  }
}

// ---- the producer warpgroup (both passes): owned tiles once, then each
// live streamed tile of the span, its terms and (pass 2) its lse and delta
template <bool kDq, typename Mask>
__device__ __forceinline__ void produce(const Smem<Mask>& sm, const Mask& mask,
                                        const CUtensorMap* own_a, const CUtensorMap* own_b,
                                        const CUtensorMap* str_a, const CUtensorMap* str_b,
                                        const CUtensorMap* terms, int col, int r0, int b,
                                        int active, int n, const float* lse_b,
                                        const float* delta_b) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_arrive_expect_tx(sm.own_full, 2 * active * kBox * 2);
    for (int w = 0; w < active; ++w) {
      tma_load_3d(sm.own_a + w * kBox, own_a, sm.own_full, col, r0 + w * kWgRows, b);
      tma_load_3d(sm.own_b + w * kBox, own_b, sm.own_full, col, r0 + w * kWgRows, b);
    }
  }
  const int r1 = min(r0 + kBM, n);
  int2 span = kDq ? mask.tiles(r0) : mask.inv_tiles(r0);
  if (r0 + kWgRows < n)
    span.y = max(span.y, kDq ? mask.tiles(r0 + kWgRows).y : mask.inv_tiles(r0 + kWgRows).y);
  int i = 0;
  for (int t = span.x; t <= span.y; ++t) {
    const int s0 = t * kBN, s1 = min(s0 + kBN, n);
    if (!(kDq ? mask.any_live(r0, r1, s0, s1) : mask.any_live(s0, s1, r0, r1))) continue;
    const int st = i % kStages, round = i / kStages;
    if (round > 0) mbar_wait(&sm.empty[st], (round - 1) & 1);
    if (tid == 0) {
      sm.tile[st] = t;
      mbar_arrive_expect_tx(&sm.full[st],
                            2 * kBox * 2 + Mask::kStageFloats * (int)sizeof(float));
      tma_load_3d(sm.str_a + st * kBox, str_a, &sm.full[st], col, s0, b);
      tma_load_3d(sm.str_b + st * kBox, str_b, &sm.full[st], col, s0, b);
      if constexpr (Mask::kTmaTerms) {
        // four 64 x 32 boxes: rows x keys [r0, +128) x [s0, +64) (dQ) or
        // [s0, +64) x [r0, +128) (dK/dV)
        float* dst = sm.terms + st * Mask::kStageFloats;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (kDq)
            tma_load_2d(dst + x * 2048, terms, &sm.full[st], s0 + 32 * (x & 1), r0 + 64 * (x >> 1));
          else
            tma_load_2d(dst + x * 2048, terms, &sm.full[st], r0 + 32 * x, s0);
        }
      }
    }
    if constexpr (!kDq) {
      if (tid < kBN) {
        const bool ok = s0 + tid < n;
        sm.lse[st * kBN + tid] = ok ? lse_b[s0 + tid] : INFINITY;  // p = 0 past N
        sm.delta[st * kBN + tid] = ok ? delta_b[s0 + tid] : 0.f;
      }
    }
    if (tid != 0) mbar_arrive(&sm.full[st]);  // each thread after its own stores
    ++i;
  }
  const int st = i % kStages, round = i / kStages;
  if (round > 0) mbar_wait(&sm.empty[st], (round - 1) & 1);
  if (tid == 0) sm.tile[st] = -1;
  mbar_arrive(&sm.full[st]);
}

// ---- pass 3 (dQ), consumer side
template <typename Mask>
struct DqRows {
  typename Mask::Row row[2];
  float lse[2], delta[2];
  int rl;  // the first of this thread's two rows, local to the block
};

// P = exp(S + term - lse), T = P (dP - delta) rounded to bf16 pairs, for
// key tile kt in stage st.
template <typename Mask>
__device__ __forceinline__ void dq_elementwise(const float (&s)[32], const float (&dp)[32],
                                               const Smem<Mask>& sm, const Mask& mask, int st,
                                               int kt, const DqRows<Mask>& rows, float scale,
                                               uint32_t (&tf)[16]) {
  const int cq = threadIdx.x & 3;
  const float* terms = sm.terms + st * Mask::kStageFloats;
  typename Mask::KCol cols[16];
  mask.kcols(kt * kBN + 2 * cq, cols);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int kl = 8 * j + 2 * cq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rl = rows.rl + 8 * r;
      const float t0 = mask.qterm(rows.row[r], cols[2 * j], rl, kl, terms);
      const float t1 = mask.qterm(rows.row[r], cols[2 * j + 1], rl, kl + 1, terms);
      const float p0 = round_bf16(exp_nat(s[4 * j + 2 * r] * scale + t0 - rows.lse[r]));
      const float p1 = round_bf16(exp_nat(s[4 * j + 2 * r + 1] * scale + t1 - rows.lse[r]));
      tf[2 * j + r] = pack_bf16(p0 * (dp[4 * j + 2 * r] - rows.delta[r]),
                                p1 * (dp[4 * j + 2 * r + 1] - rows.delta[r]));
    }
  }
}

// One step of pass 3 at sequence position i: S, dP of the next live tile,
// then dQ += T K of this one (from t), in flight while the elementwise part
// of the next writes t_next. Returns true after the last tile.
template <typename Mask>
__device__ __forceinline__ bool dq_step(float (&s)[32], float (&dp)[32], float (&dq)[32],
                                        uint32_t (&t)[16], uint32_t (&t_next)[16], uint64_t qdesc,
                                        uint64_t dodesc, const Smem<Mask>& sm, const Mask& mask,
                                        int i, const DqRows<Mask>& rows, float scale) {
  const int st = i % kStages, nst = (i + 1) % kStages;
  const int next = next_tile(sm, i + 1);
  if (next >= 0) issue_ss(s, dp, qdesc, dodesc, sm, nst);
  wgmma_fence();
  issue_rs(dq, t, sm.str_a + st * kBox);
  wgmma_commit();
  if (next >= 0) {
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(dp);
    dq_elementwise(s, dp, sm, mask, nst, next, rows, scale, t_next);
  }
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(t);
  if ((threadIdx.x & 31) == 0) mbar_arrive(&sm.empty[st]);  // the warpgroup's products are done
  return next < 0;
}

// ---- pass 2 (dK/dV), consumer side: P^T = exp(S^T + term - lse) and T^T =
// P^T (dP^T - delta) rounded to bf16 pairs, for q tile qt in stage st.
template <typename Mask>
__device__ __forceinline__ void dkdv_elementwise(const float (&s)[32], const float (&dp)[32],
                                                 const Smem<Mask>& sm, const Mask& mask, int st,
                                                 int qt, const typename Mask::Key (&keys)[2],
                                                 int kl0, float scale, uint32_t (&pf)[16],
                                                 uint32_t (&tf)[16]) {
  const int cq = threadIdx.x & 3;
  const float* lse_t = sm.lse + st * kBN;
  const float* delta_t = sm.delta + st * kBN;
  const float* terms = sm.terms + st * Mask::kStageFloats;
  typename Mask::QCol cols[16];
  mask.qcols(qt * kBN + 2 * cq, cols);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ql = 8 * j + 2 * cq;
    const float l0 = lse_t[ql], l1 = lse_t[ql + 1];
    const float d0 = delta_t[ql], d1 = delta_t[ql + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kl = kl0 + 8 * r;
      const float t0 = mask.kterm(keys[r], cols[2 * j], kl, ql, terms);
      const float t1 = mask.kterm(keys[r], cols[2 * j + 1], kl, ql + 1, terms);
      const __nv_bfloat162 p =
          __floats2bfloat162_rn(exp_nat(s[4 * j + 2 * r] * scale + t0 - l0),
                                exp_nat(s[4 * j + 2 * r + 1] * scale + t1 - l1));
      pf[2 * j + r] = *reinterpret_cast<const uint32_t*>(&p);
      tf[2 * j + r] = pack_bf16(__low2float(p) * (dp[4 * j + 2 * r] - d0),
                                __high2float(p) * (dp[4 * j + 2 * r + 1] - d1));
    }
  }
}

// One step of pass 2 at sequence position i: S^T, dP^T of the next live q
// tile, then dV += P^T dO and dK += T^T Q of this one (from p, t), in
// flight while the elementwise part of the next writes p_next, t_next.
// Returns true after the last tile.
template <typename Mask>
__device__ __forceinline__ bool dkdv_step(float (&s)[32], float (&dp)[32], float (&dk)[32],
                                          float (&dv)[32], uint32_t (&p)[16], uint32_t (&t)[16],
                                          uint32_t (&p_next)[16], uint32_t (&t_next)[16],
                                          uint64_t kdesc, uint64_t vdesc, const Smem<Mask>& sm,
                                          const Mask& mask, int i,
                                          const typename Mask::Key (&keys)[2], int kl0,
                                          float scale) {
  const int st = i % kStages, nst = (i + 1) % kStages;
  const int next = next_tile(sm, i + 1);
  if (next >= 0) issue_ss(s, dp, kdesc, vdesc, sm, nst);
  wgmma_fence();
  issue_rs(dv, p, sm.str_b + st * kBox);
  issue_rs(dk, t, sm.str_a + st * kBox);
  wgmma_commit();
  if (next >= 0) {
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(dp);
    dkdv_elementwise(s, dp, sm, mask, nst, next, keys, kl0, scale, p_next, t_next);
  }
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
  fence_regs(p);
  fence_regs(t);
  if ((threadIdx.x & 31) == 0) mbar_arrive(&sm.empty[st]);  // the warpgroup's products are done
  return next < 0;
}

// Barriers shared by both passes: the empty ones count every warp of the
// active consumer warpgroups, the full ones the 128 producer threads.
template <typename Mask>
__device__ __forceinline__ int setup(const Smem<Mask>& sm, int n, int r0) {
  const int active = min(kConsumers, (n - r0 + kWgRows - 1) / kWgRows);
  if (threadIdx.x == 0) {
    mbar_init(sm.own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 128);
      mbar_init(&sm.empty[s], active * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return active;
}

// ---- 2. dK, dV for 128 keys of one head
template <typename Mask>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_wgmma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap g_map,
               const __grid_constant__ CUtensorMap t_map, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk_out,
               bf16* __restrict__ dv_out, long dstride, long dbatch_stride, int n, int heads,
               float scale, const Mask mask) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<Mask> sm(smem_raw);
  const int k0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int active = setup(sm, n, k0);
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    const long at = ((long)b * heads + h) * n;
    produce<false>(sm, mask, &k_map, &v_map, &q_map, &g_map, &t_map, h * kD, k0, b, active, n,
                   lse + at, delta + at);
    return;
  }
  setmaxnreg_inc<232>();
  const int w = threadIdx.x / 128 - 1;
  if (w >= active) return;
  const int warp = (threadIdx.x & 127) >> 5, g = (threadIdx.x & 31) >> 2;
  const int kl0 = w * kWgRows + warp * 16 + g;  // this thread's keys kl0, kl0 + 8 of the block
  const typename Mask::Key keys[2] = {mask.key(k0 + kl0), mask.key(k0 + kl0 + 8)};
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(sm.own_full, 0);
  const uint64_t kdesc = desc_sw128(sm.own_a + w * kBox);
  const uint64_t vdesc = desc_sw128(sm.own_b + w * kBox);
  // P^T and T^T of sequence position i in (pa, ta) for even i, (pb, tb) for
  // odd i: no register copies
  float s[32], dp[32];
  uint32_t pa[16], ta[16], pb[16], tb[16];
  const int first = next_tile(sm, 0);
  if (first >= 0) {
    issue_ss(s, dp, kdesc, vdesc, sm, 0);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    dkdv_elementwise(s, dp, sm, mask, 0, first, keys, kl0, scale, pa, ta);
    for (int i = 0;; i += 2) {
      if (dkdv_step(s, dp, dk, dv, pa, ta, pb, tb, kdesc, vdesc, sm, mask, i, keys, kl0,
                    scale))
        break;
      if (dkdv_step(s, dp, dk, dv, pb, tb, pa, ta, kdesc, vdesc, sm, mask, i + 1, keys, kl0,
                    scale))
        break;
    }
  }
  const int row0 = k0 + kl0;
  store_acc(dk_out + (long)b * dbatch_stride, dk, row0, n, dstride, h * kD, scale);
  store_acc(dv_out + (long)b * dbatch_stride, dv, row0, n, dstride, h * kD, 1.f);
}

// ---- 3. dQ for 128 q rows of one head
template <typename Mask>
__global__ void __launch_bounds__(kThreads, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap g_map,
             const __grid_constant__ CUtensorMap t_map, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq_out, long dstride,
             long dbatch_stride, int n, int heads, float scale, const Mask mask) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<Mask> sm(smem_raw);
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int active = setup(sm, n, q0);
  const long at = ((long)b * heads + h) * n;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    produce<true>(sm, mask, &q_map, &g_map, &k_map, &v_map, &t_map, h * kD, q0, b, active, n,
                  lse + at, delta + at);
    return;
  }
  setmaxnreg_inc<232>();
  const int w = threadIdx.x / 128 - 1;
  if (w >= active) return;
  const int warp = (threadIdx.x & 127) >> 5, g = (threadIdx.x & 31) >> 2;
  DqRows<Mask> rows;
  rows.rl = w * kWgRows + warp * 16 + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rows.rl + 8 * r;
    rows.row[r] = mask.row(row);
    rows.lse[r] = row < n ? lse[at + row] : INFINITY;  // p = 0 for rows past N
    rows.delta[r] = row < n ? delta[at + row] : 0.f;
  }
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  mbar_wait(sm.own_full, 0);
  const uint64_t qdesc = desc_sw128(sm.own_a + w * kBox);
  const uint64_t dodesc = desc_sw128(sm.own_b + w * kBox);
  // T of sequence position i in ta for even i, tb for odd i
  float s[32], dp[32];
  uint32_t ta[16], tb[16];
  const int first = next_tile(sm, 0);
  if (first >= 0) {
    issue_ss(s, dp, qdesc, dodesc, sm, 0);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    dq_elementwise(s, dp, sm, mask, 0, first, rows, scale, ta);
    for (int i = 0;; i += 2) {
      if (dq_step(s, dp, dq, ta, tb, qdesc, dodesc, sm, mask, i, rows, scale)) break;
      if (dq_step(s, dp, dq, tb, ta, qdesc, dodesc, sm, mask, i + 1, rows, scale)) break;
    }
  }
  store_acc(dq_out + (long)b * dbatch_stride, dq, q0 + rows.rl, n, dstride, h * kD, scale);
}

// The two passes after delta; q, k, v: [B, N, H, 64] views with rows
// `stride` and batches `batch_stride` elements apart (16-byte multiples);
// terms: the mask's [tn, tn] fp32 terms (Mask::kTmaTerms), tn = N rounded up
// to 128, or null.
template <typename Mask>
int launch(const void* q, const void* k, const void* v, const void* g, const float* lse,
           const float* delta, const float* terms, void* dq, void* dk, void* dv, long stride,
           long batch_stride, long dstride, long dbatch_stride, int batch, int n, int heads,
           float scale, const Mask& mask, cudaStream_t stream) {
  const int c = heads * kD;
  CUtensorMap q_map, k_map, v_map, g_map, t_map = {};
  int err = make_map_3d_strided(&q_map, q, batch, n, c, stride, batch_stride);
  if (!err) err = make_map_3d_strided(&k_map, k, batch, n, c, stride, batch_stride);
  if (!err) err = make_map_3d_strided(&v_map, v, batch, n, c, stride, batch_stride);
  if (!err) err = make_map_3d(&g_map, g, batch, n, c);
  if (!err && Mask::kTmaTerms)
    err = make_map_2d_f32(&t_map, terms, dad_attn::term_rows(n), dad_attn::term_rows(n));
  if (err) return err;
  const size_t smem = Smem<Mask>::kBytes;
  const dim3 grid((n + kBM - 1) / kBM, heads, batch);
  cudaError_t e = cudaFuncSetAttribute(dkdv_wgmma<Mask>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dkdv_wgmma<Mask><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, g_map, t_map, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      dstride, dbatch_stride, n, heads, scale, mask);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dq_wgmma<Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  dq_wgmma<Mask><<<grid, kThreads, smem, stream>>>(q_map, k_map, v_map, g_map, t_map, lse, delta,
                                                   static_cast<bf16*>(dq), dstride,
                                                   dbatch_stride, n, heads, scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace dad_masked_wg

namespace dad_attn {

// The three launches of the backward on `stream`; returns a cudaError_t (0
// = success). delta: fp32 scratch of B*H*N floats. T: bf16 (wgmma) or fp32
// (scalar FMA). terms: the bf16 path's TMA-read terms (Mask::kTmaTerms),
// written before this call, or null.
template <typename T, typename Mask>
int launch_masked_bwd(const void* q, const void* k, const void* v, const void* out,
                      const void* g, const float* lse, float* delta, const float* terms,
                      void* dq, void* dk, void* dv, long stride, long batch_stride,
                      long dstride, long dbatch_stride, int batch, int n, int heads, float scale,
                      const Mask& mask, cudaStream_t stream) {
  cudaError_t err = launch_delta<T>(static_cast<const T*>(out), static_cast<const T*>(g), delta,
                                    batch, n, heads, stream);
  if (err != cudaSuccess) return (int)err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return dad_masked_wg::launch(q, k, v, g, lse, delta, terms, dq, dk, dv, stride,
                                 batch_stride, dstride, dbatch_stride, batch, n, heads, scale,
                                 mask, stream);
  } else {
    const float *qt = static_cast<const float*>(q), *kt = static_cast<const float*>(k),
                *vt = static_cast<const float*>(v), *gt = static_cast<const float*>(g);
    const size_t smem = masked_bwd_smem<Mask>();
    const dim3 grid((n + kTile - 1) / kTile, heads, batch);
    err = cudaFuncSetAttribute(masked_dkdv_kernel<Mask>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    masked_dkdv_kernel<Mask><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), stride,
        batch_stride, dstride, dbatch_stride, n, heads, scale, mask);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(masked_dq_kernel<Mask>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    masked_dq_kernel<Mask><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<float*>(dq), stride, batch_stride, dstride,
        dbatch_stride, n, heads, scale, mask);
    return (int)cudaGetLastError();
  }
}

}  // namespace dad_attn
