// Masked softmax attention forward, shared by the additive-bias kernel
// (flash_attention_bias.cu, kernel 5) and the banded window kernel
// (flash_attention_banded.cu, kernel 7), for sm_90a.
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
// (the JAX _banded_kernel_lse). lse = m + log(sum) in natural units.
//
// A key tile whose term is -inf for every row it meets adds exactly nothing
// (its correction factor is 1 and its probabilities 0), so it is never
// loaded: the window mask leaves 49 of 1369 keys of a row at 518^2. Both
// kernels visit the live tiles in ascending order with the same arithmetic,
// so kernel 7 equals kernel 5 with the window bias bit for bit.
//
// bf16 design (hopper_tiles.cuh, kernel 1's consumers and the backward's dQ
// producer): one block of three warpgroups per (128 q rows, head, batch),
// two blocks per SM. Warpgroup 0 is the producer: it gives up registers
// (setmaxnreg), and its first warp walks the mask's span for the 128 rows,
// asks the mask whether each 64-key tile is live for each 64-row half
// (Mask::any_live: the bias's tile marks, or the window's key segments) and
// never loads a dead tile; one thread loads the q tile once and each live
// tile's K and V by TMA from 3-D maps over the strided q, k, v, with the
// bias terms of its live halves' rows x the tile's keys (BiasMask: from the
// padded fp32 copy that bias_prep_kernel writes first), through a ring of
// two stages with full and empty mbarriers. Each stage carries its tile
// index (-1 after the last live tile) and the halves it is live for.
// Warpgroups 1 and 2 own 64 rows each: S = Q K^T on wgmma m64n64k16 from
// shared memory; s * D^-1/2 + term with the term from registers (the
// window's interval tests on the grid coordinates of a thread's key
// columns, stepped along them) or from the stage's bias boxes (8-byte
// loads); the online softmax in registers with exp as ex2 of the
// natural-units argument; P rounded to bf16 pairs in registers; O += P V on
// wgmma with V read MN-major. A warpgroup skips the products of a tile dead
// for its rows and only releases the stage. No barrier of the whole block
// after the setup. Measured on an H100 (PERF.md), this beats one block per
// SM that issues the next tile's S before this tile's PV: ptxas serializes
// those wgmma behind the conditional issues, and two warpgroups per SM hide
// less of the softmax than four.
//
// fp32 keeps the scalar-FMA kernel over attention_tiles.cuh's 64-row tiles
// (4 warps, cp.async K/V tiles, the terms staged per tile in shared memory
// and the dead tiles skipped by Mask::tile_live and a __syncthreads_or); it
// holds the tight fp32 checks.
#pragma once

#include <type_traits>

#include "attention_masks.cuh"
#include "hopper_tiles.cuh"

namespace dad_attn {

// ------------------------------------------------------------------ fp32, scalar FMA
template <typename Mask>
size_t masked_attn_fp32_smem() {
  return (size_t)3 * kTile * row_elems<float>() * sizeof(float) + Mask::kScratch +
         (size_t)kWarps * 16 * kProw * sizeof(float);
}

template <typename Mask>
__global__ void __launch_bounds__(kThreads)
    masked_attn_fp32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, long stride, long batch_stride, int n, int heads,
                     float scale, const Mask mask) {
  constexpr int kRow = row_elems<float>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kTile * kRow;
  float* vs = ks + kTile * kRow;
  unsigned char* scratch = reinterpret_cast<unsigned char*>(vs + kTile * kRow);
  float* ps = reinterpret_cast<float*>(scratch + Mask::kScratch);

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long boff = (long)b * batch_stride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair
  const int rl = warp * 16 + g;  // this thread's rows: rl and rl + 8 of the tile
  const typename Mask::Row rows[2] = {mask.row(q0 + rl), mask.row(q0 + rl + 8)};

  load_tile<float>(qs, q + boff, q0, n, stride, h * kD);
  cp_async_wait_all();
  __syncthreads();

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
    load_tile<float>(ks, k + boff, k0, n, stride, h * kD);
    load_tile<float>(vs, v + boff, k0, n, stride, h * kD);
    cp_async_wait_all();
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 keys, plus the terms
    float acc[8][4];
    zero(acc);
    fma_nt(acc, qs, ks);
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
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - m_use[0]);
      s[j][1] = expf(s[j][1] - m_use[0]);
      s[j][2] = expf(s[j][2] - m_use[1]);
      s[j][3] = expf(s[j][3] - m_use[1]);
      psum[0] += s[j][0] + s[j][1];
      psum[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // ---- O += P V
    fma_nn(o, s, ps + warp * 16 * kProw, vs);
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
  store_rows<float>(out + (long)b * n * c, o, q0, n, c, h * kD, 1.f);
}

}  // namespace dad_attn

// ------------------------------------------------------------------ bf16, wgmma
namespace dad_masked_fwd {

using namespace dad_hopper;
using bf16 = __nv_bfloat16;
using dad_attn::kD;

constexpr int kWgRows = 64;                // q rows of a consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kBM = kWgRows * kConsumers;  // q rows of a block
constexpr int kBN = 64;                    // keys of a stage
constexpr int kStages = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
// Two blocks per SM, as kernel 1: each block holds 384 x 80 registers, which
// setmaxnreg moves to the consumers (producer 32, consumers 104: all of
// them; at 24 the window's producer spilled its any_live loop).
constexpr int kBlocksPerSm = 2;
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 104;
constexpr int kBox = 64 * kD;              // elements of one TMA box (8 KB)

// Shared memory: the q tile, kStages stages of K, V and the mask's terms
// (1024-byte aligned TMA boxes), the barriers, and each stage's tile index
// and live halves. No alignment slack: two blocks of the bias kernel (112 KB
// of boxes each) fill an SM's 228 KB to within 2 KB, so the kernel relies on
// (and checks) the 1024-byte alignment of the dynamic shared memory of a
// block that has no static shared memory.
template <typename Mask>
struct Smem {
  static constexpr size_t kBytes = (size_t)(kBM + 2 * kStages * kBN) * kD * 2 +
                                   (size_t)kStages * Mask::kStageFloats * sizeof(float) +
                                   (1 + 2 * kStages) * sizeof(uint64_t) + 2 * kStages * sizeof(int);
  bf16 *q, *k, *v;
  float* terms;  // kStages x Mask::kStageFloats
  uint64_t *q_full, *full, *empty;
  int* tile;     // kStages: the key tile of each stage, -1 after the last
  int* live;     // kStages: bit w set if the tile is live for consumer w's rows
  __device__ explicit Smem(unsigned char* raw) {
    q = reinterpret_cast<bf16*>(raw);
    k = q + kBM * kD;
    v = k + kStages * kBox;
    terms = reinterpret_cast<float*>(v + kStages * kBox);
    q_full = reinterpret_cast<uint64_t*>(terms + kStages * Mask::kStageFloats);
    full = q_full + 1;
    empty = full + kStages;
    tile = reinterpret_cast<int*>(empty + kStages);
    live = tile + kStages;
  }
};

// ---- the producer's first warp: the q tile once, then each live key tile
// of the span with its terms; thread 0 issues every load.
template <typename Mask>
__device__ __forceinline__ void produce(const Smem<Mask>& sm, const Mask& mask,
                                        const CUtensorMap* q_map, const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, const CUtensorMap* t_map,
                                        int col, int q0, int b, int active, int n) {
  const bool leader = threadIdx.x == 0;
  if (leader) {
    mbar_arrive_expect_tx(sm.q_full, active * kBox * 2);
    for (int w = 0; w < active; ++w)
      tma_load_3d(sm.q + w * kBox, q_map, sm.q_full, col, q0 + w * kWgRows, b);
  }
  const int q_mid = min(q0 + kWgRows, n), q_end = min(q0 + kBM, n);
  int2 span = mask.tiles(q0);
  if (active > 1) span.y = max(span.y, mask.tiles(q_mid).y);
  int i = 0;
  for (int t = span.x; t <= span.y; ++t) {
    const int k0 = t * kBN, k1 = min(k0 + kBN, n);
    // any_live is called by the whole warp, the same answer on every lane
    int live = mask.any_live(q0, q_mid, k0, k1) ? 1 : 0;
    if (active > 1 && mask.any_live(q_mid, q_end, k0, k1)) live |= 2;
    if (live == 0) continue;
    if (leader) {
      const int st = i % kStages, round = i / kStages;
      if (round > 0) mbar_wait(&sm.empty[st], (round - 1) & 1);
      sm.tile[st] = t;
      sm.live[st] = live;
      // the terms of the live halves: two 64 x 32 boxes of rows x keys [q0 +
      // 64w, +64) x [k0, +64) each
      const int halves = Mask::kTmaTerms ? __popc(live) : 0;
      mbar_arrive_expect_tx(&sm.full[st],
                            2 * kBox * 2 + halves * 2 * 2048 * (int)sizeof(float));
      tma_load_3d(sm.k + st * kBox, k_map, &sm.full[st], col, k0, b);
      tma_load_3d(sm.v + st * kBox, v_map, &sm.full[st], col, k0, b);
      if constexpr (Mask::kTmaTerms) {
        float* dst = sm.terms + st * Mask::kStageFloats;
        for (int w = 0; w < kConsumers; ++w) {
          if (!((live >> w) & 1)) continue;
          tma_load_2d(dst + 2 * w * 2048, t_map, &sm.full[st], k0, q0 + 64 * w);
          tma_load_2d(dst + (2 * w + 1) * 2048, t_map, &sm.full[st], k0 + 32, q0 + 64 * w);
        }
      }
    }
    ++i;
  }
  if (leader) {
    const int st = i % kStages, round = i / kStages;
    if (round > 0) mbar_wait(&sm.empty[st], (round - 1) & 1);
    sm.tile[st] = -1;
    mbar_arrive(&sm.full[st]);
  }
}

// Online softmax of one tile of scores (rows g and g + 8 of this warp, the
// terms already added): update the running max and this thread's share of
// the row sums, and write P = exp(s - m) rounded to bf16 pairs in
// accumulator order (pf[2j] row g, pf[2j + 1] row g + 8); alpha rescales the
// earlier sums and the output.
__device__ __forceinline__ void softmax_tile(const float (&s)[32], float (&m_run)[2],
                                             float (&l_run)[2], uint32_t (&pf)[16],
                                             float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp_nat(m_run[r] - m_use[r]);  // 0 while the row had no live key
    m_run[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pf[2 * j] = pack_bf16(exp_nat(s[4 * j] - m_use[0]), exp_nat(s[4 * j + 1] - m_use[0]));
    pf[2 * j + 1] = pack_bf16(exp_nat(s[4 * j + 2] - m_use[1]), exp_nat(s[4 * j + 3] - m_use[1]));
    const __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&pf[2 * j]);
    const __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&pf[2 * j + 1]);
    psum[0] += __low2float(lo) + __high2float(lo);
    psum[1] += __low2float(hi) + __high2float(hi);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
}

// ---- a consumer warpgroup: 64 q rows
template <typename Mask>
__device__ __forceinline__ void consume(const Smem<Mask>& sm, const Mask& mask,
                                        bf16* __restrict__ out, float* __restrict__ lse, int q0,
                                        int w, int b, int h, int n, int heads, float scale) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int rl = w * kWgRows + warp * 16 + g;  // this thread's rows rl, rl + 8 of the block
  const typename Mask::Row rows[2] = {mask.row(q0 + rl), mask.row(q0 + rl + 8)};
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  mbar_wait(sm.q_full, 0);
  const uint64_t qdesc = desc_sw128(sm.q + w * kBox);
  for (int i = 0;; ++i) {
    const int st = i % kStages;
    mbar_wait(&sm.full[st], (i / kStages) & 1);
    const int t = sm.tile[st];
    if (t < 0) break;
    if ((sm.live[st] >> w) & 1) {
      // ---- S = Q K^T (64 rows x 64 keys), then s * D^-1/2 + term
      float s[32];
      const uint64_t kdesc = desc_sw128(sm.k + st * kBox);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) wgmma_ss_n64(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mask.add_terms(s, scale, rows, t * kBN, rl, sm.terms + st * Mask::kStageFloats);
      uint32_t pf[16];
      float alpha[2];
      softmax_tile(s, m_run, l_run, pf, alpha);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      // ---- O += P V: P from registers, V [64 keys x 64] read MN-major
      const bf16* vt = sm.v + st * kBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
        wgmma_rs_n64(o, a, desc_sw128(vt + kk * 16 * kD), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
    }
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // this warp is done with the stage
  }

  // ---- normalise and store rows g, g+8 of this warp (and their lse)
  const int c = heads * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    const int row = q0 + rl + 8 * r;
    if (row >= n) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    bf16* dst = out + ((long)b * n + row) * c + h * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * cq) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && cq == 0)
      lse[((long)b * heads + h) * n + row] = l_run[r] > 0.f ? m_run[r] + logf(l_run[r])
                                                            : INFINITY;
  }
}

template <typename Mask>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    masked_attn_wgmma(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap t_map, bf16* __restrict__ out,
                      float* __restrict__ lse, int n, int heads, float scale, const Mask mask) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_u32(smem_raw) & 1023) __trap();  // the 128-byte swizzle needs 1024-byte aligned boxes
  const Smem<Mask> sm(smem_raw);
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int active = min(kConsumers, (n - q0 + kWgRows - 1) / kWgRows);
  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], active * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32)
      produce(sm, mask, &q_map, &k_map, &v_map, &t_map, h * kD, q0, b, active, n);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int w = threadIdx.x / 128 - 1;
  if (w < active) consume(sm, mask, out, lse, q0, w, b, h, n, heads, scale);
}

// q, k, v: [B, N, H, 64] bf16 views with rows `stride` and batches
// `batch_stride` elements apart (16-byte multiples); terms: the mask's [tn,
// tn] fp32 terms (Mask::kTmaTerms), tn = term_rows(N), or null.
template <typename Mask>
int launch(const void* q, const void* k, const void* v, const float* terms, void* out,
           float* lse, long stride, long batch_stride, int batch, int n, int heads, float scale,
           const Mask& mask, cudaStream_t stream) {
  const int c = heads * kD;
  CUtensorMap q_map, k_map, v_map, t_map = {};
  int err = make_map_3d_strided(&q_map, q, batch, n, c, stride, batch_stride);
  if (!err) err = make_map_3d_strided(&k_map, k, batch, n, c, stride, batch_stride);
  if (!err) err = make_map_3d_strided(&v_map, v, batch, n, c, stride, batch_stride);
  if (!err && Mask::kTmaTerms) {
    if (terms == nullptr) return -1;
    err = make_map_2d_f32(&t_map, terms, dad_attn::term_rows(n), dad_attn::term_rows(n));
  }
  if (err) return err;
  const size_t smem = Smem<Mask>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(masked_attn_wgmma<Mask>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + kBM - 1) / kBM, heads, batch);
  masked_attn_wgmma<Mask><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, t_map, static_cast<bf16*>(out), lse, n, heads, scale, mask);
  return (int)cudaGetLastError();
}

}  // namespace dad_masked_fwd

namespace dad_attn {

// Launch the forward on `stream`: T bf16 (wgmma; terms: the bias's fp32
// terms for BiasMask, written before this call) or fp32 (scalar FMA; terms
// unused). lse may be null (inference). Returns a cudaError_t (0 =
// success).
template <typename T, typename Mask>
int launch_masked(const void* q, const void* k, const void* v, const float* terms, void* out,
                  float* lse, long stride, long batch_stride, int batch, int n, int heads,
                  float scale, const Mask& mask, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return dad_masked_fwd::launch(q, k, v, terms, out, lse, stride, batch_stride, batch, n,
                                  heads, scale, mask, stream);
  } else {
    const size_t smem = masked_attn_fp32_smem<Mask>();
    cudaError_t err = cudaFuncSetAttribute(masked_attn_fp32<Mask>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + kTile - 1) / kTile, heads, batch);
    masked_attn_fp32<Mask><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), lse, stride, batch_stride, n, heads, scale, mask);
    return (int)cudaGetLastError();
  }
}

}  // namespace dad_attn
