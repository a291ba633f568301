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
// row is below about -50), keys at or past N are masked (dQ pass) or touch
// only rows that are never stored (dK/dV pass), and p comes from the
// forward's lse, which is finite for every real row.
//
// Bound at the ViT-B 392^2 bs16 training shape (B=16, N=785, H=12, D=64,
// bf16): the five N x N x D products, 10*B*H*N^2*D = 75.7 GFLOP, take
// 76.6 us at 989 TFLOP/s; qkv, out and g read once and dqkv written once,
// about 155 MB, take 46 us at 3.35 TB/s: compute-bound.
//
// Design (deterministic, no atomics), three launches on the caller's stream:
//   1. delta[b, h, i] = sum_d g . out over the row's 64 columns, fp32
//      (attention_tiles.cuh's delta_kernel);
//   2. dK/dV: per q tile, S^T = K Q^T, P^T = exp(S^T - lse), dP^T = V dO^T,
//      dV += P^T dO, dK += (P^T (dP^T - delta)) Q: four products;
//   3. dQ: per key tile, S = Q K^T, P, dP = dO V^T, dQ += (P (dP - delta)) K:
//      three products.
// Seven products where the bound counts five: S and dP are computed in both
// passes, the price of writing every gradient once without atomics.
//
// bf16 (hopper_tiles.cuh), each pass on the forward's pieces: one block of
// three warpgroups per 128 owned rows (keys in pass 2, q rows in pass 3),
// head and batch. Warpgroup 0 is the producer: one thread loads the owned
// tiles once and streams 64-row tiles of the other side (q and dO, or K and
// V) by TMA through a ring of three stages with full and empty mbarriers; in
// pass 2 the producer warp also stages each q tile's lse and delta rows
// (+inf and 0 past N). Warpgroups 1 and 2 own 64 rows each and run every
// product on wgmma: S and dP from shared memory (both operands K-major), the
// gradient products with the rounded P or T from registers and the streamed
// tile read MN-major. Each warpgroup issues the next tile's S and dP before
// this tile's gradient products and computes the next tile's P and T while
// those run, into a second set of registers (the two sets are used in turn,
// so no register a product reads is written before it completes).
//
// fp32 keeps the scalar-FMA kernels over attention_tiles.cuh's tiles (4
// warps per 64-row tile), which hold the tight fp32 checks.

#include "attention_tiles.cuh"
#include "hopper_tiles.cuh"

namespace {

// ------------------------------------------------------------------ bf16, wgmma
namespace hop {

using namespace dad_hopper;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;
constexpr int kWgRows = 64;                // owned rows of a consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kBM = kWgRows * kConsumers;  // owned rows of a block
constexpr int kBN = 64;                    // streamed rows of a stage
constexpr int kStages = 3;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBox = 64 * kD;              // elements of one TMA box (8 KB)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: two owned operands of kBM rows, kStages stages of two
// streamed tiles (and, in pass 2, their lse and delta rows), the barriers.
constexpr size_t kSmem = 1024 /* alignment slack */ + (size_t)(2 * kBM + 2 * kStages * kBN) * kD * 2 +
                         (size_t)kStages * 2 * kBN * sizeof(float) +
                         (1 + 2 * kStages) * sizeof(uint64_t);

struct Smem {
  bf16* own_a;      // dK/dV: K  | dQ: Q   (kBM rows)
  bf16* own_b;      // dK/dV: V  | dQ: dO  (kBM rows)
  bf16* str_a;      // dK/dV: Q  | dQ: K   (kStages x kBN rows)
  bf16* str_b;      // dK/dV: dO | dQ: V   (kStages x kBN rows)
  float* lse;       // dK/dV: lse * log2(e) of the streamed q rows (kStages x kBN)
  float* delta;     // dK/dV: delta of the streamed q rows
  uint64_t* own_full;
  uint64_t* full;   // kStages
  uint64_t* empty;  // kStages
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  Smem s;
  s.own_a = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  s.own_b = s.own_a + kBM * kD;
  s.str_a = s.own_b + kBM * kD;
  s.str_b = s.str_a + kStages * kBN * kD;
  s.lse = reinterpret_cast<float*>(s.str_b + kStages * kBN * kD);
  s.delta = s.lse + kStages * kBN;
  s.own_full = reinterpret_cast<uint64_t*>(s.delta + kStages * kBN);
  s.full = s.own_full + 1;
  s.empty = s.full + kStages;
  return s;
}

// Store rows g and g+8 of this warp's 16 rows of a warpgroup accumulator,
// times `scale`, into columns [col, col+64) of rows `stride` apart; rows at
// or past n are skipped.
__device__ __forceinline__ void store_acc(bf16* base, const float (&acc)[32], int row0, int n,
                                          long stride, int col, float scale) {
  const int lane = threadIdx.x & 31, cq = lane & 3;
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

// The A fragment of k-step kk from bf16 pairs in accumulator order
// (f[2j] row g, f[2j + 1] row g + 8, columns 8j + 2cq, +1).
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint32_t (&f)[16], int kk) {
  a[0] = f[4 * kk];
  a[1] = f[4 * kk + 1];
  a[2] = f[4 * kk + 2];
  a[3] = f[4 * kk + 3];
}

// Block setup shared by both passes: barriers (the empty ones count every
// warp of the active consumer warpgroups; the full ones, in pass 2, also
// the producer warp's 32 lanes that stage lse and delta).
__device__ __forceinline__ int setup(const Smem& sm, int n, int full_count) {
  const int active = min(kConsumers, (n - (int)blockIdx.x * kBM + kWgRows - 1) / kWgRows);
  if (threadIdx.x == 0) {
    mbar_init(sm.own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], full_count);
      mbar_init(&sm.empty[s], active * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  return active;
}

// Issue S = A1 B1^T and dP = A2 B2^T of streamed tile kt (64 owned rows x
// 64 streamed rows), A1, A2 the owned tiles and B1, B2 the streamed ones,
// once the stage is in.
__device__ __forceinline__ void issue_ss(float (&s)[32], float (&dp)[32], uint64_t a1,
                                         uint64_t a2, const Smem& sm, int kt) {
  const int st = kt % kStages;
  mbar_wait(&sm.full[st], (kt / kStages) & 1);
  const uint64_t b1 = desc_sw128(sm.str_a + st * kBox), b2 = desc_sw128(sm.str_b + st * kBox);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_ss_n64(s, a1 + 2 * kk, b1 + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_ss_n64(dp, a2 + 2 * kk, b2 + 2 * kk, kk);
  wgmma_commit();
}

// Issue acc += F B for the 64 streamed rows of a tile read MN-major, F given
// as bf16 pairs in accumulator order.
__device__ __forceinline__ void issue_rs(float (&acc)[32], const uint32_t (&f)[16],
                                         const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    uint32_t a[4];
    a_frag(a, f, kk);
    wgmma_rs_n64(acc, a, desc_sw128(tile + kk * 16 * kD), 1);
  }
}

// Pass 2, streamed q tile kt: P^T = exp(S^T - lse) and T^T = P^T (dP^T -
// delta), both rounded to bf16 pairs, from the stage's lse and delta rows.
__device__ __forceinline__ void dkdv_elementwise(const float (&s)[32], const float (&dp)[32],
                                                 const Smem& sm, int kt, float scale_log2,
                                                 uint32_t (&pf)[16], uint32_t (&tf)[16]) {
  const int cq = threadIdx.x & 3;
  const float* lse_t = sm.lse + (kt % kStages) * kBN;
  const float* delta_t = sm.delta + (kt % kStages) * kBN;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = 8 * j + 2 * cq;
    const float l0 = lse_t[q], l1 = lse_t[q + 1];
    const float d0 = delta_t[q], d1 = delta_t[q + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat162 p =
          __floats2bfloat162_rn(exp2_ftz(fmaf(s[4 * j + 2 * r], scale_log2, -l0)),
                                exp2_ftz(fmaf(s[4 * j + 2 * r + 1], scale_log2, -l1)));
      pf[2 * j + r] = *reinterpret_cast<const uint32_t*>(&p);
      tf[2 * j + r] = pack_bf16(__low2float(p) * (dp[4 * j + 2 * r] - d0),
                                __high2float(p) * (dp[4 * j + 2 * r + 1] - d1));
    }
  }
}

// Pass 3, streamed key tile kt: P = exp(S - lse), 0 for keys past N, and
// T = P (dP - delta) rounded to bf16 pairs, from this thread's two rows.
__device__ __forceinline__ void dq_elementwise(const float (&s)[32], const float (&dp)[32],
                                               int kt, int n, float scale_log2,
                                               const float (&row_lse)[2],
                                               const float (&row_delta)[2], uint32_t (&tf)[16]) {
  const int cq = threadIdx.x & 3;
  const bool ragged = (kt + 1) * kBN > n;  // only the last tile holds keys past N
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = kt * kBN + 8 * j + 2 * cq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float p0 = round_bf16(exp2_ftz(fmaf(s[4 * j + 2 * r], scale_log2, -row_lse[r])));
      float p1 = round_bf16(exp2_ftz(fmaf(s[4 * j + 2 * r + 1], scale_log2, -row_lse[r])));
      if (ragged) {
        p0 = key < n ? p0 : 0.f;
        p1 = key + 1 < n ? p1 : 0.f;
      }
      tf[2 * j + r] = pack_bf16(p0 * (dp[4 * j + 2 * r] - row_delta[r]),
                                p1 * (dp[4 * j + 2 * r + 1] - row_delta[r]));
    }
  }
}

// One step of pass 2: S^T, dP^T of q tile kt + 1, then dV += P^T dO and
// dK += T^T Q of tile kt (from p, t), in flight while the elementwise part
// of tile kt + 1 writes p_next, t_next.
__device__ __forceinline__ void dkdv_step(float (&s)[32], float (&dp)[32], float (&dk)[32],
                                          float (&dv)[32], uint32_t (&p)[16], uint32_t (&t)[16],
                                          uint32_t (&p_next)[16], uint32_t (&t_next)[16],
                                          uint64_t kdesc, uint64_t vdesc, const Smem& sm, int kt,
                                          float scale_log2) {
  issue_ss(s, dp, kdesc, vdesc, sm, kt + 1);
  const int st = kt % kStages;
  wgmma_fence();
  issue_rs(dv, p, sm.str_b + st * kBox);
  issue_rs(dk, t, sm.str_a + st * kBox);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(s);
  fence_regs(dp);
  dkdv_elementwise(s, dp, sm, kt + 1, scale_log2, p_next, t_next);
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
  fence_regs(p);
  fence_regs(t);
  if ((threadIdx.x & 31) == 0) mbar_arrive(&sm.empty[st]);  // the warpgroup's products are done
}

// One step of pass 3: S, dP of key tile kt + 1, then dQ += T K of tile kt
// (from t), in flight while the elementwise part of tile kt + 1 writes t_next.
__device__ __forceinline__ void dq_step(float (&s)[32], float (&dp)[32], float (&dq)[32],
                                        uint32_t (&t)[16], uint32_t (&t_next)[16],
                                        uint64_t qdesc, uint64_t dodesc, const Smem& sm, int kt,
                                        int n, float scale_log2, const float (&row_lse)[2],
                                        const float (&row_delta)[2]) {
  issue_ss(s, dp, qdesc, dodesc, sm, kt + 1);
  const int st = kt % kStages;
  wgmma_fence();
  issue_rs(dq, t, sm.str_a + st * kBox);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(s);
  fence_regs(dp);
  dq_elementwise(s, dp, kt + 1, n, scale_log2, row_lse, row_delta, t_next);
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(t);
  if ((threadIdx.x & 31) == 0) mbar_arrive(&sm.empty[st]);  // the warpgroup's products are done
}

// The products of the last tile of pass 2 (from p, t) and of pass 3 (from t).
__device__ __forceinline__ void dkdv_last(float (&dk)[32], float (&dv)[32], uint32_t (&p)[16],
                                          uint32_t (&t)[16], const Smem& sm, int kt) {
  const int st = kt % kStages;
  wgmma_fence();
  issue_rs(dv, p, sm.str_b + st * kBox);
  issue_rs(dk, t, sm.str_a + st * kBox);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
  fence_regs(p);
  fence_regs(t);
}

__device__ __forceinline__ void dq_last(float (&dq)[32], uint32_t (&t)[16], const Smem& sm,
                                        int kt) {
  wgmma_fence();
  issue_rs(dq, t, sm.str_a + (kt % kStages) * kBox);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(t);
}

// ---- 2. dK, dV for 128 keys of one head
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_wgmma(const __grid_constant__ CUtensorMap qkv_map,
               const __grid_constant__ CUtensorMap g_map, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dqkv, int n, int heads,
               float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int c = heads * kD;
  const int k0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int active = setup(sm, n, 32);

  if (threadIdx.x < 128) {
    // ---- producer: warp 0 streams q, dO (TMA, lane 0) and lse, delta (all lanes)
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lse_b = lse + ((long)b * heads + h) * n;
      const float* delta_b = delta + ((long)b * heads + h) * n;
      if (lane == 0) {
        mbar_arrive_expect_tx(sm.own_full, 2 * active * kBox * 2);
        for (int w = 0; w < active; ++w) {
          tma_load_3d(sm.own_a + w * kBox, &qkv_map, sm.own_full, c + h * kD, k0 + w * kWgRows, b);
          tma_load_3d(sm.own_b + w * kBox, &qkv_map, sm.own_full, 2 * c + h * kD,
                      k0 + w * kWgRows, b);
        }
      }
      for (int qt = 0; qt < n_tiles; ++qt) {
        const int st = qt % kStages, round = qt / kStages;
        const int q0 = qt * kBN;
        if (round > 0) mbar_wait(&sm.empty[st], (round - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&sm.full[st], 2 * kBox * 2);
          tma_load_3d(sm.str_a + st * kBox, &qkv_map, &sm.full[st], h * kD, q0, b);
          tma_load_3d(sm.str_b + st * kBox, &g_map, &sm.full[st], h * kD, q0, b);
        }
        for (int i = lane; i < kBN; i += 32) {
          const bool ok = q0 + i < n;
          sm.lse[st * kBN + i] = ok ? lse_b[q0 + i] * kLog2e : INFINITY;  // p = 0 past N
          sm.delta[st * kBN + i] = ok ? delta_b[q0 + i] : 0.f;
        }
        mbar_arrive(&sm.full[st]);  // each lane after its own stores
      }
    }
  } else {
    // ---- consumers: 64 keys each
    setmaxnreg_inc<232>();
    const int w = threadIdx.x / 128 - 1;
    if (w < active) {
      const int warp = (threadIdx.x & 127) >> 5, g = (threadIdx.x & 31) >> 2;
      const float scale_log2 = scale * kLog2e;
      float dk[32], dv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

      mbar_wait(sm.own_full, 0);
      const uint64_t kdesc = desc_sw128(sm.own_a + w * kBox);
      const uint64_t vdesc = desc_sw128(sm.own_b + w * kBox);
      // S^T, dP^T: 64 keys x 64 q rows; P^T and T^T of tile qt in (pa, ta)
      // for even qt, (pb, tb) for odd qt: no register copies
      float s[32], dp[32];
      uint32_t pa[16], ta[16], pb[16], tb[16];
      issue_ss(s, dp, kdesc, vdesc, sm, 0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      dkdv_elementwise(s, dp, sm, 0, scale_log2, pa, ta);
      int qt = 0;
      for (; qt + 2 < n_tiles; qt += 2) {
        dkdv_step(s, dp, dk, dv, pa, ta, pb, tb, kdesc, vdesc, sm, qt, scale_log2);
        dkdv_step(s, dp, dk, dv, pb, tb, pa, ta, kdesc, vdesc, sm, qt + 1, scale_log2);
      }
      if (qt + 1 < n_tiles) {
        dkdv_step(s, dp, dk, dv, pa, ta, pb, tb, kdesc, vdesc, sm, qt, scale_log2);
        dkdv_last(dk, dv, pb, tb, sm, qt + 1);
      } else {
        dkdv_last(dk, dv, pa, ta, sm, qt);
      }
      bf16* dst = dqkv + (long)b * n * 3 * c;
      const int row0 = k0 + w * kWgRows + warp * 16 + g;
      store_acc(dst, dk, row0, n, 3L * c, c + h * kD, scale);
      store_acc(dst, dv, row0, n, 3L * c, 2 * c + h * kD, 1.f);
    }
  }
}

// ---- 3. dQ for 128 q rows of one head
__global__ void __launch_bounds__(kThreads, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap qkv_map, const __grid_constant__ CUtensorMap g_map,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dqkv, int n, int heads, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int c = heads * kD;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (n + kBN - 1) / kBN;
  const int active = setup(sm, n, 1);

  if (threadIdx.x < 128) {
    // ---- producer: one thread streams K, V
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(sm.own_full, 2 * active * kBox * 2);
      for (int w = 0; w < active; ++w) {
        tma_load_3d(sm.own_a + w * kBox, &qkv_map, sm.own_full, h * kD, q0 + w * kWgRows, b);
        tma_load_3d(sm.own_b + w * kBox, &g_map, sm.own_full, h * kD, q0 + w * kWgRows, b);
      }
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages, round = kt / kStages;
        if (round > 0) mbar_wait(&sm.empty[st], (round - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], 2 * kBox * 2);
        tma_load_3d(sm.str_a + st * kBox, &qkv_map, &sm.full[st], c + h * kD, kt * kBN, b);
        tma_load_3d(sm.str_b + st * kBox, &qkv_map, &sm.full[st], 2 * c + h * kD, kt * kBN, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    setmaxnreg_inc<232>();
    const int w = threadIdx.x / 128 - 1;
    if (w < active) {
      const int warp = (threadIdx.x & 127) >> 5, g = (threadIdx.x & 31) >> 2;
      const float scale_log2 = scale * kLog2e;
      const int row0 = q0 + w * kWgRows + warp * 16 + g;
      float row_lse[2], row_delta[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const long at = ((long)b * heads + h) * n + row;
        row_lse[r] = row < n ? lse[at] * kLog2e : INFINITY;  // p = 0 for rows past N
        row_delta[r] = row < n ? delta[at] : 0.f;
      }
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;

      mbar_wait(sm.own_full, 0);
      const uint64_t qdesc = desc_sw128(sm.own_a + w * kBox);
      const uint64_t dodesc = desc_sw128(sm.own_b + w * kBox);
      // S, dP: 64 q rows x 64 keys; T of tile kt in ta for even kt, tb for odd
      float s[32], dp[32];
      uint32_t ta[16], tb[16];
      issue_ss(s, dp, qdesc, dodesc, sm, 0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      dq_elementwise(s, dp, 0, n, scale_log2, row_lse, row_delta, ta);
      int kt = 0;
      for (; kt + 2 < n_tiles; kt += 2) {
        dq_step(s, dp, dq, ta, tb, qdesc, dodesc, sm, kt, n, scale_log2, row_lse, row_delta);
        dq_step(s, dp, dq, tb, ta, qdesc, dodesc, sm, kt + 1, n, scale_log2, row_lse, row_delta);
      }
      if (kt + 1 < n_tiles) {
        dq_step(s, dp, dq, ta, tb, qdesc, dodesc, sm, kt, n, scale_log2, row_lse, row_delta);
        dq_last(dq, tb, sm, kt + 1);
      } else {
        dq_last(dq, ta, sm, kt);
      }
      store_acc(dqkv + (long)b * n * 3 * c, dq, row0, n, 3L * c, h * kD, scale);
    }
  }
}

int launch_bf16(const void* qkv, const void* out, const void* g, const float* lse, float* delta,
                void* dqkv, int batch, int n, int heads, float scale, cudaStream_t stream) {
  const bf16* g_t = static_cast<const bf16*>(g);
  cudaError_t e = dad_attn::launch_delta<bf16>(static_cast<const bf16*>(out), g_t, delta, batch,
                                               n, heads, stream);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qkv_map, g_map;
  int err = make_map_3d(&qkv_map, qkv, batch, n, 3 * heads * kD);
  if (!err) err = make_map_3d(&g_map, g, batch, n, heads * kD);
  if (err) return err;
  const dim3 grid((n + kBM - 1) / kBM, heads, batch);
  bf16* d = static_cast<bf16*>(dqkv);
  e = cudaFuncSetAttribute(dkdv_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dkdv_wgmma<<<grid, kThreads, kSmem, stream>>>(qkv_map, g_map, lse, delta, d, n, heads, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dq_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dq_wgmma<<<grid, kThreads, kSmem, stream>>>(qkv_map, g_map, lse, delta, d, n, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace hop

// ------------------------------------------------------------------ fp32, scalar FMA
using namespace dad_attn;

struct Smem {
  float* a;      // dK/dV: K   | dQ: Q
  float* b;      // dK/dV: V   | dQ: dO
  float* c;      // dK/dV: Q   | dQ: K
  float* d;      // dK/dV: dO  | dQ: V
  float* lse;    // dK/dV: lse of the q tile's rows (+inf past N)
  float* delta;  // dK/dV: delta of the q tile's rows (0 past N)
  float* pw;     // this warp's P staging
};

__device__ __forceinline__ Smem carve(unsigned char* smem) {
  constexpr int kRow = row_elems<float>();
  Smem s;
  s.a = reinterpret_cast<float*>(smem);
  s.b = s.a + kTile * kRow;
  s.c = s.b + kTile * kRow;
  s.d = s.c + kTile * kRow;
  s.lse = s.d + kTile * kRow;
  s.delta = s.lse + kTile;
  s.pw = s.delta + kTile + (threadIdx.x >> 5) * 16 * kProw;
  return s;
}

constexpr size_t kSmemFp32 = (size_t)4 * kTile * row_elems<float>() * sizeof(float) +
                             2 * kTile * sizeof(float) + (size_t)kWarps * 16 * kProw * sizeof(float);

// ---- 2. dK, dV for one 64-key tile of one head
__global__ void __launch_bounds__(kThreads)
    dkdv_fp32(const float* __restrict__ qkv, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dqkv, int n, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = carve(smem);
  float *ks = sm.a, *vs = sm.b, *qs = sm.c, *dos = sm.d;

  const int c = heads * kD;
  const long stride = 3L * c;
  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* base = qkv + (long)b * n * stride;
  const float* gbase = g + (long)b * n * c;
  const float* lse_b = lse + ((long)b * heads + h) * n;
  const float* delta_b = delta + ((long)b * heads + h) * n;
  const int t = threadIdx.x & 3;

  load_tile<float>(ks, base, k0, n, stride, c + h * kD);
  load_tile<float>(vs, base, k0, n, stride, 2 * c + h * kD);

  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  const int n_tiles = (n + kTile - 1) / kTile;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile<float>(qs, base, q0, n, stride, h * kD);
    load_tile<float>(dos, gbase, q0, n, c, h * kD);
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
        int q = 8 * j + 2 * t + (e & 1);
        p[j][e] = expf(p[j][e] * scale - sm.lse[q]);
      }

    // dV += P^T dO
    fma_nn(dv, p, sm.pw, dos);

    // dK += (P^T (dP^T - delta)) Q
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int q = 8 * j + 2 * t + (e & 1);
        p[j][e] *= dp[j][e] - sm.delta[q];
      }
    fma_nn(dk, p, sm.pw, qs);
  }
  float* dst = dqkv + (long)b * n * stride;
  store_rows<float>(dst, dk, k0, n, stride, c + h * kD, scale);
  store_rows<float>(dst, dv, k0, n, stride, 2 * c + h * kD, 1.f);
}

// ---- 3. dQ for one 64-row q tile of one head
__global__ void __launch_bounds__(kThreads)
    dq_fp32(const float* __restrict__ qkv, const float* __restrict__ g,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dqkv, int n, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = carve(smem);
  float *qs = sm.a, *dos = sm.b, *ks = sm.c, *vs = sm.d;

  const int c = heads * kD;
  const long stride = 3L * c;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* base = qkv + (long)b * n * stride;
  const float* lse_b = lse + ((long)b * heads + h) * n;
  const float* delta_b = delta + ((long)b * heads + h) * n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g_row = lane >> 2, t = lane & 3;

  load_tile<float>(qs, base, q0, n, stride, h * kD);
  load_tile<float>(dos, g + (long)b * n * c, q0, n, c, h * kD);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g_row + 8 * r;
    row_lse[r] = row < n ? lse_b[row] : INFINITY;  // p = 0 for rows past N
    row_delta[r] = row < n ? delta_b[row] : 0.f;
  }

  float dq[8][4];
  zero(dq);
  const int n_tiles = (n + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<float>(ks, base, k0, n, stride, c + h * kD);
    load_tile<float>(vs, base, k0, n, stride, 2 * c + h * kD);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 q rows x 64 keys
    float p[8][4], dp[8][4];
    zero(p);
    zero(dp);
    fma_nt(p, qs, ks);
    fma_nt(dp, dos, vs);
    // P = exp(S - lse), zero for keys past N; T = P (dP - delta)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int r = e >> 1;
        float pe = key < n ? expf(p[j][e] * scale - row_lse[r]) : 0.f;
        p[j][e] = pe * (dp[j][e] - row_delta[r]);
      }
    // dQ += T K
    fma_nn(dq, p, sm.pw, ks);
  }
  store_rows<float>(dqkv + (long)b * n * stride, dq, q0, n, stride, h * kD, scale);
}

int launch_fp32(const void* qkv, const void* out, const void* g, const float* lse, float* delta,
                void* dqkv, int batch, int n, int heads, float scale, cudaStream_t stream) {
  const float* qkv_t = static_cast<const float*>(qkv);
  const float* g_t = static_cast<const float*>(g);
  float* dqkv_t = static_cast<float*>(dqkv);
  cudaError_t err = launch_delta<float>(static_cast<const float*>(out), g_t, delta, batch, n,
                                        heads, stream);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((n + kTile - 1) / kTile, heads, batch);
  err = cudaFuncSetAttribute(dkdv_fp32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemFp32);
  if (err != cudaSuccess) return (int)err;
  dkdv_fp32<<<grid, kThreads, kSmemFp32, stream>>>(qkv_t, g_t, lse, delta, dqkv_t, n, heads,
                                                   scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(dq_fp32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemFp32);
  if (err != cudaSuccess) return (int)err;
  dq_fp32<<<grid, kThreads, kSmemFp32, stream>>>(qkv_t, g_t, lse, delta, dqkv_t, n, heads, scale);
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
  if (dtype == 0) return hop::launch_bf16(qkv, out, g, l, dl, dqkv, batch, n, heads, scale, st);
  if (dtype == 1) return launch_fp32(qkv, out, g, l, dl, dqkv, batch, n, heads, scale, st);
  return -1;
}
