// The mask policies of the biased (kernels 5 and 6) and banded (kernels 7
// and 8) attention, read by masked_attention.cuh (forward) and
// masked_attention_bwd.cuh (backward), for sm_90a.
//
// A policy supplies the additive term of each score and the tiles a block
// visits. Query-major (the forward and the dQ pass: a block owns a q tile,
// its accumulator rows are queries and its columns keys):
//   kScratch                      bytes of shared memory it stages per tile;
//   Row row(int r)                the per-query-row state (r may be >= N);
//   bool tile_live(q0, kt)        false if key tile kt is known to be masked
//                                 for every row of the q tile at q0 (the
//                                 same answer for every thread);
//   void stage(sm, q0, k0)        called by every thread of the block: stage
//                                 what `at` reads for the tile of rows
//                                 [q0, q0+64) and keys [k0, k0+64);
//   float at(sm, Row, rl, kl)     the additive term of row q0+rl and key
//                                 k0+kl < N: a finite value, or -inf where
//                                 the key is masked (always -inf for a row
//                                 >= N);
//   int2 tiles(int q0)            the first and last key tile (inclusive)
//                                 the q tile starting at row q0 may see.
// Key-major (the dK/dV pass: a block owns a key tile, its accumulator rows
// are keys and its columns queries):
//   Key key(int kidx)             the per-key state (kidx may be >= N);
//   void stage_t(sm, q0, k0)      what `at_t` reads, as `stage`;
//   float at_t(sm, Key, kl, ql)   the term of row q0+ql and key k0+kl: as
//                                 `at`, and -inf for a key >= N;
//   int2 inv_tiles(int k0)        the first and last q tile (inclusive)
//                                 that may see the key tile at k0.
// The bf16 backward on wgmma (masked_attention_bwd.cuh) reads the terms from
// registers or from a stage its producer loads by TMA, and never loads a
// dead tile:
//   kTmaTerms, kStageFloats       whether the terms arrive by TMA, and the
//                                 floats of one stage of them;
//   bool any_live(q_lo, q_hi, k_lo, k_hi)  called by a whole warp, the same
//                                 answer on every lane: whether rows
//                                 [q_lo, q_hi) and keys [k_lo, k_hi) (both
//                                 within N) hold a live pair;
//   kcols(base, KCol[16]), qterm(Row, KCol, rl, kl, terms)   dQ pass: the
//                                 state of a thread's 16 key columns base +
//                                 8j + e, and the term of block row rl and
//                                 key kl of the stage;
//   qcols(base, QCol[16]), kterm(Key, QCol, kl, ql, terms)   dK/dV pass: the
//                                 same for query columns and owned key kl.
// Every term is -inf past N, for a row or a key.
#pragma once

#include "attention_tiles.cuh"
#include "hopper_tiles.cuh"

namespace dad_attn {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// One block per (key tile, q tile): live[q tile * nk + key tile] = whether
// the tile of the bias holds a finite entry (rows and keys < N).
template <typename TB>
__global__ void __launch_bounds__(256)
    tile_live_kernel(const TB* __restrict__ bias, int n, int nk, unsigned char* __restrict__ live) {
  const int k0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile;
  bool any = false;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    int row = q0 + i / kTile, key = k0 + i % kTile;
    if (row < n && key < n) any |= to_float(bias[(long)row * n + key]) != -INFINITY;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) live[blockIdx.y * nk + blockIdx.x] = any;
}

template <typename TB>
cudaError_t mark_live_tiles(const TB* bias, int n, unsigned char* live, cudaStream_t st) {
  const int nk = (n + kTile - 1) / kTile;
  tile_live_kernel<TB><<<dim3(nk, nk), 256, 0, st>>>(bias, n, nk, live);
  return cudaGetLastError();
}

// out [np, np] fp32 = the bias (0 without one) for rows and keys < N, -inf
// past N: the terms of the bf16 backward, read by TMA.
template <typename TB>
__global__ void __launch_bounds__(256)
    bias_f32_kernel(const TB* __restrict__ bias, int n, int np, float* __restrict__ out) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long)np * np) return;
  const int row = (int)(i / np), key = (int)(i % np);
  float x = -INFINITY;
  if (row < n && key < n)
    x = bias == nullptr ? 0.f : to_float(bias[(long)row * n + key]);
  out[i] = x;
}

template <typename TB>
cudaError_t bias_f32(const TB* bias, int n, int np, float* out, cudaStream_t st) {
  const unsigned blocks = (unsigned)(((long)np * np + 255) / 256);
  bias_f32_kernel<TB><<<blocks, 256, 0, st>>>(bias, n, np, out);
  return cudaGetLastError();
}

// An additive [N, N] bias (or none: every key < N is live), staged per tile
// as fp32 in shared memory with coalesced loads: consecutive threads read
// consecutive keys of a row (the rows of an odd N are not 4-byte aligned, so
// the loads are scalar). Row stride kBs = 68 floats keeps the accumulator-
// order reads to 2-way bank conflicts, and the transposed reads of the
// dK/dV pass (rows = keys) conflict-free. `live` holds tile_live_kernel's
// marks (null without a bias).
template <typename TB>
struct BiasMask {
  static constexpr int kBs = kTile + 4;
  static constexpr size_t kScratch = (size_t)kTile * kBs * sizeof(float);
  const TB* bias;
  const unsigned char* live;
  int n, nk;
  struct Row {};
  struct Key {};
  __device__ Row row(int) const { return {}; }
  __device__ Key key(int) const { return {}; }
  __device__ bool tile_live(int q0, int kt) const {
    return live == nullptr || live[(q0 / kTile) * nk + kt];
  }
  __device__ void stage(unsigned char* sm, int q0, int k0) const {
    float* tile = reinterpret_cast<float*>(sm);
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      int r = i / kTile, c = i % kTile;
      int row = q0 + r, key = k0 + c;
      float x = -INFINITY;
      if (row < n && key < n) x = bias == nullptr ? 0.f : to_float(bias[(long)row * n + key]);
      tile[r * kBs + c] = x;
    }
  }
  __device__ void stage_t(unsigned char* sm, int q0, int k0) const { stage(sm, q0, k0); }
  __device__ float at(const unsigned char* sm, const Row&, int rl, int kl) const {
    return reinterpret_cast<const float*>(sm)[rl * kBs + kl];
  }
  __device__ float at_t(const unsigned char* sm, const Key&, int kl, int ql) const {
    return reinterpret_cast<const float*>(sm)[ql * kBs + kl];
  }
  __device__ int2 tiles(int) const { return make_int2(0, (n - 1) / kTile); }
  __device__ int2 inv_tiles(int) const { return make_int2(0, (n - 1) / kTile); }

  // ---- the wgmma backward: the terms arrive by TMA from bias_f32_kernel's
  // copy, as 128-byte-swizzled fp32 boxes of 64 rows x 32 columns: the dQ
  // pass's stage holds rows [q0, q0+128) x keys [k0, k0+64) (boxes 2 * (r /
  // 64) + c / 32), the dK/dV pass's rows [q0, q0+64) x keys [k0, k0+128)
  // (boxes c / 32).
  static constexpr bool kTmaTerms = true;
  static constexpr int kStageFloats = 2 * kTile * kTile;
  struct KCol {};
  using QCol = KCol;
  __device__ bool any_live(int q_lo, int q_hi, int k_lo, int k_hi) const {
    if (live == nullptr) return true;
    for (int qt = q_lo / kTile; qt <= (q_hi - 1) / kTile; ++qt)
      for (int kt = k_lo / kTile; kt <= (k_hi - 1) / kTile; ++kt)
        if (live[qt * nk + kt]) return true;
    return false;
  }
  __device__ void kcols(int, KCol (&)[16]) const {}
  __device__ void qcols(int, QCol (&)[16]) const {}
  __device__ float qterm(const Row&, const KCol&, int rl, int kl, const float* t) const {
    return dad_hopper::swizzled_f32(t + ((rl >> 6) * 2 + (kl >> 5)) * 2048, rl & 63, kl & 31);
  }
  __device__ float kterm(const Key&, const QCol&, int kl, int ql, const float* t) const {
    return dad_hopper::swizzled_f32(t + (kl >> 5) * 2048, ql, kl & 31);
  }
};

// The window mask of a row-major (gh, gw) grid with no prefix tokens:
// query (y, x) sees the keys of the window x window block around its
// centre, the centre clamped to [half, max(g - 1 - half, half)] on each
// axis (ops/window.py's corner completion). Each tile stages its 64 keys'
// grid coordinates (forward, dQ) or its 64 queries' clamped centres (dK/dV),
// one division each, so that the per-score test is two compares. A key or
// query past N gets a coordinate no window reaches.
struct WindowMask {
  static constexpr size_t kScratch = (size_t)kTile * sizeof(int2);
  static constexpr int kFar = 1 << 20;
  int n, gh, gw, half;
  struct Row {
    int cy, cx;
    bool ok;
  };
  struct Key {
    int ky, kx;
  };
  __device__ static int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
  __device__ Row row(int r) const {
    int y = r / gw, x = r - y * gw;
    return {clampi(y, half, max(gh - 1 - half, half)), clampi(x, half, max(gw - 1 - half, half)),
            r < n};
  }
  __device__ Key key(int kidx) const {
    if (kidx >= n) return {-kFar, -kFar};
    int ky = kidx / gw;
    return {ky, kidx - ky * gw};
  }
  __device__ bool tile_live(int, int) const { return true; }  // the band is the whole range
  __device__ void stage(unsigned char* sm, int, int k0) const {
    if (threadIdx.x < kTile) {
      int key = k0 + threadIdx.x, ky = key / gw;
      reinterpret_cast<int2*>(sm)[threadIdx.x] = make_int2(ky, key - ky * gw);
    }
  }
  __device__ void stage_t(unsigned char* sm, int q0, int) const {
    if (threadIdx.x < kTile) {
      Row r = row(q0 + threadIdx.x);
      reinterpret_cast<int2*>(sm)[threadIdx.x] = r.ok ? make_int2(r.cy, r.cx)
                                                      : make_int2(kFar, kFar);
    }
  }
  __device__ float at(const unsigned char* sm, const Row& r, int, int kl) const {
    int2 k = reinterpret_cast<const int2*>(sm)[kl];
    return r.ok && abs(r.cy - k.x) <= half && abs(r.cx - k.y) <= half ? 0.f : -INFINITY;
  }
  __device__ float at_t(const unsigned char* sm, const Key& k, int, int ql) const {
    int2 c = reinterpret_cast<const int2*>(sm)[ql];
    return abs(c.x - k.ky) <= half && abs(c.y - k.kx) <= half ? 0.f : -INFINITY;
  }
  // the key tiles of token rows [clip(r0) - half, clip(r1) + half] for the
  // grid rows r0..r1 of the q tile (the JAX _band_bounds_traced)
  __device__ int2 tiles(int q0) const {
    int top = max(gh - 1 - half, half);
    int r0 = q0 / gw, r1 = min(q0 + kTile - 1, n - 1) / gw;
    int lo = (clampi(r0, half, top) - half) * gw;
    int hi = min((clampi(r1, half, top) + half + 1) * gw, n) - 1;
    return make_int2(lo / kTile, hi / kTile);
  }
  // the q tiles whose band holds a key of grid rows c0..c1 (the JAX
  // _inv_band_bounds_traced): a query row r sees key row c iff clip(r) is in
  // [c - half, c + half]; rows below the clip floor see the first window
  // rows, rows above its ceiling the last ones
  __device__ int2 inv_tiles(int k0) const {
    int c0 = k0 / gw, c1 = min(k0 + kTile - 1, n - 1) / gw;
    int r_lo = c0 - half <= half ? 0 : c0 - half;
    int r_hi = c1 + half >= gh - 1 - half ? gh - 1 : c1 + half;
    return make_int2(r_lo * gw / kTile, ((r_hi + 1) * gw - 1) / kTile);
  }

  // ---- the wgmma backward: terms 0 or -inf computed in registers from the
  // grid coordinates of the accumulator's rows and columns, nothing staged.
  static constexpr bool kTmaTerms = false;
  static constexpr int kStageFloats = 0;
  struct KCol {  // a key's grid cell (-kFar past N)
    int ky, kx;
  };
  struct QCol {  // a query's clamped window centre (kFar past N)
    int cy, cx;
  };
  // (idx / gw, idx % gw) by a float reciprocal and one correction (exact for
  // idx < 2^24)
  __device__ int2 grid_pos(int idx) const {
    int y = __float2int_rz(__int2float_rn(idx) * __frcp_rn(__int2float_rn(gw)));
    int x = idx - y * gw;
    if (x < 0) {
      --y;
      x += gw;
    } else if (x >= gw) {
      ++y;
      x -= gw;
    }
    return make_int2(y, x);
  }
  // f(i, idx, y, x) for the 16 columns idx = base + 8 (i / 2) + i % 2 of a
  // thread's accumulator, stepping the grid cell instead of dividing
  template <typename F>
  __device__ void walk16(int base, F f) const {
    const int2 p = grid_pos(base);
    const int dy = 8 / gw, dx = 8 - dy * gw;  // a step of 8 tokens
    int y = p.x, x = p.y;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      f(2 * j, base + 8 * j, y, x);
      const bool wrap = x + 1 >= gw;
      f(2 * j + 1, base + 8 * j + 1, wrap ? y + 1 : y, wrap ? x + 1 - gw : x + 1);
      x += dx;
      y += dy;
      const bool carry = x >= gw;
      x = carry ? x - gw : x;
      y = carry ? y + 1 : y;
    }
  }
  __device__ void kcols(int base, KCol (&c)[16]) const {
    walk16(base, [&](int i, int key, int y, int x) {
      c[i] = key < n ? KCol{y, x} : KCol{-kFar, -kFar};
    });
  }
  __device__ void qcols(int base, QCol (&c)[16]) const {
    const int top_y = max(gh - 1 - half, half), top_x = max(gw - 1 - half, half);
    walk16(base, [&](int i, int q, int y, int x) {
      c[i] = q < n ? QCol{clampi(y, half, top_y), clampi(x, half, top_x)} : QCol{kFar, kFar};
    });
  }
  // |d| <= half as one unsigned compare (the tests below use bitwise &: no
  // branches)
  __device__ bool near(int d) const { return (unsigned)(d + half) <= (unsigned)(2 * half); }
  __device__ float qterm(const Row& r, const KCol& k, int, int, const float*) const {
    return r.ok & near(r.cy - k.ky) & near(r.cx - k.kx) ? 0.f : -INFINITY;
  }
  __device__ float kterm(const Key& k, const QCol& c, int, int, const float*) const {
    return near(c.cy - k.ky) & near(c.cx - k.kx) ? 0.f : -INFINITY;
  }
  // whether a query of [q_lo, q_hi) sees a key of [k_lo, k_hi): its window
  // is one key segment per grid row, 4 queries a lane at 128 rows
  __device__ bool any_live(int q_lo, int q_hi, int k_lo, int k_hi) const {
    bool any = false;
    for (int q = q_lo + (threadIdx.x & 31); q < q_hi && !any; q += 32) {
      const Row r = row(q);
      const int x0 = max(r.cx - half, 0), x1 = min(r.cx + half, gw - 1);
      for (int y = max(r.cy - half, 0); y <= min(r.cy + half, gh - 1); ++y)
        any |= y * gw + x0 < k_hi && y * gw + x1 >= k_lo;
    }
    return __any_sync(0xffffffffu, any);
  }
};

}  // namespace dad_attn
