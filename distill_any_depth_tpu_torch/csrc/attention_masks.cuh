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
// The bf16 forward and backward on wgmma (masked_attention.cuh,
// masked_attention_bwd.cuh) read the terms from registers or from a stage
// their producer loads by TMA, and never load a dead tile:
//   kTmaTerms, kStageFloats       whether the terms arrive by TMA, and the
//                                 floats of one stage of them;
//   bool any_live(q_lo, q_hi, k_lo, k_hi)  called by a whole warp, the same
//                                 answer on every lane: whether rows
//                                 [q_lo, q_hi) and keys [k_lo, k_hi) (both
//                                 within N) hold a live pair;
//   add_terms(s[32], scale, Row[2], k0, rl, terms)   forward: s = s * scale
//                                 + term for a thread's accumulator, rows rl
//                                 and rl + 8 of the block, columns k0 + 8j +
//                                 2 (lane % 4) + e of the stage's keys;
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

// Rows (and columns) of the terms that the bf16 kernels read by TMA: N
// rounded up to the 128 rows of their blocks, so that no box leaves the
// array.
__host__ __device__ constexpr int term_rows(int n) { return (n + 127) / 128 * 128; }

// One block per 64 x 64 tile of the [tn, tn] terms, tn = term_rows(N). If
// asked, terms = the bias (0 without one) at rows and keys < N and -inf past
// N, fp32: what the bf16 kernels read by TMA (an odd N's bias rows are no
// TMA stride). If asked, live[q tile * nk + key tile] = whether the tile
// holds a finite entry, for the nk x nk tiles within N.
template <typename TB>
__global__ void __launch_bounds__(256)
    bias_prep_kernel(const TB* __restrict__ bias, int n, int nk, int tn,
                     unsigned char* __restrict__ live, float* __restrict__ terms) {
  const int k0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile;
  bool any = false;
  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x) {
    const int row = q0 + i / kTile, key = k0 + i % kTile;
    float x = -INFINITY;
    if (row < n && key < n) x = bias == nullptr ? 0.f : to_float(bias[(long)row * n + key]);
    if (terms != nullptr) terms[(long)row * tn + key] = x;
    any |= x != -INFINITY;
  }
  any = __syncthreads_or(any);
  if (live != nullptr && threadIdx.x == 0 && blockIdx.x < nk && blockIdx.y < nk)
    live[blockIdx.y * nk + blockIdx.x] = any;
}

// The tile marks (live, or null) and the fp32 terms (terms, or null) of the
// bias, in one launch.
template <typename TB>
cudaError_t bias_prep(const TB* bias, int n, unsigned char* live, float* terms, cudaStream_t st) {
  const int nk = (n + kTile - 1) / kTile, tn = term_rows(n);
  const int tiles = terms != nullptr ? tn / kTile : nk;
  bias_prep_kernel<TB><<<dim3(tiles, tiles), 256, 0, st>>>(bias, n, nk, tn, live, terms);
  return cudaGetLastError();
}

// An additive [N, N] bias (or none: every key < N is live). The fp32
// kernels stage it per tile as fp32 in shared memory with coalesced loads: consecutive threads read
// consecutive keys of a row (the rows of an odd N are not 4-byte aligned, so
// the loads are scalar). Row stride kBs = 68 floats keeps the accumulator-
// order reads to 2-way bank conflicts, and the transposed reads of the
// dK/dV pass (rows = keys) conflict-free. `live` holds bias_prep_kernel's
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

  // ---- the wgmma kernels: the terms arrive by TMA from bias_prep_kernel's
  // copy, as 128-byte-swizzled fp32 boxes of 64 rows x 32 columns: the
  // forward's and the dQ pass's stage holds rows [q0, q0+128) x keys [k0,
  // k0+64) (boxes 2 * (r / 64) + c / 32), the dK/dV pass's rows [q0, q0+64)
  // x keys [k0, k0+128) (boxes c / 32).
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
  // two neighbouring keys' terms in one 8-byte load: keys 2c, 2c + 1 share
  // a 16-byte chunk of the swizzled box
  __device__ void add_terms(float (&s)[32], float scale, const Row (&)[2], int, int rl,
                            const float* t) const {
    const int cq = threadIdx.x & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;
      const float* box = t + (row >> 6) * 2 * 2048 + (row & 63) * 32;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // keys 8j + 2cq, + 1: box j / 4, chunk 2 (j % 4) + cq / 2
        const int chunk = (2 * (j & 3) + (cq >> 1)) ^ (row & 7);
        const float2 x = *reinterpret_cast<const float2*>(box + (j >> 2) * 2048 + chunk * 4 +
                                                          2 * (cq & 1));
        s[4 * j + 2 * r] = fmaf(s[4 * j + 2 * r], scale, x.x);
        s[4 * j + 2 * r + 1] = fmaf(s[4 * j + 2 * r + 1], scale, x.y);
      }
    }
  }
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
// axis (ops/window.py's corner completion). The fp32 kernels stage per tile
// its 64 keys' grid coordinates (forward, dQ) or its 64 queries' clamped
// centres (dK/dV), one division each, so that the per-score test is two
// compares; the bf16 kernels step the coordinates in registers. A key or
// query past N gets a coordinate no window reaches.
struct WindowMask {
  static constexpr size_t kScratch = (size_t)kTile * sizeof(int2);
  static constexpr int kFar = 1 << 20;
  int n, gh, gw, half;
  // a query's window: the keys of grid rows [ylo, ylo + yspan] and columns
  // [xlo, xlo + 2 half] (see); ylo = kFar for a query past N, which sees none
  struct Row {
    int ylo, yspan, xlo;
  };
  struct Key {
    int ky, kx;
  };
  __device__ static int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
  // a query's clamped window centre (y, x)
  __device__ int2 centre(int r) const {
    int y = r / gw, x = r - y * gw;
    return make_int2(clampi(y, half, max(gh - 1 - half, half)),
                     clampi(x, half, max(gw - 1 - half, half)));
  }
  __device__ Row row(int r) const {
    if (r >= n) return {kFar, 0, kFar};
    const int2 c = centre(r);
    return {c.x - half, min(c.x + half, gh - 1) - (c.x - half), c.y - half};
  }
  // whether the row sees the key at grid cell (ky, kx): two unsigned range
  // tests, no branch; a key past N (ky >= gh, or -kFar) is outside every
  // row's span
  __device__ bool sees(const Row& r, int ky, int kx) const {
    return ((unsigned)(ky - r.ylo) <= (unsigned)r.yspan) &
           ((unsigned)(kx - r.xlo) <= (unsigned)(2 * half));
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
      const int q = q0 + threadIdx.x;
      reinterpret_cast<int2*>(sm)[threadIdx.x] = q < n ? centre(q) : make_int2(kFar, kFar);
    }
  }
  __device__ float at(const unsigned char* sm, const Row& r, int, int kl) const {
    int2 k = reinterpret_cast<const int2*>(sm)[kl];
    return sees(r, k.x, k.y) ? 0.f : -INFINITY;
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

  // ---- the wgmma kernels: terms 0 or -inf computed in registers from the
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
  // the forward: the walk's grid cells need no test of their own for a key
  // past N, whose row is at least gh
  __device__ void add_terms(float (&s)[32], float scale, const Row (&rows)[2], int k0, int,
                            const float*) const {
    walk16(k0 + 2 * (threadIdx.x & 3), [&](int i, int, int y, int x) {
      const int j = i >> 1, e = i & 1;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        s[4 * j + 2 * r + e] =
            fmaf(s[4 * j + 2 * r + e], scale, sees(rows[r], y, x) ? 0.f : -INFINITY);
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
    return sees(r, k.ky, k.kx) ? 0.f : -INFINITY;
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
      const int x1 = min(r.xlo + 2 * half, gw - 1);
      for (int y = r.ylo; y <= r.ylo + r.yspan; ++y)
        any |= y * gw + r.xlo < k_hi && y * gw + x1 >= k_lo;
    }
    return __any_sync(0xffffffffu, any);
  }
};

}  // namespace dad_attn
