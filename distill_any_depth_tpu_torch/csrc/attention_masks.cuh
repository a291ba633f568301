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
#pragma once

#include "attention_tiles.cuh"

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
};

}  // namespace dad_attn
