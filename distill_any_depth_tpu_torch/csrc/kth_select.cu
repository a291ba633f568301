// Row-wise order-statistic select for Hopper (sm_90a).
//
// Replaces the TPU kernel distill_any_depth_tpu/ops/stats.py
// ::_kth_valid_index_fused (body _select_kernel):
//
//   u [R, N] uint32 order bits (masked entries already 0xFFFFFFFF), k [R]
//   int32  ->  idx [R] int32, the FIRST index at which u equals its k-th
//   smallest value (k counted from 0, clamped to [0, N-1]).
//
// The TPU kernel holds a row in VMEM and bisects the value range in 32
// count passes. This kernel is an exact radix select over three digits
// (bits 31-21, 20-10, 9-0): per digit, a histogram of the elements that
// match the digits chosen so far, then a scan that picks the bin holding
// the k-th element. The k-th smallest uint32 is unique, so this is the value
// the bisection finds. Its first index is the least index among the
// elements equal to it: a min, so no order of atomics reaches the result.
//
// Bound: one read of u. At the HDN loss's shapes (R = 7 contexts x 16
// images = 112 rows) that is 68.8 MB at 392^2 (N = 153,664; 20.5 us at
// 3.35 TB/s) and 481 MB at 1036^2 (N = 1,073,296; 144 us).
//
// Design: a row is spread over a cluster of kCluster blocks (grid = R x
// kCluster), each owning a contiguous slice, so that 112 rows fill every
// SM; the blocks meet through distributed shared memory and cluster
// barriers.
//   1. The first digit: one sweep of the slice from device memory in
//      16-byte loads, a shared-memory histogram, and the slice's first
//      `cache` elements kept in shared memory (a 392^2 row's slice, 77 KB,
//      stays whole, two 512-thread blocks to an SM; a 1036^2 slice keeps
//      183 KB of its 537 KB, one 1024-thread block to an SM). Block r adds
//      up bins [r * 256, r * 256 + 256) over the cluster; every block then
//      finds the share, and the bin in it, that holds the rank.
//   2. One sweep of the slice (the cache, then device memory for the rest)
//      over the chosen bin's elements: their least and greatest value, their
//      least index, and the elements with their indices in a candidate
//      buffer where they fit.
//   3. Where the bin holds one value (ties: ReLU zeros, masked entries,
//      rounded values), that value is the k-th and the bin's least index is
//      the answer. Otherwise, where every block's candidates fit, block 0
//      gathers them and finishes alone, in its shared memory: by counting,
//      for each candidate, the candidates below and not above it where there
//      are at most a block's threads of them, else by the last two digits
//      and the least index. Where they do not (many distinct values
//      in one first-digit bin), the cluster runs the last two digits and
//      the least index as step 1 and further sweeps of the slice (the cache,
//      then device memory). This is part of the algorithm and exact.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // blocks per row: the portable cluster size
constexpr int kBatch = 4;    // 16-byte loads in flight per thread
constexpr int kBins = 2048;  // the widest digit (11 bits)
constexpr int kDigits = 3;
__host__ __device__ constexpr int shift_of(int d) { return d == 0 ? 21 : (d == 1 ? 10 : 0); }
__host__ __device__ constexpr int width_of(int d) { return d == 2 ? 10 : 11; }

struct Shared {
  unsigned int hist[kBins];            // this block's counts of the current digit
  unsigned int tot[kBins / kCluster];  // the cluster's counts of this block's share of bins
  unsigned int warp_sum[32];
  unsigned int share_sum;              // the sum of tot
  int bin;
  unsigned int rank;
  // step 2, this block's: the bin's elements' least and greatest value and
  // least index, the candidates kept, and whether all of them fit
  unsigned int vmin, vmax, cand_count;
  int first, compact;
  // step 2 over the cluster
  unsigned int all_min, all_max, all_cand;
  int all_first, all_compact;
  int found;  // the least index holding the selected value (cluster path)
};

// A slice of a row: `a0` leading elements before the first 16-byte aligned
// one, `nvec` aligned 4-element vectors, `ntail` trailing elements; the
// first `cvec` vectors also sit in shared memory.
struct Slice {
  const uint32_t* g;  // the slice in device memory
  const uint4* cache;
  int a0, nvec, cvec, ntail;
};

// f(i, v, valid) for every element of the slice (i is slice-relative),
// 16-byte vectors first (from shared memory where cached), then the few
// unaligned ones. Every thread makes the same number of calls, so whole
// warps reach a warp collective inside f together; padding calls have
// valid false. With kFill, the vectors are read from device memory and the
// first cvec stored to the cache.
template <int kThreads, bool kFill, typename F>
__device__ __forceinline__ void sweep(const Slice& sl, uint4* cache_w, F f) {
  const uint4* gv = reinterpret_cast<const uint4*>(sl.g + sl.a0);
  for (int base = 0; base < sl.nvec; base += kThreads * kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int vi = base + j * kThreads + threadIdx.x;
      if (!kFill && vi < sl.cvec) v[j] = sl.cache[vi];
      else v[j] = vi < sl.nvec ? __ldg(gv + vi) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int vi = base + j * kThreads + threadIdx.x;
      if (kFill && vi < sl.cvec) cache_w[vi] = v[j];
      const bool ok = vi < sl.nvec;
      const int i = sl.a0 + 4 * vi;
      f(i, v[j].x, ok);
      f(i + 1, v[j].y, ok);
      f(i + 2, v[j].z, ok);
      f(i + 3, v[j].w, ok);
    }
  }
  const int t = threadIdx.x;
  const int i = t < sl.a0 ? t : (t < sl.a0 + sl.ntail ? sl.a0 + 4 * sl.nvec + (t - sl.a0) : -1);
  f(i, i >= 0 ? sl.g[i] : 0u, i >= 0);
}

// Sum the cluster's histograms of digit d and find the bin holding element
// `rank`: sets s.bin and s.rank in every block. Block r first adds up its
// share of the bins over the cluster; then every block finds the share
// that holds the rank from the shares' sums and scans that share's counts.
template <int kThreads>
__device__ void pick_bin(Shared& s, cg::cluster_group& cluster, int me, int d,
                         unsigned int rank) {
  const int per = (1 << width_of(d)) / kCluster;  // bins a share: 256 or 128
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // ---- this block's share, over the cluster
  unsigned int c = 0;
  if (threadIdx.x < per) {
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      c += cluster.map_shared_rank(s.hist, r)[me * per + threadIdx.x];
    s.tot[threadIdx.x] = c;
  }
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) s.warp_sum[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += s.warp_sum[w];
    s.share_sum = sum;
  }
  cluster.sync();
  // ---- the share that holds the rank, then the bin inside it
  if (warp == 0) {
    const unsigned int sum = lane < kCluster ? *cluster.map_shared_rank(&s.share_sum, lane) : 0u;
    unsigned int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned int x = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += x;
    }
    const unsigned int hit = __ballot_sync(0xffffffffu, rank >= incl - sum && rank < incl);
    const int owner = __ffs(hit) - 1;
    const unsigned int before = __shfl_sync(0xffffffffu, incl - sum, owner);
    // lane l scans the owner's bins [l * each, (l + 1) * each)
    const unsigned int* tot = cluster.map_shared_rank(s.tot, owner);
    const int each = per / 32;
    unsigned int cnt[8], mine = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cnt[j] = j < each ? tot[lane * each + j] : 0u;
      mine += cnt[j];
    }
    unsigned int in2 = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned int x = __shfl_up_sync(0xffffffffu, in2, off);
      if (lane >= off) in2 += x;
    }
    unsigned int cum = before + in2 - mine;
    if (rank >= cum && rank < cum + mine) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < each && rank >= cum && rank < cum + cnt[j]) {
          s.bin = owner * per + lane * each + j;
          s.rank = rank - cum;
        }
        cum += cnt[j];
      }
    }
  }
  // s.bin and s.rank for the block; the next writes of the shares' sums and
  // counts (a later digit's) come after at least one more cluster barrier
  __syncthreads();
}

// Block-local: the bin of s.hist (digit d) holding element `rank`; sets
// s.bin and s.rank.
template <int kThreads>
__device__ void pick_bin_local(Shared& s, int d, unsigned int rank) {
  constexpr int kMax = kBins / kThreads;           // bins a thread, at most
  const int per = (1 << width_of(d)) / kThreads;  // bins a thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned int cnt[kMax], mine = 0;
#pragma unroll
  for (int j = 0; j < kMax; ++j) {
    cnt[j] = j < per ? s.hist[threadIdx.x * per + j] : 0u;
    mine += cnt[j];
  }
  unsigned int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned int x = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) s.warp_sum[warp] = incl;
  __syncthreads();
  unsigned int cum = incl - mine;
  for (int w = 0; w < warp; ++w) cum += s.warp_sum[w];
  if (rank >= cum && rank < cum + mine) {
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      if (j < per && rank >= cum && rank < cum + cnt[j]) {
        s.bin = threadIdx.x * per + j;
        s.rank = rank - cum;
      }
      cum += cnt[j];
    }
  }
  __syncthreads();
}

template <int kThreads, int kMinBlocks>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, kMinBlocks)
    kth_select_kernel(const uint32_t* __restrict__ u, const int* __restrict__ k,
                      int* __restrict__ out, int n, int slice, int cache_vecs, int cand_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& s = *reinterpret_cast<Shared*>(smem);
  uint4* cache = reinterpret_cast<uint4*>(smem + (sizeof(Shared) + 15) / 16 * 16);
  uint32_t* cand_v = reinterpret_cast<uint32_t*>(cache + cache_vecs);
  int* cand_i = reinterpret_cast<int*>(cand_v + cand_cap);

  cg::cluster_group cluster = cg::this_cluster();
  const int me = (int)cluster.block_rank();
  const long row = blockIdx.x / kCluster;
  const int lo = min(n, me * slice), len = min(n, lo + slice) - lo;
  Slice sl;
  sl.g = u + row * n + lo;
  sl.cache = cache;
  // slices start at multiples of 4, so the row's own offset sets the alignment
  sl.a0 = min(len, (int)((4 - (row * n) % 4) % 4));
  sl.nvec = (len - sl.a0) / 4;
  sl.ntail = len - sl.a0 - 4 * sl.nvec;
  sl.cvec = min(sl.nvec, cache_vecs);
  const int lane = threadIdx.x & 31;

  const int kk = k[row];
  unsigned int rank = (unsigned int)(kk < 0 ? 0 : (kk >= n ? n - 1 : kk));
  for (int i = threadIdx.x; i < kBins; i += kThreads) s.hist[i] = 0u;
  if (threadIdx.x == 0) {
    s.cand_count = 0;
    s.vmin = 0xFFFFFFFFu;
    s.vmax = 0u;
    s.first = INT_MAX;
    s.found = INT_MAX;
  }
  __syncthreads();

  // ---- 1. the first digit: one sweep of device memory, filling the cache
  sweep<kThreads, true>(sl, cache, [&](int, uint32_t v, bool ok) {
    if (ok) atomicAdd(&s.hist[v >> shift_of(0)], 1u);
  });
  cluster.sync();
  pick_bin<kThreads>(s, cluster, me, 0, rank);
  uint32_t prefix = (uint32_t)s.bin << shift_of(0);
  uint32_t pmask = ((1u << width_of(0)) - 1) << shift_of(0);
  rank = s.rank;

  // ---- 2. the chosen bin's elements
  const bool compact = s.hist[s.bin] <= (unsigned int)cand_cap;
  uint32_t vmin = 0xFFFFFFFFu, vmax = 0u;
  int first = INT_MAX;
  sweep<kThreads, false>(sl, nullptr, [&](int i, uint32_t v, bool ok) {
    const bool hit = ok && (v & pmask) == prefix;
    if (hit) {
      vmin = min(vmin, v);
      vmax = max(vmax, v);
      first = min(first, lo + i);
    }
    if (compact) {
      const unsigned int ballot = __ballot_sync(0xffffffffu, hit);
      unsigned int at = 0;
      if (lane == 0 && ballot) at = atomicAdd(&s.cand_count, (unsigned int)__popc(ballot));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (hit) {
        const int slot = (int)at + __popc(ballot & ((1u << lane) - 1));
        cand_v[slot] = v;
        cand_i[slot] = lo + i;
      }
    }
  });
  vmin = __reduce_min_sync(0xffffffffu, vmin);
  vmax = __reduce_max_sync(0xffffffffu, vmax);
  first = __reduce_min_sync(0xffffffffu, first);
  if (lane == 0) {
    atomicMin(&s.vmin, vmin);
    atomicMax(&s.vmax, vmax);
    atomicMin(&s.first, first);
  }
  if (threadIdx.x == 0) s.compact = compact;
  cluster.sync();
  if (threadIdx.x < 32) {
    const bool in = lane < kCluster;
    const Shared* o = cluster.map_shared_rank(&s, in ? lane : 0);
    const unsigned int a = __reduce_min_sync(0xffffffffu, in ? o->vmin : 0xFFFFFFFFu);
    const unsigned int b = __reduce_max_sync(0xffffffffu, in ? o->vmax : 0u);
    const int f = __reduce_min_sync(0xffffffffu, in ? o->first : INT_MAX);
    const unsigned int nc = __reduce_add_sync(0xffffffffu, in ? o->cand_count : 0u);
    const unsigned int all = __reduce_min_sync(0xffffffffu, in ? (unsigned int)o->compact : 1u);
    if (lane == 0) {
      s.all_min = a;
      s.all_max = b;
      s.all_first = f;
      s.all_cand = nc;
      s.all_compact = (int)all;
    }
  }
  __syncthreads();

  // ---- 3. the last two digits and the least index
  if (s.all_min == s.all_max) {
    // one value fills the bin: it is the k-th, and the bin's least index its first
    if (me == 0 && threadIdx.x == 0) out[row] = s.all_first;
  } else if (s.all_compact && s.all_cand <= (unsigned int)cand_cap) {
    // block 0 gathers every block's candidates after its own and finishes alone
    if (me == 0) {
      int at = (int)s.cand_count;
      for (int r = 1; r < kCluster; ++r) {
        const int nr = (int)cluster.map_shared_rank(&s, r)->cand_count;
        const uint32_t* rv = cluster.map_shared_rank(cand_v, r);
        const int* ri = cluster.map_shared_rank(cand_i, r);
        for (int i = threadIdx.x; i < nr; i += kThreads) {
          cand_v[at + i] = rv[i];
          cand_i[at + i] = ri[i];
        }
        at += nr;
      }
      const int ncand = at;
      __syncthreads();
      if (ncand <= kThreads) {
        // few candidates: candidate i holds the value if fewer than `rank` + 1
        // candidates are smaller and more than `rank` are smaller or equal
        if (threadIdx.x < ncand) {
          const uint32_t v = cand_v[threadIdx.x];
          unsigned int less = 0, leq = 0;
          for (int j = 0; j < ncand; ++j) {
            const uint32_t o = cand_v[j];
            less += o < v;
            leq += o <= v;
          }
          if (less <= rank && rank < leq) atomicMin(&s.found, cand_i[threadIdx.x]);
        }
      } else {
        for (int d = 1; d < kDigits; ++d) {
          for (int i = threadIdx.x; i < kBins; i += kThreads) s.hist[i] = 0u;
          __syncthreads();
          const uint32_t dmask = (1u << width_of(d)) - 1;
          const int shift = shift_of(d);
          for (int i = threadIdx.x; i < ncand; i += kThreads) {
            const uint32_t v = cand_v[i];
            if ((v & pmask) == prefix) atomicAdd(&s.hist[(v >> shift) & dmask], 1u);
          }
          __syncthreads();
          pick_bin_local<kThreads>(s, d, rank);
          prefix |= (uint32_t)s.bin << shift;
          pmask |= dmask << shift;
          rank = s.rank;
        }
        int mine = INT_MAX;
        for (int i = threadIdx.x; i < ncand; i += kThreads)
          if (cand_v[i] == prefix) mine = min(mine, cand_i[i]);
        mine = __reduce_min_sync(0xffffffffu, mine);
        if (lane == 0) atomicMin(&s.found, mine);
      }
      __syncthreads();
      if (threadIdx.x == 0) out[row] = s.found;
    }
  } else {
    // the cluster runs the last two digits, over the candidates where a
    // block's fit and by sweeps of its slice where they do not
    const int ncand = (int)s.cand_count;
    for (int d = 1; d < kDigits; ++d) {
      for (int i = threadIdx.x; i < kBins; i += kThreads) s.hist[i] = 0u;
      __syncthreads();
      const uint32_t dmask = (1u << width_of(d)) - 1;
      const int shift = shift_of(d);
      if (compact) {
        for (int i = threadIdx.x; i < ncand; i += kThreads) {
          const uint32_t v = cand_v[i];
          if ((v & pmask) == prefix) atomicAdd(&s.hist[(v >> shift) & dmask], 1u);
        }
      } else {
        sweep<kThreads, false>(sl, nullptr, [&](int, uint32_t v, bool ok) {
          if (ok && (v & pmask) == prefix) atomicAdd(&s.hist[(v >> shift) & dmask], 1u);
        });
      }
      cluster.sync();
      pick_bin<kThreads>(s, cluster, me, d, rank);
      prefix |= (uint32_t)s.bin << shift;
      pmask |= dmask << shift;
      rank = s.rank;
    }
    int mine = INT_MAX;
    if (compact) {
      for (int i = threadIdx.x; i < ncand; i += kThreads)
        if (cand_v[i] == prefix) mine = min(mine, cand_i[i]);
    } else {
      sweep<kThreads, false>(sl, nullptr, [&](int i, uint32_t v, bool ok) {
        if (ok && v == prefix) mine = min(mine, lo + i);
      });
    }
    mine = __reduce_min_sync(0xffffffffu, mine);
    if (lane == 0 && mine != INT_MAX) atomicMin(&s.found, mine);
    cluster.sync();
    if (me == 0 && threadIdx.x == 0) {
      int best = INT_MAX;
      for (int r = 0; r < kCluster; ++r) best = min(best, *cluster.map_shared_rank(&s.found, r));
      out[row] = best;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Shared memory a block may take (the H100's 227 KB less a margin).
constexpr int kSmemCap = 220 * 1024;

template <int kThreads, int kMinBlocks>
int launch(const void* u, const void* k, void* out, int rows, int n, int slice, int vecs,
           int cand_cap, cudaStream_t stream) {
  const int smem = ((int)sizeof(Shared) + 15) / 16 * 16 + cand_cap * 8 + vecs * 16;
  auto kernel = kth_select_kernel<kThreads, kMinBlocks>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<rows * kCluster, kThreads, smem, stream>>>(static_cast<const uint32_t*>(u),
                                                      static_cast<const int*>(k),
                                                      static_cast<int*>(out), n, slice, vecs,
                                                      cand_cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = success); -1 for an argument the kernel does
// not take. A block whose slice fits in 112 KB of shared memory with the
// rest (two of them fit an SM's 228 KB) runs 512 threads, two blocks an SM;
// a longer slice one block of 1024 threads with as large a cache as fits.
extern "C" int dad_kth_select(const void* u, const void* k, void* out, int rows, int n,
                              void* stream) {
  if (rows <= 0 || n <= 0 || (long)rows * kCluster > INT_MAX) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slice = ((n + kCluster - 1) / kCluster + 3) / 4 * 4;
  int vecs = slice / 4;
  const int fixed = ((int)sizeof(Shared) + 15) / 16 * 16;
  if (fixed + 2048 * 8 + vecs * 16 <= 112 * 1024)
    return launch<512, 2>(u, k, out, rows, n, slice, vecs, 2048, st);
  vecs = min(vecs, (kSmemCap - fixed - 4096 * 8) / 16);
  return launch<1024, 1>(u, k, out, rows, n, slice, vecs, 4096, st);
}
