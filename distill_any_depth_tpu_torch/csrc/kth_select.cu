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
// count passes. A 392^2 row is 615 KB, more than one SM's 227 KB of shared
// memory, so the row cannot stay on chip. This kernel is an exact radix
// select instead: four passes over the row, each a 256-bin shared-memory
// histogram of one byte (most significant first) over the elements that
// match the bytes chosen so far, then a warp scan that picks the bin holding
// the k-th element. The k-th smallest uint32 is unique, so this is the value
// the bisection finds. The last pass also keeps, per bin, the least index
// of an element in it (shared atomicMin): the selected bin's least index is
// the first occurrence of the value, as the TPU's min over matching
// positions (and argmax(u == value)).
//
// Bound at the HDN loss's shape (R = 7 contexts x 16 images = 112,
// N = 392^2 = 153,664): one read of u, 68.8 MB, 20.5 us at 3.35 TB/s
// (bytes). This kernel reads it four times, and its 112 blocks (one per
// row) leave 20 of the 132 SMs idle; splitting a row over a cluster is later
// work. Heavy ties (masked entries, ReLU zeros) would serialise the shared
// atomics, so each warp first groups its lanes by bin (__match_any_sync)
// and one lane per group adds the group's count.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBatch = 8;  // loads in flight per thread

__global__ void __launch_bounds__(kThreads)
    kth_select_kernel(const uint32_t* __restrict__ u, const int* __restrict__ k,
                      int* __restrict__ out, int n) {
  __shared__ unsigned int hist[256];
  __shared__ int first[256];
  __shared__ int s_bin;
  __shared__ unsigned int s_rank;

  const uint32_t* row = u + (long)blockIdx.x * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int kk = k[blockIdx.x];
  unsigned int rank = (unsigned int)(kk < 0 ? 0 : (kk >= n ? n - 1 : kk));
  uint32_t prefix = 0, pmask = 0;

  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int i = threadIdx.x; i < 256; i += kThreads) {
      hist[i] = 0;
      first[i] = INT_MAX;
    }
    __syncthreads();
    // the trip count is the same for every thread, so whole warps reach the
    // __match_any_sync together
    for (int base = 0; base < n; base += kThreads * kBatch) {
      uint32_t v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads + threadIdx.x;
        v[j] = i < n ? row[i] : 0u;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = base + j * kThreads + threadIdx.x;
        const int bin = (i < n && (v[j] & pmask) == prefix) ? (int)((v[j] >> shift) & 0xFFu)
                                                             : 256;
        const unsigned int peers = __match_any_sync(0xffffffffu, bin);
        // lanes hold ascending indices, so the group's lowest lane has its least index
        if (bin < 256 && lane == __ffs(peers) - 1) {
          atomicAdd(&hist[bin], (unsigned int)__popc(peers));
          if (pass == 3) atomicMin(&first[bin], i);
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l scans bins [8l, 8l + 8); find the bin holding element `rank`
      unsigned int cnt[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = hist[lane * 8 + j];
        sum += cnt[j];
      }
      unsigned int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        unsigned int x = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += x;
      }
      unsigned int cum = incl - sum;
      if (rank >= cum && rank < incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (rank >= cum && rank < cum + cnt[j]) {
            s_bin = lane * 8 + j;
            s_rank = rank - cum;
          }
          cum += cnt[j];
        }
      }
    }
    __syncthreads();
    const int bin = s_bin;
    rank = s_rank;
    prefix |= (uint32_t)bin << shift;
    pmask |= 0xFFu << shift;
    if (pass == 3 && threadIdx.x == 0) out[blockIdx.x] = first[bin];
    __syncthreads();  // every thread has read s_bin, s_rank and first[] before the reset
  }
}

}  // namespace

// Returns a cudaError_t (0 = success); -1 for an argument the kernel does
// not take.
extern "C" int dad_kth_select(const void* u, const void* k, void* out, int rows, int n,
                              void* stream) {
  if (rows <= 0 || n <= 0) return -1;
  kth_select_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(u), static_cast<const int*>(k), static_cast<int*>(out), n);
  return (int)cudaGetLastError();
}
