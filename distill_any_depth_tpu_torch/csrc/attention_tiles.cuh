// Tile helpers of the fp32 attention kernels of csrc/ (packed, biased and
// banded; forward and backward) and the backwards' delta pass, for sm_90a.
// The bf16 kernels run on wgmma (hopper_tiles.cuh).
//
// Tiles are 64 rows of one head's 64 columns, staged in shared memory with a
// 16-byte row pad (cp.async). A block has 4 warps; warp w owns rows [16w,
// 16w + 16) of the tile its products write. Accumulators use the mma.sync
// m16n8k16 layout: acc[j][e] holds row g (+8 for e >= 2) and column 8j + 2t +
// (e & 1), with g = lane / 4 and t = lane % 4.
//
// Two products, as scalar FMAs, cover every attention matmul:
//   nt: acc[16 x 64] += A[16 x 64] . B[64 x 64]^T  (A: this warp's 16 rows)
//   nn: acc[16 x 64] += P[16 x 64] . B[64 x 64]    (P: an accumulator)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dad_attn {

constexpr int kD = 64;       // head dim (every model of the zoo)
constexpr int kTile = 64;    // rows of a q or key tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kProw = kTile + 4;  // fp32 staging row of a P operand (fp32 path only)

template <typename T>
__host__ __device__ constexpr int row_elems() { return kD + 16 / (int)sizeof(T); }  // 16-byte pad

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// Copy rows [r0, r0+64) of one head's 64 columns (starting at column col of
// rows `stride` elements apart) into a padded smem tile; rows at or past n
// are zero-filled. Commits one cp.async group.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* base, int r0, int n, long stride,
                                          int col) {
  constexpr int kChunks = kD * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int kRow = row_elems<T>();
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    int r = i / kChunks, c = i % kChunks;
    int gr = r0 + r;
    bool ok = gr < n;
    const T* src = base + (long)(ok ? gr : 0) * stride + col + c * (16 / (int)sizeof(T));
    cp_async16(dst + r * kRow + c * (16 / (int)sizeof(T)), src, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// nt, fp32: acc += A . B^T, A = this warp's 16 rows of an smem tile.
__device__ __forceinline__ void fma_nt(float (&acc)[8][4], const float* a_tile, const float* b) {
  constexpr int kRow = row_elems<float>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* a_lo = a_tile + (warp * 16 + g) * kRow;
  const float* a_hi = a_lo + 8 * kRow;
  for (int d = 0; d < kD; ++d) {
    float a0 = a_lo[d], a1 = a_hi[d];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float b0 = b[(8 * j + 2 * t) * kRow + d];
      float b1 = b[(8 * j + 2 * t + 1) * kRow + d];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
}

// nn, fp32: acc += P . B, P an accumulator staged through this warp's
// 16 x kProw slice `pw` of shared memory.
__device__ __forceinline__ void fma_nn(float (&acc)[8][4], const float (&p)[8][4], float* pw,
                                       const float* b) {
  constexpr int kRow = row_elems<float>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pw[g * kProw + 8 * j + 2 * t] = p[j][0];
    pw[g * kProw + 8 * j + 2 * t + 1] = p[j][1];
    pw[(g + 8) * kProw + 8 * j + 2 * t] = p[j][2];
    pw[(g + 8) * kProw + 8 * j + 2 * t + 1] = p[j][3];
  }
  __syncwarp();
  for (int k = 0; k < kTile; ++k) {
    float a0 = pw[g * kProw + k], a1 = pw[(g + 8) * kProw + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float b0 = b[k * kRow + 8 * j + 2 * t];
      float b1 = b[k * kRow + 8 * j + 2 * t + 1];
      acc[j][0] = fmaf(a0, b0, acc[j][0]);
      acc[j][1] = fmaf(a0, b1, acc[j][1]);
      acc[j][2] = fmaf(a1, b0, acc[j][2]);
      acc[j][3] = fmaf(a1, b1, acc[j][3]);
    }
  }
  __syncwarp();
}

// delta[b, h, i] = sum_d g . out over the row's 64 columns, fp32, from out
// and g [B, N, H*64] contiguous: 8 threads per (token, head) row.
template <typename T>
__global__ void __launch_bounds__(256)
    delta_kernel(const T* __restrict__ out, const T* __restrict__ g, float* __restrict__ delta,
                 int n, int heads, long rows) {
  const long r = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 3;
  const int sub = threadIdx.x & 7;
  float acc = 0.f;
  if (r < rows) {
    const long token = r / heads;
    const int h = (int)(r % heads);
    const long off = token * heads * kD + h * kD + sub * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float o, d;
      if constexpr (sizeof(T) == 2) {
        o = __bfloat162float(out[off + e]);
        d = __bfloat162float(g[off + e]);
      } else {
        o = out[off + e];
        d = g[off + e];
      }
      acc = fmaf(o, d, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (r < rows && sub == 0) {
    const long token = r / heads;
    const int h = (int)(r % heads);
    const long b = token / n, i = token % n;
    delta[(b * heads + h) * n + i] = acc;
  }
}

template <typename T>
cudaError_t launch_delta(const T* out, const T* g, float* delta, int batch, int n, int heads,
                         cudaStream_t stream) {
  const long rows = (long)batch * n * heads;
  delta_kernel<T><<<(unsigned)((rows * 8 + 255) / 256), 256, 0, stream>>>(out, g, delta, n,
                                                                          heads, rows);
  return cudaGetLastError();
}

// Store rows g and g+8 of this warp's 16 rows of an accumulator, times
// `scale`, into columns [col, col+64) of rows `stride` elements apart;
// rows at or past n are skipped.
template <typename T>
__device__ __forceinline__ void store_rows(T* base, const float (&acc)[8][4], int r0, int n,
                                           long stride, int col, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = r0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    T* dst = base + (long)row * stride + col;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v0 = acc[j][2 * r] * scale, v1 = acc[j][2 * r + 1] * scale;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t) = __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) = make_float2(v0, v1);
      }
    }
  }
}

}  // namespace dad_attn
