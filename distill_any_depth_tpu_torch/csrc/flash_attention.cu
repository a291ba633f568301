// Packed-QKV softmax attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel distill_any_depth_tpu/ops/flash_attention.py
// ::_packed_fwd_impl (body _packed_kernel): bias-free attention read straight
// from the fused-QKV GEMM output.
//
//   qkv [B, N, 3*H*D] (column order q|k|v, head, dim)  ->  out [B, N, H*D]
//
// Numerics follow _packed_kernel: fp32 scores (q.k)*D^-1/2 and row max,
// exp(s - m) rounded to the input type before the PV product, an fp32 sum of
// the rounded values, fp32 PV accumulation, division by the sum after PV.
// Keys at or past N are masked with a true -inf in both the max and the sum
// (no closed-form pad correction, which cancels when every real logit of a
// row is strongly negative).
//
// Bound at the ViT-B 392^2 bs8 shape (B=8, N=785, H=12, D=64, bf16):
// 4*B*H*N^2*D = 15.1 GFLOP (15.3 us at 989 TFLOP/s) against 38.6 MB moved
// (11.5 us at 3.35 TB/s): compute-bound on the tensor cores.
//
// Design: one block of 4 warps per (q tile of 64 rows, head, batch); each
// warp owns 16 q rows. K/V tiles of 64 keys stream through shared memory
// (cp.async, zero-filled past N) with an online softmax, since K+V of one
// head (~200 KB in bf16) do not fit beside the q tile. bf16 runs the two
// products on the tensor cores with mma.sync m16n8k16 (fp32 accumulate);
// fp32 runs the same tiles, masks and softmax with scalar FMAs over the same
// accumulator ownership, so both types share everything but the products.
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kD = 64;       // head dim (every model of the zoo)
constexpr int kBM = 64;      // q rows per block
constexpr int kBN = 64;      // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T>
__host__ __device__ constexpr int row_elems() { return kD + 16 / (int)sizeof(T); }  // 16-byte pad
constexpr int kProw = kBN + 4;  // fp32 P staging row (fp32 path only)

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [r0, r0+64) of one head's 64 columns into a padded smem tile;
// rows at or past n are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* base, int r0, int n, long stride,
                                          int col) {
  constexpr int kChunks = kD * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int kRow = row_elems<T>();
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    int r = i / kChunks, c = i % kChunks;
    int gr = r0 + r;
    bool ok = gr < n;
    const T* src = base + (long)(ok ? gr : 0) * stride + col + c * (16 / (int)sizeof(T));
    cp_async16(dst + r * kRow + c * (16 / (int)sizeof(T)), src, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    packed_attn_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int heads,
                       float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kRow = row_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBM * kRow;
  T* vs = ks + kBN * kRow;
  float* ps = reinterpret_cast<float*>(vs + kBN * kRow);  // fp32 path only

  const int c = heads * kD;
  const long stride = 3L * c;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* base = qkv + (long)b * n * stride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair

  load_tile<T>(qs, base, q0, n, stride, h * kD);

  uint32_t qf[4][4];  // bf16 q fragments: 4 k-steps of 16 dims
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int n_tiles = (n + kBN - 1) / kBN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T>(ks, base, k0, n, stride, c + h * kD);
    load_tile<T>(vs, base, k0, n, stride, 2 * c + h * kD);
    cp_async_wait_all();
    __syncthreads();

    if constexpr (kBf16) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          int r = warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
          int col = kk * 16 + 8 * (lane >> 4);
          ldsm_x4(qf[kk], qs + r * kRow + col);
        }
      }
    }

    // ---- S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bfr[4];
          int key = np * 16 + (lane & 7) + 8 * (lane >> 4);
          int col = kk * 16 + 8 * ((lane >> 3) & 1);
          ldsm_x4(bfr, ks + key * kRow + col);
          mma_bf16(s[2 * np], qf[kk], bfr[0], bfr[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
        }
      }
    } else {
      const float* q_lo = reinterpret_cast<const float*>(qs) + (warp * 16 + g) * kRow;
      const float* q_hi = q_lo + 8 * kRow;
      const float* kf = reinterpret_cast<const float*>(ks);
      for (int d = 0; d < kD; ++d) {
        float a0 = q_lo[d], a1 = q_hi[d];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float k0v = kf[(8 * j + 2 * t) * kRow + d];
          float k1v = kf[(8 * j + 2 * t + 1) * kRow + d];
          s[j][0] = fmaf(a0, k0v, s[j][0]);
          s[j][1] = fmaf(a0, k1v, s[j][1]);
          s[j][2] = fmaf(a1, k0v, s[j][2]);
          s[j][3] = fmaf(a1, k1v, s[j][3]);
        }
      }
    }

    // ---- scale, mask keys >= n, online softmax (rows g and g+8)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int key = k0 + 8 * j + 2 * t + (e & 1);
        float v = key < n ? s[j][e] * scale : -INFINITY;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      float m_new = fmaxf(m_run[r], mx[r]);
      // every tile holds at least one real key, so m_new is finite; guard anyway
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m_run[r] - m_use[r]);  // exp(-inf) = 0 on the first tile
      m_run[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
    uint32_t pf[8][2];  // bf16 P packed in accumulator order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p0 = expf(s[j][0] - m_use[0]);
      float p1 = expf(s[j][1] - m_use[0]);
      float p2 = expf(s[j][2] - m_use[1]);
      float p3 = expf(s[j][3] - m_use[1]);
      if constexpr (kBf16) {
        pf[j][0] = pack_bf16(p0, p1);
        pf[j][1] = pack_bf16(p2, p3);
        __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&pf[j][0]);
        __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&pf[j][1]);
        psum[0] += __low2float(lo) + __high2float(lo);
        psum[1] += __low2float(hi) + __high2float(hi);
      } else {
        s[j][0] = p0; s[j][1] = p1; s[j][2] = p2; s[j][3] = p3;
        psum[0] += p0 + p1;
        psum[1] += p2 + p3;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // ---- O += P V
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
          uint32_t bfr[4];
          int key = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
          int col = dp * 16 + 8 * (lane >> 4);
          ldsm_x4_trans(bfr, vs + key * kRow + col);
          mma_bf16(o[2 * dp], a, bfr[0], bfr[1]);
          mma_bf16(o[2 * dp + 1], a, bfr[2], bfr[3]);
        }
      }
    } else {
      float* pw = ps + warp * 16 * kProw;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        pw[g * kProw + 8 * j + 2 * t] = s[j][0];
        pw[g * kProw + 8 * j + 2 * t + 1] = s[j][1];
        pw[(g + 8) * kProw + 8 * j + 2 * t] = s[j][2];
        pw[(g + 8) * kProw + 8 * j + 2 * t + 1] = s[j][3];
      }
      __syncwarp();
      const float* vf = reinterpret_cast<const float*>(vs);
      for (int key = 0; key < kBN; ++key) {
        float a0 = pw[g * kProw + key], a1 = pw[(g + 8) * kProw + key];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v0 = vf[key * kRow + 8 * j + 2 * t];
          float v1 = vf[key * kRow + 8 * j + 2 * t + 1];
          o[j][0] = fmaf(a0, v0, o[j][0]);
          o[j][1] = fmaf(a0, v1, o[j][1]);
          o[j][2] = fmaf(a1, v0, o[j][2]);
          o[j][3] = fmaf(a1, v1, o[j][3]);
        }
      }
      __syncwarp();
    }
  }

  // ---- normalise and store rows g, g+8 of this warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int row = q0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    T* dst = out + ((long)b * n + row) * c + h * kD;
    float inv = 1.f / l_run[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v0 = o[j][2 * r] * inv, v1 = o[j][2 * r + 1] * inv;
      if constexpr (kBf16) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * t) = __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) = make_float2(v0, v1);
      }
    }
  }
}

template <typename T>
int launch(const void* qkv, void* out, int batch, int n, int heads, float scale,
           cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  size_t smem = (size_t)(kBM + 2 * kBN) * row_elems<T>() * sizeof(T);
  if (!kBf16) smem += (size_t)kWarps * 16 * kProw * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(packed_attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kBM - 1) / kBM, heads, batch);
  packed_attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Returns a cudaError_t (0 = success);
// -1 for an argument the kernel does not take.
extern "C" int dad_packed_attention(const void* qkv, void* out, int batch, int n, int heads,
                                    int head_dim, int dtype, float scale, void* stream) {
  if (head_dim != kD || n <= 0 || batch <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(qkv, out, batch, n, heads, scale, st);
  if (dtype == 1) return launch<float>(qkv, out, batch, n, heads, scale, st);
  return -1;
}
