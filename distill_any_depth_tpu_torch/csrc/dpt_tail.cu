// DPT-head tail for Hopper (sm_90a), in two launches.
//
// Replaces the TPU kernel distill_any_depth_tpu/ops/dpt_tail.py
// ::fused_dpt_tail_v2 (body _tail_kernel_v2), with the contract of its
// tail_reference:
//
//   t [B,ht,wt,C] -> bilinear x2 (align_corners) -> conv3x3 C->C/2 + b1
//     -> bilinear to (oh,ow) (align_corners) -> conv3x3 C/2->32 + b2 -> ReLU
//     -> 1x1 32->1 + bd [-> ReLU]                         -> depth [B,oh,ow]
//
// Both 3x3 convs zero-pad by one pixel. Layouts are channels-last (NHWC).
//
// Launch 1 (tail_conv1_kernel): 2x upsample + conv1 + b1 -> v [B,2ht,2wt,C/2]
//   in the input type.
// Launch 2 (tail_head_kernel): resize to (oh,ow) + conv2 + b2 + ReLU + 1x1 +
//   bd [+ ReLU] -> depth. The 32-channel conv2 output (78.7 MB in bf16 at
//   bs8 392^2), the largest intermediate, never leaves the chip.
//
// Bound at the ViT-B 392^2 bs8 shape (t [8,112,112,128] -> [8,392,392],
// bf16): conv1 59.2 GFLOP + conv2 45.3 GFLOP is ~106 us of bf16 tensor-core
// time; one read of t plus the depth write is ~31 MB (~9 us). The v round
// trip between the launches (+103 MB, ~31 us) stays under the compute
// bound, so the split costs nothing against it.
//
// Design: each block computes an 8x16 output tile. It first builds the
// resized input for the tile plus its one-pixel conv halo (10x18 pixels x
// all channels) in shared memory, interpolating on the fly from the source,
// so the upsampled tensors u and w never exist in device memory. The conv is
// then an implicit GEMM (M = 128 pixels, N = out channels, K = 9 taps x in
// channels): bf16 on the tensor cores with mma.sync m16n8k16, A fragments
// gathered by ldmatrix from the halo tile, B fragments read as one 16-byte
// load per lane from weights the wrapper pre-packs in fragment order. fp32
// runs the same tiles with scalar FMAs. The bias, ReLU and the 32->1 head
// reduce in registers (quad shuffles) in launch 2's epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTH = 8, kTW = 16;                  // output tile
constexpr int kHH = kTH + 2, kHW = kTW + 2;       // with the conv halo
constexpr int kThreads = 128;                     // 4 warps, 2 tile rows each
constexpr int kC2 = 32;                           // conv2 output channels

template <typename T>
__host__ __device__ constexpr int pad_elems() { return 16 / (int)sizeof(T); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

// Bilinear source taps with align_corners=True, as PyTorch's
// upsample_bilinear2d computes them (float scale, truncation, clamped +1).
struct Tap {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Tap bilinear_tap(float scale, int dst, int in_size) {
  float src = scale * (float)dst;
  Tap tp;
  tp.i0 = (int)src;
  tp.i1 = tp.i0 + (tp.i0 < in_size - 1 ? 1 : 0);
  tp.l1 = src - (float)tp.i0;
  tp.l0 = 1.f - tp.l1;
  return tp;
}

__device__ __forceinline__ float ac_scale(int in_size, int out_size) {
  return out_size > 1 ? (float)(in_size - 1) / (float)(out_size - 1) : 0.f;
}

// Fill the (kHH x kHW) halo tile with src [hs, ws, CIN] bilinearly resized to
// (ho, wo); pixels outside [0,ho)x[0,wo) are the conv's zero padding.
template <typename T, int CIN>
__device__ __forceinline__ void fill_halo(T* halo, const T* src, int hs, int ws, int ho, int wo,
                                          int y0, int x0) {
  constexpr int kRow = CIN + pad_elems<T>();
  constexpr int kChunks = CIN / 8;
  const float sh = ac_scale(hs, ho), sw = ac_scale(ws, wo);
  for (int i = threadIdx.x; i < kHH * kHW * kChunks; i += kThreads) {
    int pix = i / kChunks, c8 = (i % kChunks) * 8;
    int hy = pix / kHW, hx = pix % kHW;
    int oy = y0 - 1 + hy, ox = x0 - 1 + hx;
    float r[8];
    if (oy < 0 || oy >= ho || ox < 0 || ox >= wo) {
#pragma unroll
      for (int k = 0; k < 8; ++k) r[k] = 0.f;
    } else {
      Tap ty = bilinear_tap(sh, oy, hs), tx = bilinear_tap(sw, ox, ws);
      float a[8], b[8], c[8], d[8];
      load8(src + ((long)ty.i0 * ws + tx.i0) * CIN + c8, a);
      load8(src + ((long)ty.i0 * ws + tx.i1) * CIN + c8, b);
      load8(src + ((long)ty.i1 * ws + tx.i0) * CIN + c8, c);
      load8(src + ((long)ty.i1 * ws + tx.i1) * CIN + c8, d);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        r[k] = ty.l0 * (tx.l0 * a[k] + tx.l1 * b[k]) + ty.l1 * (tx.l0 * c[k] + tx.l1 * d[k]);
    }
    store8(halo + pix * kRow + c8, r);
  }
}

// acc[mt][j][e] += implicit-GEMM 3x3 conv of the halo tile. Warp w owns
// tile rows 2w+mt (mt = 0,1); m-tile row m is tile column m. Accumulator
// element e of n-tile j sits at column g + 8*(e>>1), channel 8j + 2t + (e&1).
//
// bf16: w is pre-packed in mma B-fragment order, one uint4 per lane per
//   (k-step of 16, pair of n-tiles), k = tap*CIN + ci.
// fp32: w is the plain [9*CIN, COUT] matrix.
template <typename T, int CIN, int COUT>
__device__ __forceinline__ void conv3x3_tile(const T* halo, const void* w,
                                             float (&acc)[2][COUT / 8][4]) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kRow = CIN + pad_elems<T>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  if constexpr (kBf16) {
    const uint4* wp = static_cast<const uint4*>(w);
    const int p = (lane & 7) + 8 * ((lane >> 3) & 1);
    const int cofs = 8 * (lane >> 4);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const T* row0 = halo + ((2 * warp + dy) * kHW + p + dx) * kRow + cofs;
#pragma unroll 2
      for (int kc = 0; kc < CIN / 16; ++kc) {
        uint32_t a[2][4];
        ldsm_x4(a[0], row0 + kc * 16);
        ldsm_x4(a[1], row0 + kHW * kRow + kc * 16);
        const uint4* wk = wp + ((tap * (CIN / 16) + kc) * (COUT / 16)) * 32 + lane;
#pragma unroll
        for (int np = 0; np < COUT / 16; ++np) {
          uint4 bb = __ldg(wk + np * 32);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], bb.x, bb.y);
            mma_bf16(acc[mt][2 * np + 1], a[mt], bb.z, bb.w);
          }
        }
      }
    }
  } else {
    const float* wf = static_cast<const float*>(w);
    const float* hf = reinterpret_cast<const float*>(halo);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll 1
      for (int ci = 0; ci < CIN; ++ci) {
        float alo[2], ahi[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* hr = hf + ((2 * warp + mt + dy) * kHW + dx) * kRow + ci;
          alo[mt] = hr[g * kRow];
          ahi[mt] = hr[(g + 8) * kRow];
        }
        const float* wr = wf + (long)(tap * CIN + ci) * COUT + 2 * t;
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j) {
          float2 wv = *reinterpret_cast<const float2*>(wr + 8 * j);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            acc[mt][j][0] = fmaf(alo[mt], wv.x, acc[mt][j][0]);
            acc[mt][j][1] = fmaf(alo[mt], wv.y, acc[mt][j][1]);
            acc[mt][j][2] = fmaf(ahi[mt], wv.x, acc[mt][j][2]);
            acc[mt][j][3] = fmaf(ahi[mt], wv.y, acc[mt][j][3]);
          }
        }
      }
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    tail_conv1_kernel(const T* __restrict__ t, const void* __restrict__ w1,
                      const float* __restrict__ b1, T* __restrict__ v, int ht, int wt) {
  constexpr int CM = C / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* halo = reinterpret_cast<T*>(smem);
  const int hu = 2 * ht, wu = 2 * wt;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH, b = blockIdx.z;
  fill_halo<T, C>(halo, t + (long)b * ht * wt * C, ht, wt, hu, wu, y0, x0);
  __syncthreads();

  float acc[2][CM / 8][4];
  conv3x3_tile<T, C, CM>(halo, w1, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int oy = y0 + 2 * warp + mt;
    if (oy >= hu) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + g + 8 * half;
      if (ox >= wu) continue;
      T* dst = v + (((long)b * hu + oy) * wu + ox) * CM;
#pragma unroll
      for (int j = 0; j < CM / 8; ++j) {
        const int co = 8 * j + 2 * tq;
        store2(dst + co, acc[mt][j][2 * half] + b1[co], acc[mt][j][2 * half + 1] + b1[co + 1]);
      }
    }
  }
}

template <typename T, int CM>
__global__ void __launch_bounds__(kThreads)
    tail_head_kernel(const T* __restrict__ v, const void* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ kd,
                     const float* __restrict__ bd, T* __restrict__ out, int hv, int wv, int oh,
                     int ow, int relu_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* halo = reinterpret_cast<T*>(smem);
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH, b = blockIdx.z;
  fill_halo<T, CM>(halo, v + (long)b * hv * wv * CM, hv, wv, oh, ow, y0, x0);
  __syncthreads();

  float acc[2][kC2 / 8][4];
  conv3x3_tile<T, CM, kC2>(halo, w2, acc);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  float dsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [mt][column half]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kC2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = 8 * j + 2 * tq + (e & 1);
        const float z = fmaxf(acc[mt][j][e] + b2[co], 0.f);
        dsum[mt][e >> 1] = fmaf(z, kd[co], dsum[mt][e >> 1]);
      }
  const float bias = bd[0];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = dsum[mt][half];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int oy = y0 + 2 * warp + mt, ox = x0 + g + 8 * half;
      if (tq == 0 && oy < oh && ox < ow) {
        float d = s + bias;
        if (relu_out) d = fmaxf(d, 0.f);
        store1(out + ((long)b * oh + oy) * ow + ox, d);
      }
    }
}

template <typename T, int CIN>
size_t halo_bytes() {
  return (size_t)kHH * kHW * (CIN + pad_elems<T>()) * sizeof(T);
}

template <typename T, int C>
int launch_conv1(const void* t, const void* w1, const float* b1, void* v, int batch, int ht,
                 int wt, cudaStream_t st) {
  const size_t smem = halo_bytes<T, C>();
  cudaError_t err = cudaFuncSetAttribute(tail_conv1_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((2 * wt + kTW - 1) / kTW, (2 * ht + kTH - 1) / kTH, batch);
  tail_conv1_kernel<T, C><<<grid, kThreads, smem, st>>>(static_cast<const T*>(t), w1, b1,
                                                        static_cast<T*>(v), ht, wt);
  return (int)cudaGetLastError();
}

template <typename T, int CM>
int launch_head(const void* v, const void* w2, const float* b2, const float* kd, const float* bd,
                void* out, int batch, int hv, int wv, int oh, int ow, int relu_out,
                cudaStream_t st) {
  const size_t smem = halo_bytes<T, CM>();
  cudaError_t err = cudaFuncSetAttribute(tail_head_kernel<T, CM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((ow + kTW - 1) / kTW, (oh + kTH - 1) / kTH, batch);
  tail_head_kernel<T, CM><<<grid, kThreads, smem, st>>>(static_cast<const T*>(v), w2, b2, kd, bd,
                                                        static_cast<T*>(out), hv, wv, oh, ow,
                                                        relu_out);
  return (int)cudaGetLastError();
}

template <typename T>
int conv1_for(int c, const void* t, const void* w1, const float* b1, void* v, int batch, int ht,
              int wt, cudaStream_t st) {
  switch (c) {
    case 64: return launch_conv1<T, 64>(t, w1, b1, v, batch, ht, wt, st);
    case 128: return launch_conv1<T, 128>(t, w1, b1, v, batch, ht, wt, st);
    case 256: return launch_conv1<T, 256>(t, w1, b1, v, batch, ht, wt, st);
  }
  return -1;
}

template <typename T>
int head_for(int cm, const void* v, const void* w2, const float* b2, const float* kd,
             const float* bd, void* out, int batch, int hv, int wv, int oh, int ow, int relu_out,
             cudaStream_t st) {
  switch (cm) {
    case 32: return launch_head<T, 32>(v, w2, b2, kd, bd, out, batch, hv, wv, oh, ow, relu_out, st);
    case 64: return launch_head<T, 64>(v, w2, b2, kd, bd, out, batch, hv, wv, oh, ow, relu_out, st);
    case 128: return launch_head<T, 128>(v, w2, b2, kd, bd, out, batch, hv, wv, oh, ow, relu_out, st);
  }
  return -1;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Each returns a cudaError_t (0 = success),
// or -1 for an argument the kernels do not take.
extern "C" int dad_tail_conv1(const void* t, const void* w1, const void* b1, void* v, int batch,
                              int ht, int wt, int c, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || ht <= 0 || wt <= 0 || 2 * ht > 8 * 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bias = static_cast<const float*>(b1);
  if (dtype == 0) return conv1_for<__nv_bfloat16>(c, t, w1, bias, v, batch, ht, wt, st);
  if (dtype == 1) return conv1_for<float>(c, t, w1, bias, v, batch, ht, wt, st);
  return -1;
}

extern "C" int dad_tail_head(const void* v, const void* w2, const void* b2, const void* kd,
                             const void* bd, void* out, int batch, int hv, int wv, int cm, int oh,
                             int ow, int relu_out, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || hv <= 0 || wv <= 0 || oh <= 0 || ow <= 0 ||
      oh > 8 * 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b2f = static_cast<const float*>(b2);
  const float* kdf = static_cast<const float*>(kd);
  const float* bdf = static_cast<const float*>(bd);
  if (dtype == 0)
    return head_for<__nv_bfloat16>(cm, v, w2, b2f, kdf, bdf, out, batch, hv, wv, oh, ow, relu_out, st);
  if (dtype == 1)
    return head_for<float>(cm, v, w2, b2f, kdf, bdf, out, batch, hv, wv, oh, ow, relu_out, st);
  return -1;
}
