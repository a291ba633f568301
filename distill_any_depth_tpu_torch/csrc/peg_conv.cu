// The PEG conv's forward for Hopper (sm_90a): out = dwconv37(x) + bias + x
// over x [B, C, H, W], CPVT's position encoding (models/vit.PosConv): a 37 x
// 37 depthwise conv with zero padding 18, its bias and its identity in one
// launch.
//
// Replaces no TPU kernel: the JAX package leaves the PEG to flax's grouped
// nn.Conv (distill_any_depth_tpu/models/vit.py PosConv), that is to XLA. On
// the card ATen ran it as conv_depthwise2d_forward_kernel_generic (fp32 FMAs
// on CUDA cores, its input reloaded for every tap), then `+ x` as a second
// pass that rounded to bf16 a second time.
//
// Bound: operations. 2 B C 37^2 H W: 92.1 GFLOP at the windowed teacher's
// 1036^2 bs8 ([8, 768, 74, 74]), 0.0931 ms at 989 TFLOP/s; the bytes (x read
// and out written once, 134 MB) take 0.040 ms.
//
// bf16 design (W <= 80, H <= 384): for a channel c and a kernel row i the
// conv along x is a product with a banded Toeplitz matrix,
// T_{c,i}[x', x] = w[c, i, x' - x + 18] where |x' - x| <= 18, so
//   out[b, c, y, :] = sum_i x[b, c, y + i - 18, :] . T_{c,i},
// a GEMM whose rows are (b, y), whose depth is x' and whose width is x, both
// W padded to KW (48 or 80), on wgmma m64nKWk16 with fp32 accumulators that
// stay in registers across all 37 kernel rows. A persistent block (one per
// SM) walks work items, a channel and nb of its images each:
//   - the item's planes sit in shared memory stacked one under another, with
//     18 zero rows above, between and below them, column-chunk-major ([KW / 8
//     chunks of 8 columns][rows][8], no swizzle: a core matrix is 8
//     neighbouring rows x 16 bytes; the pitch is 1 mod 8 rows, so the copies
//     into neighbouring chunks hit distinct banks). Output row m = b (H + 18)
//     + y reads plane row m + i at kernel row i: the shift is a 16-byte move
//     of A's descriptor, never a copy. Rows that fall between two images read
//     zeros; the output rows there are computed and dropped (296 of 384 rows
//     live at H = 74, nb = 4). Two plane buffers;
//   - warpgroup 2 (the producer) expands each kernel row into T_{c,i} (KW x
//     KW bf16, K-major: [KW / 8 chunks of x'][x][8]) in a ring of kStages
//     stages. The chunks along a diagonal repeat one 8-tap window, so a
//     thread loads a window once (four aligned 4-byte words, from one of two
//     copies of the kernel rows one element apart) and stores it to its
//     chunks; chunks of zeros stay zero from the start;
//   - warpgroups 0 and 1 (the consumers) own kT 64-row tiles each: per kernel
//     row, KW / 16 K steps of kT wgmma (A from the plane at the shifted row, B
//     from the stage) and one commit; while those run, each consumer thread
//     issues a few asynchronous 4-byte copies of the next item's planes into
//     the other buffer; a stage is released once its products are done. The
//     epilogue adds the bias and x (read from the plane) in fp32 and rounds
//     once to bf16.
// At [8, 768, 74, 74]: items of 4 images, 6 tiles; 1536 items, 37 x 5 x 6
// wgmma m64n80k16 each: 279 GFLOP on the tensor cores for the 92.1 the conv
// counts (the band and the padding), about 0.28 ms at the peak rate.
// The same copies measured slower made by the producer between its stages
// (0.61 ms) or by one producer warp of their own (0.67 ms; PERF.md, row 12).
//
// fp32, and bf16 off those sizes: a direct CUDA-core kernel. A block owns a
// 32 x 32 output tile of one plane, with its 68 x 68 input halo and the
// channel's 37 x 37 weights in shared memory as fp32; a thread holds 4
// outputs of a row and a 40-wide window of each input row in registers.
// Both kernels sum every output in one fixed order: two calls give the same
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

using namespace dad_hopper;
using bf16 = __nv_bfloat16;

constexpr int kTaps = 37, kPad = 18;
constexpr int kConsumers = 256;  // warpgroups 0 and 1
constexpr int kProducers = 128;  // warpgroup 2
constexpr int kThreads = kConsumers + kProducers;
constexpr int kStages = 4;        // Toeplitz stages in the ring
// A kernel row in shared memory: kWLead zeros, the 37 taps, zeros to kWRow;
// twice, the second copy one element to the left, so that 8 taps from any
// start load as four aligned 4-byte words from one of them
constexpr int kWLead = 8, kWRow = 56;
constexpr int kWindows = kTaps + 7;  // 8-tap windows that hold a tap: starts -7 .. 36
constexpr int kMaxW = 80, kMaxH = 6 * 64;
// registers a thread: the block starts at 168 (65536 / 384, rounded down to
// 8); the consumers take 208, the producer keeps the rest
constexpr int kConsumerRegs = 208;
constexpr int kProducerRegs = 3 * 168 - 2 * kConsumerRegs;

template <int KW, int kT>
struct Shape {
  static constexpr int kChunks = KW / 8;
  static constexpr int kTiles = 2 * kT;
  static constexpr int kRows = kTiles * 64 + 2 * kPad;        // plane rows the tiles read
  static constexpr int kPitch = kRows + (9 - kRows % 8) % 8;  // rows a chunk, 1 mod 8
  static constexpr int kPlaneBytes = kChunks * kPitch * 16;
  static constexpr int kTBytes = kChunks * KW * 16;
  static constexpr int kWBytes = 2 * kTaps * kWRow * 2;  // both copies
  static constexpr size_t kSmem =
      128 /* alignment */ + 2 * kPlaneBytes + kStages * kTBytes + 2 * kWBytes + 2 * kStages * 8;
  static_assert(KW % 16 == 0 && KW <= kMaxW, "width");
  static_assert(kPitch % 8 == 1, "pitch");
  static_assert(kProducers >= 2 * kWindows, "windows");
  static_assert(kSmem <= 232448, "shared memory");
};

// An item: channel c, images b0 .. b0 + n - 1.
struct Item {
  int c, b0, n;
};

__device__ __forceinline__ Item item_of(int item, int per_channel, int nb, int batch) {
  Item it;
  it.c = item / per_channel;
  it.b0 = (item - it.c * per_channel) * nb;
  it.n = min(nb, batch - it.b0);
  return it;
}

// T_{c,i} by its windows: chunk (kc, n) holds T[8 kc + e][n] = taps s .. s
// + 7 of kernel row i, s = 8 kc + 18 - n, so the chunks along a diagonal
// (kc + 1, n + 8) repeat one window. Producer thread pt < 2 kWindows loads
// window s = pt % kWindows - 7 once a stage and writes its chunks of one
// parity of kc with n < W; the other chunks (windows of zeros, or n >= W)
// stay zero.
template <int KW>
struct ToeplitzWindows {
  int src;  // the window's first tap in a kernel row (either copy; -1: no window)
  int s, parity;

  __device__ __forceinline__ ToeplitzWindows(int pt) {
    s = pt % kWindows - 7;
    parity = pt / kWindows;
    const int p = kWLead + s;
    src = parity > 1 ? -1 : (p % 2 == 0 ? p : kTaps * kWRow + p - 1);
  }

  // T_{c,i} from kernel row `wrow` (its first copy) into `stage`
  __device__ __forceinline__ void build(uint8_t* stage, const uint16_t* wrow, int W) const {
    if (src < 0) return;
    const uint32_t* t = reinterpret_cast<const uint32_t*>(wrow + src);
    const uint4 v = make_uint4(t[0], t[1], t[2], t[3]);
#pragma unroll
    for (int k = 0; k < KW / 16; ++k) {
      const int kc = parity + 2 * k, n = 8 * kc + kPad - s;
      if (n >= 0 && n < W) *reinterpret_cast<uint4*>(stage + (kc * KW + n) * 16) = v;
    }
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Channel c's 37 x 37 weights into both copies of the kernel rows `wts`
// (their zeros stay): every load issued before the first store.
__device__ __forceinline__ void fill_weights(uint16_t* wts, const bf16* w, int c, int pt) {
  constexpr int kN = kTaps * kTaps, kSteps = (kN + kProducers - 1) / kProducers;
  const uint16_t* wc = reinterpret_cast<const uint16_t*>(w) + (long)c * kN;
  uint16_t v[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int k = pt + s * kProducers;
    v[s] = k < kN ? wc[k] : 0;
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int k = pt + s * kProducers, r = k / kTaps;
    if (k < kN) {
      uint16_t* row = wts + r * kWRow + k - r * kTaps;
      row[kWLead] = v[s];
      row[kTaps * kWRow + kWLead - 1] = v[s];
    }
  }
}

// The copies of an item's planes into a plane buffer that consumer thread t
// makes: units t, t + kConsumers, ... (a unit: one column of a row, or two
// when `pairs`: W even and x 4-byte aligned, an asynchronous 4-byte copy,
// complete at cp_async_wait_all), a few between kernel rows. The unit's
// image, row and column advance without a division.
template <int KW, int kT>
struct PlaneFill {
  const bf16* src;  // the item's channel in image b
  long image;       // elements between two images' planes
  int b, y, u, f, total, row_units, dy, du;

  __device__ __forceinline__ PlaneFill(const bf16* x, Item it, int C, int H, int W, bool pairs,
                                       int t) {
    row_units = pairs ? W / 2 : W;
    total = it.n * H * row_units;
    f = t;
    b = t / (H * row_units);
    y = (t - b * H * row_units) / row_units;
    u = t - (b * H + y) * row_units;
    dy = kConsumers / row_units;
    du = kConsumers - dy * row_units;
    image = (long)C * H * W;
    src = x + ((long)(it.b0 + b) * C + it.c) * H * W;
  }

  // per kernel row, so that the copies end by row kTaps - 1
  __device__ __forceinline__ int per_row() const {
    return ((total + kConsumers - 1) / kConsumers + kTaps - 1) / kTaps;
  }

  __device__ __forceinline__ void run(uint8_t* plane, int H, int W, bool pairs, int count) {
    using S = Shape<KW, kT>;
    for (int k = 0; k < count && f < total; ++k, f += kConsumers) {
      const int xx = pairs ? 2 * u : u;
      uint8_t* dst =
          plane + ((xx >> 3) * S::kPitch + kPad + b * (H + kPad) + y) * 16 + (xx & 7) * 2;
      if (pairs)
        cp_async4(dst, src + y * W + xx);
      else
        *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src + y * W + xx);
      u += du;
      y += dy;
      if (u >= row_units) u -= row_units, ++y;
      while (y >= H) y -= H, ++b, src += image;
    }
  }
};

template <int KW, int kT>
__global__ void __launch_bounds__(kThreads, 1)
    dad_peg_conv_depthwise2d_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                   const bf16* __restrict__ bias, bf16* __restrict__ out,
                                   int batch, int C, int H, int W, int nb, int per_channel,
                                   int pairs) {
  using S = Shape<KW, kT>;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* plane = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint8_t* tst = plane + 2 * S::kPlaneBytes;
  uint16_t* wts = reinterpret_cast<uint16_t*>(tst + kStages * S::kTBytes);
  uint64_t* tfull = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(wts) + 2 * S::kWBytes);
  uint64_t* tempty = tfull + kStages;

  const int items = C * per_channel;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&tfull[s], kProducers);
      mbar_init(&tempty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  // zeros once: the planes' padding rows and columns, the stages' chunks off
  // the band and the kernel rows' ends are never written again
  {
    uint4* z = reinterpret_cast<uint4*>(plane);
    const int n = (2 * S::kPlaneBytes + kStages * S::kTBytes + 2 * S::kWBytes) / 16;
    for (int k = threadIdx.x; k < n; k += kThreads) z[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: each item's kernel rows, then its 37 Toeplitz stages
    setmaxnreg_dec<kProducerRegs>();
    const int pt = threadIdx.x - kConsumers;
    const ToeplitzWindows<KW> windows(pt);
    if (blockIdx.x < items) {
      fill_weights(wts, w, item_of(blockIdx.x, per_channel, nb, batch).c, pt);
      bar_sync(1, kProducers);  // the weights, before any producer reads them
    }
    int q = 0, u = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++u) {
      const int buf = u & 1;
      const int next = item + gridDim.x;
      const uint16_t* wbuf = wts + buf * (S::kWBytes / 2);
#pragma unroll 1
      for (int i = 0; i < kTaps; ++i, ++q) {
        const int st = q % kStages, round = q / kStages;
        if (round > 0) mbar_wait(&tempty[st], (round - 1) & 1);
        windows.build(tst + st * S::kTBytes, wbuf + i * kWRow, W);
        fence_proxy_async();
        mbar_arrive(&tfull[st]);
        // the next item's kernel rows into the other weight buffer, whose
        // last reader (the item before this one) every producer is past; one
        // load's latency, while the ring holds kStages stages
        if (i == kStages && next < items)
          fill_weights(wts + (buf ^ 1) * (S::kWBytes / 2), w,
                       item_of(next, per_channel, nb, batch).c, pt);
      }
      if (next < items) bar_sync(1, kProducers);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns tiles wg kT .. wg kT + kT - 1 of an item
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7, wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  float acc[kT][KW / 2];
  if (blockIdx.x < items) {
    PlaneFill<KW, kT> first(x, item_of(blockIdx.x, per_channel, nb, batch), C, H, W, pairs,
                            threadIdx.x);
    first.run(plane, H, W, pairs, 1 << 30);
    cp_async_wait_all();
    fence_proxy_async();  // the copies, before wgmma reads them
    bar_sync(2, kConsumers);
  }
  int q = 0, u = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++u) {
    const int buf = u & 1;
    const int next = item + gridDim.x;
    PlaneFill<KW, kT> fill(x, item_of(next, per_channel, nb, batch), C, H, W, pairs, threadIdx.x);
    const int per_row = next < items ? fill.per_row() : 0;
    uint8_t* nplane = plane + (buf ^ 1) * S::kPlaneBytes;
    const uint32_t pbase = smem_u32(plane + buf * S::kPlaneBytes);
#pragma unroll 1
    for (int i = 0; i < kTaps; ++i, ++q) {
      const int st = q % kStages;
      mbar_wait(&tfull[st], (q / kStages) & 1);
      const uint32_t tbase = smem_u32(tst + st * S::kTBytes);
#pragma unroll
      for (int t = 0; t < kT; ++t) fence_regs(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        const uint64_t bdesc = desc_plain(tbase + kk * 2 * KW * 16, KW * 16, 128);
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const uint32_t row = (wg * kT + t) * 64 + i;
          const uint64_t adesc =
              desc_plain(pbase + (kk * 2 * S::kPitch + row) * 16, S::kPitch * 16, 128);
          wgmma_ss<KW>(acc[t], adesc, bdesc, (i | kk) != 0);
        }
      }
      wgmma_commit();
      // while the products run: a share of the next item's planes into the
      // other buffer, whose last reader (the item before this one's
      // epilogue) every consumer is past
      fill.run(nplane, H, W, pairs, per_row);
      wgmma_wait<1>();  // the previous kernel row's products are done: release its stage
#pragma unroll
      for (int t = 0; t < kT; ++t) fence_regs(acc[t]);
      if (i > 0 && lane == 0) mbar_arrive(&tempty[(q - 1) % kStages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < kT; ++t) fence_regs(acc[t]);
    if (lane == 0) mbar_arrive(&tempty[(q - 1) % kStages]);

    // ---- epilogue: (warp wi, lane 4g + tq) holds rows 16 wi + g (+8) of
    // each tile, columns 8j + 2tq (+1)
    const Item it = item_of(item, per_channel, nb, batch);
    const float bc = __bfloat162float(bias[it.c]);
    const uint8_t* pl = plane + buf * S::kPlaneBytes;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (wg * kT + t) * 64 + 16 * wi + g + 8 * half;
        const int b = m / (H + kPad), y = m - b * (H + kPad);
        if (b >= it.n || y >= H) continue;
        bf16* dst = out + ((long)(it.b0 + b) * C + it.c) * H * W + (long)y * W;
#pragma unroll
        for (int j = 0; j < KW / 8; ++j) {
          const int xx = 8 * j + 2 * tq;
          if (xx >= W) continue;
          const __nv_bfloat162 id = *reinterpret_cast<const __nv_bfloat162*>(
              pl + (j * S::kPitch + m + kPad) * 16 + 4 * tq);
          const float v0 = acc[t][4 * j + 2 * half] + bc + __low2float(id);
          const float v1 = acc[t][4 * j + 2 * half + 1] + bc + __high2float(id);
          if (pairs) {
            *reinterpret_cast<uint32_t*>(dst + xx) = pack_bf16(v0, v1);
          } else {
            dst[xx] = __float2bfloat16_rn(v0);
            if (xx + 1 < W) dst[xx + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
    // the next item's planes are in, and every consumer is done with this one's
    cp_async_wait_all();
    fence_proxy_async();
    bar_sync(2, kConsumers);
  }
}

// ------------------------------------------------------------------ direct (CUDA cores)
constexpr int kTile = 32;                  // output tile side
constexpr int kHalo = kTile + 2 * kPad;    // 68
constexpr int kHaloPitch = kHalo + 1;      // 69: a warp's 4 rows x 8 column groups hit 32 banks
constexpr int kDirectThreads = 256;        // 32 rows x 8 groups of 4 columns

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kDirectThreads)
    dad_peg_conv_depthwise2d_direct(const T* __restrict__ x, const T* __restrict__ w,
                                    const T* __restrict__ bias, T* __restrict__ out, int C, int H,
                                    int W) {
  __shared__ float s_in[kHalo * kHaloPitch];
  __shared__ float s_w[kTaps * kTaps];
  const int tiles_x = (W + kTile - 1) / kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile, y0 = (blockIdx.x / tiles_x) * kTile;
  const int c = blockIdx.y;
  const long base = ((long)blockIdx.z * C + c) * H * W;
  for (int k = threadIdx.x; k < kHalo * kHalo; k += kDirectThreads) {
    const int r = k / kHalo, cc = k - r * kHalo;
    const int yy = y0 + r - kPad, xx = x0 + cc - kPad;
    s_in[r * kHaloPitch + cc] =
        (yy >= 0 && yy < H && xx >= 0 && xx < W) ? to_float(x[base + (long)yy * W + xx]) : 0.f;
  }
  for (int k = threadIdx.x; k < kTaps * kTaps; k += kDirectThreads)
    s_w[k] = to_float(w[(long)c * kTaps * kTaps + k]);
  __syncthreads();

  const int ty = threadIdx.x >> 3, tx = (threadIdx.x & 7) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int i = 0; i < kTaps; ++i) {
    const float* row = s_in + (ty + i) * kHaloPitch + tx;
    float r[kTaps + 3];
#pragma unroll
    for (int k = 0; k < kTaps + 3; ++k) r[k] = row[k];
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const float wv = s_w[i * kTaps + j];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fmaf(wv, r[j + k], acc[k]);
    }
  }
  const float bc = to_float(bias[c]);
  const int y = y0 + ty;
  if (y >= H) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xx = x0 + tx + k;
    if (xx < W)
      out[base + (long)y * W + xx] =
          from_float<T>(acc[k] + bc + s_in[(ty + kPad) * kHaloPitch + tx + k + kPad]);
  }
}

// ------------------------------------------------------------------ host
int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

template <int KW, int kT>
int launch_wgmma(const void* x, const void* w, const void* bias, void* out, int batch, int C,
                 int H, int W, int nb, int per_channel, bool pairs, cudaStream_t st) {
  using S = Shape<KW, kT>;
  auto kernel = dad_peg_conv_depthwise2d_wgmma<KW, kT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long items = (long)C * per_channel;
  if (items > 0x7fffffff) return -1;
  const int grid = (int)(items < sm_count() ? items : sm_count());
  kernel<<<grid, kThreads, S::kSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), batch, C, H, W, nb, per_channel, pairs ? 1 : 0);
  return (int)cudaGetLastError();
}

// Images an item holds at kT tiles a consumer warpgroup: the most whose
// stacked rows, (n - 1) (H + 18) + H, fit 2 kT tiles of 64.
int images_per_item(int H, int kT) {
  const int rows = 2 * kT * 64;
  return H > rows ? 0 : (rows - H) / (H + kPad) + 1;
}

// kT with the fewest tile rows a channel (ties: the larger, fewer items),
// then the images spread evenly over the channel's items.
template <int KW>
int launch_bf16(const void* x, const void* w, const void* bias, void* out, int batch, int C,
                int H, int W, bool pairs, cudaStream_t st) {
  int best = 0, best_rows = 0, per_channel = 0;
  for (int kt = 3; kt >= 1; --kt) {
    const int nb = images_per_item(H, kt);
    if (nb == 0) continue;
    const int q = (batch + nb - 1) / nb;
    if (best == 0 || q * 2 * kt < best_rows) best = kt, best_rows = q * 2 * kt, per_channel = q;
  }
  const int nb = (batch + per_channel - 1) / per_channel;
  switch (best) {
    case 3: return launch_wgmma<KW, 3>(x, w, bias, out, batch, C, H, W, nb, per_channel, pairs, st);
    case 2: return launch_wgmma<KW, 2>(x, w, bias, out, batch, C, H, W, nb, per_channel, pairs, st);
    case 1: return launch_wgmma<KW, 1>(x, w, bias, out, batch, C, H, W, nb, per_channel, pairs, st);
    default: return -1;
  }
}

template <typename T>
int launch_direct(const void* x, const void* w, const void* bias, void* out, int batch, int C,
                  int H, int W, cudaStream_t st) {
  const long tiles = (long)((W + kTile - 1) / kTile) * ((H + kTile - 1) / kTile);
  if (tiles > 0x7fffffff || C > 65535 || batch > 65535) return -1;
  dad_peg_conv_depthwise2d_direct<T><<<dim3((unsigned)tiles, C, batch), kDirectThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), C, H, W);
  return (int)cudaGetLastError();
}

bool aligned4(const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; }

}  // namespace

// x, out [B, C, H, W] contiguous; w [C, 37 * 37]; bias [C]; all of one dtype
// (0 bf16, 1 fp32). out = dwconv37(x, padding 18) + bias + x. Returns the
// launch's CUDA error, -1 for arguments the kernels do not take.
extern "C" int dad_peg_conv_fwd(const void* x, const void* w, const void* bias, void* out,
                                int batch, int C, int H, int W, int dtype, void* stream) {
  if (batch < 0 || C < 0 || H <= 0 || W <= 0) return -1;
  if (batch == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (W > kMaxW || H > kMaxH) return launch_direct<bf16>(x, w, bias, out, batch, C, H, W, st);
    const bool pairs = W % 2 == 0 && aligned4(x) && aligned4(out);
    if (W <= 48) return launch_bf16<48>(x, w, bias, out, batch, C, H, W, pairs, st);
    return launch_bf16<80>(x, w, bias, out, batch, C, H, W, pairs, st);
  }
  if (dtype == 1) return launch_direct<float>(x, w, bias, out, batch, C, H, W, st);
  return -1;
}
