// The PEG conv for Hopper (sm_90a): out = dwconv37(x) + bias + x over x
// [B, C, H, W], CPVT's position encoding (models/vit.PosConv): a 37 x 37
// depthwise conv with zero padding 18, its bias and its identity in one
// launch; and its backward, d(x), d(weight) and d(bias) for the cotangent g.
//
// Replaces no TPU kernel: the JAX package leaves the PEG to flax's grouped
// nn.Conv (distill_any_depth_tpu/models/vit.py PosConv), that is to XLA,
// forward and backward. On the card ATen ran the forward as
// conv_depthwise2d_forward_kernel_generic (fp32 FMAs on CUDA cores, its
// input reloaded for every tap), then `+ x` as a second pass that rounded to
// bf16 a second time; and the backward as conv_depthwise2d_backward_kernel
// (d(x)), conv_depthwise2d_grad_weight_kernel (d(weight)), a sum for d(bias)
// and `dx + g`: 178 ms at the windowed student's 1036^2 bs16.
//
// Bound: operations. 2 B C 37^2 H W each for the forward, d(x) and d(weight):
// 92.1 GFLOP at the windowed teacher's 1036^2 bs8 ([8, 768, 74, 74]), 0.0931
// ms at 989 TFLOP/s; the bytes (x read and out written once, 134 MB) take
// 0.040 ms. At the student's bs16, 184.2 GFLOP, 0.186 ms each.
//
// Forward, bf16 design (W <= 80, H <= 384): for a channel c and a kernel row
// i the conv along x is a product with a banded Toeplitz matrix,
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
// Forward, fp32 and bf16 off those sizes: a direct CUDA-core kernel. A block
// owns a 32 x 32 output tile of one plane, with its 68 x 68 input halo and
// the channel's 37 x 37 weights in shared memory as fp32; a thread holds 4
// outputs of a row and a 40-wide window of each input row in registers.
//
// Backward, d(x): the forward itself on (g, the kernel flipped, no bias).
// The padding is symmetric (18 of 37 taps), so
//   d(x)[y', x'] = sum_{i,j} g[y' + i - 18, x' + j - 18] w[36 - i, 36 - j],
// and the identity's gradient is g: the forward's conv + bias + x, with
// the same kernels and the same split.
//
// Backward, d(weight) and d(bias), bf16 design (the forward's sizes): for a
// channel c and a kernel row i,
//   P_{c,i}[x', x] = sum_{b,y} x[b, c, y + i - 18, x'] g[b, c, y, x],
//   d(weight)[c, i, j] = sum_x P_{c,i}[x + j - 18, x],
// the sum along P's diagonal j - 18. P is a product whose depth is the rows
// (b, y) and whose sides are the two planes' columns. A persistent block of
// two warpgroups (256 threads) walks the forward's items (a channel and nb
// of its images) with both planes, x and g, in the forward's layout: read
// down a chunk, a core matrix is 8 rows of K by 8 columns of M or N, so both
// are MN-major operands (LBO the 128 bytes to the next 8 rows, SBO a
// chunk's pitch), and the row shift by i is again a move of A's descriptor.
// The K steps cover the item's images and the 18-row gaps between them;
// rows past the last image are never multiplied with anything but zeros.
// Per kernel row a warpgroup runs, over every K step, wgmma m64n80k16 for x'
// 0..63 by x 0..79 and m64n40k16 for x' 16..79 (kept from 64) by x 40..79,
// which hold every pair with |x' - x| <= 18 (W <= 48: one m64n48k16, x'
// 0..63 by x 0..47). Warpgroup 0 takes kernel rows 0..18, warpgroup 1 rows
// 18..36 (row 18 twice, stored once). Two accumulator sets: while the
// products of row i + 1 run, the band of row i goes to shared memory as
// Q[x][x' - x + 18] and 37 threads each sum one diagonal in a fixed order.
// Each item writes its 37 x 37 sums and its d(bias) share (the sum of its g
// plane, in a fixed order) as fp32 to a scratch buffer; a second pass adds
// a channel's items in order and rounds once to the weight's dtype. No
// atomics: two calls give the same bits. At [16, 768, 74, 74]: 3072 items of
// 4 images, 38 x 22 K steps of m64n80k16 + m64n40k16 each: 631 GFLOP on the
// tensor cores (the band, the padding and the gaps) for the 184.2 the taps
// count, about 0.64 ms at the peak rate.
//
// d(weight), fp32 and bf16 off those sizes: a direct CUDA-core kernel. A
// block owns a channel of one image and walks its 32 x 32 tiles of g with
// their 68 x 68 halos of x in shared memory as fp32; a thread holds 8 taps
// of one kernel row and a 39-wide window of each halo row in registers. Its
// per-image sums go to the same scratch and second pass.
//
// Every kernel sums every output in one fixed order: two calls give the same
// bits. Every kernel's name holds conv_depthwise2d.

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

// ------------------------------------------------------------------ d(weight), d(bias)
constexpr int kDwThreads = 256;                 // two warpgroups
constexpr int kSlots = kTaps * kTaps + 1;       // an item's partial: the taps, then d(bias)
constexpr int kRowsPerWg = (kTaps + 1) / 2;     // kernel rows a warpgroup: 0..18, 18..36

// d[64 x N] (+)= A . B, A [64 x 16] M-major and B [16 x N] N-major in shared
// memory (no-swizzle descriptors: a core matrix is 8 rows of K, each 8
// elements of M or N in 16 bytes; LBO is the step to the next 8 rows of K,
// SBO the step to the next 8 of M or N).
template <int kN>
__device__ __forceinline__ void wgmma_mn(float (&d)[kN / 2], uint64_t a, uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_mn<40>(float (&d)[20], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "%20, %21, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_mn<48>(float (&d)[24], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_mn<80>(float (&d)[40], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The products of a kernel row: x' 0..63 (A from plane chunk 0) by x 0 ..
// kN0 - 1 (B from chunk 0); for W > 48 also x' 16..79 (A from chunk kA1;
// only x' >= 64 kept) by x 40..79 (B from chunk kB1). kAChunks: the chunks
// A reads, the x plane's size (the ones past W stay zero).
template <int KW>
struct DwTiles;
template <>
struct DwTiles<48> {
  static constexpr int kAChunks = 8, kN0 = 48, kN1 = 0;
};
template <>
struct DwTiles<80> {
  static constexpr int kAChunks = 10, kN0 = 80, kN1 = 40, kA1 = 2, kB1 = 5;
};

template <int KW, int kT>
struct DwShape {
  using S = Shape<KW, kT>;
  static constexpr int kXBytes = DwTiles<KW>::kAChunks * S::kPitch * 16;
  static constexpr int kQFloats = KW * kTaps;  // Q[x][x' - x + 18] of one kernel row
  static constexpr size_t kSmem =
      128 + kXBytes + S::kPlaneBytes + 4 * kQFloats * 4 + (kDwThreads / 32) * 4;
  static_assert(kSmem <= 232448, "shared memory");
};

// The products of kernel row i over ks K steps into one accumulator set:
// A at plane row 16 kk + i (g's row 18 + 16 kk, shifted by i - 18).
template <int KW, int kT>
__device__ __forceinline__ void dw_products(float (&a0)[DwTiles<KW>::kN0 / 2],
                                            float (&a1)[DwTiles<KW>::kN1 ? DwTiles<KW>::kN1 / 2 : 1],
                                            uint32_t xbase, uint32_t gbase, int i, int ks) {
  using S = Shape<KW, kT>;
  using T = DwTiles<KW>;
  constexpr uint32_t kChunk = S::kPitch * 16;
  fence_regs(a0);
  if constexpr (T::kN1 != 0) fence_regs(a1);
  wgmma_fence();
#pragma unroll 1
  for (int kk = 0; kk < ks; ++kk) {
    const uint32_t xa = xbase + (16 * kk + i) * 16, gb = gbase + (kPad + 16 * kk) * 16;
    wgmma_mn<T::kN0>(a0, desc_plain(xa, 128, kChunk), desc_plain(gb, 128, kChunk), kk != 0);
    if constexpr (T::kN1 != 0)
      wgmma_mn<T::kN1>(a1, desc_plain(xa + T::kA1 * kChunk, 128, kChunk),
                       desc_plain(gb + T::kB1 * kChunk, 128, kChunk), kk != 0);
  }
  wgmma_commit();
}

// Kernel row i's band from a finished accumulator set into q (Q[x][x' - x +
// 18]: a warp's stores hit 32 banks), then the sum of diagonal j by thread
// j < 37 of the warpgroup in a fixed order into `dst` (null: not stored).
// (warp wi, lane 4 gq + tq) holds rows 16 wi + gq (+8) of each product,
// columns 8 jj + 2 tq (+1).
template <int KW>
__device__ __forceinline__ void dw_diagonals(float (&a0)[DwTiles<KW>::kN0 / 2],
                                             float (&a1)[DwTiles<KW>::kN1 ? DwTiles<KW>::kN1 / 2 : 1],
                                             float* q, float* dst, int W, int wg) {
  using T = DwTiles<KW>;
  const int t = threadIdx.x & 127, wi = t >> 5, gq = (t & 31) >> 2, tq = t & 3;
  fence_regs(a0);
#pragma unroll
  for (int jj = 0; jj < T::kN0 / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int xp = 16 * wi + gq + 8 * (e >> 1), xx = 8 * jj + 2 * tq + (e & 1);
      const int d = xp - xx + kPad;
      if (xp < W && xx < W && d >= 0 && d < kTaps) q[xx * kTaps + d] = a0[4 * jj + e];
    }
  if constexpr (T::kN1 != 0) {
    fence_regs(a1);
#pragma unroll
    for (int jj = 0; jj < T::kN1 / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int xp = 8 * T::kA1 + 16 * wi + gq + 8 * (e >> 1);
        const int xx = 8 * T::kB1 + 8 * jj + 2 * tq + (e & 1);
        const int d = xp - xx + kPad;
        if (xp >= 64 && xp < W && xx < W && d >= 0 && d < kTaps)
          q[xx * kTaps + d] = a1[4 * jj + e];
      }
  }
  bar_sync(1 + wg, 128);
  if (t < kTaps && dst != nullptr) {
    const int lo = max(0, kPad - t), hi = min(W, W + kPad - t);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    int xx = lo;
    for (; xx + 3 < hi; xx += 4) {
      s0 += q[xx * kTaps + t];
      s1 += q[(xx + 1) * kTaps + t];
      s2 += q[(xx + 2) * kTaps + t];
      s3 += q[(xx + 3) * kTaps + t];
    }
    for (; xx < hi; ++xx) s0 += q[xx * kTaps + t];
    dst[t] = (s0 + s1) + (s2 + s3);
  }
}

template <int KW, int kT>
__global__ void __launch_bounds__(kDwThreads, 1)
    dad_peg_conv_depthwise2d_dw_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ g,
                                      float* __restrict__ partial, int batch, int C, int H, int W,
                                      int nb, int per_channel, int pairs) {
  using S = Shape<KW, kT>;
  using D = DwShape<KW, kT>;
  using T = DwTiles<KW>;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* xpl = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint8_t* gpl = xpl + D::kXBytes;
  float* qbuf = reinterpret_cast<float*>(gpl + S::kPlaneBytes);  // [warpgroup][parity of i]
  float* red = qbuf + 4 * D::kQFloats;                            // a warp's share of d(bias)

  // zeros once: the planes' padding rows and columns are never written again
  {
    uint4* z = reinterpret_cast<uint4*>(xpl);
    for (int k = threadIdx.x; k < (D::kXBytes + S::kPlaneBytes) / 16; k += kDwThreads)
      z[k] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = wg * (kTaps - kRowsPerWg);
  const uint32_t xbase = smem_u32(xpl), gbase = smem_u32(gpl);
  float* q = qbuf + 2 * wg * D::kQFloats;
  float acc0[2][T::kN0 / 2];
  float acc1[2][T::kN1 ? T::kN1 / 2 : 1];
  const int items = C * per_channel;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = item_of(item, per_channel, nb, batch);
    __syncthreads();  // every thread is done with the last item's planes
    PlaneFill<KW, kT>(x, it, C, H, W, pairs, threadIdx.x).run(xpl, H, W, pairs, 1 << 30);
    PlaneFill<KW, kT>(g, it, C, H, W, pairs, threadIdx.x).run(gpl, H, W, pairs, 1 << 30);
    cp_async_wait_all();
    fence_proxy_async();  // the copies, before wgmma reads them
    __syncthreads();

    // rows 18 .. 18 + live - 1: the item's images and the gap after each
    const int live = it.n * (H + kPad), ks = (live - kPad + 15) / 16;
    float* out = partial + (size_t)item * kSlots;
    dw_products<KW, kT>(acc0[0], acc1[0], xbase, gbase, i0, ks);

    // d(bias)'s share while the first products run: the g plane's 16-byte
    // rows of 8 columns, a thread's in order, then a fixed tree
    {
      float s = 0.f;
      const int units = (KW / 8) * live;
      for (int u = threadIdx.x; u < units; u += kDwThreads) {
        const int k = u / live, r = u - k * live;
        const uint4 v = *reinterpret_cast<const uint4*>(gpl + (k * S::kPitch + kPad + r) * 16);
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w4[e]);
          s += __low2float(h) + __high2float(h);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp] = s;
      __syncthreads();
      if (threadIdx.x == 0) {
        float b = 0.f;
#pragma unroll
        for (int k = 0; k < kDwThreads / 32; ++k) b += red[k];
        out[kTaps * kTaps] = b;
      }
    }

    // kernel rows i0 .. i0 + 18 in pairs: the products of the next row run
    // while the band of this one is summed
#pragma unroll 1
    for (int p = 0; p < kRowsPerWg / 2; ++p) {
      const int i = i0 + 2 * p;
      dw_products<KW, kT>(acc0[1], acc1[1], xbase, gbase, i + 1, ks);
      wgmma_wait<1>();
      dw_diagonals<KW>(acc0[0], acc1[0], q + (i & 1) * D::kQFloats,
                       wg == 1 && p == 0 ? nullptr : out + i * kTaps, W, wg);
      dw_products<KW, kT>(acc0[0], acc1[0], xbase, gbase, i + 2, ks);
      wgmma_wait<1>();
      dw_diagonals<KW>(acc0[1], acc1[1], q + ((i + 1) & 1) * D::kQFloats, out + (i + 1) * kTaps,
                       W, wg);
    }
    wgmma_wait<0>();
    dw_diagonals<KW>(acc0[0], acc1[0], q + ((i0 + kRowsPerWg - 1) & 1) * D::kQFloats,
                     out + (i0 + kRowsPerWg - 1) * kTaps, W, wg);
  }
}

// A block: channel blockIdx.x of image blockIdx.y. Thread t < 185 holds taps
// j0 .. j0 + 7 of kernel row i (i = t % 37, j0 = 8 (t / 37); taps past 36
// are computed and dropped); threads 0..31 sum row t of each g tile.
constexpr int kDwGroups = (kTaps + 7) / 8;  // 8-tap groups of a kernel row

template <typename T>
__global__ void __launch_bounds__(kDirectThreads)
    dad_peg_conv_depthwise2d_dw_direct(const T* __restrict__ x, const T* __restrict__ g,
                                       float* __restrict__ partial, int C, int H, int W) {
  // x's halo; the windows of the dropped taps read up to 3 floats past it
  __shared__ float s_in[kHalo * kHaloPitch + 4];
  __shared__ float s_g[kTile * kTile];
  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const long base = ((long)b * C + c) * H * W;
  const int i = t % kTaps, j0 = 8 * (t / kTaps);
  const bool task = t < kTaps * kDwGroups;
  // the pad column and the tail are read for dropped taps alone: zeros
  if (t < kHalo) s_in[t * kHaloPitch + kHalo] = 0.f;
  if (t < 4) s_in[kHalo * kHaloPitch + t] = 0.f;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float bsum = 0.f;
  const int tiles_x = (W + kTile - 1) / kTile, tiles = tiles_x * ((H + kTile - 1) / kTile);
  for (int tile = 0; tile < tiles; ++tile) {
    const int x0 = (tile % tiles_x) * kTile, y0 = (tile / tiles_x) * kTile;
    __syncthreads();  // the last tile's readers are done
    for (int k = t; k < kHalo * kHalo; k += kDirectThreads) {
      const int r = k / kHalo, cc = k - r * kHalo;
      const int yy = y0 + r - kPad, xx = x0 + cc - kPad;
      s_in[r * kHaloPitch + cc] =
          (yy >= 0 && yy < H && xx >= 0 && xx < W) ? to_float(x[base + (long)yy * W + xx]) : 0.f;
    }
    for (int k = t; k < kTile * kTile; k += kDirectThreads) {
      const int yy = y0 + k / kTile, xx = x0 + k % kTile;
      s_g[k] = (yy < H && xx < W) ? to_float(g[base + (long)yy * W + xx]) : 0.f;
    }
    __syncthreads();
    if (t < kTile)
      for (int k = 0; k < kTile; ++k) bsum += s_g[t * kTile + k];
    if (!task) continue;
#pragma unroll 1
    for (int ty = 0; ty < kTile; ++ty) {
      const float* row = s_in + (ty + i) * kHaloPitch + j0;
      float r[kTile + 7];
#pragma unroll
      for (int k = 0; k < kTile + 7; ++k) r[k] = row[k];
#pragma unroll
      for (int tx = 0; tx < kTile; ++tx) {
        const float gv = s_g[ty * kTile + tx];
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[m] = fmaf(gv, r[tx + m], acc[m]);
      }
    }
  }
  float* out = partial + ((size_t)c * gridDim.y + b) * kSlots;
  if (task)
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (j0 + m < kTaps) out[i * kTaps + j0 + m] = acc[m];
  if (t < 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) bsum += __shfl_xor_sync(0xffffffffu, bsum, off);
    if (t == 0) out[kTaps * kTaps] = bsum;
  }
}

// d(weight) [C, 37 * 37] and d(bias) [C] (either null: not written): the sum
// of each channel's `chunks` partials in order, rounded once.
template <typename T>
__global__ void __launch_bounds__(256)
    dad_peg_conv_depthwise2d_dw_reduce(const float* __restrict__ partial, T* __restrict__ dw,
                                       T* __restrict__ db, int C, int chunks) {
  const long k = (long)blockIdx.x * 256 + threadIdx.x;
  if (k >= (long)C * kSlots) return;
  const int c = (int)(k / kSlots), s = (int)(k - (long)c * kSlots);
  const float* p = partial + (size_t)c * chunks * kSlots + s;
  float v = 0.f;
  for (int q = 0; q < chunks; ++q) v += p[(size_t)q * kSlots];
  if (s < kTaps * kTaps) {
    if (dw != nullptr) dw[(long)c * kTaps * kTaps + s] = from_float<T>(v);
  } else if (db != nullptr) {
    db[c] = from_float<T>(v);
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

// An item's tiling: kT tiles a consumer warpgroup, nb images an item,
// per_channel items a channel (kt 0: none fits).
struct Tiling {
  int kt, nb, per_channel;
};

// kT with the fewest tile rows a channel (ties: the larger, fewer items),
// then the images spread evenly over the channel's items.
Tiling tiling_of(int batch, int H) {
  Tiling tl{0, 0, 0};
  int best_rows = 0;
  for (int kt = 3; kt >= 1; --kt) {
    const int nb = images_per_item(H, kt);
    if (nb == 0) continue;
    const int q = (batch + nb - 1) / nb;
    if (tl.kt == 0 || q * 2 * kt < best_rows) tl.kt = kt, best_rows = q * 2 * kt, tl.per_channel = q;
  }
  if (tl.kt != 0) tl.nb = (batch + tl.per_channel - 1) / tl.per_channel;
  return tl;
}

template <int KW>
int launch_bf16(const void* x, const void* w, const void* bias, void* out, int batch, int C,
                int H, int W, bool pairs, cudaStream_t st) {
  const Tiling tl = tiling_of(batch, H);
  const int nb = tl.nb, per_channel = tl.per_channel;
  switch (tl.kt) {
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

// d(weight) takes the wgmma kernel where the forward does.
bool dw_on_tensor_cores(int H, int W, int dtype) { return dtype == 0 && W <= kMaxW && H <= kMaxH; }

// The partials a channel's d(weight) writes: one an item, or one an image.
int dw_chunks(int batch, int H, int W, int dtype) {
  return dw_on_tensor_cores(H, W, dtype) ? tiling_of(batch, H).per_channel : batch;
}

template <int KW, int kT>
int launch_dw_wgmma(const void* x, const void* g, float* partial, int batch, int C, int H, int W,
                    Tiling tl, bool pairs, cudaStream_t st) {
  using D = DwShape<KW, kT>;
  auto kernel = dad_peg_conv_depthwise2d_dw_wgmma<KW, kT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)D::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long items = (long)C * tl.per_channel;
  if (items > 0x7fffffff) return -1;
  const int grid = (int)(items < sm_count() ? items : sm_count());
  kernel<<<grid, kDwThreads, D::kSmem, st>>>(static_cast<const bf16*>(x),
                                              static_cast<const bf16*>(g), partial, batch, C, H,
                                              W, tl.nb, tl.per_channel, pairs ? 1 : 0);
  return (int)cudaGetLastError();
}

template <int KW>
int launch_dw_bf16(const void* x, const void* g, float* partial, int batch, int C, int H, int W,
                   bool pairs, cudaStream_t st) {
  const Tiling tl = tiling_of(batch, H);
  switch (tl.kt) {
    case 3: return launch_dw_wgmma<KW, 3>(x, g, partial, batch, C, H, W, tl, pairs, st);
    case 2: return launch_dw_wgmma<KW, 2>(x, g, partial, batch, C, H, W, tl, pairs, st);
    case 1: return launch_dw_wgmma<KW, 1>(x, g, partial, batch, C, H, W, tl, pairs, st);
    default: return -1;
  }
}

template <typename T>
int launch_dw_direct(const void* x, const void* g, float* partial, int batch, int C, int H,
                     int W, cudaStream_t st) {
  if (batch > 65535) return -1;
  dad_peg_conv_depthwise2d_dw_direct<T><<<dim3(C, batch), kDirectThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, C, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw_reduce(const float* partial, void* dw, void* db, int C, int chunks,
                     cudaStream_t st) {
  const long blocks = ((long)C * kSlots + 255) / 256;
  if (blocks > 0x7fffffff) return -1;
  dad_peg_conv_depthwise2d_dw_reduce<T><<<(unsigned)blocks, 256, 0, st>>>(
      partial, static_cast<T*>(dw), static_cast<T*>(db), C, chunks);
  return (int)cudaGetLastError();
}

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

// The bytes of fp32 scratch dad_peg_conv_bwd needs for d(weight) and d(bias):
// 37 * 37 + 1 floats for each of a channel's items (or images).
extern "C" long long dad_peg_conv_bwd_scratch(int batch, int C, int H, int W, int dtype) {
  if (batch <= 0 || C <= 0 || H <= 0 || W <= 0) return 0;
  return (long long)C * dw_chunks(batch, H, W, dtype) * kSlots * 4;
}

// The gradients of out = dwconv37(x) + bias + x for the cotangent g: g, x,
// dx [B, C, H, W] contiguous; w_flipped [C, 37 * 37] the kernel flipped in
// both axes and zero_bias [C] zeros (read for dx alone); dw [C, 37 * 37],
// db [C]; all of one dtype (0 bf16, 1 fp32); scratch of
// dad_peg_conv_bwd_scratch's bytes (read for dw and db alone). dx, dw or db
// null: not computed. dx = dwconv37(g, w_flipped) + g by the forward's
// kernels; dw and db by one partial pass and one reduction. Returns the
// first failing launch's CUDA error, -1 for arguments the kernels do not
// take.
extern "C" int dad_peg_conv_bwd(const void* g, const void* x, const void* w_flipped,
                                const void* zero_bias, void* dx, void* dw, void* db,
                                void* scratch, int batch, int C, int H, int W, int dtype,
                                void* stream) {
  if (batch < 0 || C < 0 || H <= 0 || W <= 0 || (dtype != 0 && dtype != 1)) return -1;
  if (batch == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dx != nullptr) {
    if (int err = dad_peg_conv_fwd(g, w_flipped, zero_bias, dx, batch, C, H, W, dtype, stream))
      return err;
  }
  if (dw == nullptr && db == nullptr) return 0;
  float* partial = static_cast<float*>(scratch);
  int err;
  if (dtype == 1) {
    err = launch_dw_direct<float>(x, g, partial, batch, C, H, W, st);
  } else if (!dw_on_tensor_cores(H, W, dtype)) {
    err = launch_dw_direct<bf16>(x, g, partial, batch, C, H, W, st);
  } else {
    const bool pairs = W % 2 == 0 && aligned4(x) && aligned4(g);
    err = W <= 48 ? launch_dw_bf16<48>(x, g, partial, batch, C, H, W, pairs, st)
                  : launch_dw_bf16<80>(x, g, partial, batch, C, H, W, pairs, st);
  }
  if (err) return err;
  const int chunks = dw_chunks(batch, H, W, dtype);
  return dtype == 1 ? launch_dw_reduce<float>(partial, dw, db, C, chunks, st)
                    : launch_dw_reduce<bf16>(partial, dw, db, C, chunks, st);
}
