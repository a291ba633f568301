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
// C is 64, 128, 256 or 384 (the DPT features of ViT-S, B, L and g).
//
// Launch 1 (conv1): 2x upsample + conv1 + b1 -> v [B,2ht,2wt,C/2] in the
//   input type (the plain version rounds v there too).
// Launch 2 (head): resize to (oh,ow) + conv2 + b2 + ReLU + 1x1 + bd [+ ReLU]
//   -> depth. The 32-channel conv2 output, the largest intermediate, never
//   leaves the chip.
//
// Bound: the convs' products on the tensor cores. At the ViT-B 392^2 bs8
// shape (t [8,112,112,128]) conv1 59.2 GFLOP + conv2 45.3 GFLOP is ~106 us
// at 989 TFLOP/s; at the ViT-L teacher's 1036^2 bs8 chunk (t [8,296,296,256])
// 1.654 + 0.633 TFLOP, 2.31 ms; at ViT-g's 518^2 bs8 (t [8,148,148,384])
// 0.930 + 0.237 TFLOP, 1.18 ms. The bytes (one read of t, the depth write)
// are a tenth of that, and the v round trip between the launches (~0.43 ms
// of bytes at 1036^2) stays under the compute bound.
//
// bf16 design, one kernel body for both launches: each conv is an implicit
// GEMM (M = output pixels, N = C_out, K = 9 taps x C_in) on wgmma with fp32
// accumulators, in a persistent grid (one block per SM walks output tiles of
// 2 kMT rows x 64 columns; kMT is 4 for C_out 32 and 64, 2 for 128 and 1 for
// ViT-g's 192, so that a consumer's kMT x C_out / 2 accumulators stay within
// its registers). The block's warps:
//   - warps 0-7, two consumer warpgroups, own kMT output rows of 64 pixels
//     each. wgmma reads A by descriptor straight from the halo (the resized
//     input over the tile and its one-pixel conv border, one 64-channel
//     chunk at a time, double-buffered), stored channel-group-major ([8
//     channel groups][pixels][8 channels], no swizzle: a core matrix is 8
//     neighbouring pixels x 16 bytes), so a tap's (dy, dx) shift is a
//     16-byte-aligned move of the start address and no copy; a channel
//     group's pixel pitch is 1 mod 8, so 16-byte stores of eight channel
//     groups hit distinct banks. (The register form, ldmatrix into A
//     fragments, would cost the consumers an ldmatrix per k-step and
//     registers beside their accumulators.) B is read by descriptor from a
//     weight stage. Per (chunk, tap): kMT x 4 wgmma m64nC_outk16 and one
//     commit; the previous stage (and, at a chunk's first tap, the previous
//     halo buffer) is released once its products are done. The epilogue
//     runs in registers: conv1 adds b1 and stores v; the head adds b2,
//     applies the ReLU, reduces the 32 -> 1 head over the quad of lanes that
//     hold a pixel's channels, adds bd [and the ReLU] and stores the depth.
//   - lane 0 of warp 8 brings the weights by TMA (a 2-D map, 128-byte
//     swizzle) through a 3-4 stage mbarrier ring, one stage per (chunk,
//     tap): a [C_out x 64] K-major B tile. The wrapper packs the HWIO weights
//     once into that [C_out, chunks x 9 x 64] order
//     (ops/dpt_tail.pack_conv_weight, cached per weight version by the DPT
//     head). Every block streams the same few hundred KB, which stay in L2.
//   - the other warps (7, or 11 where the consumers hold only 64
//     accumulators) fill the next chunk's halo while the consumers multiply
//     the current one. One TMA box (a 4-D map over the source, 128-byte
//     swizzled) brings the tile's source patch (up to kPR x kPC pixels x 64
//     channels) to shared memory; then each filler walks one (halo column,
//     channel group) down the tile, blending each source row's two column
//     taps once and each halo row's two source rows, in fp32 and in
//     PyTorch's order with its align_corners taps. A head whose source step
//     exceeds the patch's (not a DPT grid) gathers each piece from device
//     memory instead.
// setmaxnreg gives the consumers 160 registers where they hold 96 or 128
// accumulators. Measured on an H100 (PERF.md): the fill, not the products,
// sets the pace; the consumers wait on it a fifth to a third of their time.
// At C_out 192 (conv1 of ViT-g, one wgmma m64n192k16 per row and k-step) a
// tile is 2 x 64 pixels: kMT = 2 would need 192 accumulators a consumer
// thread, and splitting C_out between the warpgroups over the same 4 rows
// would too; fewer fill warps for more consumer registers would slow the
// fill, which sets the pace. So the halo is 4 rows for 2 output rows, 1.33x
// the halo per output pixel of the 4-row tiles.
// Two calls give the same bits: every output is summed in one fixed order.
// fp32 keeps the scalar-FMA kernels (8x16 tiles whose halo is built in
// shared memory, weights as a plain [9*C_in, C_out] matrix); at C = 384 the
// halo is staged 128 channels at a time and the output channels are split
// over two blocks (F32Conv1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"

namespace {

using namespace dad_hopper;
using bf16 = __nv_bfloat16;

constexpr int kC2 = 32;  // conv2 output channels

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  u.x = pack_bf16(f[0], f[1]);
  u.y = pack_bf16(f[2], f[3]);
  u.z = pack_bf16(f[4], f[5]);
  u.w = pack_bf16(f[6], f[7]);
  return u;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

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

// Channels c..c+7 of src [hs, ws, CIN] resized to (ho, wo) at (oy, ox); zeros
// outside [0,ho)x[0,wo) (the conv's padding) and past CIN.
template <int CIN>
__device__ __forceinline__ void resized8(float (&r)[8], const float* src, int hs, int ws, int ho,
                                         int wo, float sh, float sw, int oy, int ox, int c) {
  if (oy < 0 || oy >= ho || ox < 0 || ox >= wo || c >= CIN) {
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = 0.f;
    return;
  }
  const Tap ty = bilinear_tap(sh, oy, hs), tx = bilinear_tap(sw, ox, ws);
  float a[8], b[8], cc[8], d[8];
  load8(src + ((long)ty.i0 * ws + tx.i0) * CIN + c, a);
  load8(src + ((long)ty.i0 * ws + tx.i1) * CIN + c, b);
  load8(src + ((long)ty.i1 * ws + tx.i0) * CIN + c, cc);
  load8(src + ((long)ty.i1 * ws + tx.i1) * CIN + c, d);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r[k] = ty.l0 * (tx.l0 * a[k] + tx.l1 * b[k]) + ty.l1 * (tx.l0 * cc[k] + tx.l1 * d[k]);
}

// ------------------------------------------------------------------ bf16: wgmma

template <int CIN, int COUT, bool kHead>
struct Shape {
  static constexpr int kCinP = CIN < 64 ? 64 : CIN;  // channels in 64-wide chunks
  static constexpr int kChunks = kCinP / 64;
  // output rows per consumer warpgroup: the rows' accumulators (kMT x COUT
  // / 2 a thread) stay within the consumers' registers
  static constexpr int kMT = COUT > 128 ? 1 : COUT == 128 ? 2 : 4;
  static constexpr int kTH = 2 * kMT, kTW = 64;      // output tile
  static constexpr int kHC = kTW + 2;                // halo columns
  static constexpr int kNPix = (kTH + 2) * kHC;      // halo pixels
  static constexpr int kPitch = kNPix + (9 - kNPix % 8) % 8;  // pixels a channel group, 1 mod 8
  static constexpr int kHaloBytes = 8 * kPitch * 16;  // one 64-channel chunk
  static constexpr int kItems = 8 * kNPix;            // 16-byte pieces of a chunk's halo
  static constexpr int kWBytes = COUT * 128;          // one stage: COUT rows of 64 bf16
  static constexpr int kStages = COUT == 64 ? 3 : 4;
  static constexpr int kSteps = kChunks * 9;          // (chunk, tap) steps a tile
  // The source patch behind a chunk's halo, staged in shared memory: conv1
  // upsamples 2x (source step < 0.5 a pixel); the head's patch is sized for
  // a step up to 0.58 (4 x 14 / 2 / 14 = 4/7: the DPT grids), and a head
  // with a larger step gathers from device memory instead.
  static constexpr int kPR = (kTH + 1) * (kHead ? 58 : 50) / 100 + 3;  // rows
  static constexpr int kPC = (kTW + 1) * (kHead ? 58 : 50) / 100 + 3;  // columns
  static constexpr int kPatchBytes = kPR * kPC * 128;
  static constexpr size_t kSmem = 1024 /* alignment */ + kStages * kWBytes + 2 * kHaloBytes +
                                  kPatchBytes + (2 * kStages + 5) * 8 +
                                  (kTH + 2) * 16;
  // Registers: the consumers hold kMT x COUT / 2 fp32 accumulators. With 64
  // (COUT 32), 20 warps fit at 96 registers each: 11 fill warps. With 96
  // (COUT 192) or 128, setmaxnreg gives the consumers 160 and the other 8
  // warps 96.
  static constexpr bool kWide = kMT * COUT / 2 > 64;
  static constexpr int kThreads = kWide ? 512 : 640;
  static constexpr int kFillers = kThreads - 256 - 32;  // the fill warps' threads
  static constexpr int kConsumerRegs = 160;
  static constexpr int kFillRegs = (65536 / 256 - kConsumerRegs) / 8 * 8;
  static_assert(kPitch % 8 == 1, "pitch");
  static_assert(kSmem <= 232448, "shared memory");
};

constexpr int kConsumers = 256;  // warps 0-7: two warpgroups
constexpr int kPerFill = 2;      // halo pieces a filler has in flight

// The four source pixels' 8 channels behind one halo piece, and its weights.
struct Gather {
  uint4 v[4];
  float ly, lx;  // the second taps' weights
  bool live;     // inside the image and below CIN
};

template <int CIN>
__device__ __forceinline__ void gather(Gather& gt, const bf16* src, int hs, int ws, int ho, int wo,
                                       float sh, float sw, int oy, int ox, int c) {
  gt.live = oy >= 0 && oy < ho && ox >= 0 && ox < wo && c < CIN;
  if (!gt.live) return;
  const Tap ty = bilinear_tap(sh, oy, hs), tx = bilinear_tap(sw, ox, ws);
  gt.ly = ty.l1;
  gt.lx = tx.l1;
  const bf16* r0 = src + (long)ty.i0 * ws * CIN + c;
  const bf16* r1 = src + (long)ty.i1 * ws * CIN + c;
  gt.v[0] = __ldg(reinterpret_cast<const uint4*>(r0 + tx.i0 * CIN));
  gt.v[1] = __ldg(reinterpret_cast<const uint4*>(r0 + tx.i1 * CIN));
  gt.v[2] = __ldg(reinterpret_cast<const uint4*>(r1 + tx.i0 * CIN));
  gt.v[3] = __ldg(reinterpret_cast<const uint4*>(r1 + tx.i1 * CIN));
}

// The bilinear value of a gathered piece in fp32, as resized8, packed to bf16.
__device__ __forceinline__ uint4 blend(const Gather& gt) {
  if (!gt.live) return uint4{0u, 0u, 0u, 0u};
  float f[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&gt.v[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(h[j]);
      f[i][2 * j] = x.x;
      f[i][2 * j + 1] = x.y;
    }
  }
  const float ly1 = gt.ly, ly0 = 1.f - ly1, lx1 = gt.lx, lx0 = 1.f - lx1;
  float r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r[k] = ly0 * (lx0 * f[0][k] + lx1 * f[1][k]) + ly1 * (lx0 * f[2][k] + lx1 * f[3][k]);
  return pack8(r);
}

// The box of a 4-D map at (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 16 bytes from or to shared memory at a shared-window address.
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// The blend of patch columns cx0 and cx1 at row r, channel group c8 (a
// patch pixel q's groups sit swizzled by q % 8), in fp32.
template <int kPC>
__device__ __forceinline__ void horizontal(float (&h)[8], uint32_t patch, int r, int cx0,
                                           int cx1, float l0, float l1, int c8) {
  const int q0 = r * kPC + cx0, q1 = r * kPC + cx1;
  const uint4 a = lds128(patch + q0 * 128 + ((c8 ^ (q0 & 7)) << 4));
  const uint4 b = lds128(patch + q1 * 128 + ((c8 ^ (q1 & 7)) << 4));
  const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(ha[j]), y = __bfloat1622float2(hb[j]);
    h[2 * j] = l0 * x.x + l1 * y.x;
    h[2 * j + 1] = l0 * x.y + l1 * y.y;
  }
}

// A halo row's bilinear tap in patch rows: r0 (-1: the conv's padding row)
// and r0 + step (step 0 at the image's last row), weights l0 and l1.
struct RowTap {
  int r0, step;
  float l0, l1;
};

// A chunk's halo (piece = 8 channels of one halo pixel) by the fillers.
// Where the tile's source patch fits, it is first brought to shared memory
// by one TMA box, and each filler interpolates a halo column's channel group
// from there. Otherwise each piece gathers its four source pixels from
// device memory, kPerFill pieces a thread at a time.
template <int CIN, int COUT, bool kHead>
__device__ __forceinline__ void fill_chunk(uint8_t* hb, uint8_t* patch, RowTap* rows,
                                           const CUtensorMap* src_map, uint64_t* pfull,
                                           int& npatch, const bf16* src, int b,
                                           int hs, int ws, int ho, int wo, float sh, float sw,
                                           int y0, int x0, int cc, int ft) {
  using S = Shape<CIN, COUT, kHead>;
  // the source rows and columns behind the halo's pixels inside the image
  const int oy0 = max(y0 - 1, 0), oy1 = min(y0 + S::kTH, ho - 1);
  const int ox0 = max(x0 - 1, 0), ox1 = min(x0 + S::kTW, wo - 1);
  const int ry0 = bilinear_tap(sh, oy0, hs).i0, ry1 = bilinear_tap(sh, oy1, hs).i1;
  const int rx0 = bilinear_tap(sw, ox0, ws).i0, rx1 = bilinear_tap(sw, ox1, ws).i1;
  const int pr = ry1 - ry0 + 1, pc = rx1 - rx0 + 1;
  if (pr <= S::kPR && pc <= S::kPC) {
    const int c0 = cc * 64;
    bar_sync(1, S::kFillers);  // every filler is done with the last patch
    if (ft == 0) {
      // the box of kPR rows x kPC columns x 64 channels at (ry0, rx0, c0),
      // 128-byte swizzled: patch pixel q's channel group g sits at g ^ (q % 8)
      mbar_arrive_expect_tx(pfull, S::kPatchBytes);
      tma_load_4d(patch, src_map, pfull, c0, rx0, ry0, b);
    }
    if (ft < S::kTH + 2) {
      // the halo rows' taps, shared by every (column, channel group)
      const int oy = y0 - 1 + ft;
      RowTap rt{-1, 0, 0.f, 0.f};
      if (oy >= 0 && oy < ho) {
        const Tap ty = bilinear_tap(sh, oy, hs);
        rt = RowTap{ty.i0 - ry0, ty.i1 - ty.i0, ty.l0, ty.l1};
      }
      rows[ft] = rt;
    }
    mbar_wait(pfull, npatch & 1);
    ++npatch;
    bar_sync(1, S::kFillers);
    const uint32_t spatch = smem_u32(patch), shb = smem_u32(hb);
    // a thread a (halo column, channel group): down the column, each source
    // row's blend of the column's two taps once, then each halo row's blend
    // of its two source rows, in PyTorch's order
    for (int u = ft; u < S::kHC * 8; u += S::kFillers) {
      const int c8 = u & 7, hx = u >> 3, ox = x0 - 1 + hx;
      const bool live_col = ox >= 0 && ox < wo && c0 + c8 * 8 < CIN;
      const Tap tx = bilinear_tap(sw, live_col ? ox : 0, ws);
      const int cx0 = tx.i0 - rx0, cx1 = tx.i1 - rx0;
      int have = -2;  // h0: the source row `have`'s blend, h1: row have + 1's
      float h0[8], h1[8];
#pragma unroll
      for (int hy = 0; hy < S::kTH + 2; ++hy) {
        const RowTap ty = rows[hy];
        uint4 piece = uint4{0u, 0u, 0u, 0u};
        if (live_col && ty.r0 >= 0) {
          const int r0 = ty.r0;
          if (r0 != have) {
            if (r0 == have + 1) {
#pragma unroll
              for (int e = 0; e < 8; ++e) h0[e] = h1[e];
            } else {
              horizontal<S::kPC>(h0, spatch, r0, cx0, cx1, tx.l0, tx.l1, c8);
            }
            have = r0;
            if (ty.step) horizontal<S::kPC>(h1, spatch, r0 + 1, cx0, cx1, tx.l0, tx.l1, c8);
          }
          float r[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            r[e] = ty.l0 * h0[e] + ty.l1 * (ty.step ? h1[e] : h0[e]);
          piece = pack8(r);
        }
        sts128(shb + (c8 * S::kPitch + hy * S::kHC + hx) * 16, piece);
      }
    }
    return;
  }
  for (int base = 0; base < S::kItems; base += S::kFillers * kPerFill) {
    Gather gt[kPerFill];
#pragma unroll
    for (int p = 0; p < kPerFill; ++p) {
      const int it = base + p * S::kFillers + ft;
      const int c8 = it & 7, pix = it >> 3, hy = pix / S::kHC, hx = pix - hy * S::kHC;
      gather<CIN>(gt[p], src, hs, ws, ho, wo, sh, sw, it < S::kItems ? y0 - 1 + hy : -1,
                  x0 - 1 + hx, cc * 64 + c8 * 8);
    }
#pragma unroll
    for (int p = 0; p < kPerFill; ++p) {
      const int it = base + p * S::kFillers + ft;
      if (it < S::kItems)
        *reinterpret_cast<uint4*>(hb + ((it & 7) * S::kPitch + (it >> 3)) * 16) = blend(gt[p]);
    }
  }
}

// One conv of the tail on src [batch, hs, ws, CIN] resized to (ho, wo):
// conv1 (kHead false) writes out = v [batch, ho, wo, COUT]; the head (kHead
// true, COUT 32) writes out = depth [batch, ho, wo].
template <int CIN, int COUT, bool kHead>
__global__ void __launch_bounds__((Shape<CIN, COUT, kHead>::kThreads), 1)
    tail_conv_wgmma(const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap src_map, const bf16* __restrict__ src,
                    const float* __restrict__ bias, const float* __restrict__ kd,
                    const float* __restrict__ bd, bf16* __restrict__ out, int batch, int hs,
                    int ws, int ho, int wo, int relu_out) {
  using S = Shape<CIN, COUT, kHead>;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* wst = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* patch = wst + S::kStages * S::kWBytes;  // 1024-byte aligned, for the swizzle
  uint8_t* halo = patch + S::kPatchBytes;
  uint64_t* wfull = reinterpret_cast<uint64_t*>(halo + 2 * S::kHaloBytes);
  uint64_t* wempty = wfull + S::kStages;
  uint64_t* hfull = wempty + S::kStages;
  uint64_t* hempty = hfull + 2;
  uint64_t* pfull = hempty + 2;
  RowTap* rows = reinterpret_cast<RowTap*>(pfull + 1);

  const int tiles_x = (wo + S::kTW - 1) / S::kTW, tiles_y = (ho + S::kTH - 1) / S::kTH;
  const int ntiles = tiles_x * tiles_y * batch;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], 8);  // one arrival per consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&hfull[b], S::kFillers);
      mbar_init(&hempty[b], 8);
    }
    mbar_init(pfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= kConsumers / 32) {
    if constexpr (S::kWide) setmaxnreg_dec<S::kFillRegs>();
    if (warp == kConsumers / 32) {
      // ---- the weights: one stage per (chunk, tap), the same every tile
      if (lane == 0) {
        int q = 0;
        for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
          for (int step = 0; step < S::kSteps; ++step, ++q) {
            const int st = q % S::kStages, round = q / S::kStages;
            if (round > 0) mbar_wait(&wempty[st], (round - 1) & 1);
            mbar_arrive_expect_tx(&wfull[st], S::kWBytes);
            tma_load_2d(wst + st * S::kWBytes, &w_map, &wfull[st], step * 64, 0);
          }
        }
      }
      return;
    }
    // ---- the halo: chunk by chunk into the double buffer
    const int ft = threadIdx.x - kConsumers - 32;
    const float sh = ac_scale(hs, ho), sw = ac_scale(ws, wo);
    int h = 0, npatch = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int tx = tile % tiles_x, rest = tile / tiles_x;
      const int y0 = (rest % tiles_y) * S::kTH, x0 = tx * S::kTW, b = rest / tiles_y;
      const bf16* sb = src + (long)b * hs * ws * CIN;
      for (int cc = 0; cc < S::kChunks; ++cc, ++h) {
        const int buf = h & 1;
        if (h >= 2) mbar_wait(&hempty[buf], ((h >> 1) - 1) & 1);
        fill_chunk<CIN, COUT, kHead>(halo + buf * S::kHaloBytes, patch, rows, &src_map, pfull,
                                     npatch, sb, b, hs, ws, ho, wo, sh, sw, y0, x0, cc, ft);
        fence_proxy_async();  // the stores, before wgmma reads them
        mbar_arrive(&hfull[buf]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns tile rows w*kMT .. w*kMT + kMT - 1
  if constexpr (S::kWide) setmaxnreg_inc<S::kConsumerRegs>();
  const int w = warp / 4, wi = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  float acc[S::kMT][COUT / 2];
  int q = 0, h = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int tx = tile % tiles_x, rest = tile / tiles_x;
    const int y0 = (rest % tiles_y) * S::kTH, x0 = tx * S::kTW, b = rest / tiles_y;
    for (int cc = 0; cc < S::kChunks; ++cc, ++h) {
      const int buf = h & 1;
      mbar_wait(&hfull[buf], (h >> 1) & 1);
      const uint32_t hbase = smem_u32(halo + buf * S::kHaloBytes);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++q) {
        const int st = q % S::kStages;
        mbar_wait(&wfull[st], (q / S::kStages) & 1);
        const int dy = tap / 3, dx = tap % 3;
        const uint64_t bdesc = desc_sw128(wst + st * S::kWBytes);
#pragma unroll
        for (int r = 0; r < S::kMT; ++r) fence_regs(acc[r]);
        wgmma_fence();
#pragma unroll
        for (int r = 0; r < S::kMT; ++r) {
          const int pix = (w * S::kMT + r + dy) * S::kHC + dx;
          const uint64_t adesc = desc_plain(hbase + pix * 16, S::kPitch * 16, 128);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<COUT>(acc[r], adesc + 2 * kk * S::kPitch, bdesc + 2 * kk,
                           (cc | tap | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: release its buffers
#pragma unroll
        for (int r = 0; r < S::kMT; ++r) fence_regs(acc[r]);
        if ((cc | tap) != 0 && lane == 0) {
          mbar_arrive(&wempty[(q - 1) % S::kStages]);
          if (tap == 0) mbar_arrive(&hempty[(h - 1) & 1]);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < S::kMT; ++r) fence_regs(acc[r]);
    if (lane == 0) {
      mbar_arrive(&wempty[(q - 1) % S::kStages]);
      mbar_arrive(&hempty[(h - 1) & 1]);
    }

    // ---- epilogue: (warp wi, lane 4g + t) holds pixels x0 + 16wi + g (+8)
    // of row r, channels 8j + 2t (+1)
#pragma unroll
    for (int r = 0; r < S::kMT; ++r) {
      const int oy = y0 + w * S::kMT + r;
      if constexpr (!kHead) {
        if (oy >= ho) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ox = x0 + 16 * wi + g + 8 * half;
          if (ox >= wo) continue;
          bf16* dst = out + (((long)b * ho + oy) * wo + ox) * COUT;
#pragma unroll
          for (int j = 0; j < COUT / 8; ++j) {
            const int c = 8 * j + 2 * t;
            *reinterpret_cast<uint32_t*>(dst + c) =
                pack_bf16(acc[r][4 * j + 2 * half] + __ldg(bias + c),
                          acc[r][4 * j + 2 * half + 1] + __ldg(bias + c + 1));
          }
        }
      } else {
        float dsum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1);
            const float z = fmaxf(acc[r][4 * j + e] + __ldg(bias + c), 0.f);
            dsum[e >> 1] = fmaf(z, __ldg(kd + c), dsum[e >> 1]);
          }
        const float bias_d = __ldg(bd);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float s = dsum[half];
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          const int ox = x0 + 16 * wi + g + 8 * half;
          if (t == 0 && oy < ho && ox < wo) {
            float d = s + bias_d;
            if (relu_out) d = fmaxf(d, 0.f);
            out[((long)b * ho + oy) * wo + ox] = __float2bfloat16_rn(d);
          }
        }
      }
    }
  }
}

// src [batch, hs, ws, cin] bf16 in boxes of 64 channels x box_c columns x
// box_r rows of one image, 128-byte swizzled; elements past an edge read as
// zeros (the interpolation never uses them).
int make_patch_map(CUtensorMap* map, const void* src, int batch, int hs, int ws, int cin,
                   int box_c, int box_r) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  if (int err = tensor_map_encoder(&encode)) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)cin, (cuuint64_t)ws, (cuuint64_t)hs, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)ws * cin * 2,
                                 (cuuint64_t)hs * ws * cin * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_c, (cuuint32_t)box_r, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(src), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

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

// w: the packed [COUT, chunks * 9 * 64] bf16 weights (ops/dpt_tail.pack_conv_weight).
template <int CIN, int COUT, bool kHead>
int launch_wgmma(const void* src, const void* w, const float* bias, const float* kd,
                 const float* bd, void* out, int batch, int hs, int ws, int ho, int wo,
                 int relu_out, cudaStream_t st) {
  using S = Shape<CIN, COUT, kHead>;
  CUtensorMap w_map, src_map;
  if (int err = make_map_2d(&w_map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, COUT, S::kSteps * 64,
                            64, COUT))
    return err;
  if (int err = make_patch_map(&src_map, src, batch, hs, ws, CIN, S::kPC, S::kPR)) return err;
  auto kernel = tail_conv_wgmma<CIN, COUT, kHead>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long tiles =
      (long)((wo + S::kTW - 1) / S::kTW) * ((ho + S::kTH - 1) / S::kTH) * batch;
  if (tiles > 0x7fffffff) return -1;
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  kernel<<<grid, S::kThreads, S::kSmem, st>>>(w_map, src_map, static_cast<const bf16*>(src), bias,
                                           kd, bd,
                                           static_cast<bf16*>(out), batch, hs, ws, ho, wo,
                                           relu_out);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ fp32: scalar FMA

constexpr int kTH = 8, kTW = 16;             // output tile
constexpr int kHH = kTH + 2, kHW = kTW + 2;  // with the conv halo
constexpr int kF32Threads = 128;             // 4 warps, 2 tile rows each

// Fill the (kHH x kHW) halo tile, rows of CK + 4 floats, with CK channels of
// src [hs, ws, CIN] (src already offset to the chunk's first channel)
// bilinearly resized to (ho, wo).
template <int CK, int CIN>
__device__ __forceinline__ void fill_halo_f32(float* halo, const float* src, int hs, int ws,
                                              int ho, int wo, int y0, int x0) {
  constexpr int kRow = CK + 4;
  constexpr int kGroups = CK / 8;
  const float sh = ac_scale(hs, ho), sw = ac_scale(ws, wo);
  for (int i = threadIdx.x; i < kHH * kHW * kGroups; i += kF32Threads) {
    int pix = i / kGroups, c8 = (i % kGroups) * 8;
    int hy = pix / kHW, hx = pix % kHW;
    float r[8];
    resized8<CIN>(r, src, hs, ws, ho, wo, sh, sw, y0 - 1 + hy, x0 - 1 + hx, c8);
    store8(halo + pix * kRow + c8, r);
  }
}

// acc[mt][j][e] += the 3x3 conv of a halo tile of CK channels with w, the
// plain [9*CIN, COUT] matrix (k = tap*CIN + ci), offset to the chunk's first
// input channel and the block's first output channel; NB output channels.
// Warp w owns tile rows 2w+mt (mt = 0,1); element e of n-tile j sits at
// column g + 8*(e>>1), channel 8j + 2t + (e&1).
template <int CK, int CIN, int COUT, int NB>
__device__ __forceinline__ void conv3x3_f32(const float* halo, const float* wf,
                                            float (&acc)[2][NB / 8][4]) {
  constexpr int kRow = CK + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll 1
    for (int ci = 0; ci < CK; ++ci) {
      float alo[2], ahi[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* hr = halo + ((2 * warp + mt + dy) * kHW + dx) * kRow + ci;
        alo[mt] = hr[g * kRow];
        ahi[mt] = hr[(g + 8) * kRow];
      }
      const float* wr = wf + (long)(tap * CIN + ci) * COUT + 2 * t;
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
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

// conv1 in fp32. Up to C = 256 a block stages all C channels of its halo at
// once and computes every output channel. At C = 384 the halo (279 KB) would
// not fit in shared memory and 192 output channels would not fit in
// registers: a block stages CK = 128 channels at a time, and the output
// channels are split over NB = 96-wide blocks (blockIdx.z = image x split).
template <int C>
struct F32Conv1 {
  static constexpr int kCK = C > 256 ? 128 : C;     // channels staged at a time
  static constexpr int kNB = C > 256 ? 96 : C / 2;  // output channels a block
  static constexpr int kSplit = C / 2 / kNB;
};

template <int C>
__global__ void __launch_bounds__(kF32Threads)
    tail_conv1_f32(const float* __restrict__ t, const float* __restrict__ w1,
                   const float* __restrict__ b1, float* __restrict__ v, int ht, int wt) {
  using P = F32Conv1<C>;
  constexpr int CM = C / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* halo = reinterpret_cast<float*>(smem);
  const int hu = 2 * ht, wu = 2 * wt;
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH;
  const int b = blockIdx.z / P::kSplit, n0 = (blockIdx.z % P::kSplit) * P::kNB;
  float acc[2][P::kNB / 8][4] = {};
#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += P::kCK) {
    if (c0) __syncthreads();  // every warp is done with the last chunk
    fill_halo_f32<P::kCK, C>(halo, t + (long)b * ht * wt * C + c0, ht, wt, hu, wu, y0, x0);
    __syncthreads();
    conv3x3_f32<P::kCK, C, CM, P::kNB>(halo, w1 + (long)c0 * CM + n0, acc);
  }

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
      float* dst = v + (((long)b * hu + oy) * wu + ox) * CM + n0;
#pragma unroll
      for (int j = 0; j < P::kNB / 8; ++j) {
        const int co = 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(dst + co) =
            make_float2(acc[mt][j][2 * half] + b1[n0 + co], acc[mt][j][2 * half + 1] + b1[n0 + co + 1]);
      }
    }
  }
}

template <int CM>
__global__ void __launch_bounds__(kF32Threads)
    tail_head_f32(const float* __restrict__ v, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ kd,
                  const float* __restrict__ bd, float* __restrict__ out, int hv, int wv, int oh,
                  int ow, int relu_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* halo = reinterpret_cast<float*>(smem);
  const int x0 = blockIdx.x * kTW, y0 = blockIdx.y * kTH, b = blockIdx.z;
  fill_halo_f32<CM, CM>(halo, v + (long)b * hv * wv * CM, hv, wv, oh, ow, y0, x0);
  __syncthreads();

  float acc[2][kC2 / 8][4] = {};
  conv3x3_f32<CM, CM, kC2, kC2>(halo, w2, acc);

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
        out[((long)b * oh + oy) * ow + ox] = d;
      }
    }
}

// a halo tile of CK channels
template <int CK>
size_t halo_bytes_f32() {
  return (size_t)kHH * kHW * (CK + 4) * sizeof(float);
}

template <int C>
int launch_conv1_f32(const void* t, const void* w1, const float* b1, void* v, int batch, int ht,
                     int wt, cudaStream_t st) {
  using P = F32Conv1<C>;
  if ((long)batch * P::kSplit > 65535) return -1;
  const size_t smem = halo_bytes_f32<P::kCK>();
  cudaError_t err = cudaFuncSetAttribute(tail_conv1_f32<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((2 * wt + kTW - 1) / kTW, (2 * ht + kTH - 1) / kTH, batch * P::kSplit);
  tail_conv1_f32<C><<<grid, kF32Threads, smem, st>>>(static_cast<const float*>(t),
                                                     static_cast<const float*>(w1), b1,
                                                     static_cast<float*>(v), ht, wt);
  return (int)cudaGetLastError();
}

template <int CM>
int launch_head_f32(const void* v, const void* w2, const float* b2, const float* kd,
                    const float* bd, void* out, int batch, int hv, int wv, int oh, int ow,
                    int relu_out, cudaStream_t st) {
  const size_t smem = halo_bytes_f32<CM>();
  cudaError_t err = cudaFuncSetAttribute(tail_head_f32<CM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((ow + kTW - 1) / kTW, (oh + kTH - 1) / kTH, batch);
  tail_head_f32<CM><<<grid, kF32Threads, smem, st>>>(
      static_cast<const float*>(v), static_cast<const float*>(w2), b2, kd, bd,
      static_cast<float*>(out), hv, wv, oh, ow, relu_out);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16 (w1, w2 packed by ops/dpt_tail.pack_conv_weight),
// 1 = float32 (w1, w2 the plain [9*C_in, C_out] matrices). Each returns a
// cudaError_t (0 = success), or -1 for an argument the kernels do not take.
extern "C" int dad_tail_conv1(const void* t, const void* w1, const void* b1, void* v, int batch,
                              int ht, int wt, int c, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || ht <= 0 || wt <= 0 || 2 * ht > 8 * 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(b1);
  const int hu = 2 * ht, wu = 2 * wt;
  if (dtype == 0) {
    auto conv1 = [&](auto kernel) {
      return kernel(t, w1, b, nullptr, nullptr, v, batch, ht, wt, hu, wu, 0, st);
    };
    switch (c) {
      case 64: return conv1(launch_wgmma<64, 32, false>);
      case 128: return conv1(launch_wgmma<128, 64, false>);
      case 256: return conv1(launch_wgmma<256, 128, false>);
      case 384: return conv1(launch_wgmma<384, 192, false>);
    }
  } else if (dtype == 1) {
    switch (c) {
      case 64: return launch_conv1_f32<64>(t, w1, b, v, batch, ht, wt, st);
      case 128: return launch_conv1_f32<128>(t, w1, b, v, batch, ht, wt, st);
      case 256: return launch_conv1_f32<256>(t, w1, b, v, batch, ht, wt, st);
      case 384: return launch_conv1_f32<384>(t, w1, b, v, batch, ht, wt, st);
    }
  }
  return -1;
}

extern "C" int dad_tail_head(const void* v, const void* w2, const void* b2, const void* kd,
                             const void* bd, void* out, int batch, int hv, int wv, int cm, int oh,
                             int ow, int relu_out, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || hv <= 0 || wv <= 0 || oh <= 0 || ow <= 0 ||
      oh > 8 * 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(b2);
  const float* k = static_cast<const float*>(kd);
  const float* d = static_cast<const float*>(bd);
  auto head = [&](auto kernel) {
    return kernel(v, w2, b, k, d, out, batch, hv, wv, oh, ow, relu_out, st);
  };
  if (dtype == 0) {
    switch (cm) {
      case 32: return head(launch_wgmma<32, kC2, true>);
      case 64: return head(launch_wgmma<64, kC2, true>);
      case 128: return head(launch_wgmma<128, kC2, true>);
      case 192: return head(launch_wgmma<192, kC2, true>);
    }
  } else if (dtype == 1) {
    switch (cm) {
      case 32: return head(launch_head_f32<32>);
      case 64: return head(launch_head_f32<64>);
      case 128: return head(launch_head_f32<128>);
      case 192: return head(launch_head_f32<192>);
    }
  }
  return -1;
}
