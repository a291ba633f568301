// Banded local-window attention for Hopper (sm_90a).
//
// Replaces the TPU kernel distill_any_depth_tpu/ops/flash_attention.py
// ::_banded_fwd_impl (body _banded_kernel): attention over a row-major
// (gh, gw) token grid with no prefix tokens, where query (y, x) sees the
// keys of the window x window block around its centre, the centre clamped
// to [half, max(g - 1 - half, half)] on each axis (ops/window.py's corner
// completion; a grid axis shorter than the window sees all of it). The
// result equals the dense bias kernel (flash_attention_bias.cu) with
// local_window_bias(gh, gw, window, n_prefix=0).
//
// The mask is computed from (gh, gw, window) here and never read: at 1036^2
// (a 74 x 74 grid) an [N, N] fp32 bias would be 120 MB. Each 64-row q tile
// (in bf16, each half of a block's 128 rows), covering grid rows r0..r1,
// visits only the key tiles of token rows [clip(r0) - half, clip(r1) +
// half] (_band_bounds_traced), 8 to 10 of the 86 at 1036^2, and skips those
// its rows do not see. The kernel body is
// masked_attention.cuh's, the mask attention_masks.cuh's WindowMask: in bf16
// the window term is computed in registers from the grid coordinates of
// each score's row and column.
//
// Bound at the windowed ViT-B 1036^2 bs8 shape (B=8, N=5476, H=12, D=64,
// window 7, bf16): a band of 7 grid rows x 74 = 518 keys per query gives
// 4*B*H*N*518*D = 69.7 GFLOP (70.5 us at 989 TFLOP/s) against 269 MB moved
// (80.2 us at 3.35 TB/s): bound by bytes. Whole key tiles of the band are
// computed, so the kernel does about 1.2x the band's products.

#include "masked_attention.cuh"

using namespace dad_attn;

// q, k, v: [B, N, H, 64] with rows `stride` elements apart and batches
// `batch_stride` apart, N = gh * gw; out: [B, N, H*64]; lse: [B, H, N] fp32,
// or null (inference). dtype: 0 = bfloat16, 1 = float32. Returns a
// cudaError_t (0 = success); -1 for an argument the kernel does not take.
extern "C" int dad_banded_attention(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int batch, int n, int heads, int head_dim,
                                    long long stride, long long batch_stride, int gh, int gw,
                                    int window, int dtype, float scale, void* stream) {
  if (head_dim != kD || n <= 0 || batch <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return -1;
  if (gh <= 0 || gw <= 0 || (long long)gh * gw != n || window <= 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WindowMask m{n, gh, gw, window / 2};
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_masked<__nv_bfloat16>(q, k, v, nullptr, out, l, stride, batch_stride, batch, n,
                                        heads, scale, m, st);
  if (dtype == 1)
    return launch_masked<float>(q, k, v, nullptr, out, l, stride, batch_stride, batch, n, heads,
                                scale, m, st);
  return -1;
}
