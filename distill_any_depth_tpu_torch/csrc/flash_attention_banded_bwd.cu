// Backward of the banded local-window attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel distill_any_depth_tpu/ops/flash_attention.py
// ::_banded_bwd_impl (bodies _banded_dq_kernel and _banded_dkv_kernel, math
// _banded_tile_grads): dq, dk and dv of the banded window attention
// (flash_attention_banded.cu) on a row-major (gh, gw) grid with no prefix
// tokens, from the forward's row log-sum-exp and delta = rowsum(g * out).
// The window is computed from (gh, gw, window), never read (at 1036^2 an
// [N, N] bias would be 120 MB). The dQ pass visits each q tile's band
// (_band_bounds_traced), the dK/dV pass each key tile's inverse band
// (_inv_band_bounds_traced): token rows [c0 - half, c1 + half] of its grid
// rows c0..c1, widened to the grid's first (last) rows below (above) the
// clip. The body is masked_attention_bwd.cuh's, the mask
// attention_masks.cuh's WindowMask, so with the window bias the result
// equals flash_attention_bias_bwd.cu's bit for bit (both passes add the
// same live tiles in the same order with the same arithmetic; a dead tile
// adds exact zeros). In bf16 the window term is computed in registers from
// the grid coordinates of each score's row and column.
//
// Bound at the windowed ViT-B student's 1036^2 bs16 training shape (B=16,
// N=5476, H=12, D=64, window 7, bf16): qkv, out and g read once and d(qkv)
// written once, 1077 MB (321 us at 3.35 TB/s), against the five products of
// the live (query, key) pairs, 49 per row: 33.0 GFLOP (33.4 us at 989
// TFLOP/s). Bound by bytes. Whole tiles of the band are computed: in bf16,
// 128 owned rows against 64-row streamed tiles, 9-10 live tiles of 86 per
// block.

#include "masked_attention_bwd.cuh"

using namespace dad_attn;

// q, k, v: [B, N, H, 64] with rows `stride` elements apart and batches
// `batch_stride` apart, N = gh * gw; out, g: [B, N, H*64] contiguous; lse:
// [B, H, N] fp32 from the forward; delta: fp32 scratch of B*H*N floats; dq,
// dk, dv: [B, N, H, 64] with rows `dstride` elements apart and batches
// `dbatch_stride` apart. dtype: 0 = bfloat16, 1 = float32. Returns a
// cudaError_t (0 = success); -1 for an argument the kernels do not take.
extern "C" int dad_banded_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* out, const void* g, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int batch,
                                        int n, int heads, int head_dim, long long stride,
                                        long long batch_stride, long long dstride,
                                        long long dbatch_stride, int gh, int gw, int window,
                                        int dtype, float scale, void* stream) {
  if (head_dim != kD || n <= 0 || batch <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return -1;
  if (gh <= 0 || gw <= 0 || (long long)gh * gw != n || window <= 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WindowMask m{n, gh, gw, window / 2};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch_masked_bwd<__nv_bfloat16>(q, k, v, out, g, l, dl, nullptr, dq, dk, dv, stride,
                                            batch_stride, dstride, dbatch_stride, batch, n,
                                            heads, scale, m, st);
  if (dtype == 1)
    return launch_masked_bwd<float>(q, k, v, out, g, l, dl, nullptr, dq, dk, dv, stride,
                                    batch_stride, dstride, dbatch_stride, batch, n, heads, scale,
                                    m, st);
  return -1;
}
