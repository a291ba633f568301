// Backward of the attention with an additive bias, for Hopper (sm_90a).
//
// Replaces the TPU kernel distill_any_depth_tpu/ops/flash_attention.py
// ::_flash_bwd_impl (bodies _bwd_kernel and _bwd_bias_kernel_adapter): dq,
// dk and dv of the biased attention (flash_attention_bias.cu) with a
// constant [N, N] bias shared by batch and heads (bf16 or fp32), or none;
// keys at or past N are a true -inf. A bias that itself trains takes the
// plain version in ops/flash_attention.py, as the JAX package takes its
// einsum there. The body is masked_attention_bwd.cuh's, the mask
// attention_masks.cuh's BiasMask.
//
// Bound at the windowed ViT-B student's 518^2 bs16 training shape (B=16,
// N=1369, H=12, D=64, bf16, bf16 window bias): qkv, out and g read once,
// d(qkv) and the bias, 273 MB (81.5 us at 3.35 TB/s), against the five
// products of the live (query, key) pairs, 49 per row: 8.2 GFLOP (8.3 us at
// 989 TFLOP/s). Bound by bytes; as dense work (230 GFLOP) it would be bound
// by operations.
//
// Both passes skip the masked tiles by the forward's tile marks (one byte
// per (q tile, key tile), written by flash_attention_bias.cu's first pass
// and kept by the caller for the backward): under the window mask at 518^2
// a 64-row q tile sees 6-7 of 22 key tiles, a key tile is seen by as many q
// tiles. The bf16 passes (wgmma, masked_attention_bwd.cuh) read the bias by
// TMA from the fp32 copy padded to N' = N rounded up to 128 (-inf past N)
// that the bf16 forward wrote too: an odd N's bias rows are no valid TMA
// stride. A call without the marks (mark = 1) or without the copy (copy =
// 1) has a first launch write them here.

#include "masked_attention_bwd.cuh"

namespace {

using namespace dad_attn;

template <typename T, typename TB>
int launch_biased_bwd(const void* q, const void* k, const void* v, const void* out,
                      const void* g, const float* lse, float* delta, const void* bias,
                      unsigned char* live, int mark, float* terms, int copy, void* dq, void* dk,
                      void* dv, long stride, long batch_stride, long dstride, long dbatch_stride,
                      int batch, int n, int heads, float scale, cudaStream_t st) {
  const int nk = (n + kTile - 1) / kTile;
  BiasMask<TB> m{static_cast<const TB*>(bias), bias ? live : nullptr, n, nk};
  // the wgmma passes read the terms by TMA
  copy = copy && std::is_same<T, __nv_bfloat16>::value;
  mark = mark && bias != nullptr;
  if (mark || copy) {
    cudaError_t err = bias_prep<TB>(m.bias, n, mark ? live : nullptr, copy ? terms : nullptr, st);
    if (err != cudaSuccess) return (int)err;
  }
  return launch_masked_bwd<T>(q, k, v, out, g, lse, delta, terms, dq, dk, dv, stride,
                              batch_stride, dstride, dbatch_stride, batch, n, heads, scale, m,
                              st);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* out, const void* g,
                 const float* lse, float* delta, const void* bias, int bias_dtype,
                 unsigned char* live, int mark, float* terms, int copy, void* dq, void* dk,
                 void* dv, long stride, long batch_stride, long dstride, long dbatch_stride,
                 int batch, int n, int heads, float scale, cudaStream_t st) {
  if (bias_dtype == 0)
    return launch_biased_bwd<T, __nv_bfloat16>(q, k, v, out, g, lse, delta, bias, live, mark,
                                               terms, copy, dq, dk, dv, stride, batch_stride,
                                               dstride, dbatch_stride, batch, n, heads, scale, st);
  // an fp32 bias, or none
  return launch_biased_bwd<T, float>(q, k, v, out, g, lse, delta, bias, live, mark, terms, copy,
                                     dq, dk, dv, stride, batch_stride, dstride, dbatch_stride,
                                     batch, n, heads, scale, st);
}

}  // namespace

// q, k, v: [B, N, H, 64] with rows `stride` elements apart and batches
// `batch_stride` apart; out, g: [B, N, H*64] contiguous; lse: [B, H, N] fp32
// from the forward; delta: fp32 scratch of B*H*N floats; bias: [N, N]
// contiguous, or null; live: the forward's ceil(N/64)^2 tile marks (null
// without a bias), written first if mark != 0; terms: the bf16 forward's
// fp32 [N', N'] copy of the bias, N' = N rounded up to 128, written first
// if copy != 0 (bfloat16 only; null for float32); dq,
// dk, dv: [B, N, H, 64] with rows `dstride` elements apart and batches
// `dbatch_stride` apart.
// dtype: 0 = bfloat16, 1 = float32 (q, k, v, out, g, dq, dk, dv);
// bias_dtype: 0 = bfloat16, 1 = float32, -1 = no bias. Returns a cudaError_t
// (0 = success); -1 for an argument the kernels do not take.
extern "C" int dad_bias_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* out, const void* g, const void* lse,
                                      void* delta, const void* bias, void* live, void* terms,
                                      void* dq, void* dk, void* dv, int batch, int n, int heads,
                                      int head_dim, long long stride, long long batch_stride,
                                      long long dstride, long long dbatch_stride, int dtype,
                                      int bias_dtype, int mark, int copy, float scale,
                                      void* stream) {
  if (head_dim != kD || n <= 0 || batch <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return -1;
  if ((bias == nullptr) != (bias_dtype == -1) || bias_dtype < -1 || bias_dtype > 1) return -1;
  if (bias != nullptr && live == nullptr) return -1;
  if (dtype == 0 && terms == nullptr) return -1;
  float* t = static_cast<float*>(terms);
  unsigned char* marks = static_cast<unsigned char*>(live);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<__nv_bfloat16>(q, k, v, out, g, l, dl, bias, bias_dtype, marks, mark, t,
                                       copy, dq, dk, dv, stride, batch_stride, dstride,
                                       dbatch_stride, batch, n, heads, scale, st);
  if (dtype == 1)
    return launch_typed<float>(q, k, v, out, g, l, dl, bias, bias_dtype, marks, mark, t, copy, dq,
                               dk, dv, stride, batch_stride, dstride, dbatch_stride, batch, n,
                               heads, scale, st);
  return -1;
}
