// Attention with an additive bias for Hopper (sm_90a).
//
// Replaces the TPU kernel distill_any_depth_tpu/ops/flash_attention.py
// ::_flash_fwd_impl (body _attn_kernel through _bias_kernel_adapter): dense
// attention over all N keys with an additive [N, N] bias shared by batch and
// heads (a local-window log-mask, a segment mask, or any finite values), or
// with no bias. The kernel body is masked_attention.cuh's, the mask
// attention_masks.cuh's BiasMask.
//
// Bound at the windowed ViT-B 518^2 bs8 shape (B=8, N=1369, H=12, D=64,
// bf16, bf16 bias): 71 MB moved (qkv, out and bias once: 21.2 us at
// 3.35 TB/s) against the products of the live (query, key) pairs, 49 per row
// under the window mask: 1.65 GFLOP (1.7 us at 989 TFLOP/s). Bound by bytes;
// as dense work (46.1 GFLOP, 46.6 us) it would be bound by operations.
//
// A first launch reads the bias once: it marks each (64-row, 64-key) tile
// that holds a finite entry and, in bf16, writes the bias as fp32 terms
// padded to N' = N rounded up to 128 (-inf past N), which the wgmma kernel
// reads by TMA (an odd N's bias rows are no TMA stride). The attention
// kernel then loads only the live key tiles of its q rows, 6-7 of 22 under
// the window mask at 518^2. Both stay with the caller: the backward
// (flash_attention_bias_bwd.cu) reads the marks and the terms again.

#include "masked_attention.cuh"

namespace {

using namespace dad_attn;

template <typename T, typename TB>
int launch_biased(const void* q, const void* k, const void* v, const void* bias,
                  unsigned char* live, float* terms, void* out, float* lse, long stride,
                  long batch_stride, int batch, int n, int heads, float scale, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int nk = (n + kTile - 1) / kTile;
  BiasMask<TB> m{static_cast<const TB*>(bias), bias ? live : nullptr, n, nk};
  if (bias != nullptr || kBf16) {
    cudaError_t err =
        bias_prep<TB>(m.bias, n, bias ? live : nullptr, kBf16 ? terms : nullptr, st);
    if (err != cudaSuccess) return (int)err;
  }
  return launch_masked<T>(q, k, v, terms, out, lse, stride, batch_stride, batch, n, heads, scale,
                          m, st);
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* bias, int bias_dtype,
                 unsigned char* live, float* terms, void* out, float* lse, long stride,
                 long batch_stride, int batch, int n, int heads, float scale, cudaStream_t st) {
  if (bias_dtype == 0)
    return launch_biased<T, __nv_bfloat16>(q, k, v, bias, live, terms, out, lse, stride,
                                           batch_stride, batch, n, heads, scale, st);
  // an fp32 bias, or none
  return launch_biased<T, float>(q, k, v, bias, live, terms, out, lse, stride, batch_stride,
                                 batch, n, heads, scale, st);
}

}  // namespace

// q, k, v: [B, N, H, 64] with rows `stride` elements apart and batches
// `batch_stride` apart (16-byte multiples); bias: [N, N] contiguous, or
// null; live: ceil(N/64)^2 bytes (null without a bias) that receive the tile
// marks; terms: fp32 [N', N'], N' = N rounded up to 128, that receive the
// bias's padded copy (bfloat16 only; null for float32); out: [B, N, H*64];
// lse: [B, H, N] fp32, or null (inference). The backward
// (flash_attention_bias_bwd.cu) reads live and terms again.
// dtype: 0 = bfloat16, 1 = float32 (q, k, v, out); bias_dtype: 0 = bfloat16,
// 1 = float32, -1 = no bias. Returns a cudaError_t (0 = success); -1 for an
// argument the kernel does not take.
extern "C" int dad_bias_attention(const void* q, const void* k, const void* v, const void* bias,
                                  void* live, void* terms, void* out, void* lse, int batch, int n,
                                  int heads, int head_dim, long long stride,
                                  long long batch_stride, int dtype, int bias_dtype, float scale,
                                  void* stream) {
  if (head_dim != kD || n <= 0 || batch <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return -1;
  if ((bias == nullptr) != (bias_dtype == -1) || bias_dtype < -1 || bias_dtype > 1) return -1;
  if (bias != nullptr && live == nullptr) return -1;
  if (dtype == 0 && terms == nullptr) return -1;
  unsigned char* marks = static_cast<unsigned char*>(live);
  float* t = static_cast<float*>(terms);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<__nv_bfloat16>(q, k, v, bias, bias_dtype, marks, t, out, l, stride,
                                       batch_stride, batch, n, heads, scale, st);
  if (dtype == 1)
    return launch_typed<float>(q, k, v, bias, bias_dtype, marks, t, out, l, stride, batch_stride,
                               batch, n, heads, scale, st);
  return -1;
}
