// Packed-QKV softmax attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel distill_any_depth_tpu/ops/flash_attention.py
// ::_packed_fwd_impl (body _packed_kernel): bias-free attention read straight
// from the fused-QKV GEMM output.
//
//   qkv [B, N, 3*H*D] (column order q|k|v, head, dim)  ->  out [B, N, H*D]
//   and, when asked (training), the row log-sum-exp lse [B, H, N] fp32
//
// Numerics follow _packed_kernel: fp32 scores (q.k)*D^-1/2 and row max,
// exp(s - m) rounded to the input type before the PV product, an fp32 sum of
// the rounded values, fp32 PV accumulation, division by the sum after PV.
// Keys at or past N are masked with a true -inf in both the max and the sum
// (no closed-form pad correction, which cancels when every real logit of a
// row is strongly negative). lse = m + log(sum), in natural-log units, is
// what the backward (flash_attention_bwd.cu) recomputes the probabilities
// from.
//
// Bound at the ViT-B 392^2 bs8 shape (B=8, N=785, H=12, D=64, bf16):
// 4*B*H*N^2*D = 15.1 GFLOP (15.3 us at 989 TFLOP/s) against 38.6 MB moved
// (11.5 us at 3.35 TB/s): compute-bound on the tensor cores, which Hopper
// runs at full rate only through wgmma.
//
// bf16 design (hopper_tiles.cuh): one block of three warpgroups per
// (128-row q tile, head, batch), two blocks per SM. Warpgroup 0 is the
// producer: it gives up registers (setmaxnreg) and one thread keeps TMA loads
// in flight, the q tile once and then 64-key K and V tiles through a ring of
// two stages with full and empty mbarriers, so loads overlap the products.
// Warpgroups 1 and 2 each own 64 q rows (a warpgroup whose rows all lie past
// N does no work): S = Q K^T on wgmma m64n64k16 from shared memory, the
// online softmax in registers with one FFMA into exp2 per score (D^-1/2
// log2(e) folded into the scale), P rounded to bf16 pairs in registers, and
// O += P V on wgmma m64n64k16 with P from registers and V read MN-major. The
// TMA map over [B, N, 3C] zero-fills rows past N within each batch; the mask
// keeps those keys out of the max and the sum. Measured on an H100 (PERF.md),
// the second block per SM hides one block's softmax behind the other's
// products better than 128-key tiles with one block per SM, or than one
// warpgroup overlapping its own next S with its PV.
//
// fp32 keeps the scalar-FMA kernel over attention_tiles.cuh's tiles (4 warps
// per 64-row q tile, cp.async K/V tiles), which holds the tight fp32 checks.

#include "attention_tiles.cuh"
#include "hopper_tiles.cuh"

namespace {

// ------------------------------------------------------------------ bf16, wgmma
namespace hop {

using namespace dad_hopper;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;
constexpr int kWgRows = 64;                 // q rows of a consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kBM = kWgRows * kConsumers;   // q rows of a block
constexpr int kBN = 64;                     // keys of a stage
constexpr int kStages = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
// Two blocks per SM: each block holds 384 x 80 registers, which setmaxnreg
// moves to the consumers (producer 24, consumers 104).
constexpr int kBlocksPerSm = 2;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 104;
constexpr int kBox = 64 * kD;               // elements of one TMA box (8 KB)
constexpr size_t kSmem = 1024 /* alignment slack */ + (size_t)(kBM + 2 * kStages * kBN) * kD * 2 +
                         (1 + 3 * kStages) * sizeof(uint64_t);

// Issue S = Q K^T of key tile kt (64 q rows x kBN keys) once its K tile is in.
__device__ __forceinline__ void issue_s(float (&s)[kBN / 2], uint64_t qdesc, const bf16* ks,
                                        uint64_t* k_full, int kt) {
  const int st = kt % kStages;
  mbar_wait(&k_full[st], (kt / kStages) & 1);
  const uint64_t kdesc = desc_sw128(ks + st * kBN * kD);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_ss_n64(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
  wgmma_commit();
}

// Issue O += P V of key tile kt once its V tile is in: P [64 x kBN] from
// registers, V [kBN x 64] read MN-major.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&pf)[kBN / 4],
                                         const bf16* vs, uint64_t* v_full, int kt) {
  const int st = kt % kStages;
  mbar_wait(&v_full[st], (kt / kStages) & 1);
  const bf16* vt = vs + st * kBN * kD;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
    wgmma_rs_n64(o, a, desc_sw128(vt + kk * 16 * kD), 1);
  }
  wgmma_commit();
}

// Online softmax of one tile of scores (rows g and g + 8 of this warp):
// mask keys >= n, update the running max (raw scores) and this thread's
// share of the row sums, and write P = exp(s - m) rounded to bf16 pairs in
// accumulator order (pf[2j] row g, pf[2j + 1] row g + 8, columns 8j + 2cq
// and 8j + 2cq + 1); alpha rescales the earlier sums and the output.
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2], int k0, int n, float scale_log2,
                                             float (&m_run)[2], float (&l_run)[2],
                                             uint32_t (&pf)[kBN / 4], float (&alpha)[2]) {
  const int cq = threadIdx.x & 3;
  if (k0 + kBN > n) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * cq + (e & 1) >= n) s[4 * j + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    // every tile holds at least one real key, so m_new is finite; guard anyway
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = exp2_ftz((m_run[r] - m_use) * scale_log2);  // 0 on the first tile
    ms[r] = m_use * scale_log2;
    m_run[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    pf[2 * j] = pack_bf16(exp2_ftz(fmaf(s[4 * j], scale_log2, -ms[0])),
                          exp2_ftz(fmaf(s[4 * j + 1], scale_log2, -ms[0])));
    pf[2 * j + 1] = pack_bf16(exp2_ftz(fmaf(s[4 * j + 2], scale_log2, -ms[1])),
                              exp2_ftz(fmaf(s[4 * j + 3], scale_log2, -ms[1])));
    const __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&pf[2 * j]);
    const __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&pf[2 * j + 1]);
    psum[0] += __low2float(lo) + __high2float(lo);
    psum[1] += __low2float(hi) + __high2float(hi);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    packed_attn_wgmma(const __grid_constant__ CUtensorMap qkv_map, bf16* __restrict__ out,
                      float* __restrict__ lse, int n, int heads, float scale) {
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* ks = qs + kBM * kD;
  bf16* vs = ks + kStages * kBN * kD;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * kBN * kD);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int c = heads * kD;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int active = min(kConsumers, (n - q0 + kWgRows - 1) / kWgRows);
  const int n_tiles = (n + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], active * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, active * kBox * 2);
      for (int w = 0; w < active; ++w)
        tma_load_3d(qs + w * kBox, &qkv_map, q_full, h * kD, q0 + w * kWgRows, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages, round = kt / kStages;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        mbar_arrive_expect_tx(&k_full[st], kBox * 2);
        tma_load_3d(ks + st * kBox, &qkv_map, &k_full[st], c + h * kD, kt * kBN, b);
        mbar_arrive_expect_tx(&v_full[st], kBox * 2);
        tma_load_3d(vs + st * kBox, &qkv_map, &v_full[st], 2 * c + h * kD, kt * kBN, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int w = wg - 1;
    if (w < active) {
      const int lane = threadIdx.x & 31;
      const int g = lane >> 2, cq = lane & 3;
      const float scale_log2 = scale * 1.4426950408889634f;

      float o[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};  // raw (unscaled) running row max
      float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

      mbar_wait(q_full, 0);
      const uint64_t qdesc = desc_sw128(qs + w * kBox);
      for (int kt = 0; kt < n_tiles; ++kt) {
        float s[kBN / 2];
        uint32_t pf[kBN / 4];
        float alpha[2];
        issue_s(s, qdesc, ks, k_full, kt);
        wgmma_wait<0>();
        fence_regs(s);
        softmax_tile(s, kt * kBN, n, scale_log2, m_run, l_run, pf, alpha);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        issue_pv(o, pf, vs, v_full, kt);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pf);
        if (lane == 0) mbar_arrive(&empty[kt % kStages]);  // the warpgroup's products are done
      }

      // ---- normalise and store rows g, g+8 of this warp (and their lse)
      const int row0 = q0 + w * kWgRows + ((threadIdx.x & 127) >> 5) * 16 + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        const int row = row0 + 8 * r;
        if (row >= n) continue;
        const float inv = 1.f / l_run[r];
        bf16* dst = out + ((long)b * n + row) * c + h * kD;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * cq) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        if (lse != nullptr && cq == 0)
          lse[((long)b * heads + h) * n + row] = m_run[r] * scale + logf(l_run[r]);
      }
    }
  }
}

int launch_bf16(const void* qkv, void* out, float* lse, int batch, int n, int heads, float scale,
                cudaStream_t stream) {
  CUtensorMap map;
  int err = make_map_3d(&map, qkv, batch, n, 3 * heads * kD);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(packed_attn_wgmma,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + kBM - 1) / kBM, heads, batch);
  packed_attn_wgmma<<<grid, kThreads, kSmem, stream>>>(map, static_cast<bf16*>(out), lse, n,
                                                       heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace hop

// ------------------------------------------------------------------ fp32, scalar FMA
using namespace dad_attn;

__global__ void __launch_bounds__(kThreads)
    packed_attn_fp32(const float* __restrict__ qkv, float* __restrict__ out,
                     float* __restrict__ lse, int n, int heads, float scale) {
  constexpr int kRow = row_elems<float>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kTile * kRow;
  float* vs = ks + kTile * kRow;
  float* ps = vs + kTile * kRow;

  const int c = heads * kD;
  const long stride = 3L * c;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* base = qkv + (long)b * n * stride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair

  load_tile<float>(qs, base, q0, n, stride, h * kD);

  float o[8][4];
  zero(o);
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int n_tiles = (n + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<float>(ks, base, k0, n, stride, c + h * kD);
    load_tile<float>(vs, base, k0, n, stride, 2 * c + h * kD);
    cp_async_wait_all();
    __syncthreads();

    // ---- S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
    zero(s);
    fma_nt(s, qs, ks);

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
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - m_use[0]);
      s[j][1] = expf(s[j][1] - m_use[0]);
      s[j][2] = expf(s[j][2] - m_use[1]);
      s[j][3] = expf(s[j][3] - m_use[1]);
      psum[0] += s[j][0] + s[j][1];
      psum[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + psum[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
      o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
    }

    // ---- O += P V
    fma_nn(o, s, ps + warp * 16 * kProw, vs);
  }

  // ---- normalise and store rows g, g+8 of this warp (and their lse)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    float inv = 1.f / l_run[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][2 * r] *= inv;
      o[j][2 * r + 1] *= inv;
    }
    int row = q0 + warp * 16 + g + 8 * r;
    if (lse != nullptr && t == 0 && row < n)
      lse[((long)b * heads + h) * n + row] = m_run[r] + logf(l_run[r]);
  }
  store_rows<float>(out + (long)b * n * c, o, q0, n, c, h * kD, 1.f);
}

int launch_fp32(const void* qkv, void* out, float* lse, int batch, int n, int heads, float scale,
                cudaStream_t stream) {
  const size_t smem = (size_t)3 * kTile * row_elems<float>() * sizeof(float) +
                      (size_t)kWarps * 16 * kProw * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(packed_attn_fp32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kTile - 1) / kTile, heads, batch);
  packed_attn_fp32<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), lse, n, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. lse may be null (inference). Returns a
// cudaError_t (0 = success); -1 for an argument the kernel does not take.
extern "C" int dad_packed_attention(const void* qkv, void* out, void* lse, int batch, int n,
                                    int heads, int head_dim, int dtype, float scale,
                                    void* stream) {
  if (head_dim != kD || n <= 0 || batch <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return hop::launch_bf16(qkv, out, l, batch, n, heads, scale, st);
  if (dtype == 1) return launch_fp32(qkv, out, l, batch, n, heads, scale, st);
  return -1;
}
