// Flash attention forward for Hopper: per (batch * head), softmax(q k^T +
// mask) v with an online softmax, the masked kv blocks never loaded.
//
// Replaces the TPU kernel flash_kernel (repro/kernels/flash/kernel.py),
// whose grid walks (batch*heads, q blocks, kv blocks) with kv innermost:
// the running max m, running sum l and the (bq, hd) accumulator stay in
// VMEM scratch across the kv sweep, and @pl.when skips every kv block that
// lies wholly in the causal future or wholly outside the sliding window.
//
// On Hopper the sequential kv axis becomes a loop inside the CTA:
//   * one CTA of 256 threads per (bh, 64-row q block); the q tile is
//     widened to f32 and staged in shared memory once;
//   * the kv blocks of 64 rows are walked in order; a block is skipped,
//     before any load, by the TPU kernel's own predicate
//     (k_start < T, k_start <= q_end when causal, k_end > q_start - window
//     when windowed), so the causal triangle costs about S^2 / 2 and the
//     window about S * window;
//   * each live block's k and v tiles are widened to f32 in shared memory;
//     a thread owns 4 rows x 4 columns of the 64 x 64 score tile, the row
//     max and sum are reduced over the 16 threads sharing a row by warp
//     shuffles, and p goes through shared memory into the p v product;
//   * m, l and the accumulator (4 rows x up to 16 column groups) stay in
//     registers; the output is acc / max(l, 1e-30) in q's dtype;
//   * the mask is the TPU kernel's, with -1e30 for masked scores, and the
//     ragged edges of S and T are masked here: nothing is padded.
// q is f32 or bf16, k and v one of the two; every product and sum is f32
// FFMA (bf16 is widened on load, never TF32).  hd is any multiple of 8 up
// to 256; the register accumulator is sized for hd <= 64, 128 or 256.
//
// Bound: on the live (q, k) pairs 4 hd flop each (q k^T and p v) against q,
// k, v read once and o written once.  At granite's prefill (32 heads,
// hd 64, S = T = 4000, causal) that is 6.6e10 flop, 2.6e8 pairs, against
// 50 MB: bound by operations at 67 TFLOP/s of f32 FFMA (1.0 ms); with bf16
// q and tensor cores (wgmma) the bound would be 0.07 ms, later work.  This
// simple form reads two shared-memory words per FFMA pair and is held by
// shared-memory bandwidth, not by HBM.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;          // q rows per CTA
constexpr int kBK = 64;          // kv rows per block
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLDP = kBK + 1;    // row pitch of the p tile
constexpr float kNegInf = -1e30f;

enum FlashDType : int { kFlashF32 = 0, kFlashBF16 = 1 };

template <class T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Eight consecutive elements from 16-byte aligned memory, widened to f32.
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Rows [r0, r0 + kRows) of a (rows, hd) row-major matrix into shared
// memory with pitch ld, widened to f32; rows at or past `limit` are zero.
template <int kRows, class T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           int64_t r0, int64_t limit, int hd,
                                           int ld, float* dst) {
  const int per_row = hd / 8;
  for (int e = threadIdx.x; e < kRows * per_row; e += kThreads) {
    const int row = e / per_row;
    const int col = (e - row * per_row) * 8;
    float v[8];
    if (r0 + row < limit) {
      load8(src + (r0 + row) * hd + col, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[row * ld + col + i] = v[i];
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// kNJ: column groups of 16 in the accumulator (hd <= 16 * kNJ).
template <class TQ, class TKV, int kNJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, TQ* __restrict__ o, int64_t S,
                 int64_t T, int hd, int causal, int64_t window) {
  extern __shared__ float smem[];
  const int ld = hd + 1;                 // odd pitch: conflict-free columns
  float* sq = smem;                      // kBQ x ld
  float* sk = sq + kBQ * ld;             // kBK x ld
  float* sv = sk + kBK * ld;             // kBK x ld
  float* sp = sv + kBK * ld;             // kBQ x kLDP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t bh = blockIdx.y;
  // The heaviest causal q blocks (the last ones) are scheduled first.
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int64_t q_end = q0 + kBQ - 1;
  const int nj = (hd + 15) / 16;

  const TQ* qb = q + bh * S * hd;
  const TKV* kb = k + bh * T * hd;
  const TKV* vb = v + bh * T * hd;
  stage_tile<kBQ>(qb, q0, S, hd, ld, sq);

  float m[4], l[4], acc[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNJ; ++c) acc[i][c] = 0.f;
  }

  const int64_t nk = (T + kBK - 1) / kBK;
  for (int64_t j = 0; j < nk; ++j) {
    const int64_t k0 = j * kBK, k_end = k0 + kBK - 1;
    // The TPU kernel's block skip: the same predicate, uniform over the CTA.
    if (causal && k0 > q_end) continue;
    if (window >= 0 && k_end <= q0 - window) continue;

    __syncthreads();                     // previous block's tiles are free
    stage_tile<kBK>(kb, k0, T, hd, ld, sk);
    stage_tile<kBK>(vb, k0, T, hd, ld, sv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = sk[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(a[i], b[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t kpos = k0 + tx + 16 * c;
        bool ok = kpos < T;
        if (causal) ok = ok && kpos <= qpos;
        if (window >= 0) ok = ok && kpos > qpos - window;
        s[i][c] = ok ? s[i][c] : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        sp[(ty + 16 * i) * kLDP + tx + 16 * c] = p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty + 16 * i) * kLDP + kk];
#pragma unroll
      for (int c = 0; c < kNJ; ++c) {
        if (c < nj) {
          const float vv = sv[kk * ld + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

  TQ* ob = o + bh * S * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = q0 + ty + 16 * i;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kNJ; ++c) {
      const int col = tx + 16 * c;
      if (r < S && col < hd) ob[r * hd + col] = from_f32<TQ>(acc[i][c] * inv);
    }
  }
}

template <class TQ, class TKV, int kNJ>
int launch_flash_nj(const void* q, const void* k, const void* v, void* o,
                    int64_t bh, int64_t s, int64_t t, int hd, int causal,
                    int64_t window, cudaStream_t stream) {
  const int ld = hd + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBQ + 2 * kBK) * ld + kBQ * kLDP);
  const dim3 grid(static_cast<unsigned>((s + kBQ - 1) / kBQ),
                  static_cast<unsigned>(bh));
  return static_cast<int>(repro::launch(
      flash_fwd_kernel<TQ, TKV, kNJ>, grid, dim3(kThreads), smem, stream,
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o), s, t, hd, causal,
      window));
}

template <class TQ, class TKV>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int64_t bh, int64_t s, int64_t t, int hd, int causal,
                 int64_t window, cudaStream_t stream) {
  if (hd <= 64)
    return launch_flash_nj<TQ, TKV, 4>(q, k, v, o, bh, s, t, hd, causal,
                                       window, stream);
  if (hd <= 128)
    return launch_flash_nj<TQ, TKV, 8>(q, k, v, o, bh, s, t, hd, causal,
                                       window, stream);
  return launch_flash_nj<TQ, TKV, 16>(q, k, v, o, bh, s, t, hd, causal,
                                      window, stream);
}

}  // namespace

// q (bh, s, hd) of type q_dtype, k and v (bh, t, hd) of type kv_dtype, o
// (bh, s, hd) of type q_dtype; every pointer 16-byte aligned.  window < 0
// means no window.
extern "C" int repro_flash_attention(int q_dtype, int kv_dtype, const void* q,
                                     const void* k, const void* v, void* o,
                                     int64_t bh, int64_t s, int64_t t,
                                     int64_t hd, int causal, int64_t window,
                                     void* stream) {
  if (bh < 1 || bh > 65535 || s < 1 || t < 1 || hd < 8 || hd > 256 ||
      hd % 8 != 0 || (s + kBQ - 1) / kBQ > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(hd);
  if (q_dtype == kFlashF32 && kv_dtype == kFlashF32)
    return launch_flash<float, float>(q, k, v, o, bh, s, t, h, causal, window, st);
  if (q_dtype == kFlashF32 && kv_dtype == kFlashBF16)
    return launch_flash<float, __nv_bfloat16>(q, k, v, o, bh, s, t, h, causal,
                                              window, st);
  if (q_dtype == kFlashBF16 && kv_dtype == kFlashF32)
    return launch_flash<__nv_bfloat16, float>(q, k, v, o, bh, s, t, h, causal,
                                              window, st);
  if (q_dtype == kFlashBF16 && kv_dtype == kFlashBF16)
    return launch_flash<__nv_bfloat16, __nv_bfloat16>(q, k, v, o, bh, s, t, h,
                                                      causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
