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
//   * one CTA of 4 warps per (bh, 64-row q block), each warp 16 q rows;
//     the heaviest causal q blocks (the last ones) are scheduled first;
//   * the live kv blocks (kBK rows; kBKWide for hd > 128) are found before
//     any load by the TPU kernel's own predicate (k_start < T, k_start <=
//     q_end when causal, k_end > q_start - window when windowed) and walked
//     in order; q, k and v go raw (f32 or bf16) into shared memory through
//     cp.async, k and v in a ring of kStages stages, so the next block's
//     copy runs under this block's products; one barrier a block;
//   * the mask (-1e30 for masked scores, ragged S and T) is applied only
//     in blocks that hold a masked pair; nothing is padded;
//   * the row max and sum by warp shuffles over the 4 lanes of a quad; m,
//     the lanes' partial sums of p and the (16, hd) accumulator of a warp
//     stay in registers; the output is acc / max(l, 1e-30) in q's dtype.
//
// Both products run on the tensor cores,
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, in f32 accuracy by
// the split x = hi + lo, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)
// (lo carries the next 11 bits, so hi + lo holds x to 2^-22 of |x|).  A
// bf16 operand is exact in TF32 and is not split.  So q k^T is q_hi k +
// q_lo k with bf16 k, q_hi k_hi + q_lo k_hi + q_hi k_lo with f32 k (lo x lo,
// 2^-22 of the product, is dropped), and p v likewise with p split.  The
// small terms are summed in an f32 accumulator of their own and added to
// the hi x hi sum once, so they are never absorbed one by one into the
// larger sum; p v is summed per kv block from zero and folded into the
// accumulator as acc * alpha + pv in f32 FFMA, so the tensor core's own
// accumulation never runs over more than one block.  (Summing the small
// terms first into the one accumulator, in a second pass over the
// fragments, read 1.42 ms at granite's prefill against 1.22 for this on
// an NVIDIA H100 80GB HBM3 at 700 W; PERF.md.)  A one-pass TF32 product
// (q rounded to 10 bits) is not used: it would change the reference's
// f32 q numerics.
//
// Fragments.  The products sum over hd (q k^T) and over the keys (p v),
// and both sums are order-free, so the k index of a fragment is permuted:
// a lane t of a quad holds elements 2t and 2t + 1 of each 8-wide k-step
// (the PTX layout's t and t + 4).  Then q and f32 k fragments are float2
// reads, bf16 k fragments come from ldmatrix.x4 (a lane's 32-bit register
// holds the bf16 pair 2t, 2t + 1), bf16 v fragments from ldmatrix.x4.trans
// (keys 2t and 2t + 1 of one column), and the p fragment of p v is the
// score accumulator itself, element for element, with no shuffle.  Shared
// rows are padded to a pitch of 16-byte chunks that makes every fragment
// read of a warp free of bank conflicts: 2 mod 4 chunks for rows read as
// float2 pairs (f32 q and k), odd for rows read by ldmatrix or as scalars.
//
// q is f32 or bf16, k and v one of the two; hd is any multiple of 8 up to
// 256; the O accumulator is sized for hd <= 64, 128 or 256.
//
// Bound: on the live (q, k) pairs 4 hd flop each (q k^T and p v) against q,
// k, v read once and o written once.  At granite's prefill (32 heads,
// hd 64, S = T = 4000, causal, f32 q, bf16 k and v) that is 6.6e10 flop,
// 2.6e8 pairs, against 98 MB: as two TF32 passes on the tensor cores
// (495 TFLOP/s) 0.27 ms, as f32 FFMA 0.98 ms.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dmma_tile.cuh"

namespace {

constexpr int kBQ = 64;         // q rows per CTA, 16 a warp
constexpr int kBK = 64;         // kv rows per block, hd <= 128
constexpr int kBKWide = 32;     // kv rows per block, hd > 128
constexpr int kThreads = 128;   // 4 warps
constexpr int kStages = 2;      // k/v ring
constexpr float kNegInf = -1e30f;

enum FlashDType : int { kFlashF32 = 0, kFlashBF16 = 1 };

template <int kHD>
__host__ __device__ constexpr int block_kv() { return kHD > 128 ? kBKWide : kBK; }

// Row pitches in 16-byte chunks (see the file comment).
__host__ __device__ constexpr int pitch_pairs(int c) { return c + (6 - c % 4) % 4; }
__host__ __device__ constexpr int pitch_odd(int c) { return c | 1; }

struct Pitches {
  int cq, ckv, pq, pk, pv;  // chunks a row of q, of k and v; pitches
};

template <class TQ, class TKV>
__host__ __device__ Pitches flash_pitches(int hd) {
  Pitches p;
  p.cq = hd * static_cast<int>(sizeof(TQ)) / 16;
  p.ckv = hd * static_cast<int>(sizeof(TKV)) / 16;
  p.pq = std::is_same_v<TQ, float> ? pitch_pairs(p.cq) : pitch_odd(p.cq);
  p.pk = std::is_same_v<TKV, float> ? pitch_pairs(p.ckv) : pitch_odd(p.ckv);
  p.pv = pitch_odd(p.ckv);
  return p;
}

template <class TQ, class TKV, int kHD>
size_t flash_smem(int hd) {
  const Pitches p = flash_pitches<TQ, TKV>(hd);
  return 16 * (static_cast<size_t>(kBQ) * p.pq +
               static_cast<size_t>(kStages) * block_kv<kHD>() * (p.pk + p.pv));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to 2^-22 of |x|, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b on one 16 x 8 tile, depth 8 (TF32 operands, f32 accumulator).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kTrans>
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* p) {
  const unsigned a = repro::dmma::smem_addr(p);
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
  }
}

// The two f32 (TF32-exact) values of a bf16 pair, lower address first.
__device__ __forceinline__ uint32_t bf16_lo(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t bf16_hi(uint32_t w) { return w & 0xffff0000u; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   repro::dmma::smem_addr(dst)),
               "l"(src), "r"(bytes));
}

template <class T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// kHD: the widest head dim of the instantiation (64, 128 or 256).
template <class TQ, class TKV, int kHD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, TQ* __restrict__ o, int64_t S,
                 int64_t T, int hd, int causal, int64_t window) {
  constexpr int BK = block_kv<kHD>();
  constexpr int NS = BK / 8;               // key n-tiles of q k^T, k-steps of p v
  constexpr int NO = kHD / 8;              // n-tiles of the accumulator
  constexpr int CH = kHD > 128 ? 4 : 8;    // n-tiles of O a p v chunk
  constexpr bool kQF32 = std::is_same_v<TQ, float>;
  constexpr bool kKVF32 = std::is_same_v<TKV, float>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Pitches pt = flash_pitches<TQ, TKV>(hd);
  unsigned char* sq = smem;
  unsigned char* ring = smem + 16 * kBQ * pt.pq;
  const int stage_bytes = 16 * BK * (pt.pk + pt.pv);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.y;
  // The heaviest causal q blocks (the last ones) are scheduled first.
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int64_t q_end = q0 + kBQ - 1;
  const int nsteps = hd / 8;  // k-steps of q k^T, n-tiles of O
  const int64_t qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const TQ* qb = q + bh * S * hd;
  const TKV* kb = k + bh * T * hd;
  const TKV* vb = v + bh * T * hd;

  // The TPU kernel's block skip, as a range of live kv blocks.
  const int64_t nk = (T + BK - 1) / BK;
  int64_t j_last = nk - 1;
  if (causal && q_end / BK < j_last) j_last = q_end / BK;
  int64_t j_first = 0;
  if (window >= 0 && q0 - window + 1 > 0) j_first = (q0 - window + 1) / BK;

  // Rows [r0, r0 + rows) of a (limit, hd) matrix of `chunks` 16-byte
  // chunks a row into shared rows of `pitch` chunks; zero past `limit`.
  auto fill = [&](unsigned char* dst, const void* src, int64_t r0, int64_t limit, int rows,
                  int chunks, int pitch) {
    const unsigned char* s = static_cast<const unsigned char*>(src);
    for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
      const int r = e / chunks, c = e - r * chunks;
      const bool in = r0 + r < limit;
      cp_async16(dst + 16 * (r * pitch + c), in ? s + 16 * ((r0 + r) * chunks + c) : s,
                 in ? 16 : 0);
    }
  };
  auto fill_kv = [&](int slot, int64_t j) {
    unsigned char* st = ring + slot * stage_bytes;
    fill(st, kb, j * BK, T, BK, pt.ckv, pt.pk);
    fill(st + 16 * BK * pt.pk, vb, j * BK, T, BK, pt.ckv, pt.pv);
  };

  fill(sq, qb, q0, S, kBQ, pt.cq, pt.pq);
  if (j_first <= j_last) fill_kv(0, j_first);
  repro::dmma::cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, lsum[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // q's A fragment of k-step ks: a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1),
  // a3 (g + 8, 2t + 1), as hi and lo (lo zero for bf16 q).
  auto q_frag = [&](int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const unsigned char* r0 = sq + 16 * (warp * 16 + g) * pt.pq;
    const unsigned char* r1 = r0 + 16 * 8 * pt.pq;
    if constexpr (kQF32) {
      const float2 x0 = *reinterpret_cast<const float2*>(r0 + 4 * (8 * ks + 2 * t));
      const float2 x1 = *reinterpret_cast<const float2*>(r1 + 4 * (8 * ks + 2 * t));
      const float a[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
    } else {
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(r0 + 2 * (8 * ks + 2 * t));
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(r1 + 2 * (8 * ks + 2 * t));
      hi[0] = bf16_lo(w0); hi[1] = bf16_lo(w1); hi[2] = bf16_hi(w0); hi[3] = bf16_hi(w1);
#pragma unroll
      for (int i = 0; i < 4; ++i) lo[i] = 0u;
    }
  };

  int slot = 0;
  for (int64_t j = j_first; j <= j_last; ++j) {
    repro::dmma::cp_async_wait<0>();
    __syncthreads();  // block j landed; every warp is past block j - 1
    if (j < j_last) fill_kv(slot ^ 1, j + 1);
    repro::dmma::cp_async_commit();
    const unsigned char* sk = ring + slot * stage_bytes;
    const unsigned char* sv = sk + 16 * BK * pt.pk;
    const int64_t k0 = j * BK;

    // ---- s = q k^T over hd: the hi x hi products in s, the small terms
    // in sl, each summed in f32 on its own and added once.
    float s[NS][4], sl[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = sl[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NO; ++ks) {
      if (ks >= nsteps) break;
      uint32_t qh[4], ql[4];
      q_frag(ks, qh, ql);
      if constexpr (kKVF32) {
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
          const float2 kv = *reinterpret_cast<const float2*>(
              sk + 16 * (8 * nt + g) * pt.pk + 4 * (8 * ks + 2 * t));
          uint32_t h0, h1, l0, l1;
          split(kv.x, h0, l0);
          split(kv.y, h1, l1);
          if constexpr (kQF32) mma(sl[nt], ql, h0, h1);
          mma(sl[nt], qh, l0, l1);
          mma(s[nt], qh, h0, h1);
        }
      } else {
#pragma unroll
        for (int n0 = 0; n0 < NS; n0 += 4) {
          uint32_t r[4];
          ldmatrix4<false>(r, sk + 16 * ((8 * (n0 + (lane >> 3)) + (lane & 7)) * pt.pk + ks));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t b0 = bf16_lo(r[i]), b1 = bf16_hi(r[i]);
            if constexpr (kQF32) mma(sl[n0 + i], ql, b0, b1);
            mma(s[n0 + i], qh, b0, b1);
          }
        }
      }
    }
    if constexpr (kQF32 || kKVF32) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] += sl[i][e];
    }

    // ---- mask (blocks that hold a masked pair), online softmax
    const bool full = k0 + BK <= T && (!causal || k0 + BK - 1 <= q0) &&
                      (window < 0 || k0 > q_end - window);
    if (!full) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t kpos = k0 + 8 * nt + 2 * t + (e & 1), qpos = qrow[e >> 1];
          bool ok = kpos < T;
          if (causal) ok = ok && kpos <= qpos;
          if (window >= 0) ok = ok && kpos > qpos - window;
          if (!ok) s[nt][e] = kNegInf;
        }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = expf(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - m_new);
          sum += s[nt][e];
        }
      lsum[h] = lsum[h] * alpha[h] + sum;
      m[h] = m_new;
    }

    // ---- acc = acc * alpha + p v, CH n-tiles of O at a time; p v from
    // zero, the small terms first.  p's A fragment of k-step kk is the
    // score tile kk: a0 = s[kk][0], a1 = s[kk][2], a2 = s[kk][1], a3 = s[kk][3].
#pragma unroll
    for (int c0 = 0; c0 < NO; c0 += CH) {
      if (c0 >= nsteps) break;
      float pv[CH][4], pvl[CH][4];
#pragma unroll
      for (int i = 0; i < CH; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[i][e] = pvl[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        uint32_t ph[4], pl[4];
        const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) split(a[i], ph[i], pl[i]);
        if constexpr (kKVF32) {
          const unsigned char* r0 = sv + 16 * (8 * kk + 2 * t) * pt.pv;
          const unsigned char* r1 = r0 + 16 * pt.pv;
#pragma unroll
          for (int i = 0; i < CH; ++i) {
            const int nt = c0 + i;
            if (nt >= nsteps) break;
            const float v0 = *reinterpret_cast<const float*>(r0 + 4 * (8 * nt + g));
            const float v1 = *reinterpret_cast<const float*>(r1 + 4 * (8 * nt + g));
            uint32_t h0, h1, l0, l1;
            split(v0, h0, l0);
            split(v1, h1, l1);
            mma(pvl[i], pl, h0, h1);
            mma(pvl[i], ph, l0, l1);
            mma(pv[i], ph, h0, h1);
          }
        } else {
#pragma unroll
          for (int n0 = 0; n0 < CH; n0 += 4) {
            if (c0 + n0 >= nsteps) break;
            int chunk = c0 + n0 + (lane >> 3);
            chunk = chunk < pt.ckv ? chunk : pt.ckv - 1;  // past hd: unused tiles
            uint32_t r[4];
            ldmatrix4<true>(r, sv + 16 * ((8 * kk + (lane & 7)) * pt.pv + chunk));
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (c0 + n0 + i < nsteps) {
                const uint32_t b0 = bf16_lo(r[i]), b1 = bf16_hi(r[i]);
                mma(pvl[n0 + i], pl, b0, b1);
                mma(pv[n0 + i], ph, b0, b1);
              }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (c0 + i >= nsteps) break;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[c0 + i][e] = fmaf(acc[c0 + i][e], alpha[e >> 1], pv[i][e] + pvl[i][e]);
      }
    }
    slot ^= 1;
  }
  repro::dmma::cp_async_wait<0>();

  TQ* ob = o + bh * S * hd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lsum[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    if (qrow[h] >= S) continue;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      if (nt >= nsteps) break;
      store2<TQ>(ob + qrow[h] * hd + 8 * nt + 2 * t, acc[nt][2 * h] * inv,
                 acc[nt][2 * h + 1] * inv);
    }
  }
}

template <class TQ, class TKV, int kHD>
int launch_flash_hd(const void* q, const void* k, const void* v, void* o, int64_t bh,
                    int64_t s, int64_t t, int hd, int causal, int64_t window,
                    cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((s + kBQ - 1) / kBQ), static_cast<unsigned>(bh));
  return static_cast<int>(repro::launch(
      flash_fwd_kernel<TQ, TKV, kHD>, grid, dim3(kThreads), flash_smem<TQ, TKV, kHD>(hd),
      stream, static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o), s, t, hd, causal, window));
}

template <class TQ, class TKV>
int launch_flash(const void* q, const void* k, const void* v, void* o, int64_t bh,
                 int64_t s, int64_t t, int hd, int causal, int64_t window,
                 cudaStream_t stream) {
  if (hd <= 64)
    return launch_flash_hd<TQ, TKV, 64>(q, k, v, o, bh, s, t, hd, causal, window, stream);
  if (hd <= 128)
    return launch_flash_hd<TQ, TKV, 128>(q, k, v, o, bh, s, t, hd, causal, window, stream);
  return launch_flash_hd<TQ, TKV, 256>(q, k, v, o, bh, s, t, hd, causal, window, stream);
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
