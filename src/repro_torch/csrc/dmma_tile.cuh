// FP64 tensor-core tile for Hopper, shared by the f64 kernels of
// sketch_accum, sketch_matmul and project_out: one CTA of 8 warps owns a
// 128 x 128 output tile, each warp 64 x 32 of it as 4 x 4 tiles of
// mma.sync.aligned.m16n8k4.f64.
//
// DMMA computes in IEEE double precision (this is not TF32), so the
// kernels keep eq. (3)'s precision.  Each warp's accumulator lives in
// registers as 64 doubles a thread, in the PTX fragment layout of
// m16n8k4 f64 (g = lane >> 2, t = lane & 3):
//   A (16 x 4):  a0 = A[g][t], a1 = A[g + 8][t]
//   B (4 x 8):   b0 = B[t][g]
//   C (16 x 8):  c[e] = C[g + 8 (e >> 1)][2 t + (e & 1)]
// Hopper's deeper f64 shapes (m16n8k8, k16) run at the same rate on
// registers (benchmarks/bench_dmma.py) and need more fragment registers.
//
// Operands go from global to shared memory through a ring of kStages
// stages of kDmmaBK depth rows, filled by cp.async (commit_group /
// wait_group): while the warps multiply one stage, the next kStages - 1
// are in flight.  One barrier a stage.  Out-of-range elements are
// zero-filled by the copy itself (src-size 0), and zeros add exactly, so
// ragged edges need no padding.  16-byte copies need 16-byte aligned base
// pointers and even row pitches; the kernels take them as the template
// flag kVec16 (decided by the C entry points, dmma_aligned) and use 8-byte
// copies otherwise.
//
// Shared layout of one stage, 2 x kDmmaBM x kDmmaBK doubles (32 KB):
//   depth-contiguous ("kc", a row-major A tile): element (r, k) of the
//     kDmmaBM x kDmmaBK tile at r * kDmmaBK + 16-byte chunk (k / 2)
//     XOR 2 (r & 3);
//   row-contiguous ("mn", a B tile or a transposed A tile): element (k, c)
//     of the kDmmaBK x 128 tile at k * 128 + chunk (c / 2) XOR 2 (k & 3).
// The XOR swizzle makes every fragment read of a half-warp hit 16
// distinct 8-byte banks, without padding (which the 128 KB running tile
// of sketch_accum leaves no room for).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kDmmaBM = 128, kDmmaBN = 128;  // CTA tile
constexpr int kDmmaBK = 16;                  // depth rows a stage
constexpr int kDmmaThreads = 256;            // 8 warps: 2 (rows) x 4 (cols)
constexpr int kDmmaWM = 64, kDmmaWN = 32;    // warp tile
constexpr int kDmmaMT = kDmmaWM / 16, kDmmaNT = kDmmaWN / 8;
constexpr int kDmmaTileElems = kDmmaBM * kDmmaBK;  // one operand, one stage
constexpr int kDmmaAccs = kDmmaMT * kDmmaNT * 4;   // accumulators a thread
static_assert(kDmmaBM == kDmmaBN, "tile shape");
// The depth-contiguous swizzle XORs a row's eight 16-byte chunks: it needs
// at least 16 depth rows a stage, and a multiple of 16.
static_assert(kDmmaBK % 16 == 0, "stage depth");

// Dynamic shared bytes of a ring of `stages` stages plus `extra` bytes.
constexpr int dmma_smem_bytes(int stages, int extra = 0) {
  return stages * 2 * kDmmaTileElems * 8 + extra;
}

// 16-byte copies are legal for an operand whose base is 16-byte aligned
// and whose row pitch is even.
inline bool dmma_aligned(const void* p, int64_t ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (ld & 1) == 0;
}

using DmmaAcc = double[kDmmaMT][kDmmaNT][4];

namespace dmma {

__device__ __forceinline__ int kc_index(int r, int k) {
  return r * kDmmaBK + ((((k >> 1) ^ ((r & 3) << 1))) << 1) + (k & 1);
}

__device__ __forceinline__ int mn_index(int k, int c) {
  return k * kDmmaBN + ((((c >> 1) ^ ((k & 3) << 1))) << 1) + (c & 1);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (0, 8 or 16) of `src` to shared `dst`, zero-filling the
// rest of the 16 (kVec16) or 8 bytes.
template <bool kVec16>
__device__ __forceinline__ void cp_async(double* dst, const double* src, int bytes) {
  if constexpr (kVec16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// d += a b on one 16 x 8 tile, depth 4.
__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[2], double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// Fill one operand's stage: tile element (i, kk), i < 128 along the
// output's rows (A) or columns (B), kk < kDmmaBK along the depth, is
// src[(i0 + i) * ld + k0 + kk] (kKContig) or src[(k0 + kk) * ld + i0 + i];
// zero where i0 + i >= extent or k0 + kk >= depth.
template <bool kKContig, bool kVec16>
__device__ __forceinline__ void load_stage(double* s, const double* src, int64_t ld,
                                           int64_t extent, int64_t depth,
                                           int64_t i0, int64_t k0) {
  constexpr int kWidth = kVec16 ? 2 : 1;  // doubles a copy
  constexpr int kCopies = kDmmaTileElems / kWidth / kDmmaThreads;
  // Copy q of this thread is element e = (tid + q * threads) * kWidth of
  // the tile, neighbouring threads on neighbouring addresses of src; from
  // one copy to the next only i (kKContig) or kk moves, by a constant.
  constexpr int kStepI = kKContig ? kDmmaThreads * kWidth / kDmmaBK : 0;
  constexpr int kStepK = kKContig ? 0 : kDmmaThreads * kWidth / kDmmaBN;
  const int e = threadIdx.x * kWidth;
  const int i = kKContig ? e / kDmmaBK : e % kDmmaBN;
  const int kk = kKContig ? e % kDmmaBK : e / kDmmaBN;
  const int64_t gi = i0 + i, gk = k0 + kk;
  const double* g = kKContig ? src + gi * ld + gk : src + gk * ld + gi;
  const int64_t step = (kStepI + kStepK) * ld;  // src elements a copy
#pragma unroll
  for (int q = 0; q < kCopies; ++q) {
    const int64_t gq = kKContig ? gi + q * kStepI : gk + q * kStepK;
    const bool in = kKContig ? (gq < extent && gk < depth) : (gi < extent && gq < depth);
    const int64_t left = kKContig ? depth - gk : extent - gi;  // >= 1 when in
    const int bytes = in ? 8 * static_cast<int>(left < kWidth ? left : kWidth) : 0;
    double* d = s + (kKContig ? kc_index(i + q * kStepI, kk) : mn_index(kk + q * kStepK, i));
    cp_async<kVec16>(d, in ? g + q * step : src, bytes);
  }
}

// acc += A_stage B_stage for this warp's 64 x 32 part, depth in order.
template <bool kATrans>
__device__ __forceinline__ void mma_stage(const double* sa, const double* sb, DmmaAcc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp >> 2) * kDmmaWM, wc = (warp & 3) * kDmmaWN;
#pragma unroll
  for (int k0 = 0; k0 < kDmmaBK; k0 += 4) {
    const int k = k0 + t;
    double af[kDmmaMT][2], bf[kDmmaNT];
#pragma unroll
    for (int mt = 0; mt < kDmmaMT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wr + mt * 16 + g + 8 * i;
        af[mt][i] = sa[kATrans ? mn_index(k, r) : kc_index(r, k)];
      }
#pragma unroll
    for (int nt = 0; nt < kDmmaNT; ++nt) bf[nt] = sb[mn_index(k, wc + nt * 8 + g)];
#pragma unroll
    for (int mt = 0; mt < kDmmaMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kDmmaNT; ++nt) mma(acc[mt][nt], af[mt], bf[nt]);
  }
}

}  // namespace dmma

__device__ __forceinline__ void dmma_zero(DmmaAcc& acc) {
#pragma unroll
  for (int mt = 0; mt < kDmmaMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kDmmaNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0;
}

// f(idx, row, col, v) for each accumulator of the thread: idx in
// [0, kDmmaAccs) its index, (row, col) its place in the output, v a
// reference to it.
template <class F>
__device__ __forceinline__ void dmma_for_each(DmmaAcc& acc, int64_t row0, int64_t col0, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t r0 = row0 + (warp >> 2) * kDmmaWM + g;
  const int64_t c0 = col0 + (warp & 3) * kDmmaWN + 2 * t;
#pragma unroll
  for (int mt = 0; mt < kDmmaMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kDmmaNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f((mt * kDmmaNT + nt) * 4 + e, r0 + mt * 16 + 8 * (e >> 1),
          c0 + nt * 8 + (e & 1), acc[mt][nt][e]);
}

// acc += A[row0:row0+128, 0:depth] B[0:depth, col0:col0+128], walking the
// depth in order, kDmmaBK rows a stage, through a ring of kStages stages at
// `smem`.  A is a (rows x depth, pitch lda) or, with kATrans, its
// transpose: a (depth x rows, pitch lda) array read as A[r][k] = a[k][r]
// (real: the conjugate is the identity).  B is (depth x cols, pitch ldb).
// after(kt, ktiles) runs after each stage's product, in every thread.
//
// Every warp multiplies all its tiles, also those wholly past the last row
// or column of a ragged block (at l = 800 the 7th row block holds 32 rows
// of 128): skipping them, tested inside the loop or by a second copy of
// the loop, measured slower on the H100 (PERF.md).
template <bool kATrans, bool kVec16, int kStages, class After>
__device__ __forceinline__ void dmma_mainloop(
    double* smem, const double* __restrict__ a, int64_t lda, int64_t rows,
    const double* __restrict__ b, int64_t ldb, int64_t cols, int64_t depth,
    int64_t row0, int64_t col0, DmmaAcc& acc, After after) {
  static_assert(kStages >= 2, "a ring needs two stages");
  const int64_t ktiles = (depth + kDmmaBK - 1) / kDmmaBK;
  auto fill = [&](int slot, int64_t kt) {
    double* s = smem + slot * 2 * kDmmaTileElems;
    dmma::load_stage<!kATrans, kVec16>(s, a, lda, rows, depth, row0, kt * kDmmaBK);
    dmma::load_stage<false, kVec16>(s + kDmmaTileElems, b, ldb, cols, depth, col0,
                                    kt * kDmmaBK);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) fill(s, s);
    dmma::cp_async_commit();
  }
  int slot = 0;
  for (int64_t kt = 0; kt < ktiles; ++kt) {
    dmma::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; every warp is past stage kt - 1
    const int64_t next = kt + kStages - 1;
    if (next < ktiles) fill(slot == 0 ? kStages - 1 : slot - 1, next);
    dmma::cp_async_commit();
    const double* s = smem + slot * 2 * kDmmaTileElems;
    dmma::mma_stage<kATrans>(s, s + kDmmaTileElems, acc);
    after(kt, ktiles);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
  dmma::cp_async_wait<0>();
}

}  // namespace repro
