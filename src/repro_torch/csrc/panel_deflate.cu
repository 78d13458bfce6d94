// Panel deflation of the split blocked QR for Hopper:
//   (O, W) = (Z - Q_p W, W = Q_p^H Z)
// for an orthonormal panel Q_p (l x b, b <= 64) and the trailing residual
// Z (l x n), in f32, f64, c64 and c128.
//
// Replaces the TPU kernel panel_deflate_kernel (repro/kernels/cgs/kernel.py),
// which walks the column slabs of Z with Q_p resident in VMEM and makes one
// VMEM round trip over each slab: W and O are formed back to back from the
// one copy of the slab.  Here that property is kept: one CTA per column
// slab of NC columns, and the slab is read from device memory once.
//
// One CTA of 8 warps, two passes over l; 16-byte cp.async copies where
// both operands allow it (the twin <..., false> copies one element at a
// time); rows past l and columns past b or n are zero-filled by the copy
// itself, so ragged edges add zeros:
//   pass 1  a ring of cp.async stages holds rows of Q_p; the same rows of
//           the slab go to the resident slab in shared memory
//           (kDeflateZAhead chunks of it a stage, so the slab's copies run
//           ahead of the panel's and most of it is in flight early).  W
//           (b x NC) is formed in registers, each element one sum over l in
//           order (no split of l, no atomics: a repeated call gives the same
//           bits), then stored to W and to shared memory;
//   pass 2  O = Z - Q_p W from the resident slab, with Q_p read again
//           (from L2: every CTA reads the same panel), stored to O.
// Stages hold kDeflateRows rows.  f64 (the main path's type): a ring of
// kDeflateDmmaStages in pass 1 (W takes the ring's place after it); pass 2
// has no ring and no barrier: warp w owns the 16-row tiles w, w + 8, ...
// of O and loads their Q_p fragments from global memory into registers,
// two tiles ahead of the one it multiplies.  (On an NVIDIA H100 80GB
// HBM3 at 700 W, PERF.md: with two 32-row stages through both passes
// 0.240 ms, each stage waiting out an L2 round trip; six 16-row stages
// and registers one tile ahead 0.215, pass 1 alone 0.152 of that; three
// 32-row stages with registers two tiles ahead 0.172.)  f32, c64, c128:
// a ring of kDeflateStages in both passes.
// When the slab does not fit (l x NC x sizeof(T) with W and the ring over
// kDeflateSmemBudget), the shape selects the re-reading geometry
// <..., kResident = false>: the stages hold the chunk of the slab beside
// the chunk of Q_p, and pass 2 reads Z a second time (f64: from global
// memory in its epilogue; the others: through the ring).
//
// Slab width: 32 columns (f64 at l = 800: 204800 B, one CTA an SM, Q_p
// read twice a CTA) or 16 (102400 B: two CTAs an SM, the panel read
// twice as often); kDeflateCols is the measured choice (PERF.md).
//
// Arithmetic.  f64 runs both products on the FP64 tensor cores, mma.sync
// m16n8k4 of dmma_tile.cuh (IEEE double, not TF32): W tiles of 16 panel
// columns x 8 slab columns with Q_p^H as the transposed A operand, summed
// over l four rows an instruction; O tiles of 16 rows x 8 columns with
// K = b, four panel columns an instruction.  The panel is padded to
// bp = roundup(b, 16) columns with zeros in shared memory (b = 1..15, and
// any b % 16 != 0, b % 4 != 0 included): the padded rows of W are zero,
// so the padded k-steps of O add exact zeros.  Shared layouts are
// XOR-swizzled in 4-element groups, (r, c) at r * pitch + (c ^ 4 (r & 3)),
// so every fragment read of a half-warp hits 16 distinct 8-byte banks.
// f32, c64 and c128 run a register tile: in pass 1 a thread owns TM panel
// columns x TN slab columns of W, in pass 2 two rows x TN columns of O;
// each shared-memory load feeds at least 4 FMAs.  f32 is IEEE FFMA, never
// TF32 (eq. (3)); complex W takes the conjugate of Q_p as it is loaded.
//
// Bound at the main shape (f64, l=800, b=32, n=2^14): 214 MB (Z and Q_p
// in, O and W out) against 1.7 GFLOP, 0.064 ms of HBM against 0.025 ms of
// DMMA: bytes.  The sweep this replaces read Z twice (320 MB in all).
#include <type_traits>

#include "dmma_tile.cuh"
#include "panel_common.cuh"
#include "ring.cuh"

namespace {

using namespace repro;

constexpr int kDeflateThreads = 256;    // 8 warps
constexpr int kDeflateStages = 2;       // ring of the register-tile kernels
constexpr int kDeflateDmmaStages = 3;   // ring of the f64 kernel's pass 1
constexpr int kDeflateZAhead = 4;       // slab chunks copied a pass-1 stage
constexpr int kDeflateSmemBudget = 232448;

// Slab columns a CTA, 16 or 32 (c128: 16, its register tile's width):
// kDeflateCols first, then 16 when a resident slab of kDeflateCols does not
// fit.
constexpr int kDeflateCols = 32;
template <class T>
__host__ __device__ constexpr int deflate_max_cols() { return sizeof(T) == 16 ? 16 : 32; }
template <class T>
__host__ __device__ constexpr int deflate_cols() {
  return kDeflateCols < deflate_max_cols<T>() ? kDeflateCols : deflate_max_cols<T>();
}

// Rows of l a ring stage, and the ring's depth.
constexpr int kDeflateRows = 32;
template <class T>
__host__ __device__ constexpr int deflate_stages() {
  return std::is_same_v<T, double> ? kDeflateDmmaStages : kDeflateStages;
}

// Register tile of the f32 / c64 / c128 kernels: pass 1 TM x TN of W,
// pass 2 kPass2Rows x TN of O.
template <class T> struct DeflateTile { static constexpr int TM = 4, TN = 4; };
template <> struct DeflateTile<cplx<float>> { static constexpr int TM = 2, TN = 4; };
template <> struct DeflateTile<cplx<double>> { static constexpr int TM = 2, TN = 2; };
constexpr int kPass2Rows = 2;

// N consecutive elements of shared memory (16-byte aligned for f32 when
// N % 4 == 0: four floats a load).
template <int N, class T>
__device__ __forceinline__ void ld_run(const T* p, T (&v)[N]) {
  if constexpr (std::is_same_v<T, float> && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x; v[i + 1] = x.y; v[i + 2] = x.z; v[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

__host__ __device__ constexpr int padded_panel(int b) { return (b + 15) & ~15; }

// Dynamic shared bytes: the slab (resident), W, the ring; the f64 kernel
// puts W in the ring's place once pass 1 is done.
template <class T>
size_t deflate_smem(int nc, bool resident, int64_t l, int b) {
  const int r = kDeflateRows, bp = padded_panel(b);
  const int64_t slab = resident ? (l + r - 1) / r * r * nc : 0;
  const int64_t ring =
      static_cast<int64_t>(deflate_stages<T>()) * r * (bp + (resident ? 0 : nc));
  const int64_t wsz = static_cast<int64_t>(bp) * nc;
  const int64_t elems =
      slab + (std::is_same_v<T, double> ? (ring > wsz ? ring : wsz) : ring + wsz);
  return sizeof(T) * static_cast<size_t>(elems);
}

// Rows [r0, r0 + R) of Q_p (l x b) into a stage of bp columns, zero past b
// and l; E elements a copy.
template <class T, int R, int E>
__device__ __forceinline__ void fill_panel(T* s, const T* qp, int64_t r0, int64_t l, int b,
                                           int bp) {
  constexpr int CB = E * static_cast<int>(sizeof(T));
  for (int e = threadIdx.x * E; e < R * bp; e += kDeflateThreads * E) {
    const int rr = e / bp, p = e - rr * bp;
    const int64_t r = r0 + rr;
    const int left = b - p;
    const bool in = r < l && left > 0;
    const int bytes = in ? static_cast<int>(sizeof(T)) * (left < E ? left : E) : 0;
    cp_async_bytes<CB>(s + swz(rr, p, bp), in ? qp + r * b + p : qp, bytes);
  }
}

// Rows [r0, r0 + R) of the slab at column col0 of z (l x n) into d (pitch
// NC), zero past n and l.
template <class T, int R, int NC, int E>
__device__ __forceinline__ void fill_slab(T* d, const T* z, int64_t r0, int64_t l, int64_t n,
                                          int64_t col0) {
  constexpr int CB = E * static_cast<int>(sizeof(T));
  for (int e = threadIdx.x * E; e < R * NC; e += kDeflateThreads * E) {
    const int rr = e / NC, c = e - rr * NC;
    const int64_t r = r0 + rr, left = n - (col0 + c);
    const bool in = r < l && left > 0;
    const int bytes =
        in ? static_cast<int>(sizeof(T)) * static_cast<int>(left < E ? left : E) : 0;
    cp_async_bytes<CB>(d + swz(rr, c, NC), in ? z + r * n + col0 + c : z, bytes);
  }
}

// f64 on the FP64 tensor cores.  Pass 1 streams the panel (and the slab)
// through a ring of kDeflateDmmaStages stages: W tiles
// (16 panel columns x 8 slab columns) one or two a warp, Q_p^H the
// transposed A operand.  Pass 2 needs no ring and no barrier: warp w owns
// the 16-row tiles w, w + 8, ... of O, all NC columns, and loads their A
// fragments (32 panel columns at a time) straight from global memory (L2)
// into registers, two items ahead of the one it multiplies.
template <int NC, bool kResident, bool kVec16>
__device__ __forceinline__ void deflate_dmma(unsigned char* smem_raw,
                                             const double* __restrict__ qp,
                                             const double* __restrict__ z,
                                             double* __restrict__ o, double* __restrict__ w,
                                             int64_t l, int b, int64_t n) {
  constexpr int R = kDeflateRows, S = kDeflateDmmaStages, NT = NC / 8;
  constexpr int E = kVec16 ? 2 : 1;
  const int bp = padded_panel(b);
  const int64_t chunks = (l + R - 1) / R;
  double* slab = reinterpret_cast<double*>(smem_raw);     // chunks R x NC (resident)
  double* ring = slab + (kResident ? chunks * R * NC : 0);  // S x R x (bp [+ NC])
  double* ws = ring;                                        // bp x NC after pass 1
  const int stage = R * (bp + (kResident ? 0 : NC));
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * NC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // The copies of pass-1 stage s into slot s % S (an empty group past the
  // last stage, so the wait counts stay uniform).
  auto issue = [&](int64_t s) {
    if (s < chunks) {
      double* st = ring + (s % S) * stage;
      fill_panel<double, R, E>(st, qp, s * R, l, b, bp);
      if constexpr (kResident) {
        for (int64_t c = s * kDeflateZAhead; c < (s + 1) * kDeflateZAhead && c < chunks; ++c)
          fill_slab<double, R, NC, E>(slab + c * R * NC, z, c * R, l, n, col0);
      } else {
        fill_slab<double, R, NC, E>(st + R * bp, z, s * R, l, n, col0);
      }
    }
    dmma::cp_async_commit();
  };

  // ---- pass 1: W = Q_p^H Z, tiles (mt, nt) = divmod(warp + 8 i, NT)
  double wacc[2][4] = {};
  const int tiles = bp / 16 * NT;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
  for (int64_t s = 0; s < chunks; ++s) {
    dmma::cp_async_wait<S - 2>();
    __syncthreads();  // stage s landed; every warp is past stage s - 1
    issue(s + S - 1);
    const double* qs = ring + (s % S) * stage;
    const double* zs = kResident ? slab + s * R * NC : qs + R * bp;
#pragma unroll
    for (int k0 = 0; k0 < R; k0 += 4) {
      const int k = k0 + t;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tile = warp + 8 * i;
        if (tile < tiles) {
          const int mt = tile / NT, nt = tile % NT;
          const double a[2] = {qs[swz(k, 16 * mt + g, bp)], qs[swz(k, 16 * mt + g + 8, bp)]};
          dmma::mma(wacc[i], a, zs[swz(k, 8 * nt + g, NC)]);
        }
      }
    }
  }
  dmma::cp_async_wait<0>();
  __syncthreads();  // every warp is past pass 1: the ring is free for W
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tile = warp + 8 * i;
    if (tile < tiles) {
      const int mt = tile / NT, nt = tile % NT;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * mt + g + 8 * (e >> 1), c = 8 * nt + 2 * t + (e & 1);
        ws[swz(p, c, NC)] = wacc[i][e];
        if (p < b && col0 + c < n) w[p * n + col0 + c] = wacc[i][e];
      }
    }
  }
  __syncthreads();

  // ---- pass 2: O = Z - Q_p W; item i of this warp is the 32 panel
  // columns kc of its m-tile mt.
  const int64_t mtiles = (l + 15) / 16;
  const int nkc = (bp + 31) / 32;
  const int64_t items = (warp < mtiles ? (mtiles - warp + 7) / 8 : 0) * nkc;
  auto load = [&](double (&a)[8][2], int64_t i) {
    const int64_t r0 = 16 * (warp + 8 * (i / nkc)) + g;
    const int kc = static_cast<int>(i % nkc);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int k = 32 * kc + 4 * ks + t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = r0 + 8 * h;
        a[ks][h] = (k < b && r < l) ? __ldg(qp + r * b + k) : 0.0;
      }
    }
  };
  double acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0;
  auto step = [&](double (&cur)[8][2], int64_t i) {
    const int kc = static_cast<int>(i % nkc);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int k0 = 32 * kc + 4 * ks;
      if (k0 < bp) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          dmma::mma(acc[nt], cur[ks], ws[swz(k0 + t, 8 * nt + g, NC)]);
      }
    }
    if (kc == nkc - 1) {
      const int64_t mt = warp + 8 * (i / nkc);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t r = 16 * mt + g + 8 * h;
          const int c = 8 * nt + 2 * t;
          const int64_t gc = col0 + c;
          if (r < l) {
            double z0, z1;
            if constexpr (kResident) {
              z0 = slab[swz(static_cast<int>(r), c, NC)];
              z1 = slab[swz(static_cast<int>(r), c + 1, NC)];
            } else {
              z0 = gc < n ? __ldg(z + r * n + gc) : 0.0;
              z1 = gc + 1 < n ? __ldg(z + r * n + gc + 1) : 0.0;
            }
            const double o0 = z0 - acc[nt][2 * h], o1 = z1 - acc[nt][2 * h + 1];
            double* dst = o + r * n + gc;
            if (kVec16 && gc + 1 < n) {
              *reinterpret_cast<double2*>(dst) = make_double2(o0, o1);
            } else {
              if (gc < n) dst[0] = o0;
              if (gc + 1 < n) dst[1] = o1;
            }
          }
          acc[nt][2 * h] = 0.0;
          acc[nt][2 * h + 1] = 0.0;
        }
      }
    }
  };
  // Two items in flight a warp: three fragment buffers in turn.
  double f0[8][2], f1[8][2], f2[8][2];
  if (items > 0) load(f0, 0);
  if (items > 1) load(f1, 1);
  for (int64_t i = 0; i < items; i += 3) {
    if (i + 2 < items) load(f2, i + 2);
    step(f0, i);
    if (i + 1 >= items) break;
    if (i + 3 < items) load(f0, i + 3);
    step(f1, i + 1);
    if (i + 2 >= items) break;
    if (i + 4 < items) load(f1, i + 4);
    step(f2, i + 2);
  }
}

// f32, c64, c128 on a register tile; both passes stream the panel through
// a ring of kDeflateStages stages.
template <class T, int NC, bool kResident, bool kVec16>
__device__ __forceinline__ void deflate_tile(unsigned char* smem_raw, const T* __restrict__ qp,
                                             const T* __restrict__ z, T* __restrict__ o,
                                             T* __restrict__ w, int64_t l, int b, int64_t n) {
  constexpr int R = kDeflateRows;
  constexpr int E = kVec16 ? 16 / static_cast<int>(sizeof(T)) : 1;  // elements a copy
  constexpr int TM = DeflateTile<T>::TM, TN = DeflateTile<T>::TN;
  constexpr int CG = NC / TN;  // column groups of the register tile
  const int bp = padded_panel(b);
  const int64_t chunks = (l + R - 1) / R;
  T* slab = reinterpret_cast<T*>(smem_raw);                // chunks R x NC (resident)
  T* ws = slab + (kResident ? chunks * R * NC : 0);        // bp x NC
  T* ring = ws + bp * NC;                                  // stages x R x (bp [+ NC])
  const int stage = R * (bp + (kResident ? 0 : NC));
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * NC;
  const int tm = threadIdx.x / CG, tn = threadIdx.x % CG;

  // The copies of step s (pass 1: s < chunks, pass 2 after) into slot s % 2.
  auto issue = [&](int64_t s) {
    if (s < 2 * chunks) {
      T* st = ring + (s & 1) * stage;
      const int64_t r0 = (s < chunks ? s : s - chunks) * R;
      fill_panel<T, R, E>(st, qp, r0, l, b, bp);
      if constexpr (kResident) {
        for (int64_t c = s * kDeflateZAhead;
             s < chunks && c < (s + 1) * kDeflateZAhead && c < chunks; ++c)
          fill_slab<T, R, NC, E>(slab + c * R * NC, z, c * R, l, n, col0);
      } else {
        fill_slab<T, R, NC, E>(st + R * bp, z, r0, l, n, col0);
      }
    }
    dmma::cp_async_commit();
  };

  T racc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) racc[i][j] = T{};
  // W from the accumulators to shared memory (all bp rows) and to w.
  auto store_w = [&]() {
    if (tm * TM < bp) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int p = tm * TM + i, c = tn * TN + j;
          ws[swz(p, c, NC)] = racc[i][j];
          if (p < b && col0 + c < n) w[p * n + col0 + c] = racc[i][j];
        }
    }
  };
  if (chunks == 0) {  // l = 0: W = 0, O has no rows
    store_w();
    return;
  }

  issue(0);
  for (int64_t s = 0; s < 2 * chunks; ++s) {
    dmma::cp_async_wait<0>();
    __syncthreads();  // step s landed; every warp is past step s - 1
    if (s == chunks) {
      store_w();
      __syncthreads();
    }
    issue(s + 1);
    const bool first = s < chunks;
    const int64_t r0 = (first ? s : s - chunks) * R;
    const T* qs = ring + (s & 1) * stage;
    const T* zs = kResident ? slab + r0 * NC : qs + R * bp;
    if (first) {
      // W += Q_p^H Z: a TM x TN tile a thread, rows of l in order.
      if (tm * TM < bp) {
#pragma unroll 4
        for (int rr = 0; rr < R; ++rr) {
          T qv[TM], zv[TN];
          ld_run<TM>(qs + swz(rr, tm * TM, bp), qv);
          ld_run<TN>(zs + swz(rr, tn * TN, NC), zv);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) racc[i][j] = madd(conj_of(qv[i]), zv[j], racc[i][j]);
        }
      }
    } else if (threadIdx.x < R / kPass2Rows * CG) {
      // O = Z - Q_p W: kPass2Rows x TN a thread, KP panel columns at a
      // time (f32: four, one float4 of Q_p a row).
      constexpr int KP = std::is_same_v<T, float> ? 4 : 1;
      const int rt = threadIdx.x / CG;
      T acc[kPass2Rows][TN];
#pragma unroll
      for (int i = 0; i < kPass2Rows; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = T{};
#pragma unroll 2
      for (int p0 = 0; p0 < bp; p0 += KP) {
        T qv[kPass2Rows][KP], wv[KP][TN];
#pragma unroll
        for (int i = 0; i < kPass2Rows; ++i)
          ld_run<KP>(qs + swz(rt * kPass2Rows + i, p0, bp), qv[i]);
#pragma unroll
        for (int k = 0; k < KP; ++k) ld_run<TN>(ws + swz(p0 + k, tn * TN, NC), wv[k]);
#pragma unroll
        for (int k = 0; k < KP; ++k)
#pragma unroll
          for (int i = 0; i < kPass2Rows; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = madd(qv[i][k], wv[k][j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kPass2Rows; ++i) {
        const int rr = rt * kPass2Rows + i;
        const int64_t r = r0 + rr;
        if (r >= l) continue;
        T ov[TN];
        ld_run<TN>(zs + swz(rr, tn * TN, NC), ov);
#pragma unroll
        for (int j = 0; j < TN; ++j) ov[j] = ov[j] - acc[i][j];
        const int64_t gc = col0 + tn * TN;
        T* dst = o + r * n + gc;
        if constexpr (kVec16 && std::is_same_v<T, float>) {
          if (gc + TN <= n) {
            *reinterpret_cast<float4*>(dst) = make_float4(ov[0], ov[1], ov[2], ov[3]);
            continue;
          }
        }
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (gc + j < n) dst[j] = ov[j];
      }
    }
  }
  dmma::cp_async_wait<0>();
}

template <class T, int NC, bool kResident, bool kVec16>
__global__ void __launch_bounds__(kDeflateThreads, std::is_same_v<T, double> ? 1 : 2)
panel_deflate_kernel(const T* __restrict__ qp, const T* __restrict__ z,
                     T* __restrict__ o, T* __restrict__ w, int64_t l, int b, int64_t n) {
  static_assert(NC % 16 == 0, "the swizzle spans 16 elements");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (std::is_same_v<T, double>)
    deflate_dmma<NC, kResident, kVec16>(smem_raw, qp, z, o, w, l, b, n);
  else
    deflate_tile<T, NC, kResident, kVec16>(smem_raw, qp, z, o, w, l, b, n);
}

// 16-byte copies need 16-byte aligned bases and rows of whole 16 bytes.
template <class T>
bool deflate_aligned(const void* qp, const void* z, const void* o, int64_t b, int64_t n) {
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  return a16(qp) && a16(z) && a16(o) && (b * sizeof(T)) % 16 == 0 &&
         (n * sizeof(T)) % 16 == 0;
}

template <class T, int NC, bool kResident>
cudaError_t launch_deflate_nc(const T* qp, const T* z, T* o, T* w, int64_t l, int b,
                              int64_t n, bool vec16, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + NC - 1) / NC)), block(kDeflateThreads);
  const size_t smem = deflate_smem<T>(NC, kResident, l, b);
  return vec16 ? launch(panel_deflate_kernel<T, NC, kResident, true>, grid, block, smem,
                        stream, qp, z, o, w, l, b, n)
               : launch(panel_deflate_kernel<T, NC, kResident, false>, grid, block, smem,
                        stream, qp, z, o, w, l, b, n);
}

template <class T, int NC>
cudaError_t launch_deflate_width(const T* qp, const T* z, T* o, T* w, int64_t l, int b,
                                 int64_t n, bool resident, bool vec16, cudaStream_t s) {
  return resident ? launch_deflate_nc<T, NC, true>(qp, z, o, w, l, b, n, vec16, s)
                  : launch_deflate_nc<T, NC, false>(qp, z, o, w, l, b, n, vec16, s);
}

// deflate_cols<T>() resident, then 16 resident, then deflate_cols<T>()
// re-reading: the shapes decide.
template <class T>
cudaError_t launch_deflate(const void* qp_, const void* z_, void* o_, void* w_, int64_t l,
                           int b, int64_t n, cudaStream_t s) {
  int nc = deflate_cols<T>();
  bool resident = deflate_smem<T>(nc, true, l, b) <= kDeflateSmemBudget;
  if (!resident && nc == 32 && deflate_smem<T>(16, true, l, b) <= kDeflateSmemBudget) {
    nc = 16;
    resident = true;
  }
  if ((n + nc - 1) / nc > 0x7fffffff) return cudaErrorInvalidValue;
  const T* qp = static_cast<const T*>(qp_);
  const T* z = static_cast<const T*>(z_);
  T* o = static_cast<T*>(o_);
  T* w = static_cast<T*>(w_);
  const bool vec16 = deflate_aligned<T>(qp, z, o, b, n);
  if constexpr (deflate_max_cols<T>() == 32) {
    if (nc == 32) return launch_deflate_width<T, 32>(qp, z, o, w, l, b, n, resident, vec16, s);
  }
  return launch_deflate_width<T, 16>(qp, z, o, w, l, b, n, resident, vec16, s);
}

}  // namespace

// qp (l, b), z (l, n), o (l, n), w (b, n); all row-major.
extern "C" int repro_panel_deflate(int dtype, const void* qp, const void* z, void* o,
                                   void* w, int64_t l, int64_t b, int64_t n,
                                   void* stream) {
  if (l < 0 || n < 1 || b < 1 || b > repro::kMaxPanel || w == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_deflate, qp, z, o, w, l, static_cast<int>(b), n, s);
}
