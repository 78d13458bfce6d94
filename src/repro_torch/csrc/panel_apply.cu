// Stage B of the distributed panel for Hopper:
//   O = Z - Q_p W   and, when asked, colnorms^2(O)
// for a panel Q_p (l x b, b <= 64), its coefficients W (b x n) and the
// residual Z (l x n), in f32, f64, c64 and c128.
//
// Replaces the TPU kernel panel_apply_kernel (repro/kernels/panel_step/
// kernel.py), which walks the column slabs of Z with Q_p resident in VMEM.
//
// Bound: a byte stream.  At the distributed main shape (f64, l=800, b=32,
// n=2^14) it moves 214 MB (Z and W in, O out) against 0.84 GFLOP: 0.064 ms
// of HBM against 0.025 ms of DFMA.  So the design keeps bytes in flight
// and reads Q_p from L2 as seldom as it can: every CTA stages all of Q_p,
// so wide slabs mean few CTAs' worth of Q_p traffic.
//
// One CTA per column slab of NC columns, one 16-byte vector (E = 16 /
// sizeof(T) columns) a thread a row, so every load and store of Z and O is
// one 16-byte vector.  Slab width by shape: the widest of 64 vectors (256
// threads in 4 row groups: a thread owns the rows = g (mod 4) of each
// chunk) and 32 (256 threads, 8 row groups) that still gives
// kApplyMinCtas CTAs and fits one block's shared memory, else 16 (128
// threads, 8 row groups).  f64 at n = 2^14: 128 columns, 128 CTAs; at a
// 4-rank shard, n = 4096: 32 columns, 128 CTAs.  W's slab goes to shared
// memory once; 32-row chunks of Q_p and of the slab arrive through a ring of
// kApplyStages cp.async stages (16-byte copies where the operands allow it,
// else one element a copy; rows past l and columns past n are zero-filled by
// the copy), one barrier a chunk, and Z is read from device memory once.
// Each W vector read from shared memory feeds 8 (widest) or 4 rows, each
// Q_p vector (a broadcast) E columns.
//
// The arithmetic is the parent's, so O and colnorms^2(O) keep its bits in
// every dtype (and rid_distributed's pivots with them):
//   * each element is s = sum_p madd(Q_p[r, p], W[p, c], s), p = 0..b-1 in
//     order from zero (DFMA / FFMA, never a tensor core), then O = Z - s;
//     every element's chain is its own;
//   * the norm of a column: the partial of residue g (warp g of the parent)
//     sums |O|^2 of the rows = g (mod 8) in increasing order, from the
//     unrounded O before the store, in the one thread that owns those rows;
//     then the 8 partials are added in residue order.
// No atomics and no split of l: repeated calls give the same bits.
#include "dmma_tile.cuh"
#include "panel_common.cuh"
#include "ring.cuh"

namespace {

using namespace repro;

constexpr int kApplyNormGroups = 8;    // norm partials: rows = g (mod 8), the parent's warps
constexpr int kApplyRows = 32;         // rows of l a ring stage
constexpr int kApplyStages = 3;
constexpr int kApplyMinCtas = 128;     // a wider slab only while it gives this many CTAs
constexpr int kApplySmemBudget = 232448;

// Row groups of a slab of NC columns (one 16-byte vector a thread a row):
// 4 for 64 vectors, else 8 (one residue mod 8 a group).
template <class T, int NC>
__host__ __device__ constexpr int apply_row_groups() {
  return NC / vec_elems<T>() == 64 ? 4 : 8;
}

// Threads a CTA: 256 for 64 and 32 vectors, 128 for 16.
template <class T, int NC>
__host__ __device__ constexpr int apply_threads() {
  return NC / vec_elems<T>() * apply_row_groups<T, NC>();
}

// Panel columns in shared memory: b rounded up to whole 16-byte vectors.
template <class T>
__host__ __device__ constexpr int apply_panel(int b) {
  return (b + vec_elems<T>() - 1) / vec_elems<T>() * vec_elems<T>();
}

// Dynamic shared bytes: W's slab, the ring (a chunk of Q_p and of the
// slab a stage), the norm partials.
template <class T>
size_t apply_smem(int nc, int b) {
  const size_t bq = apply_panel<T>(b);
  return sizeof(T) * (bq * nc + static_cast<size_t>(kApplyStages) * kApplyRows * (bq + nc)) +
         sizeof(real_t<T>) * kApplyNormGroups * nc;
}

// Rows [r0, r0 + rows_here) x `width` elements of src (pitch ld, from
// column c0, zero past row `rows` and column `cols`) into dst (pitch
// `pitch`), CE elements a copy; `width` and `pitch` multiples of CE.
template <class T, int CE, int kThreads>
__device__ __forceinline__ void apply_fill(T* dst, const T* src, int64_t ld, int64_t r0,
                                           int64_t rows, int64_t c0, int64_t cols,
                                           int width, int pitch, int rows_here) {
  constexpr int CB = CE * static_cast<int>(sizeof(T));
  const int per_row = width / CE;
  for (int e = threadIdx.x; e < rows_here * per_row; e += kThreads) {
    const int rr = e / per_row, c = (e - rr * per_row) * CE;
    const int64_t r = r0 + rr, left = cols - (c0 + c);
    const bool in = r < rows && left > 0;
    const int bytes =
        in ? static_cast<int>(sizeof(T)) * static_cast<int>(left < CE ? left : CE) : 0;
    cp_async_bytes<CB>(dst + rr * pitch + c, in ? src + r * ld + c0 + c : src, bytes);
  }
}

template <class T, int NC, bool kVec16>
__global__ void __launch_bounds__(apply_threads<T, NC>(), 1)
panel_apply_kernel(const T* __restrict__ qp, const T* __restrict__ w,
                   const T* __restrict__ z, T* __restrict__ o,
                   real_t<T>* __restrict__ r2, int64_t l, int b, int64_t n) {
  using R = real_t<T>;
  constexpr int E = vec_elems<T>();
  constexpr int LPR = NC / E;                              // threads a row
  constexpr int RG = apply_row_groups<T, NC>();           // 8 or 4
  constexpr int kThreads = LPR * RG;
  constexpr int RPT = kApplyRows / RG;                     // rows a thread a chunk
  constexpr int NG = kApplyNormGroups, RES = NG / RG;      // residues a thread: 1 or 2
  constexpr int S = kApplyStages, RR = kApplyRows;
  constexpr int CE = kVec16 ? E : 1;                       // elements a copy
  static_assert(RG * RES == NG && RPT % RES == 0, "row groups of the norm residues");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bq = apply_panel<T>(b);
  const int bfull = b / E * E;                             // panel columns in whole vectors
  T* ws = reinterpret_cast<T*>(smem_raw);                  // bq x NC
  T* ring = ws + bq * NC;                                  // S x (RR x bq, RR x NC)
  const int stage = RR * (bq + NC);
  R* rs = reinterpret_cast<R*>(ring + S * stage);          // NG x NC
  const int g = threadIdx.x / LPR;                        // rows = g (mod RG)
  const int cl = (threadIdx.x % LPR) * E;                  // this thread's first slab column
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * NC;
  const int64_t chunks = (l + RR - 1) / RR;

  // Chunk s of Q_p and of the slab into slot s % S (an empty group past
  // the last chunk, so the wait counts stay uniform).
  auto issue = [&](int64_t s) {
    if (s < chunks) {
      T* st = ring + (s % S) * stage;
      apply_fill<T, CE, kThreads>(st, qp, b, s * RR, l, 0, b, bq, bq, RR);
      apply_fill<T, CE, kThreads>(st + RR * bq, z, n, s * RR, l, col0, n, NC, NC, RR);
    }
    dmma::cp_async_commit();
  };

  apply_fill<T, CE, kThreads>(ws, w, n, 0, b, col0, n, NC, NC, bq);  // joins chunk 0's group
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);

  // racc[j]: the rows = g + RG j (mod 8) of this thread's columns.
  R racc[RES][E];
#pragma unroll
  for (int j = 0; j < RES; ++j)
#pragma unroll
    for (int c = 0; c < E; ++c) racc[j][c] = R(0);
  for (int64_t s = 0; s < chunks; ++s) {
    dmma::cp_async_wait<S - 2>();
    __syncthreads();  // chunk s landed; every warp is past chunk s - 1
    issue(s + S - 1);
    const T* qs = ring + (s % S) * stage;
    const T* zs = qs + RR * bq;
    T acc[RPT][E];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < E; ++c) acc[i][c] = T{};
    for (int p0 = 0; p0 < bfull; p0 += E) {
      T wv[E][E];
#pragma unroll
      for (int e = 0; e < E; ++e) ld_vec(ws + (p0 + e) * NC + cl, wv[e]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        T qv[E];
        ld_vec(qs + (g + RG * i) * bq + p0, qv);
#pragma unroll
        for (int e = 0; e < E; ++e)
#pragma unroll
          for (int c = 0; c < E; ++c) acc[i][c] = madd(qv[e], wv[e][c], acc[i][c]);
      }
    }
    for (int p = bfull; p < b; ++p) {  // the panel's last b % E columns
      T wv[E];
      ld_vec(ws + p * NC + cl, wv);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const T q = qs[(g + RG * i) * bq + p];
#pragma unroll
        for (int c = 0; c < E; ++c) acc[i][c] = madd(q, wv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int rr = g + RG * i;
      const int64_t r = s * RR + rr;
      if (r >= l) break;
      T ov[E];
      ld_vec(zs + rr * NC + cl, ov);
#pragma unroll
      for (int c = 0; c < E; ++c) {
        ov[c] = ov[c] - acc[i][c];
        racc[i % RES][c] = abs2_add(ov[c], racc[i % RES][c]);
      }
      const int64_t gc = col0 + cl;
      T* dst = o + r * n + gc;
      if (kVec16 && gc + E <= n) {
        st_vec(dst, ov);
      } else {
#pragma unroll
        for (int c = 0; c < E; ++c)
          if (gc + c < n) dst[c] = ov[c];
      }
    }
  }
  dmma::cp_async_wait<0>();
  if (r2 == nullptr) return;
#pragma unroll
  for (int j = 0; j < RES; ++j)
#pragma unroll
    for (int c = 0; c < E; ++c) rs[(g + RG * j) * NC + cl + c] = racc[j][c];
  __syncthreads();
  for (int c = threadIdx.x; c < NC; c += kThreads) {
    if (col0 + c < n) {
      R t = rs[c];
      for (int q = 1; q < NG; ++q) t = t + rs[q * NC + c];
      r2[col0 + c] = t;
    }
  }
}

// 16-byte copies and stores need 16-byte aligned bases and rows of whole
// 16 bytes.
template <class T>
bool apply_aligned(const void* qp, const void* w, const void* z, const void* o, int64_t b,
                   int64_t n) {
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  return a16(qp) && a16(w) && a16(z) && a16(o) && (b * sizeof(T)) % 16 == 0 &&
         (n * sizeof(T)) % 16 == 0;
}

template <class T, int NC>
cudaError_t launch_apply_nc(const T* qp, const T* w, const T* z, T* o, real_t<T>* r2,
                            int64_t l, int b, int64_t n, bool vec16, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n + NC - 1) / NC)), block(apply_threads<T, NC>());
  const size_t smem = apply_smem<T>(NC, b);
  return vec16 ? launch(panel_apply_kernel<T, NC, true>, grid, block, smem, s, qp, w, z, o,
                        r2, l, b, n)
               : launch(panel_apply_kernel<T, NC, false>, grid, block, smem, s, qp, w, z, o,
                        r2, l, b, n);
}

// The widest slab (64, then 32 vectors) that still gives kApplyMinCtas
// CTAs and fits, else 16 vectors.
template <class T>
cudaError_t launch_apply(const void* qp_, const void* w_, const void* z_, void* o_, void* r2_,
                         int64_t l, int b, int64_t n, cudaStream_t s) {
  constexpr int E = vec_elems<T>();
  auto fits = [&](int nc) {
    return (n + nc - 1) / nc >= kApplyMinCtas && apply_smem<T>(nc, b) <= kApplySmemBudget;
  };
  if ((n + 16 * E - 1) / (16 * E) > 0x7fffffff) return cudaErrorInvalidValue;
  const T* qp = static_cast<const T*>(qp_);
  const T* w = static_cast<const T*>(w_);
  const T* z = static_cast<const T*>(z_);
  T* o = static_cast<T*>(o_);
  real_t<T>* r2 = static_cast<real_t<T>*>(r2_);
  const bool vec16 = apply_aligned<T>(qp, w, z, o, b, n);
  if (fits(64 * E)) return launch_apply_nc<T, 64 * E>(qp, w, z, o, r2, l, b, n, vec16, s);
  if (fits(32 * E)) return launch_apply_nc<T, 32 * E>(qp, w, z, o, r2, l, b, n, vec16, s);
  return launch_apply_nc<T, 16 * E>(qp, w, z, o, r2, l, b, n, vec16, s);
}

}  // namespace

// qp (l, b), w (b, n), z (l, n), o (l, n), r2 (n, nullable); all row-major.
extern "C" int repro_panel_apply(int dtype, const void* qp, const void* w,
                                 const void* z, void* o, void* r2, int64_t l,
                                 int64_t b, int64_t n, void* stream) {
  if (l < 0 || n < 1 || b < 1 || b > repro::kMaxPanel)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_apply, qp, w, z, o, r2, l, static_cast<int>(b), n, s);
}
