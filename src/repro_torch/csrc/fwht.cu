// One sweep of the fast Walsh-Hadamard transform along dim 0 for Hopper.
//
// Replaces the TPU kernel fwht_kernel (repro/kernels/srht/kernel.py),
// which holds the full (m, 128)-column slab in VMEM (m <= 8192, a 4 MiB
// budget) and runs all log2(m) butterfly stages on it.
//
// A CTA has at most 227 KB of shared memory, and x is row-major (m, n), so
// the port splits m = f_1 * f_2 * ... into Kronecker factors of at most
// 2^kMaxSlabLog2 rows and runs one launch (sweep) per factor, the low
// factor first.  A sweep with factor F = 2^f and row stride s transforms,
// for every group (hi, lo) with lo < s, the F rows hi*F*s + lo + j*s
// (j < F): the butterfly stages h = s, 2s, ..., (F/2)s of the whole
// transform.  The sweeps therefore apply the stages in increasing-h order,
// as the plain version does, and each butterfly is an exact IEEE add/sub
// of the same two values, so the result is bit-equal to the plain version.
// The scale 1/sqrt(m) is passed in and applied once, by the last sweep
// (the others pass 1, which multiplies exactly).  Later factors are
// addressed with the stride s: no transposes are materialised.
//
// Bound: each sweep reads and writes x once (2 m n sizeof(T) bytes) for
// m n f adds, so a sweep is a byte stream; the transform costs one read and
// write of x per factor (two at m = 2^16 and 2^18).
//
// Design, for a sweep near HBM's rate:
//   * a tile is one group's F rows x a piece of kFwhtRowBytes (F = 2^9:
//     kFwhtTileBytes / F) contiguous bytes of each row, one CTA a tile;
//     blockIdx.x walks the column pieces, so the CTAs that run together
//     read neighbouring pieces of the same rows;
//   * a thread owns one 16-byte vector of columns and R = 2^RL rows of the
//     tile in registers.  Its rows are loaded straight into registers (R
//     independent 16-byte loads in flight a thread), the stages whose bit
//     of the row index its rows span run on registers, and then the tile
//     goes once through shared memory so that each thread holds rows that
//     span the next RL bits (a round): F = 2^8 takes two rounds and one
//     exchange, 2^9 three.  The last round scales and stores from
//     registers.  Two CTAs an SM (64 KB of shared memory each): one CTA's
//     loads overlap the other's stages;
//   * in round q the thread's slot s (RL bits) is row bits P..P+RL-1 of
//     the tile index j, P = min(q RL, f - RL), and its thread index gives
//     the other bits (row_of); the round applies the stages of bits
//     q RL .. min(q RL + RL, f) - 1 in increasing order, so a last short
//     round spans some bits already done and leaves them alone.
//     kernels/srht/kernel.py (sweep_rounds, slot_rows) holds the same map;
//     the CPU tests run the schedule on it against the plain version.
// 16-byte loads and stores when both bases are 16-byte aligned and a row
// is whole 16 bytes (the twin <..., false> moves one element at a time);
// columns past n are neither read nor written.
#include "ring.cuh"

namespace {

using namespace repro;

constexpr int kMaxSlabLog2 = 9;        // MAX_SLAB_LOG2 in kernel.py
constexpr int kFwhtRegLog2 = 4;        // rows a thread holds: 2^4
constexpr int kFwhtRowBytes = 256;     // widest piece of a row a tile holds
constexpr int kFwhtTileBytes = 65536;  // rows x piece of a tile, at most
constexpr int kThreads = 256;          // most threads a CTA

__device__ __forceinline__ float scale_by(float x, float s) { return x * s; }
__device__ __forceinline__ double scale_by(double x, double s) { return x * s; }
template <class R>
__device__ __forceinline__ cplx<R> scale_by(cplx<R> x, R s) {
  return {x.re * s, x.im * s};
}

// Tile row of slot s of the thread with row index rt in a round whose
// slot bits start at P.
__device__ __forceinline__ int row_of(int rt, int s, int P, int RL) {
  return (rt & ((1 << P) - 1)) | (s << P) | ((rt >> P) << (P + RL));
}

template <class T, bool kVec, int E>
__device__ __forceinline__ void load_cols(const T* p, int64_t left, T (&v)[E]) {
  if constexpr (kVec) {
    if (left > 0) {
      ld_vec(p, v);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = e < left ? p[e] : T{};
}

template <class T, bool kVec, int E>
__device__ __forceinline__ void store_cols(T* p, int64_t left, const T (&v)[E]) {
  if constexpr (kVec) {
    if (left > 0) st_vec(p, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e < left) p[e] = v[e];
}

template <class T, int RL, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
fwht_kernel(const T* x, T* y, int64_t n, int64_t stride, int f_log2, int cv_log2,
            real_t<T> scale) {
  constexpr int E = vec_elems<T>();
  constexpr int R = 1 << RL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // F rows x (1 << cv_log2) vectors
  const int cv = threadIdx.x & ((1 << cv_log2) - 1);
  const int rt = threadIdx.x >> cv_log2;
  const int64_t g = blockIdx.y + static_cast<int64_t>(gridDim.y) * blockIdx.z;
  const int64_t base = (g / stride) * (stride << f_log2) + g % stride;
  const int64_t col = ((static_cast<int64_t>(blockIdx.x) << cv_log2) + cv) * E;
  const int64_t left = n - col;  // columns of this thread's vector in x
  const int rounds = RL > 0 ? (f_log2 + RL - 1) / RL : 0;
  auto first_bit = [&](int q) { return q * RL < f_log2 - RL ? q * RL : f_log2 - RL; };

  T v[R][E];
  // Round 0: slot bits are the tile index's low bits (P = 0).
#pragma unroll
  for (int s = 0; s < R; ++s)
    load_cols<T, kVec>(x + (base + static_cast<int64_t>(row_of(rt, s, 0, RL)) * stride) * n +
                           col,
                       left, v[s]);
  for (int q = 0; q < rounds; ++q) {
    const int P = first_bit(q);
    if (q > 0) {  // the tile through shared memory: round q-1's rows out, round q's in
      const int Pp = first_bit(q - 1);
      if (q > 1) __syncthreads();  // every thread has read round q-1's rows
#pragma unroll
      for (int s = 0; s < R; ++s)
        st_vec(tile + ((row_of(rt, s, Pp, RL) << cv_log2) + cv) * E, v[s]);
      __syncthreads();
#pragma unroll
      for (int s = 0; s < R; ++s)
        ld_vec(tile + ((row_of(rt, s, P, RL) << cv_log2) + cv) * E, v[s]);
    }
    const int lo = q * RL - P;
    const int hi = (q * RL + RL < f_log2 ? q * RL + RL : f_log2) - P;
#pragma unroll
    for (int sb = 0; sb < RL; ++sb) {
      if (sb < lo || sb >= hi) continue;
#pragma unroll
      for (int s = 0; s < R; ++s) {
        if (s & (1 << sb)) continue;
        const int t = s | (1 << sb);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const T u = v[s][e], w = v[t][e];
          v[s][e] = u + w;
          v[t][e] = u - w;
        }
      }
    }
  }
  const int P = rounds > 0 ? first_bit(rounds - 1) : 0;
#pragma unroll
  for (int s = 0; s < R; ++s) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[s][e] = scale_by(v[s][e], scale);
    store_cols<T, kVec>(y + (base + static_cast<int64_t>(row_of(rt, s, P, RL)) * stride) * n +
                            col,
                        left, v[s]);
  }
}

// Geometry of one sweep (kernel.py, fwht_pass_launch, computes the same).
struct FwhtGeometry {
  int rl, cv_log2, threads, smem;
  int64_t gx, gy, gz;
};

template <class T>
FwhtGeometry fwht_geometry(int64_t m, int64_t n, int f_log2) {
  FwhtGeometry g{};
  const int piece = (kFwhtTileBytes >> f_log2) < kFwhtRowBytes ? (kFwhtTileBytes >> f_log2)
                                                                 : kFwhtRowBytes;
  const int vecs = piece / 16;  // vectors of a row in a tile
  g.cv_log2 = 0;
  while ((1 << g.cv_log2) < vecs) ++g.cv_log2;
  g.rl = f_log2 < kFwhtRegLog2 ? f_log2 : kFwhtRegLog2;
  g.threads = (1 << (f_log2 - g.rl)) * vecs;
  const int rounds = g.rl > 0 ? (f_log2 + g.rl - 1) / g.rl : 0;
  g.smem = rounds > 1 ? (1 << f_log2) * piece : 0;
  const int64_t cols = int64_t{vecs} * vec_elems<T>();
  const int64_t groups = m >> f_log2;
  g.gx = (n + cols - 1) / cols;
  g.gy = groups < 32768 ? groups : 32768;
  g.gz = groups / g.gy;
  return g;
}

template <class T, int RL>
cudaError_t launch_fwht_rl(const FwhtGeometry& g, const T* x, T* y, int64_t n, int64_t stride,
                           int f_log2, real_t<T> scale, bool vec, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(g.gx), static_cast<unsigned>(g.gy),
                  static_cast<unsigned>(g.gz));
  return vec ? launch(fwht_kernel<T, RL, true>, grid, dim3(g.threads), g.smem, s, x, y, n,
                      stride, f_log2, g.cv_log2, scale)
             : launch(fwht_kernel<T, RL, false>, grid, dim3(g.threads), g.smem, s, x, y, n,
                      stride, f_log2, g.cv_log2, scale);
}

template <class T>
cudaError_t launch_fwht(const void* x_, void* y_, int64_t m, int64_t n, int64_t stride,
                        int f_log2, double scale_, cudaStream_t s) {
  const FwhtGeometry g = fwht_geometry<T>(m, n, f_log2);
  if (g.gx > 0x7fffffff || g.gz > 65535) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(y_);
  auto a16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = a16(x) && a16(y) && (n * static_cast<int64_t>(sizeof(T))) % 16 == 0;
  const real_t<T> scale = static_cast<real_t<T>>(scale_);
  switch (g.rl) {
    case 0: return launch_fwht_rl<T, 0>(g, x, y, n, stride, f_log2, scale, vec, s);
    case 1: return launch_fwht_rl<T, 1>(g, x, y, n, stride, f_log2, scale, vec, s);
    case 2: return launch_fwht_rl<T, 2>(g, x, y, n, stride, f_log2, scale, vec, s);
    case 3: return launch_fwht_rl<T, 3>(g, x, y, n, stride, f_log2, scale, vec, s);
    default: return launch_fwht_rl<T, kFwhtRegLog2>(g, x, y, n, stride, f_log2, scale, vec, s);
  }
}

}  // namespace

// One sweep: factor f = 2^f_log2 at row stride `stride` over x (m, n),
// written to y (which may be x).  m must be a power of two, f * stride
// must divide m.
extern "C" int repro_fwht_pass(int dtype, const void* x, void* y, int64_t m,
                               int64_t n, int64_t stride, int f_log2,
                               double scale, void* stream) {
  if (m <= 0 || n <= 0 || (m & (m - 1)) || stride <= 0 || f_log2 < 0 ||
      f_log2 > kMaxSlabLog2 || m % ((int64_t{1} << f_log2) * stride))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_fwht, x, y, m, n, stride, f_log2, scale, s);
}
