// Panel Gram of the distributed CholeskyQR2 oracle, for Hopper.
//
// Replaces the TPU kernel panel_gram_kernel
// (repro/kernels/panel_gram/kernel.py), which keeps the candidate panel C
// (l x b) resident in VMEM across slabs and, in one pass over the local
// residual shard Z (l x n), emits
//   G = C^H C   (b x b)   on grid step 0 only,
//   V = C^H Z   (b x n)   one slab per grid step.
//
// Here both products are one product C^H [C | Z]: the Gram is one more
// output tile, whose right operand is C itself, computed by CTA 0 in
// parallel with the slabs of V (CTA 1 + s: columns [s NC, s NC + NC) of Z).
// Every CTA runs the same loop:
//   * l is walked in order in chunks of kGramRows rows, staged through a
//     ring of kGramStages cp.async stages (the chunk of C, zero past b, and
//     the chunk of the CTA's right operand, zero past its last column), so
//     the next two chunks are in flight while the FMAs run; 16-byte copies
//     when both bases are 16-byte aligned and both pitches are multiples
//     of 16 bytes (the twin <T, false, TJ> copies one element at a time);
//   * the CTA's warps form gp x gc groups: gp = ceil(b / 8) row groups of 8
//     output rows (panel columns of C) and gc column groups of 32 TJ
//     columns, lane q owning columns q + 32 j (j < TJ), so a thread keeps an
//     8 x TJ register tile, reads C broadcast and the operand
//     conflict-free.  gc = min(8 / gp, NC / 32) fills up to 8 warps (TJ =
//     NC / 32 / gc): one CTA runs the whole l loop, and its warps hide each
//     other's latency (bench_dmma, f64, b = 32: 0.074 ms on 8 warps of
//     8 x 2 tiles, 0.085 on 4 warps of 8 x 4; PERF.md);
//   * each output element is one sum over l in order from zero, the same
//     madd(conj(c[r, p]), x[r, j], s) as the factor's Gram (panel_step.cu,
//     gram_lower): G and V are the bits of the one-CTA Gram and the
//     32-column slabs before, and V does not depend on the column tiling.
//     l is not split; no atomics.
//
// With g null the Gram CTA returns at once: panel_step.cu's sweeps take V
// alone, their W.  With r2 given (panel_coeff's sweep), each slab CTA also
// writes the downdated norms of its columns, r2 = max(r2_in -
// colnorms^2(V), 0): after a barrier, a thread a column reads the CTA's V
// back (from L2, where its stores just went; V is stored unrounded, as
// it was summed) and sums 8 partials, partial g over the rows p = g + 8 q
// in increasing q, added in g order -- the order of the sweep it
// replaced (its warp g held the rows = g mod 8), so its bits.
//
// Bound at the gram path's shape (f64, l=800, b=32, n=2^14): 109 MB
// (C and Z in, G and V out) against 0.84 GFLOP, 0.0326 ms of HBM against
// 0.025 ms of DFMA (the in-order sums rule out DMMA), so bytes.  Geometry
// there: 1 + 128 CTAs of 256 threads (gp = 4, gc = 2, TJ = 2, NC = 128),
// one wave on 132 SMs; 3 stages x 32 rows x (32 + 128) x 8 B = 122880 B
// of dynamic shared memory.  C is re-read once per CTA (26 MB from L2, a
// quarter of the 32-column slabs' 105 MB).  c128 takes NC = 64 (its
// registers), so its widest case (b = 64) asks for 3 x 32 x (64 + 64) x
// 16 = 196608 B.  Every CTA walks all of l, so a CTA's loop, not HBM, sets
// the time: the Gram tile alone takes about as long as the whole launch.
#include <climits>

#include "dmma_tile.cuh"
#include "panel_common.cuh"

namespace {

using namespace repro;

constexpr int kGramRows = 32;      // rows of l a stage
constexpr int kGramStages = 3;     // cp.async ring
constexpr int kGramWarpRows = 8;   // output rows (panel columns) a warp
constexpr int kGramCols = 128;     // operand columns a CTA (c128: half)
constexpr int kGramWarps = 8;      // warps a CTA, at most
static_assert(kMaxPanel / kGramWarpRows <= kGramWarps, "one warp a row group");

template <class T>
__host__ __device__ constexpr int gram_cols() {
  return sizeof(T) == 16 ? kGramCols / 2 : kGramCols;
}

// Copy kBytes (4, 8 or 16) of src to shared dst, of which the first
// `bytes` are read and the rest zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, int bytes) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dmma::smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     dmma::smem_addr(dst)),
                 "l"(src), "n"(kBytes), "r"(bytes));
  }
}

template <class T, bool kVec16, int TJ>
__global__ void __launch_bounds__(kGramWarps * 32)
panel_gram_kernel(const T* __restrict__ c, const T* __restrict__ z,
                  T* __restrict__ g, T* __restrict__ v,
                  const real_t<T>* __restrict__ r2_in, real_t<T>* __restrict__ r2,
                  int64_t l, int b, int64_t n) {
  constexpr int NC = gram_cols<T>();
  constexpr int W = kVec16 ? 16 / static_cast<int>(sizeof(T)) : 1;  // elements a copy
  constexpr int kCopy = W * static_cast<int>(sizeof(T));              // bytes a copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int bp = (b + kGramWarpRows - 1) / kGramWarpRows * kGramWarpRows;
  const int stage = kGramRows * (bp + NC);  // elements: C chunk, then operand chunk
  constexpr int kColGroups = NC / (32 * TJ);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = warp / kColGroups * kGramWarpRows, cw = warp % kColGroups * 32 * TJ;

  // The right operand of this CTA: C for the Gram tile, a slab of Z else.
  // Without g (panel_step's W = Q_p^H Z), the Gram CTA has no work.
  const bool gram_cta = blockIdx.x == 0;
  if (gram_cta && g == nullptr) return;
  const T* x = gram_cta ? c : z;
  const int64_t cols = gram_cta ? b : n;  // the operand's width and pitch
  const int64_t col0 = gram_cta ? 0 : static_cast<int64_t>(blockIdx.x - 1) * NC;
  T* out = gram_cta ? g : v;

  auto fill = [&](int slot, int64_t chunk) {
    T* cs = smem + slot * stage;
    T* xs = cs + kGramRows * bp;
    const int64_t r0 = chunk * kGramRows;
    for (int e = threadIdx.x * W; e < kGramRows * bp; e += blockDim.x * W) {
      const int rr = e / bp, p = e % bp;  // W divides b (kVec16) and bp
      const bool in = r0 + rr < l && p < b;
      cp_async_bytes<kCopy>(cs + e, in ? c + (r0 + rr) * b + p : c, in ? kCopy : 0);
    }
    for (int e = threadIdx.x * W; e < kGramRows * NC; e += blockDim.x * W) {
      const int rr = e / NC, j = e % NC;
      const int64_t gcol = col0 + j, left = cols - gcol;
      const bool in = r0 + rr < l && left > 0;
      const int bytes = in ? static_cast<int>(sizeof(T)) * (left < W ? static_cast<int>(left) : W)
                           : 0;
      cp_async_bytes<kCopy>(xs + e, in ? x + (r0 + rr) * cols + gcol : x, bytes);
    }
  };

  T acc[kGramWarpRows][TJ];
#pragma unroll
  for (int i = 0; i < kGramWarpRows; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = T{};
  auto step = [&](const T* cs, const T* xs, int rr) {
    T cv[kGramWarpRows], xv[TJ];
#pragma unroll
    for (int i = 0; i < kGramWarpRows; ++i) cv[i] = conj_of(cs[rr * bp + p0 + i]);
#pragma unroll
    for (int j = 0; j < TJ; ++j) xv[j] = xs[rr * NC + cw + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < kGramWarpRows; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) acc[i][j] = madd(cv[i], xv[j], acc[i][j]);
  };

  const int64_t chunks = (l + kGramRows - 1) / kGramRows;
#pragma unroll
  for (int s = 0; s < kGramStages - 1; ++s) {
    if (s < chunks) fill(s, s);
    dmma::cp_async_commit();
  }
  int slot = 0;
  for (int64_t t = 0; t < chunks; ++t) {
    dmma::cp_async_wait<kGramStages - 2>();
    __syncthreads();  // chunk t landed; every warp is past chunk t - 1
    const int64_t next = t + kGramStages - 1;
    if (next < chunks) fill(slot == 0 ? kGramStages - 1 : slot - 1, next);
    dmma::cp_async_commit();
    const T* cs = smem + slot * stage;
    const T* xs = cs + kGramRows * bp;
    const int64_t left = l - t * kGramRows;
    if (left >= kGramRows) {
#pragma unroll
      for (int rr = 0; rr < kGramRows; ++rr) step(cs, xs, rr);
    } else {
      for (int rr = 0; rr < left; ++rr) step(cs, xs, rr);
    }
    slot = slot + 1 == kGramStages ? 0 : slot + 1;
  }
  dmma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kGramWarpRows; ++i) {
    const int p = p0 + i;
    if (p >= b) break;
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const int64_t col = col0 + cw + lane + 32 * j;
      if (col < cols) out[p * cols + col] = acc[i][j];
    }
  }
  if (gram_cta || r2 == nullptr) return;

  // The downdate, a thread a column of the slab, from V as just stored
  // (the barrier makes the block's stores visible to it).
  using R = real_t<T>;
  __syncthreads();
  for (int j = threadIdx.x; j < NC; j += blockDim.x) {
    const int64_t col = col0 + j;
    if (col >= n) break;
    R t = R(0);
    // Fixed trip counts, fully unrolled: a loop bounded by b left c128's
    // narrowest tile (TJ = 1) with a spilled register.
#pragma unroll
    for (int gi = 0; gi < kGramWarpRows; ++gi) {
      R part = R(0);
#pragma unroll
      for (int q = 0; q < kMaxPanel / kGramWarpRows; ++q) {
        const int p = gi + kGramWarpRows * q;
        if (p < b) part = abs2_add(out[p * n + col], part);
      }
      t = gi == 0 ? part : t + part;
    }
    t = r2_in[col] - t;
    r2[col] = t < R(0) ? R(0) : t;  // max(., 0) that keeps a NaN
  }
}

template <class T>
bool gram_aligned(const void* p, int64_t ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (ld * sizeof(T)) % 16 == 0;
}

template <class T, int TJ>
cudaError_t launch_gram_tj(const T* c, const T* z, T* g, T* v, const real_t<T>* r2_in,
                           real_t<T>* r2, int64_t l, int b, int64_t n, dim3 grid, dim3 block,
                           size_t smem, cudaStream_t stream) {
  return gram_aligned<T>(c, b) && gram_aligned<T>(z, n)
             ? launch(panel_gram_kernel<T, true, TJ>, grid, block, smem, stream, c, z, g, v,
                      r2_in, r2, l, b, n)
             : launch(panel_gram_kernel<T, false, TJ>, grid, block, smem, stream, c, z, g, v,
                      r2_in, r2, l, b, n);
}

// Returns the launch's status, a refused shared-memory request's included.
template <class T>
cudaError_t launch_gram(const void* c_, const void* z_, void* g_, void* v_,
                        const void* r2_in_, void* r2_, int64_t l, int b, int64_t n,
                        cudaStream_t stream) {
  constexpr int NC = gram_cols<T>();
  const int bp = (b + kGramWarpRows - 1) / kGramWarpRows * kGramWarpRows;
  const int gp = bp / kGramWarpRows;
  const int gc = kGramWarps / gp < NC / 32 ? kGramWarps / gp : NC / 32;  // >= 1
  const int tj = NC / 32 / gc;
  const int64_t ctas = 1 + (n + NC - 1) / NC;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * kGramStages * kGramRows * static_cast<size_t>(bp + NC);
  const dim3 grid(static_cast<unsigned>(ctas)), block(32 * gp * gc);
  const T* c = static_cast<const T*>(c_);
  const T* z = static_cast<const T*>(z_);
  T* g = static_cast<T*>(g_);
  T* v = static_cast<T*>(v_);
  const real_t<T>* r2_in = static_cast<const real_t<T>*>(r2_in_);
  real_t<T>* r2 = static_cast<real_t<T>*>(r2_);
  if constexpr (NC / 32 >= 4) {
    if (tj == 4)
      return launch_gram_tj<T, 4>(c, z, g, v, r2_in, r2, l, b, n, grid, block, smem, stream);
  }
  if (tj == 2)
    return launch_gram_tj<T, 2>(c, z, g, v, r2_in, r2, l, b, n, grid, block, smem, stream);
  return launch_gram_tj<T, 1>(c, z, g, v, r2_in, r2, l, b, n, grid, block, smem, stream);
}

}  // namespace

extern "C" int repro_panel_gram(int dtype, const void* c, const void* z, void* g,
                                void* v, int64_t l, int64_t b, int64_t n,
                                void* stream) {
  if (l < 0 || n < 0 || b < 1 || b > repro::kMaxPanel)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_gram, c, z, g, v, nullptr, nullptr, l, static_cast<int>(b), n,
                 s);
}

// panel_coeff's sweep (panel_step.cu): V = C^H Z with the downdated norms
// r2 = max(r2_in - colnorms^2(V), 0), no Gram; one launch.
extern "C" int repro_panel_gram_downdate(int dtype, const void* c, const void* z,
                                         const void* r2_in, void* v, void* r2, int64_t l,
                                         int64_t b, int64_t n, void* stream) {
  if (l < 0 || n < 1 || b < 1 || b > repro::kMaxPanel || r2_in == nullptr || r2 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH(dtype, launch_gram, c, z, nullptr, v, r2_in, r2, l, static_cast<int>(b), n,
                 s);
}
