// Probes of Hopper's FP64 tensor cores for bench_dmma.py, kept out of the
// production library: the fragment maps of mma.sync .f64 (one warp against
// a known product) and each shape's rate on registers alone.
//
// Shapes by code: 0 = m8n8k4 (Ampere), 4 = m16n8k4, 8 = m16n8k8,
// 16 = m16n8k16 (Hopper, PTX ISA 7.8).  The maps (g = lane >> 2,
// t = lane & 3) are those of csrc/dmma_tile.cuh:
//   A: a[i] = A[g + 8 (i & 1)][t + 4 (i >> 1)]   (m8n8k4: a0 = A[g][t])
//   B: b[i] = B[t + 4 i][g]
//   C: c[e] = C[g + 8 (e >> 1)][2 t + (e & 1)]   (m8n8k4: e < 2)
#include "common.cuh"

namespace {

template <int K>
__device__ __forceinline__ void mma(double (&d)[4], const double* a, const double* b) {
  if constexpr (K == 4) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (K == 8) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else if constexpr (K == 16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
        "{%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  } else {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
        : "+d"(d[0]), "+d"(d[1])
        : "d"(a[0]), "d"(b[0]));
  }
}

// D = C + A B for A (M x K), B (K x 8), C and D (M x 8), row-major; one
// warp, each operand loaded into its fragment by the maps above.
template <int K>
__global__ void dmma_frag_kernel(const double* A, const double* B, const double* C,
                                 double* D) {
  constexpr int KK = K == 0 ? 4 : K;
  constexpr int kA = K == 0 ? 1 : KK / 2, kB = K == 0 ? 1 : KK / 4;
  constexpr int kC = K == 0 ? 2 : 4;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[8], b[4], d[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = 0; i < kA; ++i) a[i] = A[(g + 8 * (i & 1)) * KK + t + 4 * (i >> 1)];
  for (int i = 0; i < kB; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  for (int e = 0; e < kC; ++e) d[e] = C[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)];
  mma<K>(d, a, b);
  for (int e = 0; e < kC; ++e) D[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = d[e];
}

// 16 independent tiles a warp, `iters` rounds on registers alone; `out`
// keeps the sums live.
template <int K>
__global__ void __launch_bounds__(256) dmma_rate_kernel(double* out, int iters) {
  double acc[16][4], a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (static_cast<int>(threadIdx.x) - i);
  for (int j = 0; j < 16; ++j)
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) mma<K>(acc[j], a, b);
  }
  double s = 0.0;
  for (int j = 0; j < 16; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int K>
cudaError_t launch_probe(const double* A, const double* B, const double* C, double* D,
                         double* out, int blocks, int iters, cudaStream_t stream) {
  if (out == nullptr)
    return repro::launch(dmma_frag_kernel<K>, dim3(1), dim3(32), 0, stream, A, B, C, D);
  return repro::launch(dmma_rate_kernel<K>, dim3(blocks), dim3(256), 0, stream, out,
                       iters);
}

}  // namespace

// shape code (0, 4, 8, 16); the fragment check when out is null, else the
// rate probe on `blocks` CTAs of 8 warps writing blocks * 256 doubles.
extern "C" int repro_dmma_probe(int shape, const double* A, const double* B,
                                const double* C, double* D, double* out, int blocks,
                                int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: return launch_probe<0>(A, B, C, D, out, blocks, iters, s);
    case 4: return launch_probe<4>(A, B, C, D, out, blocks, iters, s);
    case 8: return launch_probe<8>(A, B, C, D, out, blocks, iters, s);
    case 16: return launch_probe<16>(A, B, C, D, out, blocks, iters, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

REPRO_QUERY_ENTRIES
