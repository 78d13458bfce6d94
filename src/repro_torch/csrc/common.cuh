// Element types and arithmetic shared by the port's CUDA kernels.
//
// Every kernel is a template over its element type T and is instantiated
// for float, double, cplx<float> and cplx<double>.  cplx<R> has the layout
// of torch's complex64 / complex128 (re, im interleaved).  The complex
// parts reduce to a conj in inner products, |x|^2 in norms and a Hermitian
// Cholesky; the accumulator is T itself, so f32 data accumulates in f32
// and f64 data in f64 (FFMA / DFMA only, no tensor-core TF32).
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

// Element-type codes, in the order of repro_torch.kernels.common.KERNEL_DTYPES.
enum DType : int { kF32 = 0, kF64 = 1, kC64 = 2, kC128 = 3 };

template <class R>
struct __align__(2 * sizeof(R)) cplx {
  R re, im;
};

template <class T> struct RealOf { using type = T; };
template <class R> struct RealOf<cplx<R>> { using type = R; };
template <class T> using real_t = typename RealOf<T>::type;

template <class R> __host__ __device__ constexpr R tiny_of();
template <> __host__ __device__ constexpr float tiny_of<float>() { return FLT_MIN; }
template <> __host__ __device__ constexpr double tiny_of<double>() { return DBL_MIN; }

template <class R> __host__ __device__ constexpr R eps_of();
template <> __host__ __device__ constexpr float eps_of<float>() { return FLT_EPSILON; }
template <> __host__ __device__ constexpr double eps_of<double>() { return DBL_EPSILON; }

__device__ __forceinline__ float sqrt_r(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_r(double x) { return sqrt(x); }

// c + a * b, fused where the hardware fuses it.
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }
template <class R>
__device__ __forceinline__ cplx<R> madd(cplx<R> a, cplx<R> b, cplx<R> c) {
  cplx<R> r;
  r.re = madd(-a.im, b.im, madd(a.re, b.re, c.re));
  r.im = madd(a.im, b.re, madd(a.re, b.im, c.im));
  return r;
}

template <class R>
__device__ __forceinline__ cplx<R> operator+(cplx<R> a, cplx<R> b) {
  return {a.re + b.re, a.im + b.im};
}
template <class R>
__device__ __forceinline__ cplx<R> operator-(cplx<R> a, cplx<R> b) {
  return {a.re - b.re, a.im - b.im};
}
template <class R>
__device__ __forceinline__ cplx<R> operator*(cplx<R> a, cplx<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

__device__ __forceinline__ float conj_of(float x) { return x; }
__device__ __forceinline__ double conj_of(double x) { return x; }
template <class R>
__device__ __forceinline__ cplx<R> conj_of(cplx<R> x) { return {x.re, -x.im}; }

__device__ __forceinline__ float real_of(float x) { return x; }
__device__ __forceinline__ double real_of(double x) { return x; }
template <class R>
__device__ __forceinline__ R real_of(cplx<R> x) { return x.re; }

// acc + |x|^2
__device__ __forceinline__ float abs2_add(float x, float acc) { return fmaf(x, x, acc); }
__device__ __forceinline__ double abs2_add(double x, double acc) { return fma(x, x, acc); }
template <class R>
__device__ __forceinline__ R abs2_add(cplx<R> x, R acc) {
  return madd(x.im, x.im, madd(x.re, x.re, acc));
}

// x / s for a real s.
__device__ __forceinline__ float div_r(float x, float s) { return x / s; }
__device__ __forceinline__ double div_r(double x, double s) { return x / s; }
template <class R>
__device__ __forceinline__ cplx<R> div_r(cplx<R> x, R s) { return {x.re / s, x.im / s}; }

template <class T> __device__ __forceinline__ T from_real(real_t<T> x);
template <> __device__ __forceinline__ float from_real<float>(float x) { return x; }
template <> __device__ __forceinline__ double from_real<double>(double x) { return x; }
template <> __device__ __forceinline__ cplx<float> from_real<cplx<float>>(float x) { return {x, 0.f}; }
template <> __device__ __forceinline__ cplx<double> from_real<cplx<double>>(double x) { return {x, 0.0}; }

// ------------------------------------------------------------ launches
//
// Every kernel is launched through launch() below, which returns the
// status of the launch: that of a refused shared-memory request
// (cudaFuncSetAttribute) before the kernel is queued, else
// cudaGetLastError() after it.  A refused request's error is cleared
// from the thread's last-error state, so the context and the next launch
// are unaffected.
//
// Geometry query: while a thread has a LaunchSink installed (the C entry
// points repro_query_begin / repro_query_end, REPRO_QUERY_ENTRIES), launch()
// records what it would launch -- grid, block, dynamic shared bytes and the
// kernel's static attributes -- instead of launching.  The analysis pass
// calls the ordinary C entry points under a sink to hold each kernel
// contract's declared launches to the code that issues them.

constexpr int kQueryFields = 11;  // gx gy gz bx by bz smem static regs local maxthr

struct LaunchSink {
  int64_t* out;
  int cap;
  int n;
};

inline thread_local LaunchSink* g_launch_sink = nullptr;

template <class... P, class... A>
cudaError_t launch(void (*kern)(P...), dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream, A... args) {
  if (LaunchSink* s = g_launch_sink) {
    if (s->n < s->cap) {
      cudaFuncAttributes at{};
      const cudaError_t e = cudaFuncGetAttributes(&at, kern);
      if (e != cudaSuccess) {
        cudaGetLastError();
        return e;
      }
      int64_t* r = s->out + static_cast<int64_t>(s->n) * kQueryFields;
      r[0] = grid.x; r[1] = grid.y; r[2] = grid.z;
      r[3] = block.x; r[4] = block.y; r[5] = block.z;
      r[6] = static_cast<int64_t>(smem);
      r[7] = static_cast<int64_t>(at.sharedSizeBytes);
      r[8] = at.numRegs;
      r[9] = static_cast<int64_t>(at.localSizeBytes);
      r[10] = at.maxThreadsPerBlock;
    }
    ++s->n;
    return cudaSuccess;
  }
  if (smem > 0) {
    if (smem > static_cast<size_t>(0x7fffffff)) return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) {
      cudaGetLastError();  // a refused request leaves no sticky state
      return e;
    }
  }
  kern<<<grid, block, smem, stream>>>(static_cast<P>(args)...);
  return cudaGetLastError();
}

}  // namespace repro

// The geometry-query entry points of one shared library (define once in it):
// repro_query_begin(out, cap) installs a sink of cap records of
// kQueryFields int64 each on the calling thread; repro_query_end() removes
// it and returns the number of launches recorded.
#define REPRO_QUERY_ENTRIES                                                 \
  namespace {                                                               \
  thread_local repro::LaunchSink g_query_sink;                              \
  }                                                                         \
  extern "C" void repro_query_begin(int64_t* out, int cap) {                \
    g_query_sink = repro::LaunchSink{out, cap, 0};                          \
    repro::g_launch_sink = &g_query_sink;                                   \
  }                                                                         \
  extern "C" int repro_query_end() {                                        \
    repro::g_launch_sink = nullptr;                                         \
    return g_query_sink.n;                                                  \
  }

// Returns LAUNCH<T>(args...) -- a cudaError_t -- for the element type named
// by `code`, from the enclosing entry point; an unknown code returns
// cudaErrorInvalidValue.
#define REPRO_DISPATCH(code, LAUNCH, ...)                                   \
  switch (code) {                                                           \
    case repro::kF32: return static_cast<int>(LAUNCH<float>(__VA_ARGS__));  \
    case repro::kF64: return static_cast<int>(LAUNCH<double>(__VA_ARGS__)); \
    case repro::kC64:                                                       \
      return static_cast<int>(LAUNCH<repro::cplx<float>>(__VA_ARGS__));     \
    case repro::kC128:                                                      \
      return static_cast<int>(LAUNCH<repro::cplx<double>>(__VA_ARGS__));    \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }
