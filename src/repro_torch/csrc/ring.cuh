// Pieces of the cp.async rings shared by panel_deflate.cu, panel_apply.cu
// and tsolve.cu: the XOR swizzle of a shared-memory tile, a copy of a
// given byte count that zero-fills the rest, and 16-byte vectors of each
// element type.
#pragma once

#include "common.cuh"

namespace repro {

// Element (r, c) of a tile of `pitch` columns (a multiple of 16): the
// column XORed in groups of four by the row's low two bits, so that the
// four rows of a fragment read (k = t of an m16n8k4 operand) land on
// distinct banks.  Runs of four (or two) elements that start at a
// multiple of four (or two) stay contiguous.
__device__ __forceinline__ int swz(int r, int c, int pitch) {
  return r * pitch + (c ^ ((r & 3) << 2));
}

// Copy kBytes (4, 8 or 16) of src to shared dst, of which the first
// `bytes` are read and the rest zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(kBytes), "r"(bytes));
  }
}

// Elements of T in 16 bytes.
template <class T>
__host__ __device__ constexpr int vec_elems() { return 16 / static_cast<int>(sizeof(T)); }

// One 16-byte load or store of vec_elems<T>() elements at p (16-byte
// aligned; shared or global memory).
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void ld_vec(const double* p, double (&v)[2]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x; v[1] = x.y;
}
__device__ __forceinline__ void ld_vec(const cplx<float>* p, cplx<float> (&v)[2]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = {x.x, x.y}; v[1] = {x.z, x.w};
}
__device__ __forceinline__ void ld_vec(const cplx<double>* p, cplx<double> (&v)[1]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = {x.x, x.y};
}
__device__ __forceinline__ void st_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st_vec(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void st_vec(cplx<float>* p, const cplx<float> (&v)[2]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0].re, v[0].im, v[1].re, v[1].im);
}
__device__ __forceinline__ void st_vec(cplx<double>* p, const cplx<double> (&v)[1]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0].re, v[0].im);
}

}  // namespace repro
