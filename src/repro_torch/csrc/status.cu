// Error text for the status codes the kernels' C entry points return, and
// the library's geometry-query entry points (common.cuh).
#include "common.cuh"

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

REPRO_QUERY_ENTRIES
