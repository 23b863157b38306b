// The one C entry every kernel library exports beside its launchers: the
// text of a cudaError_t returned by a launcher (kernels/build.py reads it).
#pragma once

#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
