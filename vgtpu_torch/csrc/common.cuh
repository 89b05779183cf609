// Shared by every csrc/*.cu: each file is its own shared library, loaded
// with ctypes (vgtpu_torch/utils/cuda_build.py), so each carries its own copy
// of this error-string entry point.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
