// Shared by every csrc/*.cu: each file is its own shared library, loaded
// with ctypes (vgtpu_torch/utils/cuda_build.py), so each carries its own copy
// of this error-string entry point.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* vg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace vg {

// A retained pan's view window over a scene grid of tiles (ops/coverage.
// ViewWindow.tiles): columns [x0, x1) and rows [y0, y1) of a grid ntx tiles
// wide; on == 0 without a window.  K1 and K2 take it.
struct TileWindow {
  int on, x0, y0, x1, y1, ntx;
  __device__ __forceinline__ bool holds(int tile) const {
    const int ty = tile / ntx;
    const int tx = tile - ty * ntx;
    return tx >= x0 && tx < x1 && ty >= y0 && ty < y1;
  }
};

// Every entry point takes the device of its tensors and launches under this
// scope: it makes that device current only when the calling thread's current
// device is another (a multi-GPU caller launching on a second card) and
// restores the caller's device when the entry point returns.  The common
// case costs one cudaGetDevice, a thread-local read; the Python wrappers
// enter no torch.cuda.device context of their own.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    if (cudaGetDevice(&prev_) == cudaSuccess && prev_ != device) {
      switched_ = cudaSetDevice(device) == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;

 private:
  int prev_ = -1;
  bool switched_ = false;
};

// A launch that needs more than the default 48 KB of dynamic shared memory
// first raises `kernel`'s limit to all the current device offers a block
// (227 KB on an H100, less the kernel's static shared memory).  `done` is a
// per-kernel bit mask of the devices already raised, so the attribute is set
// once per kernel and device, not per launch.
template <class Kernel>
inline void allow_dynamic_smem(Kernel kernel, unsigned* done) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return;
  const unsigned bit = 1u << (dev & 31);
  if (*done & bit) return;
  int optin = 0;
  cudaFuncAttributes fa;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) {
    return;
  }
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - static_cast<int>(fa.sharedSizeBytes)) ==
      cudaSuccess) {
    *done |= bit;
  }
}

// Launches kernel<<<grid, threads, smem_bytes, stream>>>(args...), first
// raising its dynamic shared memory limit where smem_bytes needs it
// (allow_dynamic_smem, `raised` its per-kernel device mask); returns
// cudaGetLastError().
template <class Kernel, class... Args>
inline int launch_kernel(Kernel kernel, unsigned* raised, dim3 grid,
                         int threads, int smem_bytes, cudaStream_t stream,
                         Args... args) {
  if (smem_bytes > 48 * 1024) allow_dynamic_smem(kernel, raised);
  kernel<<<grid, threads, smem_bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vg
