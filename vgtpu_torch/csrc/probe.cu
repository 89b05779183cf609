// K8: out = x * 2 + 1, the cold-dispatch probe.
//
// Replaces the Pallas TPU kernel `k` of the PALLAS probe in
// tools/probe_cold_tax.py, which exists to time a fresh process's first
// kernel execution.  Its port (vgtpu_torch/utils/cold_probe.py) times the
// port's own kernel route: the nvcc-built library loaded with ctypes, the
// first launch and the fetch of its result.  The plain twin is
// vgtpu_torch/utils/cold_probe.py::probe_affine_torch.
//
// What bounds it on an H100: bytes (4 read and 4 written per element, 2
// float ops); at the probe's (256, 128) it is one launch's latency.
//
// Design: one thread per element.  x*2 is exact, so the one rounding of the
// add equals the twin's whether or not it were fused.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_affine_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.f + 1.f;
}

}  // namespace

// x, out: n contiguous f32 on `device`.  Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
extern "C" int vg_probe_affine(const float* x, float* out, int n, int device,
                               cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const vg::DeviceScope scope(device);
  if (n > 0) {
    probe_affine_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        x, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
