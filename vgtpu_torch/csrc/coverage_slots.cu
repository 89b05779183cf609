// K6: exact box-filtered winding coverage of edge chunks, one thread per
// (chunk, pixel), the edge-slot loop outermost.
//
// Replaces the Pallas TPU kernel vgtpu/ops/coverage_pallas.py::_kernel
// (coverage_chunks_pallas), the first coverage kernel: its grid walks the
// CH edge slots of a block of chunks and accumulates the (BC, NPX) output
// block slot by slot.  Same function and layout as K1 (csrc/coverage.cu):
// out[c * NPX + p] is the signed area chunk c's CH edges sweep over tile
// pixel p, summed in slot order.  The plain twin is
// vgtpu_torch/ops/coverage.py::coverage_chunks_torch.
//
// What bounds it on an H100: arithmetic (about 25 float ops per edge and
// pixel: every edge at every pixel, where K1 skips the rows an edge does
// not span; 16*CH bytes in and 4 bytes out per chunk and pixel), and here
// every thread also derives the edge's scalars itself, two IEEE divisions
// per edge and pixel where K1 takes them once per edge.
//
// Design, deliberately simple so that its time beside K1's shows what K1's
// shared staging buys: one thread per (chunk, pixel), consecutive threads on
// consecutive pixels of one chunk, so the stores coalesce.  The edge-slot
// loop is the thread's only loop, as the slot axis is the TPU grid's inner
// axis; per slot the thread reads the edge's 16 bytes through the read-only
// path (__ldg of a float4: every thread of the chunk reads the same
// address), computes its scalars with K1's vg::stage_edge and adds its
// contribution with vg::edge_contribution (csrc/edge_coverage.cuh).  No
// shared memory.  Rounding: K1's (-fmad=false, the two explicit
// __fmaf_rn), so K6 equals K1 and the twin bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"
#include "edge_coverage.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
coverage_slots_kernel(const float4* __restrict__ edges,
                      float* __restrict__ out, int nc, int ch, int tile_w,
                      int npx) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<size_t>(nc) * npx) return;
  const int c = static_cast<int>(i / npx);
  const int p = static_cast<int>(i - static_cast<size_t>(c) * npx);
  const int row = p / tile_w;
  const float px = static_cast<float>(p - row * tile_w);
  const float py = static_cast<float>(row);
  const float4* ed = edges + static_cast<size_t>(c) * ch;
  float acc = 0.f;
  for (int e = 0; e < ch; ++e) {
    const float4 v = __ldg(ed + e);
    const float raw[4] = {v.x, v.y, v.z, v.w};
    float q[vg::kEdgeScalars];
    vg::stage_edge(raw, q);
    acc += vg::edge_contribution(q, px, py);
  }
  out[i] = acc;
}

}  // namespace

// edges: (nc, ch, 4) f32 contiguous, 16-byte aligned; out: (nc, npx) f32
// contiguous; both on `device`.  Launches on `stream`, does not synchronise;
// returns cudaGetLastError().
extern "C" int vg_coverage_slots(const float* edges, float* out, int nc,
                                 int ch, int tile_w, int npx, int device,
                                 cudaStream_t stream) {
  const size_t total = static_cast<size_t>(nc) * npx;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (nc < 0 || npx < 0 || blocks > 0x7fffffffu) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vg::DeviceScope scope(device);
  if (blocks > 0) {
    coverage_slots_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(edges), out, nc, ch, tile_w, npx);
  }
  return static_cast<int>(cudaGetLastError());
}
