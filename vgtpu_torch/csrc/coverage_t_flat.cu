// K5: exact box-filtered winding coverage of edge chunks, pixel-major, in
// the flat form: one pixel per thread, edges read from device memory.
//
// Replaces the Pallas TPU kernel vgtpu/ops/coverage_pallas.py::_kernel_t
// (coverage_chunks_pallas_t_raw, variant "flat"), which evaluates each
// edge's contribution over the whole (NPX, BC) block instead of K4's
// row-structured form.  Same function and layout as K4 (csrc/coverage_t.cu):
// out[p * NC + c] is the signed area chunk c's CH edges sweep over tile
// pixel p, summed in edge order (the TPU kernel's `unroll` groups are
// reassociations of that sum, which neither K4 nor K5 takes).  The plain
// twin is vgtpu_torch/ops/coverage.py::coverage_chunks_t_torch.
//
// What bounds it on an H100: arithmetic, as K4 (about 25 float ops per edge
// and pixel), plus the per-edge scalars that every thread derives itself
// (two IEEE divisions per edge and pixel where K4 takes them once per edge
// and chunk).
//
// Design: K4 without K4's shared staging and its 8 pixel accumulators, so
// that its time beside K4's shows what those buy.  A block of 32 x 8
// threads owns 32 consecutive chunks and walks the pixels 8 at a time;
// threadIdx.x is the chunk, so a warp stores 32 consecutive floats of one
// pixel row of the output (the stores coalesce); each thread takes one
// pixel per pass and reads its chunk's edges through the read-only path
// (__ldg of a float4), with K1's vg::stage_edge and vg::edge_contribution
// (csrc/edge_coverage.cuh).  Rounding: K1's, so K5 equals K4, K1 and the
// twin bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"
#include "edge_coverage.cuh"

namespace {

constexpr int kChunks = 32;   // chunks per block, one per threadIdx.x
constexpr int kRows = 8;      // pixels per block and pass, one per threadIdx.y

__global__ void __launch_bounds__(kChunks * kRows)
coverage_t_flat_kernel(const float4* __restrict__ edges,
                       float* __restrict__ out, int nc, int ch, int tile_w,
                       int npx) {
  const int c = blockIdx.x * kChunks + threadIdx.x;
  if (c >= nc) return;
  const float4* ed = edges + static_cast<size_t>(c) * ch;
  for (int p = blockIdx.y * kRows + threadIdx.y; p < npx;
       p += gridDim.y * kRows) {
    const int row = p / tile_w;
    const float px = static_cast<float>(p - row * tile_w);
    const float py = static_cast<float>(row);
    float acc = 0.f;
    for (int e = 0; e < ch; ++e) {
      const float4 v = __ldg(ed + e);
      const float raw[4] = {v.x, v.y, v.z, v.w};
      float q[vg::kEdgeScalars];
      vg::stage_edge(raw, q);
      acc += vg::edge_contribution(q, px, py);
    }
    out[static_cast<size_t>(p) * nc + c] = acc;
  }
}

}  // namespace

// edges: (nc, ch, 4) f32 contiguous, 16-byte aligned; out: (npx, nc) f32
// contiguous; both on `device`.  Launches on `stream`, does not synchronise;
// returns cudaGetLastError().
extern "C" int vg_coverage_t_flat(const float* edges, float* out, int nc,
                                  int ch, int tile_w, int npx, int device,
                                  cudaStream_t stream) {
  const vg::DeviceScope scope(device);
  if (nc > 0 && npx > 0) {
    int ys = (npx + kRows - 1) / kRows;
    if (ys > 65535) ys = 65535;
    const dim3 grid((nc + kChunks - 1) / kChunks, ys);
    const dim3 block(kChunks, kRows);
    coverage_t_flat_kernel<<<grid, block, 0, stream>>>(
        reinterpret_cast<const float4*>(edges), out, nc, ch, tile_w, npx);
  }
  return static_cast<int>(cudaGetLastError());
}
