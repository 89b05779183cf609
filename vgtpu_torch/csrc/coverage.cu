// K1: exact box-filtered winding coverage of edge chunks over one tile.
//
// Replaces the Pallas TPU kernel vgtpu/ops/coverage_pallas.py::_kernel_t2_rt
// (driven by coverage_chunks_pallas_rt_raw).  Same function: for chunk c of
// CH tile-local edges (x0, y0, x1, y1), out[c, p] is the sum over its edges
// of the signed area the edge sweeps over pixel p, in the division-free
// G-form of vgtpu/ops/coverage.py::_edge_contribution (ARCHITECTURE.md):
//   u0 = (px + 1) - x(ytop),  u1 = u0 - m*h,  c = clamp(u, 0, 1),
//   G(u) = c * (u - c/2),     contribution = (G(u0) - G(u1)) * s/m,
// with near-vertical edges (|m| < 0.01) taking s*h*clamp(u0).
// The plain twin is vgtpu_torch/ops/coverage.py::coverage_chunks_torch.
//
// What bounds it on an H100: arithmetic.  Each (chunk, pixel) pair costs
// about 25 float ops per edge and reads nothing per pixel; the only device
// memory traffic is the 16*CH-byte edge list in and 4 KB of coverage out per
// chunk (8x128 tile), so at the 1080p pool sizes the kernel is far from the
// 3.35 TB/s bandwidth roof and is limited by FP32 issue rate and occupancy.
//
// Design: one block per group of kChunksPerBlock chunks.  The per-edge
// scalars (x0, y0, ymin, ymax, s, m, steep, s/m) are computed once per edge
// and staged in shared memory, where every thread reads them as broadcasts.
// Each thread owns pixels p = threadIdx.x + k*blockDim.x and accumulates
// its chunk's CH edges in a register in edge order (the plain version's
// order), then stores the chunk-major (NC, TH*TW) row — consecutive threads
// store consecutive pixels, so stores coalesce.  No transpose of the TPU
// kernel's (8,128)/lane layout survives.
//
// Rounding: IEEE division is kept (no --use_fast_math), and the library is
// built with -fmad=false, so nvcc contracts no a*b+c into an FMA on its own.
// The G-form divides by m, which amplifies an ulp of error in u up to 100x,
// so the two a*b+c sites the reference XLA contracts — x(ytop) and u1 — are
// written as explicit __fmaf_rn here and as explicit FMAs in the plain twin.
// Kernel and twin then evaluate the same roundings in the same order.

#include <cuda_runtime.h>

#include "common.cuh"
#include "edge_coverage.cuh"

namespace {

constexpr int kChunksPerBlock = 4;
constexpr int kMaxCh = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
coverage_chunks_kernel(const float* __restrict__ edges,
                       float* __restrict__ out, int nc, int ch, int tile_w,
                       int npx) {
  // per-edge scalars: x0, y0, ymin, ymax, s, m, steep, s_over_m
  __shared__ float sp[kChunksPerBlock][kMaxCh][vg::kEdgeScalars];
  const int c0 = blockIdx.x * kChunksPerBlock;

  for (int i = threadIdx.x; i < kChunksPerBlock * ch; i += blockDim.x) {
    const int lc = i / ch;
    const int e = i - lc * ch;
    const int c = c0 + lc;
    if (c >= nc) continue;
    vg::stage_edge(edges + (static_cast<size_t>(c) * ch + e) * 4, sp[lc][e]);
  }
  __syncthreads();

  for (int lc = 0; lc < kChunksPerBlock; ++lc) {
    const int c = c0 + lc;
    if (c >= nc) break;
    float* orow = out + static_cast<size_t>(c) * npx;
    for (int p = threadIdx.x; p < npx; p += blockDim.x) {
      const int row = p / tile_w;
      const float px = static_cast<float>(p - row * tile_w);
      const float py = static_cast<float>(row);
      float acc = 0.f;
      for (int e = 0; e < ch; ++e) acc += vg::edge_contribution(sp[lc][e], px, py);
      orow[p] = acc;
    }
  }
}

}  // namespace

// edges: (nc, ch, 4) f32 contiguous; out: (nc, npx) f32 rows (a row range of
// the caller's (NC_total + 1, npx) cov_all), both on `device`.  Launches on
// `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int vg_coverage_chunks(const float* edges, float* out, int nc,
                                  int ch, int tile_w, int npx, int device,
                                  cudaStream_t stream) {
  const vg::DeviceScope scope(device);
  if (nc > 0) {
    const int blocks = (nc + kChunksPerBlock - 1) / kChunksPerBlock;
    coverage_chunks_kernel<<<blocks, kThreads, 0, stream>>>(edges, out, nc,
                                                            ch, tile_w, npx);
  }
  return static_cast<int>(cudaGetLastError());
}
