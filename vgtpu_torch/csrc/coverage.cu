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

namespace {

constexpr int kChunksPerBlock = 4;
constexpr int kMaxCh = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
coverage_chunks_kernel(const float* __restrict__ edges,
                       float* __restrict__ out, int nc, int ch, int tile_w,
                       int npx) {
  // per-edge scalars: x0, y0, ymin, ymax, s, m, steep, s_over_m
  __shared__ float sp[kChunksPerBlock][kMaxCh][8];
  const int c0 = blockIdx.x * kChunksPerBlock;

  for (int i = threadIdx.x; i < kChunksPerBlock * ch; i += blockDim.x) {
    const int lc = i / ch;
    const int e = i - lc * ch;
    const int c = c0 + lc;
    if (c >= nc) continue;
    const float* ed = edges + (static_cast<size_t>(c) * ch + e) * 4;
    const float x0 = ed[0], y0 = ed[1], x1 = ed[2], y1 = ed[3];
    const float dy = y1 - y0;
    const float s = dy > 0.f ? 1.f : (dy < 0.f ? -1.f : 0.f);  // jnp.sign
    // the |dy| guard comes before the steep test (coverage_pallas.py:276)
    const float m = (x1 - x0) / (fabsf(dy) < 1e-6f ? 1.f : dy);
    const bool steep = fabsf(m) < 0.01f;
    float* q = sp[lc][e];
    q[0] = x0;
    q[1] = y0;
    q[2] = fminf(y0, y1);
    q[3] = fmaxf(y0, y1);
    q[4] = s;
    q[5] = m;
    q[6] = steep ? 1.f : 0.f;
    q[7] = s / (steep ? 1.f : m);
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
      for (int e = 0; e < ch; ++e) {
        const float* q = sp[lc][e];
        const float ytop = fmaxf(q[2], py);
        const float h = fmaxf(fminf(q[3], py + 1.f) - ytop, 0.f);
        const float u0 = (px + 1.f) - __fmaf_rn(q[5], ytop - q[1], q[0]);
        const float u1 = __fmaf_rn(-q[5], h, u0);
        const float cl0 = fminf(fmaxf(u0, 0.f), 1.f);
        const float cl1 = fminf(fmaxf(u1, 0.f), 1.f);
        const float g0 = cl0 * (u0 - 0.5f * cl0);
        const float g1 = cl1 * (u1 - 0.5f * cl1);
        acc += q[6] != 0.f ? q[4] * h * cl0 : (g0 - g1) * q[7];
      }
      orow[p] = acc;
    }
  }
}

}  // namespace

// edges: (nc, ch, 4) f32 contiguous; out: (nc, npx) f32 rows (a row range of
// the caller's (NC_total + 1, npx) cov_all).  Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
extern "C" int vg_coverage_chunks(const float* edges, float* out, int nc,
                                  int ch, int tile_w, int npx,
                                  cudaStream_t stream) {
  if (nc > 0) {
    const int blocks = (nc + kChunksPerBlock - 1) / kChunksPerBlock;
    coverage_chunks_kernel<<<blocks, kThreads, 0, stream>>>(edges, out, nc,
                                                            ch, tile_w, npx);
  }
  return static_cast<int>(cudaGetLastError());
}
