// K4: exact box-filtered winding coverage of edge chunks, pixel-major.
//
// Replaces the Pallas TPU kernel vgtpu/ops/coverage_pallas.py::_kernel_t2
// (coverage_chunks_pallas_t_raw, variant "row"), which feeds the chunk ->
// entry segment-sum of the sharded frame and the variant-sharded batch
// (vgtpu_torch/ops/coverage.py::entry_coverage_from_pools).  Same function
// as K1 (csrc/coverage.cu) in the transposed layout: out[p * NC + c] is the
// signed area chunk c's CH edges sweep over tile pixel p.  The TPU kernel
// writes (g0 - g1) * b_gen + a_vert * c0, with b_gen = 0 on near-vertical
// edges and a_vert = 0 on the others, so one term is always an exact 0 and
// the sum equals K1's select form bit for bit; this kernel takes K1's
// per-edge arithmetic from edge_coverage.cuh.  The plain twin is
// vgtpu_torch/ops/coverage.py::coverage_chunks_t_torch.
//
// What bounds it on an H100: arithmetic (about 25 float ops per edge and
// pixel: every edge at every pixel, where K1 skips the rows an edge does
// not span; 16*CH bytes in and 4 bytes out per chunk and pixel).
//
// Design: a block of 32 x 8 threads owns 32 consecutive chunks and a slab
// of pixels.  threadIdx.x is the chunk, so a warp stores 32 consecutive
// floats of one pixel row of the output: the stores coalesce.  The per-edge
// scalars of the block's chunks are staged in shared memory with the chunk
// innermost ([edge][scalar][chunk], 32 KB at CH = 32), so a warp's loads hit
// 32 different banks.  The staging is dynamic shared memory of 1 KB per edge
// sized at launch, so any CH the card can hold (227 edges) is taken
// (ops/coverage_t_cuda.k4_geometry mirrors the sizing).  One form serves
// every CH: it has the former static 32-edge array's 952 instructions and
// 55 registers, and its device time on the n = 1 sharded frame is within
// 2% of that form's (NVIDIA H100 80GB HBM3, 700 W).  Each thread keeps
// kPix accumulators and walks the edges
// outermost: one edge's 8 scalars are loaded once for kPix pixels, and
// every pixel still sums its edges in edge order (K1's and the twin's order).
// Rounding: as K1 (-fmad=false, the two explicit __fmaf_rn sites).

#include <cuda_runtime.h>

#include "common.cuh"
#include "edge_coverage.cuh"

namespace {

constexpr int kChunks = 32;   // chunks per block, one per threadIdx.x
constexpr int kRows = 8;      // threadIdx.y
constexpr int kPix = 8;       // pixels per thread and pass

// Dynamic shared bytes of a block over chunks of ch edges.
inline size_t block_smem(int ch) {
  return sizeof(float) * vg::kEdgeScalars * kChunks * static_cast<size_t>(ch);
}

__global__ void __launch_bounds__(kChunks * kRows)
coverage_chunks_t_kernel(const float* __restrict__ edges,
                         float* __restrict__ out, int nc, int ch,
                         int tile_w, int npx) {
  extern __shared__ float sp[];  // [edge][scalar][chunk]
  const int tid = threadIdx.y * kChunks + threadIdx.x;
  const int c0 = blockIdx.x * kChunks;

  for (int i = tid; i < kChunks * ch; i += kChunks * kRows) {
    const int e = i / kChunks;
    const int lc = i - e * kChunks;
    const int c = c0 + lc;
    if (c >= nc) continue;
    float q[vg::kEdgeScalars];
    vg::stage_edge(edges + (static_cast<size_t>(c) * ch + e) * 4, q);
#pragma unroll
    for (int k = 0; k < vg::kEdgeScalars; ++k) {
      sp[(e * vg::kEdgeScalars + k) * kChunks + lc] = q[k];
    }
  }
  __syncthreads();

  const int c = c0 + threadIdx.x;
  if (c >= nc) return;
  const int stride = gridDim.y * kRows * kPix;
  for (int p0 = (blockIdx.y * kRows + threadIdx.y) * kPix; p0 < npx;
       p0 += stride) {
    float px[kPix], py[kPix], acc[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int p = p0 + j;
      const int row = p / tile_w;
      px[j] = static_cast<float>(p - row * tile_w);
      py[j] = static_cast<float>(row);
      acc[j] = 0.f;
    }
    for (int e = 0; e < ch; ++e) {
      float q[vg::kEdgeScalars];
#pragma unroll
      for (int k = 0; k < vg::kEdgeScalars; ++k) {
        q[k] = sp[(e * vg::kEdgeScalars + k) * kChunks + threadIdx.x];
      }
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        acc[j] += vg::edge_contribution(q, px[j], py[j]);
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (p0 + j < npx) out[static_cast<size_t>(p0 + j) * nc + c] = acc[j];
    }
  }
}

}  // namespace

// edges: (nc, ch, 4) f32 contiguous; out: (npx, nc) f32 contiguous; both on
// `device`.  smem_bytes is the launch's dynamic shared memory as the
// wrapper computed it (ops/coverage_t_cuda.k4_geometry: ch KB); a value
// other than this file's sizing is refused.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int vg_coverage_chunks_t(const float* edges, float* out, int nc,
                                    int ch, int tile_w, int npx,
                                    int smem_bytes, int device,
                                    cudaStream_t stream) {
  const size_t smem = block_smem(ch);
  if (ch < 1 || smem != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vg::DeviceScope scope(device);
  if (nc > 0 && npx > 0) {
    const int per_block = kRows * kPix;
    int ys = (npx + per_block - 1) / per_block;
    if (ys > 65535) ys = 65535;
    const dim3 grid((nc + kChunks - 1) / kChunks, ys);
    const dim3 block(kChunks, kRows);
    static unsigned raised = 0;
    if (smem > 48 * 1024) {
      vg::allow_dynamic_smem(coverage_chunks_t_kernel, &raised);
    }
    coverage_chunks_t_kernel<<<grid, block, smem, stream>>>(edges, out, nc,
                                                            ch, tile_w, npx);
  }
  return static_cast<int>(cudaGetLastError());
}
