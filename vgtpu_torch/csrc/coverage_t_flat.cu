// K5: exact box-filtered winding coverage of edge chunks, pixel-major, for
// one pool (the entry point of vgtpu's flat variant).
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
// What bounds it on an H100: the 4 bytes of coverage written per chunk and
// pixel against ~12 float ops per pixel and *live* (edge, row) pair, as
// K1 and K4.  The first port evaluated every edge at every pixel
// and derived each edge's scalars (two IEEE divisions) per (edge, pixel):
// 0.2618 ms device per [5c] frame, 16.5x the live bound; this design
// takes 0.0584-0.0587 ms, 3.7x (four launches, one a pool; chip_smoke.py
// [6], NVIDIA H100 80GB HBM3, 700 W).
//
// Design: K4's, for one pool (csrc/edge_coverage.cuh):
// - Exact culling: a block stages its chunks' edge scalars and, per (chunk,
//   row), the mask of the edges with h > 0 (vg::stage_edges), and each
//   pixel sums only its row's live edges, in edge order
//   (vg::add_live_edges).
// - Warp <-> (row, 128-column group), lane <-> 4 columns a warp apart; the
//   warp walks its row for each of the block's cpb chunks in turn and
//   transposes through a warp-private [pixel][chunk] buffer, row stride
//   cpb + 1 floats, then stores each pixel's cpb consecutive chunks: with
//   cpb = 8, one 32-byte sector a pixel.  cpb = 8 where the staging fits
//   the card, else 4, 2, 1; windows of at most kRowsPerBlock rows, blocks
//   along grid.y striding over them.
// - Edge windows: a chunk deeper than one window (ew edges,
//   ops/coverage_cuda.EDGE_WINDOW) takes the deep form, one chunk a block,
//   the edges staged a window at a time, the sums in registers across
//   windows (vg::walk_deep), one float a pixel stored (no transpose), so
//   every CH runs.
// - Staging source: each lane loads its edge's 16 bytes from device
//   memory.  K6's bulk copy into shared memory (csrc/coverage_slots.cu)
//   took 0.05581-0.05913 ms device per [5c] frame here against the warp
//   loads' 0.05513-0.0554 (both built and timed in turns within each of
//   four chip_smoke.py runs, before the slower was removed; NVIDIA H100
//   80GB HBM3, 700 W).
// Rounding: K1's (-fmad=false, the two explicit __fmaf_rn, the same
// walk), so K5 equals K4, K1 and the twin bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"
#include "edge_coverage.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps (K4's block)
constexpr int kGroupCols = 128;   // a warp's columns: 32 lanes x 4
constexpr int kMaxChunks = 8;     // chunks per block at most
constexpr int kRowsPerBlock = 8;  // rows a window holds at most

// Dynamic shared bytes of a shallow block over cpb chunks of ch edges and
// windows of win rows: the scalars, the masks, the warps' transpose
// buffers.
inline size_t block_smem(int ch, int cpb, int win) {
  const size_t nwords = static_cast<size_t>((ch + 31) / 32);
  return sizeof(float) * cpb * vg::kEdgeScalars * static_cast<size_t>(ch) +
         sizeof(unsigned) * cpb * win * nwords +
         sizeof(float) * (kThreads / 32) * kGroupCols * (cpb + 1);
}

__global__ void __launch_bounds__(kThreads)
coverage_t_flat_kernel(const float* __restrict__ edges, float* __restrict__ out,
                       int nc, int ch, int th, int tile_w, int cpb, int win) {
  extern __shared__ __align__(16) float smem[];
  const int nwords = (ch + 31) >> 5;
  const int c0 = blockIdx.x * cpb;
  const int ncb = nc - c0 < cpb ? nc - c0 : cpb;  // the block's chunks
  const int lcpb = __ffs(cpb) - 1;                // cpb is a power of two
  const int bstride = cpb + 1;
  float* sp = smem;
  unsigned* masks = reinterpret_cast<unsigned*>(sp + cpb * ch * vg::kEdgeScalars);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wbuf = reinterpret_cast<float*>(masks + cpb * win * nwords) +
                warp * kGroupCols * bstride;
  const int groups = tile_w / kGroupCols;
  const float* src = edges + static_cast<size_t>(c0) * ch * 4;
  for (int r0 = blockIdx.y * win; r0 < th; r0 += gridDim.y * win) {
    const int nr = th - r0 < win ? th - r0 : win;
    if (r0 != static_cast<int>(blockIdx.y) * win) __syncthreads();
    vg::stage_edges(src, ch * 4, ncb, ch, ch, r0, 1, nr, sp, masks);
    for (int u = warp; u < nr * groups; u += kThreads / 32) {
      const int r = u / groups;
      const int px0 = (u - r * groups) * kGroupCols;
      for (int lc = 0; lc < ncb; ++lc) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        vg::add_live_edges<4, 32>(sp + lc * ch * vg::kEdgeScalars,
                                  masks + (lc * nr + r) * nwords, nwords,
                                  static_cast<float>(r0 + r), px0 + lane, acc);
#pragma unroll
        for (int j = 0; j < 4; ++j) wbuf[(lane + 32 * j) * bstride + lc] = acc[j];
      }
      __syncwarp();
      // pixel px of the group, chunk lc: lc fastest, so a warp stores
      // 32 / cpb pixels' runs of cpb consecutive chunks
      const size_t p0 = static_cast<size_t>(r0 + r) * tile_w + px0;
      for (int i = lane; i < kGroupCols << lcpb; i += 32) {
        const int px = i >> lcpb;
        const int lc = i & (cpb - 1);
        if (lc < ncb) out[(p0 + px) * nc + c0 + lc] = wbuf[px * bstride + lc];
      }
      __syncwarp();
    }
  }
}

// The deep form: block (x, y) owns chunk x and the units y * 8 .. y * 8 + 7
// of its tile (strided by gridDim.y * 8); windows of ew edges; each lane
// stores its 4 pixels' floats of the chunk.
__global__ void __launch_bounds__(kThreads)
coverage_t_flat_deep_kernel(const float* __restrict__ edges,
                            float* __restrict__ out, int nc, int ch, int th,
                            int tile_w, int ew) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int groups = tile_w / kGroupCols;
  const float* ce = edges + static_cast<size_t>(c) * ch * 4;
  for (int u0 = blockIdx.y * (kThreads / 32); u0 < th * groups;
       u0 += gridDim.y * (kThreads / 32)) {
    float acc[4];
    int r, px0;
    if (vg::walk_deep(ce, ch, ew, th, groups, u0, smem, acc, &r, &px0)) {
      float* o = out + static_cast<size_t>(r * tile_w + px0) * nc + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[static_cast<size_t>(j) * nc] = acc[j];
    }
  }
}

}  // namespace

// edges: (nc, ch, 4) f32 contiguous, 16-byte aligned; out: (th * tile_w,
// nc) f32 contiguous; both on `device`.  tile_w a multiple of 128, ch >= 1.
// ew: 0 for the shallow form (cpb chunks a block, a power of two 1..8,
// windows of win <= kRowsPerBlock rows), else the deep form's edge window
// (a multiple of 32; one chunk a block, cpb ignored).  smem_bytes: the
// launch's dynamic shared memory; all as the wrapper computed them
// (ops/coverage_t_flat_cuda.k5_geometry).  A smem_bytes below this file's
// sizing is refused.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int vg_coverage_t_flat(const float* edges, float* out, int nc,
                                  int ch, int th, int tile_w, int cpb, int win,
                                  int ew, int smem_bytes, int device,
                                  cudaStream_t stream) {
  const bool deep = ew != 0;
  if (win > th) win = th;
  if (!deep && (cpb < 1 || cpb > kMaxChunks || (cpb & (cpb - 1)) || win < 1 ||
                win > kRowsPerBlock)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t need =
      deep ? vg::deep_smem(ew, th < kThreads / 32 ? th : kThreads / 32)
           : block_smem(ch, cpb, win);
  if (nc < 0 || ch < 1 || th < 1 || tile_w < kGroupCols ||
      tile_w % kGroupCols || (deep && (ew < 32 || ew % 32)) ||
      smem_bytes < 0 || static_cast<size_t>(smem_bytes) < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vg::DeviceScope scope(device);
  if (nc == 0) return static_cast<int>(cudaGetLastError());
  if (deep) {
    const long long units = static_cast<long long>(th) * (tile_w / kGroupCols);
    const long long ys = (units + kThreads / 32 - 1) / (kThreads / 32);
    const dim3 grid(nc, ys < 65535 ? ys : 65535);
    static unsigned raised = 0;
    return vg::launch_kernel(coverage_t_flat_deep_kernel, &raised, grid,
                             kThreads, smem_bytes, stream, edges, out, nc, ch,
                             th, tile_w, ew);
  }
  int ys = (th + win - 1) / win;
  if (ys > 65535) ys = 65535;
  const dim3 grid((nc + cpb - 1) / cpb, ys);
  static unsigned raised = 0;
  return vg::launch_kernel(coverage_t_flat_kernel, &raised, grid, kThreads,
                           smem_bytes, stream, edges, out, nc, ch, th, tile_w,
                           cpb, win);
}
