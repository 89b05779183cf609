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
// the sum equals K1's select form bit for bit.  The plain twin is
// vgtpu_torch/ops/coverage.py::coverage_chunks_t_torch.
//
// What bounds it on an H100: the 4 bytes of coverage written per chunk and
// pixel, against ~12 float ops per pixel and *live* (edge, row) pair, as
// K1 (chip_smoke.py [6] prints the live share of the sharded frame's pools).
//
// Design: K1's culling, then a transpose through shared memory.
// - Exact culling (csrc/edge_coverage.cuh): a block stages its chunks'
//   edge scalars and, per (chunk, row), the mask of the edges with h > 0
//   (vg::stage_chunks), and each pixel sums only its row's live edges, in
//   edge order (vg::add_live_edges): an edge with h == 0 adds exactly +-0,
//   so the sum is the dense edge-order sum bit for bit.
// - Warp <-> (row, 128-column group), lane <-> 4 columns a warp apart
//   (px0 + 32 j): the warp walks its row for each of the block's chunks in
//   turn, K1's per-lane work (the row part once per live edge, 4 columns
//   each) with every mask the warp's, so culling costs no divergence (a lane
//   per chunk, the layout before, would wait for its warp's deepest chunk's
//   edges at every pixel).
// - Transpose without a block barrier: each warp owns a buffer of its 128
//   pixels x the block's cpb chunks in shared memory, [pixel][chunk] with
//   row stride cpb + 1 floats (a lane's columns are a warp apart, so a
//   chunk's writes land in 32 banks); once the group's chunks are summed
//   (__syncwarp) the warp stores it pixel by pixel, each pixel's cpb
//   consecutive chunks of the (NPX, NC) output: with cpb = 8, one full
//   32-byte sector a pixel (pools hold multiples of 128 chunks), four a
//   store instruction.  Warps never wait for each other inside a window,
//   so a deep chunk holds back only its own warp.  (Blocks of 32 chunks,
//   a whole line a pixel, were slower on the n = 1 sharded frame: 0.0893
//   ms device a launch with a block-wide buffer between barriers, 0.0633
//   with warps of 32-column units, against this design's 0.0363 and K1's
//   0.0326 on the frame's pools; chip_smoke.py [6], NVIDIA H100 80GB HBM3,
//   700 W.)
// - Chunks per block: cpb = 8 where the staging fits the card's 227 KB
//   (every CH up to the edge window), else 4, 2, 1; cpb is uniform over a
//   launch.
// - Windows of rows: a block owns cpb chunks and a window of W rows (at
//   most kRowsPerBlock, the default tile's 8, fewer where the masks would
//   not fit), blocks along grid.y stride over the tile's windows, so the
//   staging never grows with the tile's height (ops/coverage_t_cuda.
//   k4_geometry mirrors the sizing).
// - One launch over all pools: by-value descriptors (edges, output, NC, CH,
//   first block; vg::Pools), deepest pool first, as K1; each pool writes its
//   own (NPX, NC_pool) output.
// - Edge windows (csrc/edge_coverage.cuh): a launch whose deepest pool is
//   deeper than one edge window (ew edges, ops/coverage_cuda.EDGE_WINDOW)
//   takes the deep form, coverage_chunks_t_deep_kernel: K1's deep walk
//   (vg::walk_deep: one chunk a block, a warp per (row, 128 columns) unit,
//   the edges staged a window at a time, the sums in registers across
//   windows), so every CH runs.  One chunk a block stores one float a
//   pixel, 4 bytes strided by NC: no transpose.  Shallow launches keep the
//   form above.
// Rounding: as K1 (-fmad=false, the two explicit __fmaf_rn sites; the
// per-column expressions are add_edge_row's).

#include <cuda_runtime.h>

#include "common.cuh"
#include "edge_coverage.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kGroupCols = 128;   // a warp's columns: 32 lanes x 4
constexpr int kMaxChunks = 8;     // chunks per block at most
constexpr int kRowsPerBlock = 8;  // rows a window holds at most

// Dynamic shared bytes of a block over cpb chunks of ch edges and windows of
// win rows: edge scalars, masks, the warps' transpose buffers.
inline size_t block_smem(int ch, int cpb, int win) {
  const size_t nwords = static_cast<size_t>((ch + 31) / 32);
  return sizeof(float) * cpb * vg::kEdgeScalars * static_cast<size_t>(ch) +
         sizeof(unsigned) * cpb * win * nwords +
         sizeof(float) * (kThreads / 32) * kGroupCols * (cpb + 1);
}

__global__ void __launch_bounds__(kThreads)
coverage_chunks_t_kernel(const vg::Pools P, int th, int tile_w, int cpb,
                         int win) {
  extern __shared__ __align__(16) float smem[];
  const vg::PoolDesc d = vg::pick_pool(P);
  const int nc = d.nc, ch = d.ch;
  const int nwords = (ch + 31) >> 5;
  const int c0 = (static_cast<int>(blockIdx.x) - d.block0) * cpb;
  const int lcpb = __ffs(cpb) - 1;  // cpb is a power of two
  const int bstride = cpb + 1;
  float* sp = smem;
  unsigned* masks = reinterpret_cast<unsigned*>(sp + cpb * ch * vg::kEdgeScalars);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* wbuf = reinterpret_cast<float*>(masks + cpb * win * nwords) +
                warp * kGroupCols * bstride;
  const int groups = tile_w / kGroupCols;
  const int ncb = nc - c0 < cpb ? nc - c0 : cpb;  // the block's chunks

  for (int r0 = blockIdx.y * win; r0 < th; r0 += gridDim.y * win) {
    const int nr = th - r0 < win ? th - r0 : win;
    if (r0 != static_cast<int>(blockIdx.y) * win) __syncthreads();
    vg::stage_chunks(d.edges, nc, ch, c0, cpb, r0, nr, sp, masks);
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
        if (lc < ncb) {
          d.out[(p0 + px) * nc + c0 + lc] = wbuf[px * bstride + lc];
        }
      }
      __syncwarp();
    }
  }
}

// The deep form: block (x, y) owns chunk x - block0 of its pool and the
// units y * 8 .. y * 8 + 7 of its tile (strided by gridDim.y * 8);
// windows of ew edges; each lane stores its 4 pixels' floats of the chunk.
__global__ void __launch_bounds__(kThreads)
coverage_chunks_t_deep_kernel(const vg::Pools P, int th, int tile_w, int ew) {
  extern __shared__ __align__(16) float smem[];
  const vg::PoolDesc d = vg::pick_pool(P);
  const int c = static_cast<int>(blockIdx.x) - d.block0;
  const int groups = tile_w / kGroupCols;
  const float* edges = d.edges + static_cast<size_t>(c) * d.ch * 4;
  for (int u0 = blockIdx.y * (kThreads / 32); u0 < th * groups;
       u0 += gridDim.y * (kThreads / 32)) {
    float acc[4];
    int r, px0;
    if (vg::walk_deep(edges, d.ch, ew, th, groups, u0, smem, acc, &r,
                      &px0)) {
      float* o = d.out + static_cast<size_t>(r * tile_w + px0) * d.nc + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[static_cast<size_t>(j) * d.nc] = acc[j];
    }
  }
}

}  // namespace

// desc: npools descriptors, vg::kDescWords 64-bit words each (edges, rp
// (unused), out, nc, ch, block0: ops/coverage_cuda.pack_pools with cpb
// chunks per block), read on the host; each pool's edges (nc, ch, 4) f32
// and its own output (th * tile_w, nc) f32, all on `device`.  tile_w a
// multiple of 128.  ew: 0 for the shallow form, else the deep form's edge
// window (a multiple of 32; cpb must then be 1).  Shallow: cpb (a power of
// two, 1..8) chunks per block, win (1..kRowsPerBlock) rows a window.
// smem_bytes the launch's dynamic shared memory: all as the wrapper
// computed them (ops/coverage_t_cuda.k4_geometry for the call's deepest
// pool).  A smem_bytes below this file's sizing for the launch's deepest
// pool (deep: one window of ew edges and min(th, 8) rows), or a malformed
// descriptor, is refused.  Launches on `stream`, does not synchronise;
// returns cudaGetLastError().
extern "C" int vg_coverage_chunks_t(const long long* desc, int npools, int th,
                                    int tile_w, int cpb, int win, int ew,
                                    int smem_bytes, int device,
                                    cudaStream_t stream) {
  vg::Pools pools;
  int max_ch = 0;
  const bool deep = ew != 0;
  if (cpb < 1 || cpb > kMaxChunks || (cpb & (cpb - 1)) || (deep && cpb != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = vg::read_pools(desc, npools, cpb, &pools, &max_ch);
  if (win > th) win = th;
  const size_t need =
      deep ? vg::deep_smem(ew, th < kThreads / 32 ? th : kThreads / 32)
           : block_smem(max_ch, cpb, win);
  if (blocks < 0 || max_ch < 1 || th < 1 || win < 1 ||
      win > kRowsPerBlock || tile_w < kGroupCols || tile_w % kGroupCols ||
      (deep && (ew < 32 || ew % 32)) || smem_bytes < 0 ||
      static_cast<size_t>(smem_bytes) < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vg::DeviceScope scope(device);
  if (deep) {
    static unsigned raised = 0;
    if (smem_bytes > 48 * 1024) {
      vg::allow_dynamic_smem(coverage_chunks_t_deep_kernel, &raised);
    }
    const long long units = static_cast<long long>(th) * (tile_w / kGroupCols);
    const long long ys = (units + kThreads / 32 - 1) / (kThreads / 32);
    coverage_chunks_t_deep_kernel<<<dim3(blocks, ys < 65535 ? ys : 65535),
                                    kThreads, smem_bytes, stream>>>(
        pools, th, tile_w, ew);
    return static_cast<int>(cudaGetLastError());
  }
  int ys = (th + win - 1) / win;
  if (ys > 65535) ys = 65535;
  static unsigned raised = 0;
  if (smem_bytes > 48 * 1024) {
    vg::allow_dynamic_smem(coverage_chunks_t_kernel, &raised);
  }
  coverage_chunks_t_kernel<<<dim3(blocks, ys), kThreads, smem_bytes, stream>>>(
      pools, th, tile_w, cpb, win);
  return static_cast<int>(cudaGetLastError());
}
