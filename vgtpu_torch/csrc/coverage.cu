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
// What bounds it on an H100: the 4 bytes of coverage written per chunk and
// pixel (4 KB per chunk of an 8x128 tile; the edge lists in are 16*CH bytes
// a chunk) against ~12 float ops per pixel and *live* (edge, row) pair.
// Most pairs are dead: an edge spans few of a tile's rows (chip_smoke.py
// [6] prints the live share of the 1080p frame's pairs, h > 0).
//
// Exactness of the skip (csrc/edge_coverage.cuh): an edge with h == 0 on a
// row adds exactly +0 or -0 to each of its pixels, and adding +-0 to the
// accumulator, which starts at +0, leaves it unchanged bit for bit.  So
// walking only the live edges of each row, in edge order, gives the dense
// edge-order sum of the twin bit for bit (for edges whose slope is finite).
//
// Design:
// - Staging (vg::stage_chunks): a block of kThreads threads owns
//   kChunksPerBlock chunks.  One warp per (chunk, 32-edge word) stages each
//   edge's scalars (x0, y0, ymin, ymax, s, m, steep, s/m) in shared memory
//   and takes one ballot per tile row of the edges with h > 0, computed with
//   the kernel's own float expressions: a per-(chunk, row) mask, ceil(CH/32)
//   words.  Any tile height: the staging is dynamic shared memory sized
//   at launch for the launch's deepest pool (at most one edge window deep)
//   and a window of W rows, kChunksPerBlock * (32 CH + 4 W ceil(CH/32))
//   bytes.  W is the
//   whole tile where that fits in the card's 227 KB (every tile up to
//   14,512 rows at CH = 2, 7,072 at CH = 48), else the most rows that fit:
//   the block stages the masks of one window, walks it, and restages the
//   next (ops/coverage_cuda.k1_geometry mirrors the sizing).  A tile of one
//   window runs the loop once, with the staging and walk it had before
//   windows existed.
// - Warp <-> (chunk, row, 128-column group), lane <-> 4 adjacent columns.
//   The warp walks only its row's set bits, in edge order (__ffs): per live
//   edge it reads the 8 scalars as two broadcast float4 loads, computes
//   ytop, h and x(ytop) once, then each lane its 4 columns' G-form (or steep
//   form) with the twin's roundings in its order
//   (vg::add_edge_row).  The mask is the warp's, so culling costs no
//   divergence.  Tiles with more rows (or column groups) than warps loop the
//   warps over them.  Each lane stores one float4: a row of 128 columns is
//   one 512-byte coalesced store, chunk-major (NC, TH*TW).
// - One launch over all pools: the pools pass as a by-value array of
//   descriptors (edges, output row, NC, CH, first block; vg::Pools); a block
//   finds its pool from the block prefix.  ops/coverage_cuda.pack_pools
//   orders the deepest pools first (their blocks are the longest) and
//   splits a tuple of more than kMaxPools pools into several launches.  The
//   dead row of cov_all is a pool of one chunk with no edges: its block
//   writes zeros, so no separate fill runs.
// - Edge windows (csrc/edge_coverage.cuh): the staging above holds all of
//   a block's edges, 32 bytes an edge, so it has a depth ceiling (1,808
//   edges a chunk).  A launch whose deepest pool is deeper than one edge
//   window (ew edges, ops/coverage_cuda.EDGE_WINDOW) takes the deep form,
//   coverage_chunks_deep_kernel: a block owns one chunk and 4 of its
//   (row, 128-column) units, a warp each, and walks the chunk's edges a
//   window at a time (vg::walk_deep), each warp's 4 sums in registers
//   across windows, so every CH runs.  The sum still runs in edge order,
//   so the deep form equals the twin bit for bit too.  Shallow launches
//   (every pool of the default configurations) keep the form above and
//   its source.
// - A view window (a retained pan, vgtpu_torch/raster/retained.py): the
//   launch takes the scene tiles a view reaches (columns [x0, x1), rows
//   [y0, y1) of a grid ntx tiles wide) and each pool the scene tile of
//   each chunk (the descriptor's rp word).  A chunk outside the window is
//   neither staged nor computed and its row is not written; a block with
//   none inside exits at once.  The rows an in-window tile reads are
//   written all the same: its entries' chunks, primary and extra, share
//   its tile, and the dead row has no tiles.  Without a window (every
//   frame-path launch) every chunk is walked as before.
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

// K1's and K3's block (edge_coverage.cuh; ops/coverage_cuda.py mirrors it)
constexpr int kChunksPerBlock = vg::kPoolChunksPerBlock;
constexpr int kThreads = vg::kPoolThreads;
constexpr int kGroupCols = 128;  // a warp's columns: 32 lanes x 4

// Dynamic shared bytes of a block over chunks of ch edges and windows of
// win rows.
inline size_t block_smem(int ch, int win) {
  const size_t nwords = static_cast<size_t>((ch + 31) / 32);
  return sizeof(float) * kChunksPerBlock * vg::kEdgeScalars * ch +
         sizeof(unsigned) * kChunksPerBlock * win * nwords;
}

using vg::TileWindow;

// The pool's chunk tiles under a window, else null: every chunk is live.
__device__ __forceinline__ const int* window_tiles(const TileWindow& W,
                                                   const vg::PoolDesc& d) {
  return W.on ? reinterpret_cast<const int*>(d.rp) : nullptr;
}

__global__ void __launch_bounds__(kThreads)
coverage_chunks_kernel(const vg::Pools P, int th, int tile_w, int win,
                       const TileWindow W) {
  extern __shared__ __align__(16) float smem[];
  const vg::PoolDesc d = vg::pick_pool(P);
  const int ch = d.ch;
  const int nwords = (ch + 31) >> 5;
  const int c0 = (static_cast<int>(blockIdx.x) - d.block0) * kChunksPerBlock;
  // bit lc: chunk c0 + lc lies in the window; the same in every thread, so
  // a block with none returns before any barrier
  unsigned live = ~0u;
  const int* tiles = window_tiles(W, d);
  if (tiles != nullptr) {
    live = 0u;
    for (int lc = 0; lc < kChunksPerBlock && c0 + lc < d.nc; ++lc) {
      if (W.holds(__ldg(tiles + c0 + lc))) live |= 1u << lc;
    }
    if (live == 0u) return;
  }
  float* sp = smem;
  unsigned* masks =
      reinterpret_cast<unsigned*>(smem + kChunksPerBlock * ch * vg::kEdgeScalars);
  const int lane = threadIdx.x & 31;
  const int groups = tile_w / kGroupCols;
  const int npx = th * tile_w;
  for (int r0 = 0; r0 < th; r0 += win) {
    const int nr = th - r0 < win ? th - r0 : win;
    if (r0 > 0) __syncthreads();  // every warp is done with the last window
    vg::stage_chunks(d.edges, d.nc, ch, c0, kChunksPerBlock, r0, nr, sp, masks,
                     live);
    const int per_chunk = nr * groups;
    for (int t = threadIdx.x >> 5; t < kChunksPerBlock * per_chunk;
         t += kThreads / 32) {
      const int lc = t / per_chunk;
      const int c = c0 + lc;
      if (c >= d.nc) break;  // t rises, so every later task is past nc too
      if (!((live >> lc) & 1u)) continue;  // outside the window: no row
      const int rg = t - lc * per_chunk;
      const int r = rg / groups;
      const int px0 = (rg - r * groups) * kGroupCols + lane * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      vg::add_live_edges<4>(sp + lc * ch * vg::kEdgeScalars,
                            masks + (lc * nr + r) * nwords, nwords,
                            static_cast<float>(r0 + r), px0, acc);
      *reinterpret_cast<float4*>(d.out + static_cast<size_t>(c) * npx +
                                 (r0 + r) * tile_w + px0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
}

// The deep form: block (x, y) owns chunk x - block0 of its pool (one chunk
// a block) and the units y * 4 .. y * 4 + 3 of its tile (strided by
// gridDim.y * 4); windows of ew edges.
__global__ void __launch_bounds__(kThreads)
coverage_chunks_deep_kernel(const vg::Pools P, int th, int tile_w, int ew,
                            const TileWindow W) {
  extern __shared__ __align__(16) float smem[];
  const vg::PoolDesc d = vg::pick_pool(P);
  const int c = static_cast<int>(blockIdx.x) - d.block0;
  const int* tiles = window_tiles(W, d);
  if (tiles != nullptr && !W.holds(__ldg(tiles + c))) return;  // block-uniform
  const int groups = tile_w / kGroupCols;
  const int npx = th * tile_w;
  const float* edges = d.edges + static_cast<size_t>(c) * d.ch * 4;
  for (int u0 = blockIdx.y * (kThreads / 32); u0 < th * groups;
       u0 += gridDim.y * (kThreads / 32)) {
    float acc[4];
    int r, px0;
    if (vg::walk_deep(edges, d.ch, ew, th, groups, u0, smem, acc, &r,
                      &px0)) {
      *reinterpret_cast<float4*>(d.out + static_cast<size_t>(c) * npx +
                                 r * tile_w + px0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
}

}  // namespace

// desc: npools descriptors, vg::kDescWords 64-bit words each (edges, rp
// (the pool's (nc,) int32 chunk tiles under a view window, else null), out,
// nc, ch, block0: ops/coverage_cuda.pack_pools), read on the host; each
// pool's edges (nc, ch, 4) f32 and its output rows (nc, th * tile_w) f32,
// 16-byte aligned, all on `device`.  tile_w a multiple of 128.  view: null,
// or 5 host ints (x0, y0, x1, y1, ntx), the view window: only chunks whose
// tile lies in columns [x0, x1) and rows [y0, y1) of a grid ntx tiles wide
// (and pools without tiles) are computed.
// ew: 0 for the shallow form (blocks of kChunksPerBlock chunks), else the
// deep form's edge window (a multiple of 32; one chunk a block).  win: the
// rows a shallow window stages (>= 1); smem_bytes: the launch's dynamic
// shared memory; all as the wrapper computed them (ops/coverage_cuda.
// k1_geometry for the call's deepest pool).  A smem_bytes below this
// file's sizing (shallow: min(win, th) rows for the launch's deepest pool;
// deep: one window of ew edges and min(th, 4) rows), or a malformed
// descriptor, is refused.  Launches on `stream`, does not synchronise;
// returns cudaGetLastError().
extern "C" int vg_coverage_chunks(const long long* desc, int npools, int th,
                                  int tile_w, int win, const int* view, int ew,
                                  int smem_bytes, int device,
                                  cudaStream_t stream) {
  vg::Pools pools;
  int max_ch = 0;
  const bool deep = ew != 0;
  const int blocks = vg::read_pools(desc, npools, deep ? 1 : kChunksPerBlock,
                                    &pools, &max_ch);
  if (win > th) win = th;
  const size_t need =
      deep ? vg::deep_smem(ew, th < kThreads / 32 ? th : kThreads / 32)
           : block_smem(max_ch, win);
  if (blocks < 0 || th < 1 || win < 1 || tile_w < kGroupCols ||
      tile_w % kGroupCols || (deep && (ew < 32 || ew % 32)) ||
      smem_bytes < 0 || static_cast<size_t>(smem_bytes) < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TileWindow W{0, 0, 0, 0, 0, 1};
  if (view != nullptr) {
    W = TileWindow{1, view[0], view[1], view[2], view[3], view[4]};
    if (W.ntx < 1 || W.x0 < 0 || W.y0 < 0 || W.x1 < W.x0 || W.y1 < W.y0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const vg::DeviceScope scope(device);
  if (deep) {
    static unsigned raised = 0;
    if (smem_bytes > 48 * 1024) {
      vg::allow_dynamic_smem(coverage_chunks_deep_kernel, &raised);
    }
    const long long units = static_cast<long long>(th) * (tile_w / kGroupCols);
    const long long ys = (units + kThreads / 32 - 1) / (kThreads / 32);
    coverage_chunks_deep_kernel<<<dim3(blocks, ys < 65535 ? ys : 65535),
                                  kThreads, smem_bytes, stream>>>(
        pools, th, tile_w, ew, W);
    return static_cast<int>(cudaGetLastError());
  }
  static unsigned raised = 0;
  if (smem_bytes > 48 * 1024) {
    vg::allow_dynamic_smem(coverage_chunks_kernel, &raised);
  }
  coverage_chunks_kernel<<<blocks, kThreads, smem_bytes, stream>>>(
      pools, th, tile_w, win, W);
  return static_cast<int>(cudaGetLastError());
}
