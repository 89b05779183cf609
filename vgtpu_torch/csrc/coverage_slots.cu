// K6: exact box-filtered winding coverage of edge chunks, chunk-major, for
// one pool.
//
// Replaces the Pallas TPU kernel vgtpu/ops/coverage_pallas.py::_kernel
// (coverage_chunks_pallas), the first coverage kernel: its grid walks the
// CH edge slots of a block of chunks and accumulates the (BC, NPX) output
// block slot by slot.  Same function and layout as K1 (csrc/coverage.cu):
// out[c * NPX + p] is the signed area chunk c's CH edges sweep over tile
// pixel p, summed in slot order.  The plain twin is
// vgtpu_torch/ops/coverage.py::coverage_chunks_torch.
//
// What bounds it on an H100: the 4 bytes of coverage written per chunk and
// pixel against ~12 float ops per pixel and *live* (edge, row) pair, as K1:
// an edge spans few of a tile's rows (68-82% of the 1080p frame's (edge,
// row) pairs are dead, h == 0).  The first port evaluated every edge
// at every pixel and derived each edge's scalars (two IEEE divisions) per
// (edge, pixel): 0.2151 ms device per [5c] frame, 13.5x the live bound;
// this design takes 0.0505-0.0509 ms, 3.2x (four launches, one a pool;
// chip_smoke.py [6], NVIDIA H100 80GB HBM3, 700 W).
//
// Design: K1's, for one pool (csrc/edge_coverage.cuh):
// - Staging: a block of kThreads threads owns kChunksPerBlock chunks; one
//   warp per (chunk, 32-edge word) stages each edge's scalars once per
//   block and one ballot per row of the edges with h > 0, an exact
//   per-(chunk, row) mask (vg::stage_edges).  Row windows as K1: the whole
//   tile where the masks fit, else the most rows that fit, restaged window
//   by window.
// - Warp <-> (chunk, row, 128-column group), lane <-> 4 adjacent columns;
//   the warp walks only its row's live edges in edge order
//   (vg::add_live_edges) and each lane stores one float4.
// - Edge windows: a chunk deeper than one window (ew edges,
//   ops/coverage_cuda.EDGE_WINDOW) takes the deep form, one chunk a block,
//   the edges staged a window at a time, the sums in registers across
//   windows (vg::walk_deep), so every CH runs.
// - Staging source: a shallow block's raw edges are contiguous (its
//   chunks' CH * 16 bytes each), so one thread copies them into shared
//   memory with Hopper's bulk copy, completion on an mbarrier (bulk_load),
//   and the lanes stage from shared memory.  Against each lane loading its
//   edge's 16 bytes from device memory (K5's and the deep forms' staging)
//   the bulk copy took 0.04796-0.04825 ms device per [5c] frame, the warp
//   loads 0.05011-0.05081 (both built and timed in turns within each of
//   four chip_smoke.py runs, before the slower was removed; NVIDIA H100
//   80GB HBM3, 700 W).  The deep form stages with warp loads through
//   vg::walk_deep, as K1's, K4's and K5's do.
// Rounding: K1's (-fmad=false, the two explicit __fmaf_rn, the same walk),
// so K6 equals K1 and the twin bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"
#include "edge_coverage.cuh"

namespace {

constexpr int kChunksPerBlock = vg::kPoolChunksPerBlock;  // K1's block
constexpr int kThreads = vg::kPoolThreads;
constexpr int kGroupCols = 128;  // a warp's columns: 32 lanes x 4

// Dynamic shared bytes of a shallow block over chunks of ch edges and
// windows of win rows: the scalars, the raw edges, the mbarrier, the masks.
inline size_t block_smem(int ch, int win) {
  const size_t nwords = static_cast<size_t>((ch + 31) / 32);
  return sizeof(float) * kChunksPerBlock * (vg::kEdgeScalars + 4) * ch + 16 +
         sizeof(unsigned) * kChunksPerBlock * win * nwords;
}

// Hopper's bulk copy (TMA without a tensor map): one thread copies a run of
// bytes (a multiple of 16, both ends 16-byte aligned) from device memory
// into shared memory, and the copy completes on an mbarrier (one arrival:
// the issuing thread's, which also announces the bytes).  A waiting thread
// spins on the barrier's phase parity, 0 for its first completion.
// bar_init is thread 0's, followed by a block barrier.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  // shared memory's earlier generic-proxy accesses come before the copy's
  // writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(kThreads)
coverage_slots_kernel(const float* __restrict__ edges, float* __restrict__ out,
                      int nc, int ch, int th, int tile_w, int win) {
  extern __shared__ __align__(16) float smem[];
  const int nwords = (ch + 31) >> 5;
  const int c0 = blockIdx.x * kChunksPerBlock;
  const int ncb = nc - c0 < kChunksPerBlock ? nc - c0 : kChunksPerBlock;
  float* sp = smem;
  float* raw = sp + kChunksPerBlock * ch * vg::kEdgeScalars;
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(raw + kChunksPerBlock * ch * 4);
  unsigned* masks = reinterpret_cast<unsigned*>(bar + 2);
  if (threadIdx.x == 0) {
    bar_init(bar);
    bulk_load(raw, edges + static_cast<size_t>(c0) * ch * 4, 16u * ncb * ch,
              bar);
  }
  __syncthreads();  // the barrier's init before any wait
  bar_wait(bar, 0);
  const int lane = threadIdx.x & 31;
  const int groups = tile_w / kGroupCols;
  const int npx = th * tile_w;
  for (int r0 = 0; r0 < th; r0 += win) {
    const int nr = th - r0 < win ? th - r0 : win;
    if (r0 > 0) __syncthreads();  // every warp is done with the last window
    vg::stage_edges(raw, ch * 4, ncb, ch, ch, r0, 1, nr, sp, masks);
    const int per_chunk = nr * groups;
    for (int t = threadIdx.x >> 5; t < ncb * per_chunk; t += kThreads / 32) {
      const int lc = t / per_chunk;
      const int rg = t - lc * per_chunk;
      const int r = rg / groups;
      const int px0 = (rg - r * groups) * kGroupCols + lane * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      vg::add_live_edges<4>(sp + lc * ch * vg::kEdgeScalars,
                            masks + (lc * nr + r) * nwords, nwords,
                            static_cast<float>(r0 + r), px0, acc);
      *reinterpret_cast<float4*>(out + static_cast<size_t>(c0 + lc) * npx +
                                 (r0 + r) * tile_w + px0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
}

// The deep form: block (x, y) owns chunk x and the units y * 4 .. y * 4 + 3
// of its tile (strided by gridDim.y * 4); windows of ew edges.
__global__ void __launch_bounds__(kThreads)
coverage_slots_deep_kernel(const float* __restrict__ edges,
                           float* __restrict__ out, int ch, int th, int tile_w,
                           int ew) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int groups = tile_w / kGroupCols;
  const int npx = th * tile_w;
  const float* ce = edges + static_cast<size_t>(c) * ch * 4;
  for (int u0 = blockIdx.y * (kThreads / 32); u0 < th * groups;
       u0 += gridDim.y * (kThreads / 32)) {
    float acc[4];
    int r, px0;
    if (vg::walk_deep(ce, ch, ew, th, groups, u0, smem, acc, &r, &px0)) {
      *reinterpret_cast<float4*>(out + static_cast<size_t>(c) * npx +
                                 r * tile_w + px0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
}

}  // namespace

// edges: (nc, ch, 4) f32 contiguous, 16-byte aligned; out: (nc, th *
// tile_w) f32 contiguous, 16-byte aligned; both on `device`.  tile_w a
// multiple of 128, ch >= 1.  ew: 0 for the shallow form (blocks of
// kChunksPerBlock chunks, windows of win rows), else the deep form's edge
// window (a multiple of 32; one chunk a block).  smem_bytes: the launch's
// dynamic shared memory; all as the wrapper computed them
// (ops/coverage_slots_cuda.k6_geometry).  A smem_bytes below this file's
// sizing is refused.
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int vg_coverage_slots(const float* edges, float* out, int nc,
                                 int ch, int th, int tile_w, int win, int ew,
                                 int smem_bytes, int device,
                                 cudaStream_t stream) {
  const bool deep = ew != 0;
  if (win > th) win = th;
  const size_t need =
      deep ? vg::deep_smem(ew, th < kThreads / 32 ? th : kThreads / 32)
           : block_smem(ch, win);
  if (nc < 0 || ch < 1 || th < 1 || win < 1 || tile_w < kGroupCols ||
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
    return vg::launch_kernel(coverage_slots_deep_kernel, &raised, grid,
                             kThreads, smem_bytes, stream, edges, out, ch, th,
                             tile_w, ew);
  }
  const dim3 grid((nc + kChunksPerBlock - 1) / kChunksPerBlock);
  static unsigned raised = 0;
  return vg::launch_kernel(coverage_slots_kernel, &raised, grid, kThreads,
                           smem_bytes, stream, edges, out, nc, ch, th, tile_w,
                           win);
}
