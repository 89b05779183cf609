// K3: chunk winding coverage with the resolve epilogue, for supersampled
// (ss > 1) frames.
//
// Replaces the Pallas TPU kernel vgtpu/ops/coverage_resolve.py::_kernel_t2_res
// (driven by coverage_chunks_pallas_res).  Same function: for chunk c of CH
// tile-local edges over a tile of TH = ss * TH_OUT sub-rows, K1's winding
// (csrc/edge_coverage.cuh, summed in edge order) per sub-pixel, then per
// sub-row, in the order of coverage_resolve.py:269-286:
//   w = winding + backdrop[r]             (rparams row RP_BD + r)
//   cov = min(|w|, 1); even-odd 1-|mod(w,2)-1| (floored mod, as jnp.mod)
//   non-AA threshold >= 0.5; textured quads forced to 1
//   pixel-centre scissor on the sub-row centre (tile-local, sub-row y)
// and the ss sub-rows of an output row summed in order k = 0..ss-1 and
// multiplied by 1/ss.  Output: chunk-major (NC, TH_OUT*TW) final coverage.
// The plain twin is vgtpu_torch/ops/coverage_resolve.py::
// coverage_chunks_res_torch.
//
// A second entry point, vg_resolve_rows, applies the same epilogue to rows
// gathered by id from the folded sub-row coverage (the multi-chunk "XE"
// entries, whose total winding exists only after the extras fold); its twin
// is resolve_cov_rows_torch.  The epilogue is one __device__ function.
//
// What bounds it on an H100: ~12 float ops per sub-pixel and live (edge,
// sub-row) pair plus ~15 of epilogue per sub-pixel, against 4 bytes written
// per output pixel (1/ss of K1's bytes); the edge lists and params are a few
// hundred bytes per chunk.  Most (edge, sub-row) pairs are dead
// (chip_smoke.py [6] prints the live share).
//
// Exactness of the skip: as K1 (csrc/coverage.cu, csrc/edge_coverage.cuh):
// an edge with h == 0 on a sub-row adds exactly +-0 to its winding, which
// leaves the accumulator (started at +0) unchanged bit for bit, so each
// sub-row's winding, and everything the epilogue makes of it, equals the
// dense edge-order sum bit for bit.
//
// Design: the TPU kernel keeps a (NPX, BC) VMEM accumulator across a grid
// axis of edge slots, then transposes; none of that survives.
// - Staging: a block of kThreads threads owns kChunksPerBlock chunks and
//   stages, as K1 (vg::stage_chunks), each edge's scalars and a per-(chunk,
//   sub-row) mask of the edges with h > 0, one ballot per sub-row; the edges
//   and masks live in dynamic shared memory sized at launch for the
//   launch's deepest pool.  Each chunk's rparams column
//   (RP_ROWS x NC, a strided column, read once per block) is staged too:
//   tiles of up to kStaticTh = 64 sub-rows (every tile at tile_h 8, the
//   default) stage it in a static array with a compile-time row stride,
//   taller tiles after the masks in the dynamic shared memory.  The static
//   form keeps the rparams staging's source as it was before the dynamic
//   form existed: builds that reached it through one pointer for both forms
//   compiled to a reordered body whose 1080p ss=2 launches took ~5% more
//   device time (NVIDIA H100 80GB HBM3, 700 W).
// - Windows of sub-rows (tiles over kStaticTh sub-rows, their own kernel,
//   coverage_res_windowed_kernel).  The masks and the backdrop rows of the
//   rparams column are staged for a window of W output rows (W * ss
//   sub-rows) at a time: the whole tile where it fits the card's 227 KB,
//   else the most output rows that fit.  The block walks a window, then
//   restages the next, so the staging does not grow with the tile:
//   kChunksPerBlock * (32 CH + 4 W ss ceil(CH/32)) bytes + kChunksPerBlock
//   * (RP_BD + W ss) floats (ops/coverage_resolve_cuda.k3_geometry mirrors
//   the sizing).  The static form stages its whole tile, as before.
// - Warp <-> (chunk, output row, 128-column group), lane <-> 4 adjacent
//   columns, as K1.  The warp walks its ss sub-rows one after the other,
//   each over that sub-row's live edges only, in edge order
//   (vg::add_live_edges); it resolves each sub-pixel with resolve_sub
//   (backdrop RP_BD + sr, even-odd, non-AA, texture, scissor), sums the
//   sub-rows in order k = 0..ss-1, multiplies by 1/ss and stores one float4
//   per lane: no accumulator round-trips memory.
// - One launch over all RES pools: by-value pool descriptors (edges,
//   rparams, output row, NC, CH, first block) as in K1, packed by
//   ops/coverage_cuda.pack_pools.
// - Edge windows (csrc/edge_coverage.cuh): a launch whose deepest pool is
//   deeper than one edge window (ew edges, ops/coverage_cuda.EDGE_WINDOW)
//   takes the deep form, coverage_res_deep_kernel, so every CH runs.  A
//   block owns one chunk and 4 (output row, 128-column group) units, a
//   warp each.  For each sub-row k = 0..ss-1 in turn it stages the
//   chunk's edges a window at a time (vg::stage_edges: the scalars and the
//   masks of sub-row k of its output rows), each warp carrying its 4
//   windings in registers from window to window; after the last window it
//   resolves them (resolve_sub) and adds them to the sub-row sum in order
//   k.  The resolve comes after the whole edge-order sum, so the deep form
//   equals the twin bit for bit.  The rparams are read from device memory
//   (a few broadcast loads a warp).  Shallow launches keep the forms above
//   and their sources.
//
// Rounding: as K1 (the two explicit __fmaf_rn, -fmad=false, IEEE division);
// 1/ss is a power of two, so the final product is exact.

#include <cuda_runtime.h>

#include "common.cuh"
#include "edge_coverage.cuh"

namespace {

// K1's and K3's block (edge_coverage.cuh; ops/coverage_cuda.py mirrors it)
constexpr int kChunksPerBlock = vg::kPoolChunksPerBlock;
constexpr int kThreads = vg::kPoolThreads;
constexpr int kGroupCols = 128;  // a warp's columns: 32 lanes x 4
constexpr int kRowsThreads = 256;  // vg_resolve_rows: one block per row
// rparams rows (vgtpu/ops/coverage_resolve.py RP_*)
constexpr int RP_EO = 0, RP_NOAA = 1, RP_TEXF = 2, RP_SC = 3, RP_BD = 8;
constexpr int kStaticTh = 64;  // sub-rows the static rparams staging holds

struct ResolveParams {
  float eo, noaa, texf, sx0, sy0, sx1, sy1;
};

// One sub-pixel's resolved coverage from its total winding w (backdrop
// included) at tile-local pixel centre (pxl, pyl).
__device__ __forceinline__ float resolve_sub(float w, const ResolveParams& r,
                                             float pxl, float pyl) {
  float cov = fminf(fabsf(w), 1.f);
  const float md = w - 2.f * floorf(w * 0.5f);  // floored, as jnp.mod
  const float cov_eo = 1.f - fabsf(md - 1.f);
  cov = r.eo > 0.f ? cov_eo : cov;
  cov = r.noaa > 0.f ? (cov >= 0.5f ? 1.f : 0.f) : cov;
  cov = r.texf > 0.f ? 1.f : cov;
  const bool inside =
      (pxl >= r.sx0) && (pyl >= r.sy0) && (pxl < r.sx1) && (pyl < r.sy1);
  return cov * (inside ? 1.f : 0.f);
}

// Dynamic shared bytes of a block over chunks of ch edges, tiles of th
// sub-rows and windows of win sub-rows: the edge scalars and a window's
// masks (the static form: one window, win = th), then (th > kStaticTh) the
// rparams header and a window's backdrop rows.
inline size_t block_smem(int ch, int th, int win) {
  const size_t nwords = static_cast<size_t>((ch + 31) / 32);
  return sizeof(float) * kChunksPerBlock * vg::kEdgeScalars * ch +
         sizeof(unsigned) * kChunksPerBlock * win * nwords +
         (th <= kStaticTh ? 0 : sizeof(float) * kChunksPerBlock *
                                    static_cast<size_t>(RP_BD + win));
}

// Tiles of up to kRows - RP_BD sub-rows (kRows = RP_BD + kStaticTh): each
// chunk's rparams column staged in a static array of kRows rows, the masks
// of the whole tile in one window.  Its source is the static form's before
// windows existed: one loop over windows in it compiled to 40 more
// instructions and took ~6% more device time on the 1080p ss=2 frame
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py [6]).
template <int kRows>
__global__ void __launch_bounds__(kThreads)
coverage_res_kernel(const vg::Pools P, int tile_w, int ss, int th_out) {
  static_assert(kRows > 0, "the static form");
  extern __shared__ __align__(16) float smem[];
  __shared__ float srp[kChunksPerBlock][kRows];
  const vg::PoolDesc d = vg::pick_pool(P);
  const int nc = d.nc, ch = d.ch;
  const int nwords = (ch + 31) >> 5;
  const int c0 = (static_cast<int>(blockIdx.x) - d.block0) * kChunksPerBlock;
  const int th = th_out * ss;
  const int nrp = RP_BD + th;
  float* sp = smem;
  unsigned* masks =
      reinterpret_cast<unsigned*>(smem + kChunksPerBlock * ch * vg::kEdgeScalars);
  const float* rp = d.rp;

  // rparams column of each chunk; neighbouring threads read neighbouring
  // chunks of one row (stage_chunks' closing barrier covers these stores)
  for (int i = threadIdx.x; i < kChunksPerBlock * nrp; i += blockDim.x) {
    const int k = i / kChunksPerBlock;
    const int lc = i - k * kChunksPerBlock;
    const int c = c0 + lc;
    if (c < nc) srp[lc][k] = rp[static_cast<size_t>(k) * nc + c];
  }
  vg::stage_chunks(d.edges, nc, ch, c0, kChunksPerBlock, 0, th, sp, masks);

  const int lane = threadIdx.x & 31;
  const int groups = tile_w / kGroupCols;
  const int per_chunk = th_out * groups;
  const int npx_out = th_out * tile_w;
  const float inv_ss = 1.f / static_cast<float>(ss);
  for (int t = threadIdx.x >> 5; t < kChunksPerBlock * per_chunk;
       t += kThreads / 32) {
    const int lc = t / per_chunk;
    const int c = c0 + lc;
    if (c >= nc) break;  // t rises, so every later task is past nc too
    const int rg = t - lc * per_chunk;
    const int ro = rg / groups;
    const int px0 = (rg - ro * groups) * kGroupCols + lane * 4;
    const float* q = srp[lc];
    const ResolveParams r{q[RP_EO],     q[RP_NOAA],   q[RP_TEXF],   q[RP_SC],
                          q[RP_SC + 1], q[RP_SC + 2], q[RP_SC + 3]};
    const float* sp_chunk = sp + lc * ch * vg::kEdgeScalars;
    float c_sum[4];
    for (int k = 0; k < ss; ++k) {
      const int sr = ro * ss + k;
      const float py = static_cast<float>(sr);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      vg::add_live_edges<4>(sp_chunk, masks + (lc * th + sr) * nwords, nwords,
                            py, px0, acc);
      const float bd = q[RP_BD + sr];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float cv = resolve_sub(acc[j] + bd, r,
                                     static_cast<float>(px0 + j) + 0.5f,
                                     py + 0.5f);
        c_sum[j] = k == 0 ? cv : c_sum[j] + cv;
      }
    }
    *reinterpret_cast<float4*>(d.out + static_cast<size_t>(c) * npx_out +
                               ro * tile_w + px0) =
        make_float4(c_sum[0] * inv_ss, c_sum[1] * inv_ss, c_sum[2] * inv_ss,
                    c_sum[3] * inv_ss);
  }
}

// Taller tiles: the masks and the rparams backdrop rows staged a window of
// win_out output rows (win_out * ss sub-rows) at a time in dynamic shared
// memory after the edges, RP_BD header rows + the window's backdrop rows
// per chunk.
__global__ void __launch_bounds__(kThreads)
coverage_res_windowed_kernel(const vg::Pools P, int tile_w, int ss, int th_out,
                             int win_out) {
  extern __shared__ __align__(16) float smem[];
  const vg::PoolDesc d = vg::pick_pool(P);
  const int nc = d.nc, ch = d.ch;
  const int nwords = (ch + 31) >> 5;
  const int c0 = (static_cast<int>(blockIdx.x) - d.block0) * kChunksPerBlock;
  const int win = win_out * ss;          // sub-rows a window stages
  float* sp = smem;
  unsigned* masks =
      reinterpret_cast<unsigned*>(smem + kChunksPerBlock * ch * vg::kEdgeScalars);
  float* srp = reinterpret_cast<float*>(masks + kChunksPerBlock * win * nwords);
  const float* rp = d.rp;
  const int lane = threadIdx.x & 31;
  const int groups = tile_w / kGroupCols;
  const int npx_out = th_out * tile_w;
  const float inv_ss = 1.f / static_cast<float>(ss);

  for (int ro0 = 0; ro0 < th_out; ro0 += win_out) {
    const int nro = th_out - ro0 < win_out ? th_out - ro0 : win_out;
    const int r0 = ro0 * ss, nr = nro * ss;
    if (ro0 > 0) __syncthreads();  // every warp is done with the last window
    // the RP_BD header rows and the window's backdrop rows, RP_BD + r0 ..
    // RP_BD + r0 + nr - 1, of each chunk's rparams column (stage_chunks'
    // closing barrier covers these stores)
    const int nrp = RP_BD + nr;
    for (int i = threadIdx.x; i < kChunksPerBlock * nrp; i += blockDim.x) {
      const int k = i / kChunksPerBlock;
      const int lc = i - k * kChunksPerBlock;
      const int c = c0 + lc;
      const int row = k < RP_BD ? k : k + r0;
      if (c < nc) srp[lc * (RP_BD + win) + k] = rp[static_cast<size_t>(row) * nc + c];
    }
    vg::stage_chunks(d.edges, nc, ch, c0, kChunksPerBlock, r0, nr, sp, masks);

    const int per_chunk = nro * groups;
    for (int t = threadIdx.x >> 5; t < kChunksPerBlock * per_chunk;
         t += kThreads / 32) {
      const int lc = t / per_chunk;
      const int c = c0 + lc;
      if (c >= nc) break;  // t rises, so every later task is past nc too
      const int rg = t - lc * per_chunk;
      const int rl = rg / groups;
      const int ro = ro0 + rl;
      const int px0 = (rg - rl * groups) * kGroupCols + lane * 4;
      const float* q = srp + lc * (RP_BD + win);  // row RP_BD + j: sub-row r0 + j
      const ResolveParams r{q[RP_EO],     q[RP_NOAA],   q[RP_TEXF],   q[RP_SC],
                            q[RP_SC + 1], q[RP_SC + 2], q[RP_SC + 3]};
      const float* sp_chunk = sp + lc * ch * vg::kEdgeScalars;
      float c_sum[4];
      for (int k = 0; k < ss; ++k) {
        const int sr = ro * ss + k;
        const float py = static_cast<float>(sr);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        vg::add_live_edges<4>(sp_chunk, masks + (lc * nr + sr - r0) * nwords,
                              nwords, py, px0, acc);
        const float bd = q[RP_BD + sr - r0];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float cv = resolve_sub(acc[j] + bd, r,
                                       static_cast<float>(px0 + j) + 0.5f,
                                       py + 0.5f);
          c_sum[j] = k == 0 ? cv : c_sum[j] + cv;
        }
      }
      *reinterpret_cast<float4*>(d.out + static_cast<size_t>(c) * npx_out +
                                 ro * tile_w + px0) =
          make_float4(c_sum[0] * inv_ss, c_sum[1] * inv_ss, c_sum[2] * inv_ss,
                      c_sum[3] * inv_ss);
    }
  }
}

// The deep form: block (x, y) owns chunk x - block0 of its pool and the
// units y * 4 .. y * 4 + 3 of its tile's (output row, group) units
// (strided by gridDim.y * 4); windows of ew edges.  Its shared memory is
// one window's scalars and the masks of 4 sub-rows.
__global__ void __launch_bounds__(kThreads)
coverage_res_deep_kernel(const vg::Pools P, int tile_w, int ss, int th_out,
                         int ew) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kWarps = kThreads / 32;
  const vg::PoolDesc d = vg::pick_pool(P);
  const int nc = d.nc, ch = d.ch;
  const int c = static_cast<int>(blockIdx.x) - d.block0;
  float* sp = smem;
  unsigned* masks = reinterpret_cast<unsigned*>(smem + ew * vg::kEdgeScalars);
  const float* edges = d.edges + static_cast<size_t>(c) * ch * 4;
  const float* rp = d.rp;
  auto param = [&](int k) { return __ldg(rp + static_cast<size_t>(k) * nc + c); };
  const ResolveParams r{param(RP_EO),     param(RP_NOAA),   param(RP_TEXF),
                        param(RP_SC),     param(RP_SC + 1), param(RP_SC + 2),
                        param(RP_SC + 3)};
  const int lane = threadIdx.x & 31;
  const int groups = tile_w / kGroupCols;
  const int units = th_out * groups;
  const int npx_out = th_out * tile_w;
  const int nwin = (ch + ew - 1) / ew;
  const float inv_ss = 1.f / static_cast<float>(ss);
  for (int u0 = blockIdx.y * kWarps; u0 < units; u0 += gridDim.y * kWarps) {
    const int u = u0 + (threadIdx.x >> 5);
    const int ulast = (u0 + kWarps < units ? u0 + kWarps : units) - 1;
    const int ro0 = u0 / groups;
    const int nro = ulast / groups - ro0 + 1;
    const int ro = u / groups;
    const int px0 = (u - ro * groups) * kGroupCols + lane * 4;
    float c_sum[4];
    for (int k = 0; k < ss; ++k) {
      const int sr = ro * ss + k;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int w = 0; w < nwin; ++w) {
        const int e0 = w * ew;
        const int n = ch - e0 < ew ? ch - e0 : ew;
        __syncthreads();  // every warp is done with the last window
        vg::stage_edges(edges + static_cast<size_t>(e0) * 4, 0, 1, n, ew,
                        ro0 * ss + k, ss, nro, sp, masks);
        if (u < units) {
          const int nwords = (n + 31) >> 5;
          vg::add_live_edges<4>(sp, masks + (ro - ro0) * nwords, nwords,
                                static_cast<float>(sr), px0, acc);
        }
      }
      if (u < units) {
        const float bd = param(RP_BD + sr);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float cv = resolve_sub(acc[j] + bd, r,
                                       static_cast<float>(px0 + j) + 0.5f,
                                       static_cast<float>(sr) + 0.5f);
          c_sum[j] = k == 0 ? cv : c_sum[j] + cv;
        }
      }
    }
    if (u < units) {
      *reinterpret_cast<float4*>(d.out + static_cast<size_t>(c) * npx_out +
                                 ro * tile_w + px0) =
          make_float4(c_sum[0] * inv_ss, c_sum[1] * inv_ss, c_sum[2] * inv_ss,
                      c_sum[3] * inv_ss);
    }
  }
}

__global__ void __launch_bounds__(kRowsThreads)
resolve_rows_kernel(const float* __restrict__ cov_sub,
                    const int* __restrict__ ids, const float* __restrict__ rp,
                    float* __restrict__ out, int n, int tile_w, int ss,
                    int th_out) {
  const int i = blockIdx.x;
  const int npx_out = th_out * tile_w;
  const float* src = cov_sub + static_cast<size_t>(ids[i]) * npx_out * ss;
  // block-uniform loads of row i's params column (RP_ROWS, n)
  auto P = [&](int k) { return __ldg(rp + static_cast<size_t>(k) * n + i); };
  const ResolveParams r{P(RP_EO),     P(RP_NOAA),   P(RP_TEXF),   P(RP_SC),
                        P(RP_SC + 1), P(RP_SC + 2), P(RP_SC + 3)};
  const float inv_ss = 1.f / static_cast<float>(ss);
  for (int p = threadIdx.x; p < npx_out; p += blockDim.x) {
    const int ro = p / tile_w;
    const int x = p - ro * tile_w;
    float c_sum = 0.f;
    for (int k = 0; k < ss; ++k) {
      const int sr = ro * ss + k;
      const float cv = resolve_sub(src[sr * tile_w + x] + P(RP_BD + sr), r,
                                   static_cast<float>(x) + 0.5f,
                                   static_cast<float>(sr) + 0.5f);
      c_sum = k == 0 ? cv : c_sum + cv;
    }
    out[static_cast<size_t>(i) * npx_out + p] = c_sum * inv_ss;
  }
}

}  // namespace

// desc: npools descriptors, vg::kDescWords 64-bit words each (edges, rp,
// out, nc, ch, block0: ops/coverage_cuda.pack_pools), read on the host;
// each pool's edges (nc, ch, 4) f32, rparams (RP_BD + th rows padded, nc)
// f32 (row stride nc) and output rows (nc, th_out * tile_w) f32, 16-byte
// aligned (a row range of the caller's cov_final), all on `device`.
// tile_w a multiple of 128.  ew: 0 for the shallow forms (blocks of
// kChunksPerBlock chunks), else the deep form's edge window (a multiple of
// 32; one chunk a block).  win_out: the output rows a shallow window
// stages (>= 1); smem_bytes: the launch's dynamic shared memory; all as
// the wrapper computed them (ops/coverage_resolve_cuda.k3_geometry for the
// call's deepest pool).  A smem_bytes below this file's sizing for the
// launch's deepest pool (deep: one window of ew edges and 4 sub-rows), or
// a malformed descriptor, is refused.  Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
extern "C" int vg_coverage_chunks_res(const long long* desc, int npools,
                                      int tile_w, int ss, int th_out,
                                      int win_out, int ew, int smem_bytes,
                                      int device, cudaStream_t stream) {
  vg::Pools pools;
  int max_ch = 0;
  const bool deep = ew != 0;
  const int blocks = vg::read_pools(desc, npools, deep ? 1 : kChunksPerBlock,
                                    &pools, &max_ch);
  const int th = th_out * ss;
  if (th <= kStaticTh || win_out > th_out) win_out = th_out;  // static: one window
  const size_t need = deep ? vg::deep_smem(ew, kThreads / 32)
                           : block_smem(max_ch, th, win_out * ss);
  if (blocks < 0 || ss < 1 || th_out < 1 || win_out < 1 ||
      tile_w < kGroupCols || tile_w % kGroupCols ||
      (deep && (ew < 32 || ew % 32)) || smem_bytes < 0 ||
      static_cast<size_t>(smem_bytes) < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vg::DeviceScope scope(device);
  if (deep) {
    static unsigned raised = 0;
    if (smem_bytes > 48 * 1024) {
      vg::allow_dynamic_smem(coverage_res_deep_kernel, &raised);
    }
    const long long units =
        static_cast<long long>(th_out) * (tile_w / kGroupCols);
    const long long ys = (units + kThreads / 32 - 1) / (kThreads / 32);
    coverage_res_deep_kernel<<<dim3(blocks, ys < 65535 ? ys : 65535),
                               kThreads, smem_bytes, stream>>>(
        pools, tile_w, ss, th_out, ew);
  } else if (th <= kStaticTh) {
    static unsigned raised = 0;
    if (smem_bytes > 48 * 1024) {
      vg::allow_dynamic_smem(coverage_res_kernel<RP_BD + kStaticTh>, &raised);
    }
    coverage_res_kernel<RP_BD + kStaticTh>
        <<<blocks, kThreads, smem_bytes, stream>>>(pools, tile_w, ss, th_out);
  } else {
    static unsigned raised = 0;
    if (smem_bytes > 48 * 1024) {
      vg::allow_dynamic_smem(coverage_res_windowed_kernel, &raised);
    }
    coverage_res_windowed_kernel<<<blocks, kThreads, smem_bytes, stream>>>(
        pools, tile_w, ss, th_out, win_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// cov_sub: (R, th_out*ss*tile_w) f32 folded sub-row coverage; ids: (n,) i32
// rows of cov_sub; rp: (RP_ROWS, n) f32, row stride n; out: (n,
// th_out*tile_w) f32 rows; all on `device`.  Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
extern "C" int vg_resolve_rows(const float* cov_sub, const int* ids,
                               const float* rp, float* out, int n, int tile_w,
                               int ss, int th_out, int device,
                               cudaStream_t stream) {
  if (ss < 1 || th_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vg::DeviceScope scope(device);
  if (n > 0) {
    resolve_rows_kernel<<<n, kRowsThreads, 0, stream>>>(cov_sub, ids, rp, out,
                                                        n, tile_w, ss, th_out);
  }
  return static_cast<int>(cudaGetLastError());
}
