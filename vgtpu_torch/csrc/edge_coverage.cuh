// The per-edge arithmetic of the coverage kernels: one place, so they
// accumulate the same winding with the same roundings.  See coverage.cu for
// the G-form and why the two a*b+c sites are explicit __fmaf_rn (the
// library is built with -fmad=false).
//
// Which kernel uses what:
//   stage_edge          every coverage kernel (K1, K3-K6)
//   edge_row_h, add_edge_row, add_live_edges
//                       every coverage kernel: only the (edge, row) pairs
//                       with h > 0
//   stage_chunks        the shallow forms of K1, K3 and K4: a block stages
//                       all of its chunks' edges at once, the row masks one
//                       window of rows at a time
//   stage_edges         the shallow forms of K5 and K6, and every deep form:
//                       one window of edges (kEdgeWindow for the deep forms,
//                       all of a chunk's for the shallow ones), from device
//                       or shared memory
//   walk_deep, deep_smem
//                       the deep forms of K1, K4, K5 and K6 (K3's resolves
//                       its sub-rows, so it walks its own)
//   PoolDesc / Pools / pick_pool / read_pools, kPoolChunksPerBlock,
//   kPoolThreads       K1, K3 and K4: one launch over several chunk pools
//
// Edge windows.  A chunk's edges are summed in edge order.  A form that
// stages all of a chunk's edges in one block (the shallow forms) has a
// depth ceiling: 32 shared bytes an edge.  Chunks deeper than one window
// (kEdgeWindow edges, a multiple of 32, so the mask words stay whole) take
// the deep form: a block owns one chunk, each warp one (row, 128-column
// group) unit for the whole walk, and the block stages the chunk's edges a
// window at a time (their scalars and the row masks of its units' rows),
// walks the window, and restages the next after a barrier.  Each warp's
// accumulators stay in registers across windows, and each pixel's sum runs
// window by window, word by word, bit by bit: the edge order of the dense
// sum, so the deep form equals it bit for bit as the shallow one does.  A
// launch whose chunks all fit one window keeps the shallow form (the
// defaults' pools are at most 24 edges deep).
#pragma once

#include <cuda_runtime.h>

namespace vg {

constexpr int kEdgeScalars = 8;

// (x0, y0, x1, y1) -> the per-edge scalars x0, y0, ymin, ymax, s, m, steep,
// s/m that every pixel of the tile reads.
__device__ __forceinline__ void stage_edge(const float* ed, float* q) {
  const float x0 = ed[0], y0 = ed[1], x1 = ed[2], y1 = ed[3];
  const float dy = y1 - y0;
  const float s = dy > 0.f ? 1.f : (dy < 0.f ? -1.f : 0.f);  // jnp.sign
  // the |dy| guard comes before the steep test (coverage_pallas.py:276)
  const float m = (x1 - x0) / (fabsf(dy) < 1e-6f ? 1.f : dy);
  const bool steep = fabsf(m) < 0.01f;
  q[0] = x0;
  q[1] = y0;
  q[2] = fminf(y0, y1);
  q[3] = fmaxf(y0, y1);
  q[4] = s;
  q[5] = m;
  q[6] = steep ? 1.f : 0.f;
  q[7] = s / (steep ? 1.f : m);
}

// ---- The (edge, row) split --------------------------------------------------
//
// An edge's signed area over pixel (px, py) (the twin's _edge_contribution:
// ytop = max(ymin, py), h = max(min(ymax, py + 1) - ytop, 0), u0 = (px +
// 1) - x(ytop), u1 = u0 - m h, then the G-form or the steep form) has its
// ytop, h and x(ytop) from the (edge, row) pair alone.  An edge with h == 0 on a row contributes exactly +0 or -0 to every
// pixel of it (the steep form gives s*0*cl0; in the G-form u1 =
// fma(-m, 0, u0) == u0, so g0 - g1 == 0), and adding +-0 to an accumulator
// that starts at +0 leaves it unchanged bit for bit (a round-to-nearest sum
// is -0 only when both operands are -0).  So the kernels walk, per row,
// only the edges with h > 0, and equal the dense sum bit for bit for any
// edges whose slope m is finite (an infinite m needs |x1 - x0| > 3e32).

// h, the part of row py that edge q spans, with the twin's own expressions
// (so `h > 0` is exact); *ytop gets max(ymin, py).
__device__ __forceinline__ float edge_row_h(const float* q, float py,
                                            float* ytop) {
  *ytop = fmaxf(q[2], py);
  return fmaxf(fminf(q[3], py + 1.f) - *ytop, 0.f);
}

// acc[j] += edge q's signed area over pixel (px0 + j * kStep, py) for j <
// kCols: the row part once, then per column the twin's roundings in its
// order.  kStep 1 (K1, K3, K6): a lane's adjacent columns; K4 and K5 take
// kStep 32 (a lane's
// columns a warp apart, so its transpose buffer is written without bank
// conflicts).
template <int kCols, int kStep = 1>
__device__ __forceinline__ void add_edge_row(const float* q, float py,
                                             int px0, float* acc) {
  float ytop;
  const float h = edge_row_h(q, py, &ytop);
  const float xt = __fmaf_rn(q[5], ytop - q[1], q[0]);
  if (q[6] != 0.f) {
    const float sh = q[4] * h;  // (s * h) * cl0, the twin's order
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float u0 = (static_cast<float>(px0 + j * kStep) + 1.f) - xt;
      acc[j] += sh * fminf(fmaxf(u0, 0.f), 1.f);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float u0 = (static_cast<float>(px0 + j * kStep) + 1.f) - xt;
      const float u1 = __fmaf_rn(-q[5], h, u0);
      const float cl0 = fminf(fmaxf(u0, 0.f), 1.f);
      const float cl1 = fminf(fmaxf(u1, 0.f), 1.f);
      const float g0 = cl0 * (u0 - 0.5f * cl0);
      const float g1 = cl1 * (u1 - 0.5f * cl1);
      acc[j] += (g0 - g1) * q[7];
    }
  }
}

// Stages chunks c0 .. c0 + nchunks - 1 (those < nc) of an (nc, ch, 4) edge
// array over one window of rows, r0 .. r0 + nr - 1: the per-edge scalars
// into sp[(lc * ch + e) * kEdgeScalars] (16-byte aligned), and for each
// (chunk, row of the window) the mask of the edges live on the row, h > 0
// by edge_row_h, into masks[(lc * nr + r - r0) * nwords + w] (bit b <->
// edge 32 w + b; nwords = ceil(ch / 32)).  One warp per (chunk, 32-edge
// word): each lane stages one edge in registers and the warp takes one
// ballot per row.  Chunk lc is staged only where bit lc of `live` is set
// (K1 under a view window); the others get no scalars and empty masks.
// Ends with __syncthreads().  A kernel whose tile is
// taller than its window calls this once per window, after a barrier that
// ends the previous window's reads: the scalars are written again with the
// same values, the masks are the new window's.  So the staging is sized by
// the window, not by the tile.
__device__ __forceinline__ void stage_chunks(const float* edges, int nc,
                                             int ch, int c0, int nchunks,
                                             int r0, int nr, float* sp,
                                             unsigned* masks,
                                             unsigned live = ~0u) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nwords = (ch + 31) >> 5;
  for (int t = threadIdx.x >> 5; t < nchunks * nwords; t += nwarps) {
    const int lc = t / nwords;
    const int w = t - lc * nwords;
    const int c = c0 + lc;
    const int e = w * 32 + lane;
    const bool valid = c < nc && e < ch && ((live >> lc) & 1u);
    float q[kEdgeScalars] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) {
      stage_edge(edges + (static_cast<size_t>(c) * ch + e) * 4, q);
      float4* dst = reinterpret_cast<float4*>(sp + (lc * ch + e) * kEdgeScalars);
      dst[0] = make_float4(q[0], q[1], q[2], q[3]);
      dst[1] = make_float4(q[4], q[5], q[6], q[7]);
    }
    for (int r = 0; r < nr; ++r) {
      float ytop;
      const bool live =
          valid && edge_row_h(q, static_cast<float>(r0 + r), &ytop) > 0.f;
      const unsigned bits = __ballot_sync(0xffffffffu, live);
      if (lane == 0) masks[(lc * nr + r) * nwords + w] = bits;
    }
  }
  __syncthreads();
}

// acc[j] += the contributions to columns px0 + j * kStep (j < kCols) of row
// py of the live edges in one (chunk, row) mask, in edge order (words in
// order, bits from the lowest): the sum of every edge, bit for bit.
template <int kCols, int kStep = 1>
__device__ __forceinline__ void add_live_edges(const float* sp_chunk,
                                               const unsigned* mask,
                                               int nwords, float py, int px0,
                                               float* acc) {
  for (int w = 0; w < nwords; ++w) {
    unsigned bits = mask[w];
    while (bits) {
      const int e = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      const float4* src =
          reinterpret_cast<const float4*>(sp_chunk + e * kEdgeScalars);
      const float4 a = src[0], b = src[1];
      const float q[kEdgeScalars] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      add_edge_row<kCols, kStep>(q, py, px0, acc);
    }
  }
}

// ---- Edge windows -------------------------------------------------------------

// Stages one window of edges for nchunks chunks: chunk lc's edges (x0, y0,
// x1, y1) start at raw + lc * cstride floats, in device or shared memory
// (16-byte aligned), and its ew edges of the window go, as per-edge
// scalars, to sp[(lc * sps + i) * kEdgeScalars] (sps >= ew, 16-byte
// aligned); for each (chunk, row r < nr) the mask of the window's edges
// live on row r0 + r * rs (h > 0 by edge_row_h) goes to masks[(lc * nr +
// r) * nwords + w] (bit b <-> edge 32 w + b of the window; nwords =
// ceil(ew / 32)).  One warp per (chunk, 32-edge word): each lane loads one
// edge as a float4, stages it in registers, and the warp takes one ballot
// per row.  Ends with __syncthreads().
__device__ __forceinline__ void stage_edges(const float* raw, int cstride,
                                            int nchunks, int ew, int sps,
                                            int r0, int rs, int nr,
                                            float* sp, unsigned* masks) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nwords = (ew + 31) >> 5;
  for (int t = threadIdx.x >> 5; t < nchunks * nwords; t += nwarps) {
    const int lc = t / nwords;
    const int w = t - lc * nwords;
    const int i = w * 32 + lane;
    const bool valid = i < ew;
    float q[kEdgeScalars] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) {
      const float4 v = *reinterpret_cast<const float4*>(
          raw + static_cast<size_t>(lc) * cstride + i * 4);
      const float ed[4] = {v.x, v.y, v.z, v.w};
      stage_edge(ed, q);
      float4* dst = reinterpret_cast<float4*>(sp + (lc * sps + i) * kEdgeScalars);
      dst[0] = make_float4(q[0], q[1], q[2], q[3]);
      dst[1] = make_float4(q[4], q[5], q[6], q[7]);
    }
    for (int r = 0; r < nr; ++r) {
      float ytop;
      const bool live =
          valid && edge_row_h(q, static_cast<float>(r0 + r * rs), &ytop) > 0.f;
      const unsigned bits = __ballot_sync(0xffffffffu, live);
      if (lane == 0) masks[(lc * nr + r) * nwords + w] = bits;
    }
  }
  __syncthreads();
}

// The deep form's shared memory for windows of ew edges and nr rows: the
// window's scalars (32 bytes an edge), then the masks (nr rows of
// ceil(ew / 32) words).  ops/coverage_cuda.deep_smem mirrors its size.
inline __host__ __device__ size_t deep_smem(int ew, int nr) {
  return sizeof(float) * kEdgeScalars * static_cast<size_t>(ew) +
         sizeof(unsigned) * static_cast<size_t>(nr) * ((ew + 31) / 32);
}

// The deep form's walk (K1, K4, K5, K6).  The block owns one chunk, its ch
// edges at `edges` (device memory, 16-byte aligned), and units u0 .. u0 +
// nwarps - 1 of the tile's th * groups (row, 128-column group) units, warp
// w unit u0 + w.  For each window of ew edges (ew a multiple of 32) the
// block stages the scalars and the masks of its units' rows (at most
// nwarps rows) and each warp adds its row's live edges to acc[j], column
// px0 + j (j < 4), in edge order; acc stays in registers across windows.
// Every call starts with a block barrier, so a block may walk several unit
// ranges.  Returns false for a warp past the last unit; *row and *px0 get
// the warp's row and its lane's first column.
__device__ __forceinline__ bool walk_deep(const float* edges, int ch, int ew,
                                          int th, int groups, int u0,
                                          float* smem, float* acc, int* row,
                                          int* px0) {
  const int nwarps = blockDim.x >> 5;
  const int u = u0 + (threadIdx.x >> 5);
  const int units = th * groups;
  const int ulast = (u0 + nwarps < units ? u0 + nwarps : units) - 1;
  const int r0 = u0 / groups;
  const int nr = ulast / groups - r0 + 1;
  const int r = u / groups;
  *row = r;
  *px0 = (u - r * groups) * 128 + (threadIdx.x & 31) * 4;
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  unsigned* masks = reinterpret_cast<unsigned*>(smem + ew * kEdgeScalars);
  const int nwin = (ch + ew - 1) / ew;
  __syncthreads();  // the previous range's walk is done with the staging
  for (int k = 0; k < nwin; ++k) {
    const int e0 = k * ew;
    const int n = ch - e0 < ew ? ch - e0 : ew;
    if (k) __syncthreads();  // every warp is done with window k - 1
    stage_edges(edges + static_cast<size_t>(e0) * 4, 0, 1, n, ew, r0, 1, nr,
                smem, masks);
    if (u < units) {
      add_live_edges<4>(smem, masks + (r - r0) * ((n + 31) >> 5),
                        (n + 31) >> 5, static_cast<float>(r), *px0, acc);
    }
  }
  return u < units;
}

// One launch of K1, K3 or K4 covers up to kMaxPools chunk pools.  The
// pools' descriptors pass by value; pool i owns blocks [block0_i,
// block0_{i+1}) and writes its nc chunk rows from `out` on (K4: its own
// pixel-major (npx, nc) output at `out`).  K3 also reads each pool's
// (RP_ROWS, nc) rparams, row stride nc.  The host packs them
// (ops/coverage_cuda.pack_pools) as kDescWords 64-bit words per pool:
// edges, rp, out, nc, ch, block0.  K1's and K3's blocks are kPoolThreads
// threads over kPoolChunksPerBlock chunks; K4 passes its own chunks per
// block.  ops/coverage_cuda.py mirrors
// kMaxPools, kPoolChunksPerBlock, kPoolThreads and kEdgeScalars in one
// block (MAX_POOLS, CHUNKS_PER_BLOCK, THREADS, EDGE_SCALARS); a mirror that
// drifts is refused, not obeyed: read_pools rejects block prefixes counted
// with another chunks-per-block, and the entry points a dynamic shared
// size below their own.
constexpr int kMaxPools = 8;
constexpr int kDescWords = 6;
constexpr int kPoolChunksPerBlock = 4;
constexpr int kPoolThreads = 128;

struct PoolDesc {
  const float* edges;  // (nc, ch, 4); unread when ch == 0 (K1's dead row)
  // K3: (RP_ROWS, nc) rparams; K1: the (nc,) int32 scene tiles of the
  // chunks under a view window, or null (no window, and the dead row);
  // K4: unused
  const float* rp;
  float* out;          // the pool's first output row (K4: its output)
  int nc, ch, block0;
};

struct Pools {
  PoolDesc p[kMaxPools];
  int n;
};

// This block's pool: the last with block0 <= blockIdx.x.  The loop has
// constant indices, so the descriptors are read from the parameter bank
// (no local-memory copy of P).
__device__ __forceinline__ PoolDesc pick_pool(const Pools& P) {
  PoolDesc d = P.p[0];
#pragma unroll
  for (int i = 1; i < kMaxPools; ++i) {
    if (i < P.n && static_cast<int>(blockIdx.x) >= P.p[i].block0) d = P.p[i];
  }
  return d;
}

// Host: reads npools packed descriptors into *P and checks them: 1 <=
// npools <= kMaxPools, ch >= 0, nc >= 1, and block0 the running sum of
// ceil(nc / chunks_per_block) from 0.  Returns the launch's block count,
// or -1 if a check fails; *max_ch gets the largest ch.
inline int read_pools(const long long* desc, int npools, int chunks_per_block,
                      Pools* P, int* max_ch) {
  if (npools < 1 || npools > kMaxPools) return -1;
  int blocks = 0;
  *max_ch = 0;
  P->n = npools;
  for (int i = 0; i < npools; ++i) {
    const long long* w = desc + i * kDescWords;
    PoolDesc& d = P->p[i];
    d.edges = reinterpret_cast<const float*>(w[0]);
    d.rp = reinterpret_cast<const float*>(w[1]);
    d.out = reinterpret_cast<float*>(w[2]);
    d.nc = static_cast<int>(w[3]);
    d.ch = static_cast<int>(w[4]);
    d.block0 = static_cast<int>(w[5]);
    if (d.nc < 1 || d.ch < 0 || d.block0 != blocks) return -1;
    blocks += (d.nc + chunks_per_block - 1) / chunks_per_block;
    if (d.ch > *max_ch) *max_ch = d.ch;
  }
  for (int i = npools; i < kMaxPools; ++i) P->p[i] = P->p[0];
  return blocks;
}

}  // namespace vg
