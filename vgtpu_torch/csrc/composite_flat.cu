// K7: the painter composite of one bucket over the flat (NPX, Nb) block of
// dense, slot-major winding.
//
// Replaces the Pallas TPU kernel vgtpu/ops/composite_pallas.py::_kernel
// (composite_bucket_pallas(variant="flat")).  Same function as K2's form
// (a) (csrc/composite.cu), ss = 1 only, over another input layout: per
// tile the bucket's MO painter slots are scanned in order; per slot and
// pixel it optionally adds the entry's per-row backdrop (add_backdrop,
// params rows _P_BD..+TH), applies the fill rule, the scissor and the clip
// state machine, shades solid / gradient / triangle / colour-tile paint
// and blends premultiplied src-over.  Inputs, all channel- or slot-major
// with tiles innermost:
//   ew_t (MO, NPX, Nb) winding, gathered by the caller (K2 gathers inside
//   the kernel through pteb instead); params (MO, NPP, k*Nb); ct (MO,
//   4*NPX, k*Nb) colour tiles (texture lane only); bg (4*NPX, 1) the
//   background column or (4*NPX, k*Nb) a per-tile init plane;
// output fb_t (4*NPX, k*Nb).  k = k_rep > 1 variant blocks of Nb tiles
// share the one block of ew_t (the TPU kernel's index map i % bpv): tile t
// reads ew column t % Nb.  The plain twin is vgtpu_torch/ops/composite.py::
// composite_bucket_torch (ss=1), which stands for both TPU variants: the
// flat and rows kernels agree bit for bit (tests/test_torch_composite.py).
//
// What bounds it on an H100: memory traffic of the valid slots' ew_t values
// (4 bytes per valid slot and pixel), the params columns, the colour tiles
// and each tile written once; ~20 float ops per valid slot and pixel.  What
// bounded the first design (one instantiation with the seven lanes as
// runtime values, 128 registers with a spill; every slot of the bucket walked
// for every tile; each slot starting with ~15 dependent params loads from
// device memory, re-read by the 128 threads that share a tile, and its ew
// loads issued only after them) was serial latency per slot: 0.6516 ms
// device per 1080p frame, 30.6x the bound (NVIDIA H100 80GB HBM3, 700 W).
//
// Design:
// - Layout.  ew_t[j, p, :] and fb_t[c*NPX + p, :] both have tiles
//   innermost, so threadIdx.x runs along tiles: a warp reads 32 consecutive
//   tiles of one (slot, pixel) and writes 32 consecutive tiles of one output
//   row.  A block owns kTiles = 32 tiles x a group of kGroup = 32 pixels
//   (grid = tile blocks x pixel groups); each thread owns kPix consecutive
//   pixels of its tile and keeps their framebuffer channels (and, on the
//   clip lane, clip mask and accumulator) in registers across the slot
//   loop, the TPU grid's sequential axis.  A warp per tile instead (8 tiles
//   a block, lanes along pixels, each warp walking only its tile's valid
//   slots) read ew_t a 4-byte value per sector per lane and was slower on
//   the 1080p frame's large buckets: 0.2803 ms device per [5c] frame
//   against this layout's 0.2335 (chip_smoke.py [6] in two calls on NVIDIA
//   H100 80GB HBM3, 700 W; 0.2920 against 0.2539 ms summed over the
//   buckets in one call, vgtpu_torch/utils/bucket_times.py).
// - Wide and narrow blocks.  kPix = 4 (256 threads) in general; a bucket
//   whose grid has fewer blocks than the card has SMs (few tiles, so each
//   SM holds one block and every slot's chain of dependent loads and
//   arithmetic is exposed) takes kPix = 2 (512 threads): twice the warps in
//   flight, each with half the chain.  Both forms stage the same tables.
//   Per bucket of the 1080p frame, narrow against wide: 12 tiles, MO 32
//   0.0383 / 0.0559 ms; 96 tiles, MO 16 0.0292 / 0.0423; 384 tiles, MO 16
//   0.0386 / 0.0318 (torch.profiler device ms, vgtpu_torch/utils/
//   bucket_times.py, NVIDIA H100 80GB HBM3, 700 W).
// - Lanes at compile time where they cost registers.  The template bits G
//   are the gradient, tri, texture and clip lanes (16 instantiations a
//   form): they hold the paint temporaries, the colour-tile reads and 8
//   clip registers.  Even-odd, non-AA and scissor (a floor, a compare, four
//   compares against staged rows) stay runtime values, as do add_backdrop,
//   the init plane and k_rep: all uniform over a launch.  All seven as
//   template bits (128 instantiations a form) would add a minute to a build
//   that runs beside K2's 144; with four, ptxas gives 52-80 registers (the
//   first, all-runtime build: 128 with a spill) and 4-byte spill stores in
//   3 of the 32 instantiations (wide: gradient + tri + texture, gradient +
//   clip, all lanes; none
//   that the 1080p frame's buckets take; K2's build shows the same, 8 of
//   144), and the 32 build in seconds (chip_smoke.py [2] prints the time
//   and ptxas).
// - Staged slot tables.  Per window of up to kWindow slots (fewer where
//   64 KB would not hold them) the block copies, in one cooperative pass of
//   coalesced cp.async copies all in flight together (a warp per (slot,
//   row); a params row of 32 tiles is one 128-byte line), the params rows
//   its instantiation reads (row_mask: 14 of rows 0..29 for a solid bucket,
//   all 30 with gradient and triangle paint) and, with add_backdrop, the
//   backdrop rows its pixel group spans, for all its tiles, into shared
//   memory laid out [slot][row][tile]: a window is one load latency instead
//   of ~15 dependent loads per slot, and each params column is read by one
//   block per pixel group, not by every thread.
// - Only live slots.  A slot that no tile of the block holds valid is
//   skipped (a ballot on the staged P_VALID row, one bit a slot): exact, by
//   K2's argument (csrc/composite.cu): an invalid slot blends fb*1 + src*0
//   = fb for finite paint and the clip state moves only on valid slots.  A
//   tile whose own slot is invalid in a live slot keeps c = 0, as before.
// - ew in flight.  kStages = 4 live slots' ew values are in flight per
//   thread (cp.async, 4 bytes a pixel, into a ring in shared memory) while
//   the thread composites the current slot; each thread copies exactly what
//   it later reads, so a per-thread cp.async.wait_group suffices.
// - One launch per bucket, as raster/frame.execute_plan_flat and vgtpu's
//   entry point launch; the geometry (window, staged rows, shared bytes) is
//   one host function that ops/composite_flat_cuda.k7_geometry mirrors, and
//   a launch whose shared bytes disagree is refused.
// The fill rule, clip step and shading are K2's (csrc/composite_common.cuh),
// so the two round alike.

#include <cuda_runtime.h>

#include "common.cuh"
#include "composite_common.cuh"

namespace {

using namespace vg;

constexpr int kTiles = 32;   // tiles per block, one per threadIdx.x
constexpr int kGroup = 32;   // pixels of each tile per block
// a thread owns kPix consecutive pixels of its tile (4, or 2 on small
// grids: wide and narrow blocks); a block is kTiles x kGroup / kPix threads
template <int kPix>
__host__ __device__ constexpr int block_threads() { return kTiles * (kGroup / kPix); }
constexpr int kStages = 4;   // ew ring depth: live slots in flight
constexpr int kWindow = 32;  // slots staged per window at most (one bit each)
constexpr int kWindowFloats = 16384;  // staged table's budget: 64 KB
constexpr int kMeta = 30;    // params rows 0..29: the most a slot stages
constexpr int kMaxBd = 34;   // backdrop rows a pixel group spans at most

// The params rows (of 0..29) instantiation G reads, as a bit mask: the
// metadata and solid paint every bucket reads (valid, rule, AA, paint kind,
// scissor rect, paint origin, inner colour; rule, AA and scissor serve the
// runtime lanes), the kind row on the clip lane, the colour-tile flag on the
// texture lane, the gradient's and the triangle's paint rows on theirs.
__host__ __device__ constexpr unsigned row_mask(int G) {
  unsigned m = 1u << P_VALID | 1u << P_RULE | 1u << P_AA | 1u << P_PK |
               0xfu << P_SC | 1u << P_OX | 1u << P_OY | 0xfu << (P_PAINT + 10);
  if (G & 8) m |= 1u << P_KIND;
  if (G & 4) m |= 1u << P_CTILE;
  if (G & 1) m |= 0x3ffu << P_PAINT | 0xfu << (P_PAINT + 14);
  if (G & 2) m |= 0xfffu << P_PAINT;
  return m;
}

__host__ __device__ constexpr int popc32(unsigned m) {
  int n = 0;
  for (; m; m &= m - 1u) ++n;
  return n;
}

// Rows instantiation G stages per slot: its params rows, then nbd backdrop
// rows.
inline int staged_rows(int G, int nbd) { return popc32(row_mask(G)) + nbd; }

struct Args {
  const float* ew;
  const float* params;
  const float* ct;
  const float* bg;
  float* out;
  int nb, nbo, mo, npp, tile_w, npx, bg_cols, add_backdrop, lanes;
  int nbd;  // backdrop rows staged per slot (add_backdrop), else 0
};

// The launch geometry (mirrored by ops/composite_flat_cuda.py::k7_geometry).
struct Geometry {
  int window, nbd, nr;
  size_t smem;
};

Geometry geometry(int mo, int npx, int tile_w, bool add_backdrop, int G) {
  Geometry g;
  g.window = mo < kWindow ? mo : kWindow;
  const int th = npx / tile_w;
  // output rows a group of kGroup consecutive pixels, starting at a
  // multiple of kGroup, spans at most
  const int span = tile_w % kGroup == 0   ? 1
                   : kGroup % tile_w == 0 ? kGroup / tile_w
                                          : kGroup / tile_w + 2;
  g.nbd = add_backdrop ? (span < th ? span : th) : 0;
  g.nr = staged_rows(G, g.nbd);
  const int fit = kWindowFloats / (g.nr * kTiles);
  if (g.window > fit) g.window = fit;
  // the ew ring: kStages x kGroup floats a tile, whatever the form
  g.smem = sizeof(float) * (static_cast<size_t>(g.window) * g.nr * kTiles +
                            static_cast<size_t>(kStages) * kGroup * kTiles);
  return g;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A (slot, tile) column of instantiation G's staged table: params row
// `row` (a compile-time constant at every call once inlined, so the index
// folds) is the table's row popc(row_mask(G) below it), kTiles floats apart.
template <int G>
struct StagedColumn {
  const float* p;
  __device__ __forceinline__ float operator()(int row) const {
    return p[__popc(row_mask(G) & ((1u << row) - 1u)) * kTiles];
  }
};

// G: lane bits gradient 1, tri 2, texture 4, clip 8 (a.lanes holds
// even-odd 16, non-AA 32, scissor 64 as runtime bits); kPix: pixels a
// thread (4 wide, 2 narrow).
template <int G, int kPix>
__global__ void __launch_bounds__(block_threads<kPix>())
composite_flat_kernel(const __grid_constant__ Args a, int window, int nr) {
  constexpr int kThreads = block_threads<kPix>();
  constexpr bool kGrad = G & 1, kTri = G & 2, kTex = G & 4, kClip = G & 8;
  const bool eo = a.lanes & 16, noaa = a.lanes & 32, scissor = a.lanes & 64;
  constexpr int kParamRows = popc32(row_mask(G));
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_row[kMeta + kMaxBd];               // staged row -> params row
  float* sp = smem;                                   // [slot][row][tile]
  float* ring = sp + window * nr * kTiles;            // [stage][kPix][thread]
  const int tx = threadIdx.x;
  const int tid = threadIdx.y * kTiles + tx;
  const int t0 = blockIdx.x * kTiles;
  const int t = t0 + tx;
  const int g0 = blockIdx.y * kGroup;                 // the group's first pixel
  const int p0 = g0 + threadIdx.y * kPix;
  const bool tile_ok = t < a.nbo;
  const bool warp_active = p0 < a.npx;                // uniform over the warp
  const int npx = a.npx;
  const int te = tile_ok ? t % a.nb : 0;              // k_rep: ew's one block
  const int r_lo = g0 / a.tile_w;                     // first staged bd row
  const int bcol = a.bg_cols == 1 ? 0 : t;
  // the staged rows' params rows: G's rows in order, then the backdrop rows
  // of the group (a group's last ones may lie past the tile: clamped into
  // the slot, never read then); the window loop's first barrier publishes it
  if (tid < nr) {
    int row = 0;
    if (tid < kParamRows) {
      for (int k = tid; row < kMeta; ++row) {
        if ((row_mask(G) >> row & 1u) && k-- == 0) break;
      }
    } else {
      const int bd = P_BD + r_lo + tid - kParamRows;
      row = bd < a.npp ? bd : a.npp - 1;
    }
    s_row[tid] = row;
  }

  float fr[kPix], fg[kPix], fbl[kPix], fa[kPix], mask[kPix], accum[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = p0 + k;
    const bool on = tile_ok && p < npx;
    fr[k] = on ? a.bg[static_cast<size_t>(p) * a.bg_cols + bcol] : 0.f;
    fg[k] = on ? a.bg[static_cast<size_t>(npx + p) * a.bg_cols + bcol] : 0.f;
    fbl[k] = on ? a.bg[static_cast<size_t>(2 * npx + p) * a.bg_cols + bcol] : 0.f;
    fa[k] = on ? a.bg[static_cast<size_t>(3 * npx + p) * a.bg_cols + bcol] : 0.f;
    mask[k] = 1.f;
    accum[k] = 0.f;
  }

  // issue slot w0 + j's ew values of the thread's pixels into stage st
  auto issue = [&](int slot, int st) {
    const float* src = a.ew + static_cast<size_t>(slot) * npx * a.nb + te;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (p0 + k < npx) {
        cp_async4(ring + (st * kPix + k) * kThreads + tid,
                  src + static_cast<size_t>(p0 + k) * a.nb);
      }
    }
  };

  // composite staged slot j (global slot `slot`) from stage st
  auto composite = [&](int j, int slot, int st) {
    const StagedColumn<G> P{sp + j * nr * kTiles + tx};
    const float valid = P(P_VALID), rule = P(P_RULE);
    const float kind = kClip ? P(P_KIND) : K_DRAW;  // staged on the clip lane
    const float aa = P(P_AA), pk = P(P_PK);
    const float ox = P(P_OX), oy = P(P_OY);
    const bool is_quad_tex = pk == PK_TEXTURE;
    const bool use_ct =
        kTex && (P(P_CTILE) > 0.f) && (is_quad_tex || pk == PK_IMAGE);
    const bool is_draw = valid > 0.f && kind == K_DRAW;
    const bool is_cadd = valid > 0.f && kind == K_CLIP_ADD;
    const bool is_ccommit = valid > 0.f && kind == K_CLIP_COMMIT;
    const bool is_creset = valid > 0.f && kind == K_CLIP_RESET;
    const float* ctp =
        kTex ? a.ct + static_cast<size_t>(slot) * 4 * npx * a.nbo + t : nullptr;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = p0 + k;
      if (p >= npx) break;
      const int r = p / a.tile_w;
      const float pxl = static_cast<float>(p - r * a.tile_w) + 0.5f;
      const float pyl = static_cast<float>(r) + 0.5f;
      float w = ring[(st * kPix + k) * kThreads + tid];
      if (a.add_backdrop) w = w + sp[(j * nr + kParamRows + r - r_lo) * kTiles + tx];
      const float cv = fill_coverage(eo, noaa, kTex, scissor, P, w, rule, aa,
                                     is_quad_tex, pxl, pyl, ox, oy);
      const float c =
          kClip ? clip_step(cv, rule, is_draw, is_cadd, is_ccommit, is_creset,
                            mask[k], accum[k])
                : (valid > 0.f ? cv : 0.f);
      shade_blend(kGrad, kTri, kTex, P, pk, use_ct, ctp, a.nbo, p, npx,
                  pxl + ox, oy + pyl, c, fr[k], fg[k], fbl[k], fa[k]);
    }
  };

  for (int w0 = 0; w0 < a.mo; w0 += window) {
    const int nw = a.mo - w0 < window ? a.mo - w0 : window;
    __syncthreads();  // every thread is done with the previous window
    // the window's slot tables: every load in flight at once (cp.async),
    // one latency; warp w stages (slot, row) pairs w, w + 8, ..., lane <->
    // tile
    {
      const int warp = tid >> 5;
      const bool tile_in = t0 + tx < a.nbo;
      for (int jk = warp; jk < nw * nr; jk += kThreads / 32) {
        const int j = jk / nr;
        float* dst = sp + jk * kTiles + tx;
        if (tile_in) {
          cp_async4(dst, a.params +
                             (static_cast<size_t>(w0 + j) * a.npp + s_row[jk - j * nr]) *
                                 a.nbo + t0 + tx);
        } else {
          *dst = 0.f;  // no tile: never valid
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!warp_active) continue;
    // the window's live slots: bit j when some tile of the block (the
    // warp's 32 tiles are the block's) holds slot w0 + j valid
    unsigned live = 0;
    for (int j = 0; j < nw; ++j) {
      if (__any_sync(0xffffffffu, sp[(j * nr + P_VALID) * kTiles + tx] > 0.f)) {
        live |= 1u << j;
      }
    }
    if (!tile_ok) continue;  // after the warp-wide ballots
    // kStages - 1 live slots ahead; every iteration commits one group
    // (empty at the tail), so wait_group<kStages - 1> leaves the current
    // slot's values landed
    unsigned ahead = live;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (ahead) {
        issue(w0 + __ffs(ahead) - 1, i);
        ahead &= ahead - 1;
      }
      cp_async_commit();
    }
    for (int i = 0; live; ++i) {
      const int j = __ffs(live) - 1;
      live &= live - 1;
      if (ahead) {
        issue(w0 + __ffs(ahead) - 1, (i + kStages - 1) % kStages);
        ahead &= ahead - 1;
      }
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      composite(j, w0 + j, i % kStages);
    }
  }

  if (!(tile_ok && warp_active)) return;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = p0 + k;
    if (p >= npx) break;
    a.out[static_cast<size_t>(p) * a.nbo + t] = fr[k];
    a.out[static_cast<size_t>(npx + p) * a.nbo + t] = fg[k];
    a.out[static_cast<size_t>(2 * npx + p) * a.nbo + t] = fbl[k];
    a.out[static_cast<size_t>(3 * npx + p) * a.nbo + t] = fa[k];
  }
}

struct Launch {
  Args a;
  Geometry g;
  dim3 grid;
  cudaStream_t stream;
};

template <int G, int kPix>
void launch(const Launch& l) {
  static unsigned raised = 0;
  if (l.g.smem > 48 * 1024) allow_dynamic_smem(composite_flat_kernel<G, kPix>, &raised);
  composite_flat_kernel<G, kPix>
      <<<l.grid, dim3(kTiles, kGroup / kPix), l.g.smem, l.stream>>>(l.a, l.g.window,
                                                                  l.g.nr);
}

// lane bits -> the matching instantiation, G = 15 down to 0
template <int G>
struct Dispatch {
  static void run(int g, bool narrow, const Launch& l) {
    if (g == G) {
      if (narrow) {
        launch<G, 2>(l);
      } else {
        launch<G, 4>(l);
      }
    } else {
      Dispatch<G - 1>::run(g, narrow, l);
    }
  }
};

template <>
struct Dispatch<-1> {
  static void run(int, bool, const Launch&) {}
};

// Streaming multiprocessors of the current device, read once per device.
int sm_count() {
  static int count[32] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int& n = count[dev & 31];
  if (n == 0 &&
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    n = 0;
  }
  return n;
}

}  // namespace

// One bucket.  ew (mo, npx, nb); params (mo, npp, nbo) with nbo a multiple
// of nb (k_rep = nbo / nb variant blocks) and npp >= 32 + npx / tile_w when
// add_backdrop, else >= 30; ct (mo, 4*npx, nbo), or null without the
// texture lane; bg (4*npx, bg_cols) with bg_cols 1 (background column) or
// nbo (init plane); out (4*npx, nbo); all f32 contiguous on `device`.
// flags bit i = lane i of (gradient, tri, texture, clip, even-odd, non-AA,
// scissor): bits 0-3 pick the instantiation, bits 4-6 pass as runtime
// values.  smem_bytes: the dynamic shared memory as the wrapper computed it
// (ops/composite_flat_cuda.k7_geometry); a value other than geometry()'s is
// refused.  Launches on `stream`, does not synchronise; returns
// cudaGetLastError().
extern "C" int vg_composite_flat(const float* ew, const float* params,
                                 const float* ct, const float* bg, float* out,
                                 int nb, int nbo, int mo, int npp, int tile_w,
                                 int npx, int bg_cols, int flags,
                                 int add_backdrop, int smem_bytes, int device,
                                 cudaStream_t stream) {
  if (flags < 0 || flags >= 128 || nb < 1 || nbo % nb || tile_w < 1 ||
      npx % tile_w || (bg_cols != 1 && bg_cols != nbo) || mo < 0 ||
      npp < (add_backdrop ? P_BD + npx / tile_w : kMeta) ||
      ((flags & 4) && ct == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g = geometry(mo, npx, tile_w, add_backdrop != 0, flags & 15);
  if (g.smem != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vg::DeviceScope scope(device);
  if (nbo > 0 && npx > 0) {
    const dim3 grid((nbo + kTiles - 1) / kTiles, (npx + kGroup - 1) / kGroup);
    const Launch l{{ew, params, ct, bg, out, nb, nbo, mo, npp, tile_w, npx,
                    bg_cols, add_backdrop != 0, flags, g.nbd},
                   g, grid, stream};
    // a grid of fewer blocks than the card has SMs takes the narrow form
    Dispatch<15>::run(flags & 15, static_cast<long long>(grid.x) * grid.y < sm_count(), l);
  }
  return static_cast<int>(cudaGetLastError());
}
