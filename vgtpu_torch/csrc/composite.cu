// K2: the fused painter composite of one bucket of tiles.
//
// Replaces the Pallas TPU kernel vgtpu/ops/composite_pallas.py::_kernel_rows
// (driven by composite_bucket_pallas / frame_fb_pallas) in all five of its
// forms.  Three pick the coverage the slot loop reads:
//   (a) ss = 1 and (d) ss > 1, over raw sub-row winding (add_backdrop):
//       per tile it scans the bucket's MO painter slots in order; per slot and
//       sub-pixel it
//       - adds the entry's per-sub-row backdrop (params rows _P_BD..+TH),
//       - applies the fill rule: nonzero min(|w|,1), even-odd
//         1-|mod(w,2)-1| (floored mod, as jnp.mod), non-AA >= 0.5, textured
//         quads forced to 1, and the pixel-centre scissor on the sub-row
//         centre,
//       - updates the clip state: ADD accumulates, COMMIT tests > 0.5 with
//         the In/Out rule, RESET clears;
//       the masked coverage of the ss sub-rows of an output pixel is summed
//       in order and multiplied by 1/ss, then, once per output pixel, it
//   (e) over FINAL output-domain coverage (cov_final, csrc/
//       coverage_resolve.cu), for buckets without the clip lane: coverage is
//       c = valid ? ew + rbd[row] * ins_x : 0, where rbd holds the resolved
//       backdrop rows of chunkless slots and ins_x is the x half of the
//       scissor (only when the scissor lane is on); then it
//   - shades solid / gradient (inverse paint matrix, sdroundrect, feather) /
//     triangle affine colour / colour-tile texture at the output pixel
//     (paint row oy/ss + output-row centre),
//   - blends premultiplied src-over into the framebuffer.
// Two runtime switches combine with any of them:
//   (b) per-tile init planes (`init`): each tile starts from its own
//       framebuffer row fb[ids[t]], which the caller filled with a resident
//       layer (the layer memo), instead of the broadcast background.  Pad
//       tiles (ids[t] == the scratch row) start from the background: every
//       pad block of a bucket writes the scratch row, and one reading it
//       while another writes would race.  Buckets partition the tiles, so a
//       real row is read and written by its own blocks only, each its own
//       pixels.
//   (c) k_rep variant blocks (`nbp1` < nbp): the bucket's nbp tiles are
//       k_rep = nbp / nbp1 blocks of one variant's nbp1 tiles each; params,
//       ctile and ids are read at t, the coverage row at pteb[t % nbp1], so
//       the variants share one block of winding coverage (vgtpu's index map
//       i % bpv), re-read from L2 across variants.
// A view window (a retained pan, vgtpu_torch/raster/retained.py) combines
// with forms (a) and (d): the launch takes the scene tiles a view reaches
// and the view's output layout.  A lane whose tile lies outside the window
// (pad lanes included) does no work; an in-window tile is written at its
// output position, straight into the view's image (the right and bottom
// tiles clipped to it) or its output tile grid, not into a framebuffer row.
// Without a window the lanes write their framebuffer rows as always.
// The seven lane flags (gradient, tri, texture, clip, even-odd, non-AA,
// scissor) are the template bit mask F of forms (a)/(d), so a bucket
// compiles only its lanes; ss is a runtime value.  Form (e) reads only four
// lanes (gradient, tri, texture, scissor): its own kernel, 16
// instantiations.  (b) and (c) are block-uniform runtime values.  The plain
// twin is vgtpu_torch/ops/composite.py::composite_bucket_into_torch.
//
// What bounds it on an H100.  The bytes are small: one coverage row of
// 4*ss KB (forms (a)/(d)) or 4 KB (form (e)) per valid (tile, slot), 16 KB
// of colour tile on texture slots, and each tile written once; the 1080p
// ss=1 frame's eight buckets move ~67 MB, 0.020 ms at 3.35 TB/s.  What
// bounded the first design (one block of 256 threads per tile, the slot
// loop reading its params column and coverage row straight from device
// memory) was serial latency: each slot began with ~20 dependent strided
// params loads, then the pteb id, then the coverage row it names, nothing in
// flight ahead, over all MO slots of the bucket even where the tile's own
// depth was smaller -- ~1 us per slot, 0.2576 ms per frame (12.9x the
// bound, NVIDIA H100 80GB HBM3, 700 W).
//
// Design:
// - Pixel groups.  A block owns one tile's group of `threads * kPix` output
//   pixels (grid = tiles x groups); each thread owns kPix = 4 consecutive
//   pixels of one output row, so coverage, colour tiles and the framebuffer
//   move as 16-byte vectors.  The thread count no longer caps the tile:
//   every tile shape vgtpu admits (tile_w 128/256, tile_h any multiple of 8,
//   ss 1/2/4/8) launches.  threads = 256 at ss <= 2, 128 above, so the
//   coverage ring and the clip state stay far inside 227 KB.
// - Slot tables in shared memory.  The block stages, per window of kWindow
//   slots and in one cooperative pass of independent loads, the tile's
//   params rows 0..29 of each slot, the backdrop rows of its group (form
//   (e): the rbd rows), and its pteb and ctile ids.  A window is one load
//   latency instead of ~20 per slot; windows bound the shared memory for
//   any MO up to the 256 slot cap.
// - Only the tile's valid slots.  Warp 0 compacts the window's slots with
//   P_VALID > 0 into a list (ballot + popc) and the slot loop walks the list.
//   An invalid slot is a no-op: c = 0 blends fb*1 + src*0 = fb for finite
//   paint (pad slots carry entry 0's finite paint), and the clip state
//   machine moves only on valid slots; so skipping them is exact.
// - Coverage fetched ahead.  kStages = 3 slots' coverage rows (and colour
//   tiles) are in flight per thread with cp.async into a ring in shared
//   memory while the thread composites the current slot.  Each thread
//   copies exactly the 16-byte pieces it later reads, so a per-thread
//   cp.async.wait_group suffices: no block barrier inside the slot loop.
// - The clip mask and accumulator of the thread's 4*ss sub-pixels live in
//   shared memory (2*ss*threads float4, clip lane only), sized per pixel
//   group, not per tile.
// - Launch geometry in one host function, geometry(), which
//   vgtpu_torch/ops/composite_cuda.py::k2_geometry mirrors; the wrapper
//   passes its dynamic shared bytes and a launch whose bytes disagree is
//   refused.  The shared-memory attribute is raised once per instantiation
//   and device, only when a launch needs more than 48 KB.
// Shared memory per block (bytes): 16 * threads * (kStages*chunks +
// 4*kStages [texture] + 2*ss [clip]) + 4 * (kWindow * (30 + rows*chunks) +
// 3*kWindow + 4), chunks = ss (form (e): 1), rows = output rows per group:
// 22.8 KB for the 1080p ss=1 buckets without texture, 123 KB at most
// (ss=8, clip and texture).
// The choice: ptxas gives the 144 instantiations 40-88 registers (8 spill
// at most 12 bytes; chip_smoke.py [2] prints the summary), so 256 threads
// of 4 pixels, with 22.8 KB of shared memory, leave room for 2-3 blocks
// per SM.  Builds with 128 threads or with 2, 5 or 8 ring stages were no
// faster on the 1080p frame: what is left is the per-launch ramp and tail
// of the eight bucket launches, not the coverage latency.
//
// Rounding: IEEE division and sqrt are kept (no --use_fast_math) and the
// library is built with -fmad=false; the gradient's paint-space
// coordinates take one explicit __fmaf_rn each, as the plain twin does, so
// kernel and twin round the same operations the same way.  1/ss is a power
// of two, so oy*(1/ss) and the coverage average are exact products.  The
// fill rule, the clip step and the shading and blending live in
// composite_common.cuh, shared with K7 (csrc/composite_flat.cu).

#include <cuda_runtime.h>

#include "common.cuh"
#include "composite_common.cuh"

namespace {

using namespace vg;

constexpr int kPix = 4;          // consecutive output pixels per thread
constexpr int kMaxThreads = 256; // threads per block at ss <= 2 (128 above)
constexpr int kStages = 3;       // coverage ring depth: slots in flight
constexpr int kWindow = 64;      // slots staged per window
constexpr int kMeta = 30;        // params rows 0..29 staged per slot

// The view window (w.on == 0 without one): its scene tiles w; output tile
// (oy, ox) shows scene tile (vy + oy, vx + ox), and its output pixel (row
// r, column c) sits at pixel oy * s_ty + ox * s_tx + r * s_r + c of the
// output, written where ox * tile_w + c < clip_w and oy * th_out + r <
// clip_h (ops/coverage.ViewWindow.layout).
struct View {
  TileWindow w;
  int vx, vy, clip_w, clip_h;
  long long s_ty, s_tx, s_r;
};

struct Args {
  const float* cov;
  const int* pteb;
  const float* params;
  const float* ct;
  const int* ctile;
  const float* rbd;
  const int* ids;
  float4 bg;
  float* fb;   // the framebuffer, or under a view window the output
  View view;
  int nbp, nbp1, mo, npp, rbr, tile_w, npx_out, ss, init, scratch;
  int group;  // output pixels per block: threads * kPix
  int rows;   // output rows a group spans at most
  int nr;     // staged rows per slot: kMeta + rows * (ss, or 1 in form (e))
};

// The launch geometry (mirrored by ops/composite_cuda.py::k2_geometry).
struct Geometry {
  int threads, group, groups, rows, nr;
  size_t smem;
};

Geometry geometry(int npx_out, int tile_w, int ss, bool is_final, bool clip,
                  bool tex) {
  Geometry g;
  g.threads = ss <= 2 ? kMaxThreads : kMaxThreads / 2;
  g.group = g.threads * kPix;
  g.groups = (npx_out + g.group - 1) / g.group;
  const int th_out = npx_out / tile_w;
  const int span = g.group % tile_w ? g.group / tile_w + 2 : g.group / tile_w;
  g.rows = th_out < span ? th_out : span;
  const int chunks = is_final ? 1 : ss;
  g.nr = kMeta + g.rows * chunks;
  g.smem = 16 * static_cast<size_t>(g.threads) *
               (kStages * chunks + (tex ? 4 * kStages : 0) +
                (clip ? 2 * ss : 0)) +
           4 * static_cast<size_t>(kWindow * g.nr + 3 * kWindow + 4);
  return g;
}

__device__ __forceinline__ void cp_async16(float4* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One block: tile blockIdx.x, pixel group blockIdx.y.  F: lane bits
// (gradient 1, tri 2, texture 4, clip 8, even-odd 16, non-AA 32, scissor
// 64); kFinal: form (e) (only gradient, tri, texture and scissor are read).
template <int F, bool kFinal>
__device__ __forceinline__ void composite_tile(const Args& a) {
  constexpr bool kGrad = F & 1, kTri = F & 2, kTex = F & 4;
  constexpr bool kClip = !kFinal && (F & 8);
  constexpr bool kEo = !kFinal && (F & 16), kNoAa = !kFinal && (F & 32);
  constexpr bool kScissor = F & 64;
  extern __shared__ float4 smem4[];
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int row = a.ids[t];
  // block-uniform, before any barrier: a lane outside the window does no work
  if (a.view.w.on && !a.view.w.holds(row)) return;
  const int tc = t % a.nbp1;                // coverage rows: variant block 0
  const int ss = a.ss;
  const int chunks = kFinal ? 1 : ss;       // 16-byte coverage pieces a slot
  const int npx = a.npx_out * ss;           // sub-pixels per tile
  const float inv_ss = 1.f / static_cast<float>(ss);

  float4* ring = smem4;                                  // [kStages][chunks][nthr]
  float4* tring = ring + kStages * chunks * nthr;        // [kStages][4][nthr]
  float4* clip4 = tring + (kTex ? kStages * 4 * nthr : 0);  // [2][ss][nthr]
  float* sp = reinterpret_cast<float*>(clip4 + (kClip ? 2 * ss * nthr : 0));
  int* s_pteb = reinterpret_cast<int*>(sp + kWindow * a.nr);
  int* s_ctile = s_pteb + kWindow;
  int* s_list = s_ctile + kWindow;
  int* s_count = s_list + kWindow;

  const int g0 = blockIdx.y * a.group;      // the group's first output pixel
  const int p0 = g0 + tid * kPix;           // the thread's first pixel
  const bool active = p0 < a.npx_out;
  const int ro = p0 / a.tile_w;             // its output row and column
  const int col0 = p0 - ro * a.tile_w;
  const int ro_lo = g0 / a.tile_w;          // the group's first output row
  const int th_out = a.npx_out / a.tile_w;
  const int nrows = a.rows < th_out - ro_lo ? a.rows : th_out - ro_lo;
  const int r_first = kFinal ? ro_lo : ro_lo * ss;  // first staged bd/rbd row
  const int nstage = kMeta + nrows * chunks;        // rows staged per slot

  float fr[kPix], fg[kPix], fbl[kPix], fa[kPix];
  {
    // the broadcast background, or (form (b)) the tile's own framebuffer
    // row, except on pad tiles (row == scratch)
    const bool from_fb = a.init != 0 && row != a.scratch && active;
    const float4* in =
        reinterpret_cast<const float4*>(a.fb) + static_cast<size_t>(row) * a.npx_out + p0;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const float4 v = from_fb ? in[k] : a.bg;
      fr[k] = v.x;
      fg[k] = v.y;
      fbl[k] = v.z;
      fa[k] = v.w;
    }
  }
  if (kClip && active) {
    for (int s = 0; s < ss; ++s) {
      clip4[s * nthr + tid] = make_float4(1.f, 1.f, 1.f, 1.f);
      clip4[(ss + s) * nthr + tid] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // issue slot list[i]'s coverage pieces (and colour tile) into stage st
  auto issue = [&](int i, int st) {
    const int j = s_list[i];
    const int crow = s_pteb[j];
    if (kFinal) {
      cp_async16(ring + st * nthr + tid,
                 a.cov + static_cast<size_t>(crow) * a.npx_out + p0);
    } else {
      const float* src = a.cov + static_cast<size_t>(crow) * npx +
                         static_cast<size_t>(ro * ss) * a.tile_w + col0;
      for (int s = 0; s < ss; ++s) {
        cp_async16(ring + (st * ss + s) * nthr + tid, src + s * a.tile_w);
      }
    }
    if (kTex) {
      const SharedColumn P{sp + j * a.nr};
      const float pk = P(P_PK);
      if (P(P_CTILE) > 0.f && (pk == PK_TEXTURE || pk == PK_IMAGE)) {
        const float* ctp =
            a.ct + static_cast<size_t>(s_ctile[j]) * 4 * a.npx_out + p0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          cp_async16(tring + (st * 4 + c) * nthr + tid, ctp + c * a.npx_out);
        }
      }
    }
  };

  // composite staged slot j from stage st into the thread's 4 pixels
  auto composite = [&](int j, int st) {
    const SharedColumn P{sp + j * a.nr};
    const float valid = P(P_VALID), pk = P(P_PK);
    const float ox = P(P_OX), oy = P(P_OY);
    const bool use_ct =
        kTex && (P(P_CTILE) > 0.f) && (pk == PK_TEXTURE || pk == PK_IMAGE);
    float c_out[kPix];
    if (kFinal) {
      const float4 c4 = ring[st * nthr + tid];
      const float cw[kPix] = {c4.x, c4.y, c4.z, c4.w};
      const float rv = P(kMeta + ro - r_first);
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const float pxl = static_cast<float>(col0 + q) + 0.5f;
        float c;
        if (kScissor) {
          const bool ins_x = (pxl >= P(P_SC) - ox) && (pxl < P(P_SC + 2) - ox);
          c = cw[q] + rv * (ins_x ? 1.f : 0.f);
        } else {
          c = cw[q] + rv;
        }
        c_out[q] = valid > 0.f ? c : 0.f;
      }
    } else {
      const float kind = P(P_KIND), rule = P(P_RULE), aa = P(P_AA);
      const bool is_quad_tex = pk == PK_TEXTURE;
      const bool is_draw = valid > 0.f && kind == K_DRAW;
      const bool is_cadd = valid > 0.f && kind == K_CLIP_ADD;
      const bool is_ccommit = valid > 0.f && kind == K_CLIP_COMMIT;
      const bool is_creset = valid > 0.f && kind == K_CLIP_RESET;
      for (int s = 0; s < ss; ++s) {
        const float4 w4 = ring[(st * ss + s) * nthr + tid];
        const float cw[kPix] = {w4.x, w4.y, w4.z, w4.w};
        const int r = ro * ss + s;                    // sub-row
        const float bd = P(kMeta + r - r_first);
        const float pyl = static_cast<float>(r) + 0.5f;
        float m[kPix], acc[kPix];
        if (kClip) {
          const float4 m4 = clip4[s * nthr + tid];
          const float4 a4 = clip4[(ss + s) * nthr + tid];
          m[0] = m4.x, m[1] = m4.y, m[2] = m4.z, m[3] = m4.w;
          acc[0] = a4.x, acc[1] = a4.y, acc[2] = a4.z, acc[3] = a4.w;
        }
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          const float pxl = static_cast<float>(col0 + q) + 0.5f;
          const float w = cw[q] + bd;
          const float cv = fill_coverage(kEo, kNoAa, kTex, kScissor, P, w, rule,
                                         aa, is_quad_tex, pxl, pyl, ox, oy);
          float c;
          if (kClip) {
            c = clip_step(cv, rule, is_draw, is_cadd, is_ccommit, is_creset,
                          m[q], acc[q]);
          } else {
            c = valid > 0.f ? cv : 0.f;
          }
          c_out[q] = s == 0 ? c : c_out[q] + c;
        }
        if (kClip) {
          clip4[s * nthr + tid] = make_float4(m[0], m[1], m[2], m[3]);
          clip4[(ss + s) * nthr + tid] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        }
      }
#pragma unroll
      for (int q = 0; q < kPix; ++q) c_out[q] = c_out[q] * inv_ss;
    }
    // paints are pixel-space: output rows sit at oy/ss (oy counts sub-rows);
    // channel c of the thread's pixel q in the stage: ctp[c*nthr*kPix + tid*kPix + q]
    const float* ctp = reinterpret_cast<const float*>(tring + st * 4 * nthr);
    const float pyc = oy * inv_ss + (static_cast<float>(ro) + 0.5f);
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const float pxl = static_cast<float>(col0 + q) + 0.5f;
      shade_blend(kGrad, kTri, kTex, P, pk, use_ct, ctp, 1, tid * kPix + q,
                  nthr * kPix, pxl + ox, pyc, c_out[q], fr[q], fg[q], fbl[q],
                  fa[q]);
    }
  };

  for (int w0 = 0; w0 < a.mo; w0 += kWindow) {
    const int nw = a.mo - w0 < kWindow ? a.mo - w0 : kWindow;
    __syncthreads();  // every thread is done with the previous window
    // the window's slot tables: independent loads, one latency
    for (int i = tid; i < nw * nstage; i += nthr) {
      const int j = i / nstage;
      const int k = i - j * nstage;
      const size_t slot = static_cast<size_t>(w0 + j);
      float v;
      if (k < kMeta) {
        v = __ldg(a.params + (slot * a.npp + k) * a.nbp + t);
      } else if (kFinal) {
        v = __ldg(a.rbd + (slot * a.rbr + r_first + k - kMeta) * a.nbp + t);
      } else {
        v = __ldg(a.params + (slot * a.npp + P_BD + r_first + k - kMeta) * a.nbp + t);
      }
      sp[j * a.nr + k] = v;
    }
    for (int j = tid; j < nw; j += nthr) {
      s_pteb[j] = __ldg(a.pteb + static_cast<size_t>(tc) * a.mo + w0 + j);
      if (kTex) s_ctile[j] = __ldg(a.ctile + static_cast<size_t>(t) * a.mo + w0 + j);
    }
    __syncthreads();
    // the window's valid slots, in order
    if (tid < 32) {
      int n = 0;
      for (int j0 = 0; j0 < nw; j0 += 32) {
        const int j = j0 + tid;
        const bool v = j < nw && sp[j * a.nr + P_VALID] > 0.f;
        const unsigned ballot = __ballot_sync(0xffffffffu, v);
        if (v) s_list[n + __popc(ballot & ((1u << tid) - 1u))] = j;
        n += __popc(ballot);
      }
      if (tid == 0) *s_count = n;
    }
    __syncthreads();
    const int nv = *s_count;
    if (!active) continue;
    // kStages - 1 slots ahead; every iteration commits one group (empty at
    // the tail), so wait_group<kStages - 1> leaves slot i's pieces landed
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < nv) issue(i, i);
      cp_async_commit();
    }
    for (int i = 0; i < nv; ++i) {
      const int ahead = i + kStages - 1;
      if (ahead < nv) issue(ahead, ahead % kStages);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      composite(s_list[i], i % kStages);
    }
  }

  if (active && a.view.w.on) {
    // output pixel (oty * th_out + ro, otx * tile_w + col0 + k), clipped
    const int ty = row / a.view.w.ntx;
    const int otx = row - ty * a.view.w.ntx - a.view.vx;
    const int oty = ty - a.view.vy;
    if (oty * th_out + ro < a.view.clip_h) {
      float4* out = reinterpret_cast<float4*>(a.fb) + oty * a.view.s_ty +
                    otx * a.view.s_tx + ro * a.view.s_r + col0;
      const int x = otx * a.tile_w + col0;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (x + k < a.view.clip_w) out[k] = make_float4(fr[k], fg[k], fbl[k], fa[k]);
      }
    }
  } else if (active) {
    float4* out = reinterpret_cast<float4*>(a.fb) + static_cast<size_t>(row) * a.npx_out + p0;
#pragma unroll
    for (int k = 0; k < kPix; ++k) out[k] = make_float4(fr[k], fg[k], fbl[k], fa[k]);
  }
}

// Forms (a) ss = 1 and (d) ss > 1: raw sub-row winding.
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
composite_bucket_kernel(const __grid_constant__ Args a) {
  composite_tile<F, false>(a);
}

// Form (e): final output-domain coverage + resolved backdrop rows; G bits:
// gradient, tri, texture, scissor.
template <int G>
__global__ void __launch_bounds__(kMaxThreads)
composite_final_kernel(const __grid_constant__ Args a) {
  composite_tile<(G & 7) | ((G & 8) << 3), true>(a);
}

struct Launch {
  Args a;
  Geometry g;
  cudaStream_t stream;
};

// flags -> the matching form (a)/(d) instantiation, F = 127 down to 0
template <int F>
struct Dispatch {
  static void run(int flags, const Launch& l) {
    if (flags == F) {
      static unsigned raised = 0;
      if (l.g.smem > 48 * 1024) allow_dynamic_smem(composite_bucket_kernel<F>, &raised);
      composite_bucket_kernel<F><<<dim3(l.a.nbp, l.g.groups), l.g.threads, l.g.smem,
                                   l.stream>>>(l.a);
    } else {
      Dispatch<F - 1>::run(flags, l);
    }
  }
};

template <>
struct Dispatch<-1> {
  static void run(int, const Launch&) {}
};

// lanes -> the matching form (e) instantiation, G = 15 down to 0
template <int G>
struct DispatchFinal {
  static void run(int lanes, const Launch& l) {
    if (lanes == G) {
      static unsigned raised = 0;
      if (l.g.smem > 48 * 1024) allow_dynamic_smem(composite_final_kernel<G>, &raised);
      composite_final_kernel<G><<<dim3(l.a.nbp, l.g.groups), l.g.threads, l.g.smem,
                                  l.stream>>>(l.a);
    } else {
      DispatchFinal<G - 1>::run(lanes, l);
    }
  }
};

template <>
struct DispatchFinal<-1> {
  static void run(int, const Launch&) {}
};

}  // namespace

// One bucket.  pteb (nbp1, mo) i32, with nbp a multiple of nbp1 (form (c):
// nbp / nbp1 variant blocks share the coverage rows; nbp1 == nbp
// otherwise); ctile (nbp, mo) i32; params (mo, npp, nbp); ct
// (NCT+1, 4*npx_out) or null without the texture lane; ids (nbp,)
// framebuffer rows; fb (scratch+1, npx_out, 4), row `scratch` the pad
// tiles' row.  init != 0 (form (b)): tiles start from their fb rows.
// flags bit i = lane i of (gradient, tri, texture, clip, even-odd, non-AA,
// scissor).
// Form (a)/(d), rbd == null: cov (NC+1, npx_out*ss) raw sub-row winding,
// npp >= 32 + TH.  Form (e), rbd != null: cov (R, npx_out) final coverage,
// rbd (mo, rbr, nbp) with rbr >= TH_OUT; the clip lane and form (c) are
// refused.
// view: null, or 12 host words (x0, y0, x1, y1, ntx, vx, vy, clip_w,
// clip_h, s_ty, s_tx, s_r; struct View), a view window over forms (a)/(d):
// fb is then the view's output, and init, form (c) and form (e) are
// refused.
// cov, ct and fb 16-byte aligned, tile_w a multiple of 4 dividing npx_out
// (checked by the Python wrapper, which also computes smem_bytes with
// k2_geometry: a value other than geometry()'s is refused).  All on
// `device`.  Launches on `stream`, does not synchronise; returns
// cudaGetLastError().
extern "C" int vg_composite_bucket(const float* cov, const int* pteb,
                                   const float* params, const float* ct,
                                   const int* ctile, const float* rbd,
                                   const int* ids, float bg_r, float bg_g,
                                   float bg_b, float bg_a, float* fb,
                                   const long long* view, int nbp,
                                   int nbp1, int mo, int npp, int rbr,
                                   int tile_w, int npx_out, int ss, int flags,
                                   int init, int scratch, int smem_bytes,
                                   int device, cudaStream_t stream) {
  const bool is_final = rbd != nullptr;
  if (flags < 0 || flags >= 128 || ss < 1 || tile_w < kPix || tile_w % kPix ||
      npx_out < tile_w || npx_out % tile_w || nbp1 < 1 || nbp % nbp1 ||
      npp < (is_final ? kMeta : vg::P_BD + (npx_out / tile_w) * ss) ||
      (is_final && ((flags & 8) || nbp1 != nbp || rbr < npx_out / tile_w)) ||
      ((flags & 4) && (ct == nullptr || ctile == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g = geometry(npx_out, tile_w, ss, is_final, flags & 8, flags & 4);
  if (g.smem != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  View v{};
  if (view != nullptr) {
    const TileWindow w{1, static_cast<int>(view[0]), static_cast<int>(view[1]),
                       static_cast<int>(view[2]), static_cast<int>(view[3]),
                       static_cast<int>(view[4])};
    v = View{w, static_cast<int>(view[5]), static_cast<int>(view[6]),
             static_cast<int>(view[7]), static_cast<int>(view[8]), view[9],
             view[10], view[11]};
    const bool empty = w.x1 == w.x0 || w.y1 == w.y0;
    if (is_final || init != 0 || nbp1 != nbp || w.ntx < 1 || w.x1 < w.x0 ||
        w.y1 < w.y0 || (!empty && (w.x0 < v.vx || w.y0 < v.vy))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const vg::DeviceScope scope(device);
  if (nbp > 0) {
    const Launch l{{cov, pteb, params, ct, ctile, rbd, ids,
                    make_float4(bg_r, bg_g, bg_b, bg_a), fb, v, nbp, nbp1, mo, npp,
                    rbr, tile_w, npx_out, ss, init, scratch, g.group, g.rows, g.nr},
                   g,
                   stream};
    if (is_final) {
      const int lanes = (flags & 7) | ((flags >> 6) & 1) << 3;
      DispatchFinal<15>::run(lanes, l);
    } else {
      Dispatch<127>::run(flags, l);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
