// K2: the fused painter composite of one bucket of tiles.
//
// Replaces the Pallas TPU kernel vgtpu/ops/composite_pallas.py::_kernel_rows
// (driven by composite_bucket_pallas / frame_fb_pallas) in all five of its
// forms.  Three pick the coverage the slot loop reads:
//   (a) ss = 1 and (d) ss > 1, over raw sub-row winding (add_backdrop):
//       per tile it scans the bucket's MO painter slots in order; per slot
//       and sub-pixel it
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
//       real row is read and written by its one block only.  Cost: one extra
//       16-byte load per output pixel per bucket.
//   (c) k_rep variant blocks (`nbp1` < nbp): the bucket's nbp tiles are
//       k_rep = nbp / nbp1 blocks of one variant's nbp1 tiles each; params,
//       ctile and ids are read at t, the coverage row at pteb[t % nbp1], so
//       the variants share one block of winding coverage (vgtpu's index map
//       i % bpv).  It adds no traffic: the shared coverage rows are re-read
//       from L2 across variants.
// The seven lane flags (gradient, tri, texture, clip, even-odd, non-AA,
// scissor) are the template bit mask F of forms (a)/(d), so a bucket
// compiles only its lanes; ss is a runtime loop bound.  Form (e) reads only
// four lanes (gradient, tri, texture, scissor): its own template G, 16
// instantiations.  (b) and (c) are block-uniform runtime values, so they add
// no instantiation.  The plain twin is vgtpu_torch/ops/composite.py::
// composite_bucket_torch.
//
// What bounds it on an H100: memory traffic of the coverage gather.  Each
// (tile, slot) reads one coverage row of 4*ss KB (forms (a)/(d)) or 4 KB
// (form (e)), and 16 KB of colour tile on texture slots, and does ~30-60
// float ops per pixel, so the kernel sits near the bandwidth side of the
// roofline; the framebuffer never leaves registers.
//
// Design: one block per tile of the bucket, blockDim = TH_OUT*TW/4 threads
// (256 for 8x128 output tiles, the launch bound); each thread owns 4 output
// pixels p = threadIdx.x + k*blockDim.x and keeps their 4 framebuffer
// channels in registers across the sequential slot loop — the loop that was
// the TPU kernel's sequential grid axis.  Per slot it walks the ss sub-rows
// with its 4 pixels innermost and unrolled, so each sub-row's 4 coverage
// loads are in flight together (a pixel-outer order serialised them: 1.7x
// the device time at ss=1 on an H100 80GB HBM3 at 700 W), then shades and
// blends the 4 pixels.  The clip mask and accumulator of the thread's 4*ss
// sub-pixels live in dynamic shared memory (2*TH*TW floats, clip lane
// only): ss is a runtime value, so they cannot be a register array, and
// each thread touches only its own sub-pixels, so no barrier is needed.  Per slot the
// block reads that slot's params column (block-uniform loads) and gathers
// the coverage row cov[pteb[t, slot]] inside the kernel, so the TPU path's
// (MO, NPX, Nb) ew_t transpose is never materialized; colour tiles are
// gathered the same way from the channel-major (NCT+1, 4*NPX_OUT) ct_flat
// by ctile id.  The finished tile is stored as float4 pixels into the
// (T+1, TH_OUT, TW, 4) framebuffer at row ids[t]; pad tiles write the
// scratch row T.
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

constexpr int kPix = 4;       // output pixels per thread
constexpr int kThreads = 256; // TH_OUT*TW/kPix for 8x128 output tiles

// The thread's 4 starting pixels: the broadcast background, or (form (b))
// the tile's own framebuffer row, except on pad tiles (row == scratch).
__device__ __forceinline__ void load_start(const float* fb, int row, int init,
                                           int scratch, int npx_out, float4 bg,
                                           float* fr, float* fg, float* fbl,
                                           float* fa) {
  const bool from_fb = init != 0 && row != scratch;
  const float4* in = reinterpret_cast<const float4*>(fb) + static_cast<size_t>(row) * npx_out;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const float4 v = from_fb ? in[threadIdx.x + k * blockDim.x] : bg;
    fr[k] = v.x;
    fg[k] = v.y;
    fbl[k] = v.z;
    fa[k] = v.w;
  }
}

// Forms (a) ss = 1 and (d) ss > 1: raw sub-row winding.
template <int F>
__global__ void __launch_bounds__(kThreads)
composite_bucket_kernel(const float* __restrict__ cov,
                        const int* __restrict__ pteb,
                        const float* __restrict__ params,
                        const float* __restrict__ ct,
                        const int* __restrict__ ctile,
                        const int* __restrict__ ids, float4 bg,
                        float* __restrict__ fb, int nbp, int nbp1, int mo,
                        int npp, int tile_w, int npx_out, int ss, int init,
                        int scratch) {
  constexpr bool kGrad = F & 1, kTri = F & 2, kTex = F & 4, kClip = F & 8;
  constexpr bool kEo = F & 16, kNoAa = F & 32, kScissor = F & 64;
  // clip lane: mask[npx], accum[npx] over the tile's sub-pixels
  extern __shared__ float clip_state[];
  const int t = blockIdx.x;
  const int tc = t % nbp1;                  // coverage rows: variant block 0
  const int npx = npx_out * ss;
  const float inv_ss = 1.f / static_cast<float>(ss);
  float* smask = clip_state;
  float* saccum = clip_state + npx;

  float fr[kPix], fg[kPix], fbl[kPix], fa[kPix];
  load_start(fb, ids[t], init, scratch, npx_out, bg, fr, fg, fbl, fa);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (kClip) {
      const int p = threadIdx.x + k * blockDim.x;
      const int ro = p / tile_w;
      const int col = p - ro * tile_w;
      for (int s = 0; s < ss; ++s) {
        smask[(ro * ss + s) * tile_w + col] = 1.f;
        saccum[(ro * ss + s) * tile_w + col] = 0.f;
      }
    }
  }

  for (int slot = 0; slot < mo; ++slot) {
    const float* pp = params + static_cast<size_t>(slot) * npp * nbp + t;
    auto P = [&](int row) { return param(pp, nbp, row); };
    const float valid = P(P_VALID), kind = P(P_KIND), rule = P(P_RULE);
    const float aa = P(P_AA), pk = P(P_PK);
    const float ox = P(P_OX), oy = P(P_OY);
    const bool is_quad_tex = pk == PK_TEXTURE;
    const bool use_ct =
        kTex && (P(P_CTILE) > 0.f) && (is_quad_tex || pk == PK_IMAGE);
    const bool is_draw = valid > 0.f && kind == K_DRAW;
    const bool is_cadd = valid > 0.f && kind == K_CLIP_ADD;
    const bool is_ccommit = valid > 0.f && kind == K_CLIP_COMMIT;
    const bool is_creset = valid > 0.f && kind == K_CLIP_RESET;
    const float* cw = cov + static_cast<size_t>(pteb[tc * mo + slot]) * npx;
    const float* ctp = nullptr;
    if (kTex) ctp = ct + static_cast<size_t>(ctile[t * mo + slot]) * 4 * npx_out;

    // sub-rows outermost, the thread's 4 pixels innermost and unrolled, so
    // the 4 coverage loads of a sub-row are in flight together
    float c_sum[kPix];
    for (int s = 0; s < ss; ++s) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const int p = threadIdx.x + k * blockDim.x;   // output pixel
        const int ro = p / tile_w;
        const int col = p - ro * tile_w;
        const int r = ro * ss + s;                    // sub-row
        const int ps = r * tile_w + col;              // sub-pixel
        const float pxl = static_cast<float>(col) + 0.5f;
        const float pyl = static_cast<float>(r) + 0.5f;
        const float w = cw[ps] + P(P_BD + r);
        const float cv = fill_coverage(kEo, kNoAa, kTex, kScissor, pp, nbp, w,
                                       rule, aa, is_quad_tex, pxl, pyl, ox, oy);
        float c;
        if (kClip) {
          float m = smask[ps], acc = saccum[ps];
          c = clip_step(cv, rule, is_draw, is_cadd, is_ccommit, is_creset, m, acc);
          smask[ps] = m;
          saccum[ps] = acc;
        } else {
          c = valid > 0.f ? cv : 0.f;
        }
        c_sum[k] = s == 0 ? c : c_sum[k] + c;
      }
    }

#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = threadIdx.x + k * blockDim.x;
      const int ro = p / tile_w;
      const float pxl = static_cast<float>(p - ro * tile_w) + 0.5f;
      // paints are pixel-space: output rows sit at oy/ss (oy counts sub-rows)
      const float pyc = oy * inv_ss + (static_cast<float>(ro) + 0.5f);
      shade_blend(kGrad, kTri, kTex, pp, nbp, pk, use_ct, ctp, 1, p, npx_out,
                  pxl + ox, pyc, c_sum[k] * inv_ss, fr[k], fg[k], fbl[k], fa[k]);
    }
  }

  float4* out = reinterpret_cast<float4*>(fb) + static_cast<size_t>(ids[t]) * npx_out;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    out[threadIdx.x + k * blockDim.x] = make_float4(fr[k], fg[k], fbl[k], fa[k]);
  }
}

// Form (e): final output-domain coverage + resolved backdrop rows; no rule,
// AA or clip work.  G bits: gradient, tri, texture, scissor.
template <int G>
__global__ void __launch_bounds__(kThreads)
composite_final_kernel(const float* __restrict__ cov,
                       const int* __restrict__ pteb,
                       const float* __restrict__ params,
                       const float* __restrict__ ct,
                       const int* __restrict__ ctile,
                       const float* __restrict__ rbd,
                       const int* __restrict__ ids, float4 bg,
                       float* __restrict__ fb, int nbp, int nbp1, int mo,
                       int npp, int rbr, int tile_w, int npx_out, int ss,
                       int init, int scratch) {
  constexpr bool kGrad = G & 1, kTri = G & 2, kTex = G & 4, kScissor = G & 8;
  const int t = blockIdx.x;
  const int tc = t % nbp1;                  // coverage rows: variant block 0
  const float inv_ss = 1.f / static_cast<float>(ss);

  float fr[kPix], fg[kPix], fbl[kPix], fa[kPix];
  load_start(fb, ids[t], init, scratch, npx_out, bg, fr, fg, fbl, fa);

  for (int slot = 0; slot < mo; ++slot) {
    const float* pp = params + static_cast<size_t>(slot) * npp * nbp + t;
    auto P = [&](int row) { return param(pp, nbp, row); };
    const float valid = P(P_VALID), pk = P(P_PK);
    const float ox = P(P_OX), oy = P(P_OY);
    const bool use_ct =
        kTex && (P(P_CTILE) > 0.f) && (pk == PK_TEXTURE || pk == PK_IMAGE);
    const float* cw = cov + static_cast<size_t>(pteb[tc * mo + slot]) * npx_out;
    const float* rb = rbd + static_cast<size_t>(slot) * rbr * nbp + t;
    const float* ctp = nullptr;
    if (kTex) ctp = ct + static_cast<size_t>(ctile[t * mo + slot]) * 4 * npx_out;

#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = threadIdx.x + k * blockDim.x;
      const int ro = p / tile_w;
      const float pxl = static_cast<float>(p - ro * tile_w) + 0.5f;
      const float rv = __ldg(rb + static_cast<size_t>(ro) * nbp);
      float c;
      if (kScissor) {
        const bool ins_x = (pxl >= P(P_SC) - ox) && (pxl < P(P_SC + 2) - ox);
        c = cw[p] + rv * (ins_x ? 1.f : 0.f);
      } else {
        c = cw[p] + rv;
      }
      c = valid > 0.f ? c : 0.f;
      const float pyc = oy * inv_ss + (static_cast<float>(ro) + 0.5f);
      shade_blend(kGrad, kTri, kTex, pp, nbp, pk, use_ct, ctp, 1, p, npx_out,
                  pxl + ox, pyc, c, fr[k], fg[k], fbl[k], fa[k]);
    }
  }

  float4* out = reinterpret_cast<float4*>(fb) + static_cast<size_t>(ids[t]) * npx_out;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    out[threadIdx.x + k * blockDim.x] = make_float4(fr[k], fg[k], fbl[k], fa[k]);
  }
}

struct Args {
  const float* cov;
  const int* pteb;
  const float* params;
  const float* ct;
  const int* ctile;
  const float* rbd;
  const int* ids;
  float4 bg;
  float* fb;
  int nbp, nbp1, mo, npp, rbr, tile_w, npx_out, ss, init, scratch;
  cudaStream_t stream;
};

// flags -> the matching form (a)/(d) instantiation, F = 127 down to 0
template <int F>
struct Dispatch {
  static void run(int flags, const Args& a) {
    if (flags == F) {
      const size_t smem =
          (F & 8) ? 2 * sizeof(float) * static_cast<size_t>(a.npx_out) * a.ss : 0;
      if (smem > 48 * 1024) {
        cudaFuncSetAttribute(composite_bucket_kernel<F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
      }
      composite_bucket_kernel<F><<<a.nbp, a.npx_out / kPix, smem, a.stream>>>(
          a.cov, a.pteb, a.params, a.ct, a.ctile, a.ids, a.bg, a.fb, a.nbp,
          a.nbp1, a.mo, a.npp, a.tile_w, a.npx_out, a.ss, a.init, a.scratch);
    } else {
      Dispatch<F - 1>::run(flags, a);
    }
  }
};

template <>
struct Dispatch<-1> {
  static void run(int, const Args&) {}
};

// lanes -> the matching form (e) instantiation, G = 15 down to 0
template <int G>
struct DispatchFinal {
  static void run(int lanes, const Args& a) {
    if (lanes == G) {
      composite_final_kernel<G><<<a.nbp, a.npx_out / kPix, 0, a.stream>>>(
          a.cov, a.pteb, a.params, a.ct, a.ctile, a.rbd, a.ids, a.bg, a.fb,
          a.nbp, a.nbp1, a.mo, a.npp, a.rbr, a.tile_w, a.npx_out, a.ss,
          a.init, a.scratch);
    } else {
      DispatchFinal<G - 1>::run(lanes, a);
    }
  }
};

template <>
struct DispatchFinal<-1> {
  static void run(int, const Args&) {}
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
// npx_out must be a multiple of 4 with npx_out/4 <= 256 (checked by the
// Python wrapper).  Launches on `stream`, does not synchronise; returns
// cudaGetLastError().
extern "C" int vg_composite_bucket(const float* cov, const int* pteb,
                                   const float* params, const float* ct,
                                   const int* ctile, const float* rbd,
                                   const int* ids, float bg_r, float bg_g,
                                   float bg_b, float bg_a, float* fb, int nbp,
                                   int nbp1, int mo, int npp, int rbr,
                                   int tile_w, int npx_out, int ss, int flags,
                                   int init, int scratch,
                                   cudaStream_t stream) {
  if (flags < 0 || flags >= 128 || ss < 1 || npx_out % kPix ||
      npx_out / kPix > kThreads || nbp1 < 1 || nbp % nbp1 ||
      (rbd != nullptr && ((flags & 8) || nbp1 != nbp))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nbp > 0) {
    const Args a{cov, pteb, params, ct, ctile, rbd, ids,
                 make_float4(bg_r, bg_g, bg_b, bg_a), fb, nbp, nbp1, mo, npp,
                 rbr, tile_w, npx_out, ss, init, scratch, stream};
    if (rbd != nullptr) {
      const int lanes = (flags & 7) | ((flags >> 6) & 1) << 3;
      DispatchFinal<15>::run(lanes, a);
    } else {
      Dispatch<127>::run(flags, a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
