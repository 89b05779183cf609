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
// What bounds it on an H100: memory traffic of the dense ew_t (4 bytes per
// slot and pixel, invalid slots included), the params columns and the
// colour tiles; ~20-60 float ops per slot and pixel.
//
// Design: ew_t[j, p, :] and fb_t[c*NPX + p, :] both have tiles innermost,
// so threadIdx.x runs along tiles: a warp reads 32 consecutive tiles of one
// (slot, pixel) and writes 32 consecutive tiles of one output row, and its
// params loads are 32 consecutive floats of one row.  (One block per tile,
// as K2 has, would read ew_t with a stride of Nb*4 bytes.)  A block is 32
// tiles x 8 threads; each thread owns kPix consecutive pixels of its tile
// and keeps their 4 framebuffer channels, clip mask and clip accumulator in
// registers across the slot loop, the TPU grid's sequential axis.  The
// seven lane flags, add_backdrop, the init plane and k_rep are runtime
// values, uniform over the launch: one instantiation, a build of seconds
// (K2's 144 take 32-55 s).  The fill rule, clip step and shading are K2's
// (csrc/composite_common.cuh), so the two round alike.

#include <cuda_runtime.h>

#include "common.cuh"
#include "composite_common.cuh"

namespace {

using namespace vg;

constexpr int kTiles = 32;   // tiles per block, one per threadIdx.x
constexpr int kRows = 8;     // threadIdx.y
constexpr int kPix = 8;      // consecutive pixels per thread

__global__ void __launch_bounds__(kTiles * kRows)
composite_flat_kernel(const float* __restrict__ ew,
                      const float* __restrict__ params,
                      const float* __restrict__ ct,
                      const float* __restrict__ bg, float* __restrict__ out,
                      int nb, int nbo, int mo, int npp, int tile_w, int npx,
                      int bg_cols, int flags, int add_backdrop) {
  const int t = blockIdx.x * kTiles + threadIdx.x;
  const int p0 = (blockIdx.y * kRows + threadIdx.y) * kPix;
  if (t >= nbo || p0 >= npx) return;
  const int te = t % nb;                  // k_rep: ew_t's one variant block
  const bool grad = flags & 1, tri = flags & 2, tex = flags & 4;
  const bool clip = flags & 8, eo = flags & 16, noaa = flags & 32;
  const bool scissor = flags & 64;
  const int bcol = bg_cols == 1 ? 0 : t;

  float fr[kPix], fg[kPix], fbl[kPix], fa[kPix], mask[kPix], accum[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = p0 + k;
    if (p >= npx) break;
    fr[k] = bg[static_cast<size_t>(p) * bg_cols + bcol];
    fg[k] = bg[static_cast<size_t>(npx + p) * bg_cols + bcol];
    fbl[k] = bg[static_cast<size_t>(2 * npx + p) * bg_cols + bcol];
    fa[k] = bg[static_cast<size_t>(3 * npx + p) * bg_cols + bcol];
    mask[k] = 1.f;
    accum[k] = 0.f;
  }

  for (int slot = 0; slot < mo; ++slot) {
    const GlobalColumn P{params + static_cast<size_t>(slot) * npp * nbo + t,
                         nbo};
    const float valid = P(P_VALID), kind = P(P_KIND), rule = P(P_RULE);
    const float aa = P(P_AA), pk = P(P_PK);
    const float ox = P(P_OX), oy = P(P_OY);
    const bool is_quad_tex = pk == PK_TEXTURE;
    const bool use_ct =
        tex && (P(P_CTILE) > 0.f) && (is_quad_tex || pk == PK_IMAGE);
    const bool is_draw = valid > 0.f && kind == K_DRAW;
    const bool is_cadd = valid > 0.f && kind == K_CLIP_ADD;
    const bool is_ccommit = valid > 0.f && kind == K_CLIP_COMMIT;
    const bool is_creset = valid > 0.f && kind == K_CLIP_RESET;
    const float* ew_s = ew + static_cast<size_t>(slot) * npx * nb + te;
    const float* ctp =
        tex ? ct + static_cast<size_t>(slot) * 4 * npx * nbo + t : nullptr;

#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = p0 + k;
      if (p >= npx) break;
      const int r = p / tile_w;
      const float pxl = static_cast<float>(p - r * tile_w) + 0.5f;
      const float pyl = static_cast<float>(r) + 0.5f;
      float w = __ldg(ew_s + static_cast<size_t>(p) * nb);
      if (add_backdrop) w = w + P(P_BD + r);
      const float cv = fill_coverage(eo, noaa, tex, scissor, P, w, rule, aa,
                                     is_quad_tex, pxl, pyl, ox, oy);
      const float c =
          clip ? clip_step(cv, rule, is_draw, is_cadd, is_ccommit, is_creset,
                           mask[k], accum[k])
               : (valid > 0.f ? cv : 0.f);
      shade_blend(grad, tri, tex, P, pk, use_ct, ctp, nbo, p, npx, pxl + ox,
                  oy + pyl, c, fr[k], fg[k], fbl[k], fa[k]);
    }
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = p0 + k;
    if (p >= npx) break;
    out[static_cast<size_t>(p) * nbo + t] = fr[k];
    out[static_cast<size_t>(npx + p) * nbo + t] = fg[k];
    out[static_cast<size_t>(2 * npx + p) * nbo + t] = fbl[k];
    out[static_cast<size_t>(3 * npx + p) * nbo + t] = fa[k];
  }
}

}  // namespace

// One bucket.  ew (mo, npx, nb); params (mo, npp, nbo) with nbo a multiple
// of nb (k_rep = nbo / nb variant blocks) and npp >= 32 + npx / tile_w when
// add_backdrop; ct (mo, 4*npx, nbo), or null without the texture lane; bg
// (4*npx, bg_cols) with bg_cols 1 (background column) or nbo (init plane);
// out (4*npx, nbo); all f32 contiguous on `device`.  flags bit i = lane i
// of (gradient, tri, texture, clip, even-odd, non-AA, scissor).  Launches on
// `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int vg_composite_flat(const float* ew, const float* params,
                                 const float* ct, const float* bg, float* out,
                                 int nb, int nbo, int mo, int npp, int tile_w,
                                 int npx, int bg_cols, int flags,
                                 int add_backdrop, int device,
                                 cudaStream_t stream) {
  if (flags < 0 || flags >= 128 || nb < 1 || nbo % nb || tile_w < 1 ||
      npx % tile_w || (bg_cols != 1 && bg_cols != nbo) ||
      ((flags & 4) && ct == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vg::DeviceScope scope(device);
  if (nbo > 0 && npx > 0) {
    const int per_block = kRows * kPix;
    const dim3 grid((nbo + kTiles - 1) / kTiles,
                    (npx + per_block - 1) / per_block);
    composite_flat_kernel<<<grid, dim3(kTiles, kRows), 0, stream>>>(
        ew, params, ct, bg, out, nb, nbo, mo, npp, tile_w, npx, bg_cols, flags,
        add_backdrop);
  }
  return static_cast<int>(cudaGetLastError());
}
