// K2: the fused painter composite of one bucket of tiles.
//
// Replaces the Pallas TPU kernel vgtpu/ops/composite_pallas.py::_kernel_rows
// (driven by composite_bucket_pallas / frame_fb_pallas) for its ss=1 form:
// add_backdrop, a broadcast background, one variant (k_rep=1), raw sub-row
// coverage (cov_final=False).  Per tile it scans the bucket's MO painter
// slots in order; per slot and pixel it
//   - adds the entry's per-row backdrop (params rows _P_BD = 32..32+TH),
//   - applies the fill rule: nonzero min(|w|,1), even-odd 1-|mod(w,2)-1|
//     (floored mod, as jnp.mod), non-AA >= 0.5, textured quads forced to 1,
//     and the pixel-centre scissor,
//   - updates the clip state: ADD accumulates, COMMIT tests > 0.5 with the
//     In/Out rule, RESET clears,
//   - shades solid / gradient (inverse paint matrix, sdroundrect, feather) /
//     triangle affine colour / colour-tile texture,
//   - blends premultiplied src-over into the framebuffer.
// The seven lane flags (gradient, tri, texture, clip, even-odd, non-AA,
// scissor) are the template bit mask F, so a bucket compiles only its lanes.
// The plain twin is vgtpu_torch/ops/composite.py::composite_bucket_torch.
//
// What bounds it on an H100: memory traffic of the coverage gather.  Each
// (tile, slot) reads one 4 KB coverage row (and 16 KB of colour tile on
// texture slots) and does ~30-60 float ops per pixel, so the kernel sits
// near the bandwidth side of the roofline; the framebuffer and clip state
// never leave registers.
//
// Design: one block per tile of the bucket, blockDim = TH*TW/4 threads,
// each thread owns 4 pixels p = threadIdx.x + k*blockDim.x and keeps their 4
// framebuffer channels (plus the clip mask and accumulator when the clip
// lane is on) in registers across the sequential slot loop — the loop that
// was the TPU kernel's sequential grid axis.  Per slot the block reads that
// slot's params column (block-uniform loads) and gathers the coverage row
// cov_all[pteb[t, slot]] inside the kernel, so the TPU path's (MO, NPX, Nb)
// ew_t transpose is never materialized; colour tiles are gathered the same
// way from the channel-major (NCT+1, 4*NPX) ct_flat by ctile id.  The
// finished tile is stored as float4 pixels into the (T+1, TH, TW, 4)
// framebuffer at row ids[t]; pad tiles write the scratch row T.
//
// Rounding: IEEE division and sqrt are kept (no --use_fast_math) and the
// library is built with -fmad=false; the gradient's paint-space
// coordinates take one explicit __fmaf_rn each, as the plain twin does, so
// kernel and twin round the same operations the same way.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// params rows (vgtpu/ops/composite_pallas.py _P_*)
constexpr int P_VALID = 0, P_KIND = 1, P_RULE = 2, P_AA = 3, P_PK = 4;
constexpr int P_SC = 5, P_CTILE = 9, P_OX = 10, P_OY = 11, P_PAINT = 12;
constexpr int P_BD = 32;
// op and paint kinds (vgtpu/raster/binning.py)
constexpr float K_DRAW = 0.f, K_CLIP_ADD = 1.f, K_CLIP_COMMIT = 2.f;
constexpr float K_CLIP_RESET = 3.f;
constexpr float PK_GRADIENT = 1.f, PK_IMAGE = 2.f, PK_TEXTURE = 3.f;
constexpr float PK_TRI = 4.f;
constexpr int kPix = 4;  // pixels per thread

template <int F>
__global__ void __launch_bounds__(1024)
composite_bucket_kernel(const float* __restrict__ cov,
                        const int* __restrict__ pteb,
                        const float* __restrict__ params,
                        const float* __restrict__ ct,
                        const int* __restrict__ ctile,
                        const int* __restrict__ ids, float4 bg,
                        float* __restrict__ fb, int nbp, int mo, int npp,
                        int tile_w, int npx) {
  constexpr bool kGrad = F & 1, kTri = F & 2, kTex = F & 4, kClip = F & 8;
  constexpr bool kEo = F & 16, kNoAa = F & 32, kScissor = F & 64;
  const int t = blockIdx.x;

  float fr[kPix], fg[kPix], fbl[kPix], fa[kPix], mask[kPix], accum[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    fr[k] = bg.x;
    fg[k] = bg.y;
    fbl[k] = bg.z;
    fa[k] = bg.w;
    mask[k] = 1.f;
    accum[k] = 0.f;
  }

  for (int slot = 0; slot < mo; ++slot) {
    const float* pp = params + static_cast<size_t>(slot) * npp * nbp + t;
    auto P = [&](int row) { return __ldg(pp + static_cast<size_t>(row) * nbp); };
    const float valid = P(P_VALID), kind = P(P_KIND), rule = P(P_RULE);
    const float aa = P(P_AA), pk = P(P_PK);
    const float ox = P(P_OX), oy = P(P_OY);
    const float inner_r = P(P_PAINT + 10), inner_g = P(P_PAINT + 11);
    const float inner_b = P(P_PAINT + 12), inner_a = P(P_PAINT + 13);
    const bool is_quad_tex = pk == PK_TEXTURE;
    const bool use_ct =
        kTex && (P(P_CTILE) > 0.f) && (is_quad_tex || pk == PK_IMAGE);
    const bool is_draw = valid > 0.f && kind == K_DRAW;
    const bool is_cadd = valid > 0.f && kind == K_CLIP_ADD;
    const bool is_ccommit = valid > 0.f && kind == K_CLIP_COMMIT;
    const bool is_creset = valid > 0.f && kind == K_CLIP_RESET;
    const float* cw = cov + static_cast<size_t>(pteb[t * mo + slot]) * npx;
    const float* ctp = nullptr;
    if (kTex) ctp = ct + static_cast<size_t>(ctile[t * mo + slot]) * 4 * npx;

#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = threadIdx.x + k * blockDim.x;
      const int r = p / tile_w;
      const float pxl = static_cast<float>(p - r * tile_w) + 0.5f;
      const float pyl = static_cast<float>(r) + 0.5f;

      const float w = cw[p] + P(P_BD + r);
      float cv = fminf(fabsf(w), 1.f);
      if (kEo) {
        const float md = w - 2.f * floorf(w * 0.5f);  // floored, as jnp.mod
        const float cov_eo = 1.f - fabsf(md - 1.f);
        cv = rule == 0.f ? cv : cov_eo;
      }
      if (kNoAa) cv = aa != 0.f ? cv : (cv >= 0.5f ? 1.f : 0.f);
      if (kTex) cv = is_quad_tex ? 1.f : cv;
      if (kScissor) {
        const bool inside_y = (pyl >= P(P_SC + 1) - oy) && (pyl < P(P_SC + 3) - oy);
        const bool inside = (pxl >= P(P_SC) - ox) && inside_y &&
                            (pxl < P(P_SC + 2) - ox);
        cv = cv * (inside ? 1.f : 0.f);
      }

      float c;
      if (kClip) {
        c = (is_draw ? cv : 0.f) * mask[k];
        const float acc = is_cadd ? accum[k] + cv : accum[k];
        const float inside_f = acc > 0.5f ? 1.f : 0.f;
        const float committed = rule == 0.f ? inside_f : 1.f - inside_f;
        mask[k] = is_creset ? 1.f : (is_ccommit ? committed : mask[k]);
        accum[k] = is_ccommit ? 0.f : acc;
      } else {
        c = valid > 0.f ? cv : 0.f;
      }

      float col_r = inner_r, col_g = inner_g, col_b = inner_b, col_a = inner_a;
      if (kGrad || kTri) {
        const float pxc = pxl + ox;
        const float pyc = pyl + oy;
        if (kGrad && pk == PK_GRADIENT) {
          // the one FMA per coordinate the reference XLA contracts: u is
          // ~1e5 for linear gradients, where an ulp moves d by ~3e-5
          const float ux = __fmaf_rn(P(P_PAINT + 0), pxc, P(P_PAINT + 2) * pyc) + P(P_PAINT + 4);
          const float uy = __fmaf_rn(P(P_PAINT + 1), pxc, P(P_PAINT + 3) * pyc) + P(P_PAINT + 5);
          const float ex = P(P_PAINT + 6), ey = P(P_PAINT + 7);
          const float rad = P(P_PAINT + 8);
          const float feather = fmaxf(P(P_PAINT + 9), 1e-6f);
          const float dx = fabsf(ux) - (ex - rad);
          const float dy = fabsf(uy) - (ey - rad);
          const float mx = fmaxf(dx, 0.f), my = fmaxf(dy, 0.f);
          const float sd = fminf(fmaxf(dx, dy), 0.f) + sqrtf(mx * mx + my * my) - rad;
          const float d = fminf(fmaxf((sd + feather * 0.5f) / feather, 0.f), 1.f);
          col_r = inner_r * (1.f - d) + P(P_PAINT + 14) * d;
          col_g = inner_g * (1.f - d) + P(P_PAINT + 15) * d;
          col_b = inner_b * (1.f - d) + P(P_PAINT + 16) * d;
          col_a = inner_a * (1.f - d) + P(P_PAINT + 17) * d;
        }
        if (kTri && pk == PK_TRI) {
          col_r = P(P_PAINT + 0) * pxc + P(P_PAINT + 4) * pyc + P(P_PAINT + 8);
          col_g = P(P_PAINT + 1) * pxc + P(P_PAINT + 5) * pyc + P(P_PAINT + 9);
          col_b = P(P_PAINT + 2) * pxc + P(P_PAINT + 6) * pyc + P(P_PAINT + 10);
          col_a = P(P_PAINT + 3) * pxc + P(P_PAINT + 7) * pyc + P(P_PAINT + 11);
        }
      }

      float src_r, src_g, src_b, src_a;
      if (kTex && use_ct) {
        src_r = ctp[p];
        src_g = ctp[npx + p];
        src_b = ctp[2 * npx + p];
        src_a = ctp[3 * npx + p];
      } else {
        src_r = col_r * col_a;
        src_g = col_g * col_a;
        src_b = col_b * col_a;
        src_a = col_a;
      }

      const float a = src_a * c;
      const float one_minus_a = 1.f - a;
      fr[k] = src_r * c + fr[k] * one_minus_a;
      fg[k] = src_g * c + fg[k] * one_minus_a;
      fbl[k] = src_b * c + fbl[k] * one_minus_a;
      fa[k] = a + fa[k] * one_minus_a;
    }
  }

  float4* out = reinterpret_cast<float4*>(fb) + static_cast<size_t>(ids[t]) * npx;
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
  const int* ids;
  float4 bg;
  float* fb;
  int nbp, mo, npp, tile_w, npx;
  cudaStream_t stream;
};

// flags -> the matching instantiation, F = 127 down to 0
template <int F>
struct Dispatch {
  static void run(int flags, const Args& a) {
    if (flags == F) {
      composite_bucket_kernel<F><<<a.nbp, a.npx / kPix, 0, a.stream>>>(
          a.cov, a.pteb, a.params, a.ct, a.ctile, a.ids, a.bg, a.fb, a.nbp,
          a.mo, a.npp, a.tile_w, a.npx);
    } else {
      Dispatch<F - 1>::run(flags, a);
    }
  }
};

template <>
struct Dispatch<-1> {
  static void run(int, const Args&) {}
};

}  // namespace

// One bucket: cov (NC+1, npx); pteb, ctile (nbp, mo) i32; params
// (mo, npp, nbp); ct (NCT+1, 4*npx) or null without the texture lane; ids
// (nbp,) framebuffer rows; fb (T+1, npx, 4).  flags bit i = lane i of
// (gradient, tri, texture, clip, even-odd, non-AA, scissor).  npx must be a
// multiple of 4 with npx/4 <= 1024 (checked by the Python wrapper).
// Launches on `stream`, does not synchronise; returns cudaGetLastError().
extern "C" int vg_composite_bucket(const float* cov, const int* pteb,
                                   const float* params, const float* ct,
                                   const int* ctile, const int* ids,
                                   float bg_r, float bg_g, float bg_b,
                                   float bg_a, float* fb, int nbp, int mo,
                                   int npp, int tile_w, int npx, int flags,
                                   cudaStream_t stream) {
  if (flags < 0 || flags >= 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nbp > 0) {
    const Args a{cov, pteb, params, ct, ctile, ids,
                 make_float4(bg_r, bg_g, bg_b, bg_a), fb, nbp, mo, npp,
                 tile_w, npx, stream};
    Dispatch<127>::run(flags, a);
  }
  return static_cast<int>(cudaGetLastError());
}
