// The per-pixel steps of the painter composite, shared by K2
// (csrc/composite.cu) and K7 (csrc/composite_flat.cu) so that the two
// composite with the same roundings: the metadata rows of a (slot, tile)
// params column, the fill rule, the clip state machine, and the shading and
// blending of one output pixel.  The lane switches (gradient, tri, texture,
// even-odd, non-AA, scissor) are arguments: K2 passes its template bits,
// which fold away in the inlined call, K7 its template bits for gradient,
// tri and texture and runtime flags for the rest.  The params column is an
// accessor over a slot table staged in shared memory: K2's rows adjacent
// (SharedColumn), K7's a row of tiles apart (its StagedColumn); the
// arithmetic is the same.  Rounding: see composite.cu (-fmad=false, the
// gradient's two explicit __fmaf_rn).
#pragma once

namespace vg {

// params rows (vgtpu/ops/composite_pallas.py _P_*)
constexpr int P_VALID = 0, P_KIND = 1, P_RULE = 2, P_AA = 3, P_PK = 4;
constexpr int P_SC = 5, P_CTILE = 9, P_OX = 10, P_OY = 11, P_PAINT = 12;
constexpr int P_BD = 32;
// op and paint kinds (vgtpu/raster/binning.py)
constexpr float K_DRAW = 0.f, K_CLIP_ADD = 1.f, K_CLIP_COMMIT = 2.f;
constexpr float K_CLIP_RESET = 3.f;
constexpr float PK_GRADIENT = 1.f, PK_IMAGE = 2.f, PK_TEXTURE = 3.f;
constexpr float PK_TRI = 4.f;

// A (slot, tile) params column staged in shared memory, rows adjacent.
struct SharedColumn {
  const float* p;
  __device__ __forceinline__ float operator()(int row) const { return p[row]; }
};

// Winding w (backdrop included) -> rule-applied coverage of the sample at
// tile-local centre (pxl, pyl): nonzero min(|w|,1), even-odd 1-|mod(w,2)-1|
// (floored mod, as jnp.mod), non-AA >= 0.5, textured quads forced to 1, the
// pixel-centre scissor.
template <class Col>
__device__ __forceinline__ float fill_coverage(bool eo, bool noaa, bool tex,
                                               bool scissor, const Col& P,
                                               float w, float rule, float aa,
                                               bool is_quad_tex, float pxl,
                                               float pyl, float ox, float oy) {
  float cv = fminf(fabsf(w), 1.f);
  if (eo) {
    const float md = w - 2.f * floorf(w * 0.5f);  // floored, as jnp.mod
    const float cov_eo = 1.f - fabsf(md - 1.f);
    cv = rule == 0.f ? cv : cov_eo;
  }
  if (noaa) cv = aa != 0.f ? cv : (cv >= 0.5f ? 1.f : 0.f);
  if (tex) cv = is_quad_tex ? 1.f : cv;
  if (scissor) {
    const bool inside_y = (pyl >= P(P_SC + 1) - oy) && (pyl < P(P_SC + 3) - oy);
    const bool inside = (pxl >= P(P_SC) - ox) && inside_y &&
                        (pxl < P(P_SC + 2) - ox);
    cv = cv * (inside ? 1.f : 0.f);
  }
  return cv;
}

// One slot's clip step for one sample: returns the masked draw coverage
// (read before the update) and advances mask and accum: ADD accumulates,
// COMMIT tests > 0.5 with the In/Out rule, RESET clears.
__device__ __forceinline__ float clip_step(float cv, float rule, bool is_draw,
                                           bool is_cadd, bool is_ccommit,
                                           bool is_creset, float& mask,
                                           float& accum) {
  const float m = mask;
  const float c = (is_draw ? cv : 0.f) * m;
  const float acc = is_cadd ? accum + cv : accum;
  const float inside_f = acc > 0.5f ? 1.f : 0.f;
  const float committed = rule == 0.f ? inside_f : 1.f - inside_f;
  mask = is_creset ? 1.f : (is_ccommit ? committed : m);
  accum = is_ccommit ? 0.f : acc;
  return c;
}

// Shade output pixel p at screen centre (pxc, pyc) and blend coverage c
// over (fr, fg, fbl, fa).  P is this (slot, tile)'s params column; channel k
// of pixel p of its colour tile is ctp[(k*npx + p)*cs].
template <class Col>
__device__ __forceinline__ void shade_blend(bool grad, bool tri, bool tex,
                                            const Col& P, float pk,
                                            bool use_ct, const float* ctp,
                                            int cs, int p, int npx, float pxc,
                                            float pyc, float c, float& fr,
                                            float& fg, float& fbl, float& fa) {
  const float inner_r = P(P_PAINT + 10), inner_g = P(P_PAINT + 11);
  const float inner_b = P(P_PAINT + 12), inner_a = P(P_PAINT + 13);
  float col_r = inner_r, col_g = inner_g, col_b = inner_b, col_a = inner_a;
  if (grad && pk == PK_GRADIENT) {
    // the one FMA per coordinate the reference XLA contracts: u is ~1e5 for
    // linear gradients, where an ulp moves d by ~3e-5
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
  if (tri && pk == PK_TRI) {
    col_r = P(P_PAINT + 0) * pxc + P(P_PAINT + 4) * pyc + P(P_PAINT + 8);
    col_g = P(P_PAINT + 1) * pxc + P(P_PAINT + 5) * pyc + P(P_PAINT + 9);
    col_b = P(P_PAINT + 2) * pxc + P(P_PAINT + 6) * pyc + P(P_PAINT + 10);
    col_a = P(P_PAINT + 3) * pxc + P(P_PAINT + 7) * pyc + P(P_PAINT + 11);
  }

  float src_r, src_g, src_b, src_a;
  if (tex && use_ct) {
    src_r = ctp[static_cast<size_t>(p) * cs];
    src_g = ctp[static_cast<size_t>(npx + p) * cs];
    src_b = ctp[static_cast<size_t>(2 * npx + p) * cs];
    src_a = ctp[static_cast<size_t>(3 * npx + p) * cs];
  } else {
    src_r = col_r * col_a;
    src_g = col_g * col_a;
    src_b = col_b * col_a;
    src_a = col_a;
  }

  const float a = src_a * c;
  const float one_minus_a = 1.f - a;
  fr = src_r * c + fr * one_minus_a;
  fg = src_g * c + fg * one_minus_a;
  fbl = src_b * c + fbl * one_minus_a;
  fa = a + fa * one_minus_a;
}

}  // namespace vg
