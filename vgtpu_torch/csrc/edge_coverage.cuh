// The per-edge arithmetic of K1 (csrc/coverage.cu), K3
// (csrc/coverage_resolve.cu), K4 (csrc/coverage_t.cu), K5
// (csrc/coverage_t_flat.cu) and K6 (csrc/coverage_slots.cu): one place, so
// the kernels accumulate the same winding with the same roundings.  See
// coverage.cu for the G-form and why the two a*b+c sites are explicit
// __fmaf_rn (the library is built with -fmad=false).
#pragma once

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

// Signed area edge q sweeps over pixel (px, py) (tile-local column, row).
__device__ __forceinline__ float edge_contribution(const float* q, float px,
                                                   float py) {
  const float ytop = fmaxf(q[2], py);
  const float h = fmaxf(fminf(q[3], py + 1.f) - ytop, 0.f);
  const float u0 = (px + 1.f) - __fmaf_rn(q[5], ytop - q[1], q[0]);
  const float u1 = __fmaf_rn(-q[5], h, u0);
  const float cl0 = fminf(fmaxf(u0, 0.f), 1.f);
  const float cl1 = fminf(fmaxf(u1, 0.f), 1.f);
  const float g0 = cl0 * (u0 - 0.5f * cl0);
  const float g1 = cl1 * (u1 - 0.5f * cl1);
  return q[6] != 0.f ? q[4] * h * cl0 : (g0 - g1) * q[7];
}

}  // namespace vg
