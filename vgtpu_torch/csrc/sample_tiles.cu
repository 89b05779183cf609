// S1: texture sampling into colour tiles, tile-major, in K2's flat layout.
//
// Replaces no TPU kernel: vgtpu's device sampler
// (vgtpu/ops/sampling_device.py::_sample_jit) is plain XLA.  Its plain
// torch port, vgtpu_torch/ops/sampling_device.py::sample_groups, is this
// kernel's twin.  S1 was added because the twin materialises dense hat
// weights over the whole texture for every (entry, quad) pair, O(K * TW *
// IW) floats: the 1080p frame's glyph quads over the 512x512 atlas make a
// (1024, 128, 512) weight tensor, 268 MB, which six elementwise passes and
// two matrix products read and write on every retained-pan view
// (~1.8 ms of device time and 91 launches a view on an H100).
//
// What bounds it on an H100: the output, NCT+1 tiles of 4 x TH x TW floats
// written once.  On the city map's pan (vgbench's cell citymap_z17.pan)
// that is 5,600 colour tiles, 92 MB, 0.027 ms at 3.35 TB/s; on the tiger's
// scroll 1.5 MB, where one launch's latency and its densest tile bound it.
// The map's tiles hold 5.8 glyph quads each (up to 22), each ~8x9 px of the
// tile's 1,024: 98% of the (pair, pixel) slots are outside every quad, and
// a design that sets a pair up or samples it at every pixel of its tile
// spends its time there (0.33 ms a map view, ~11x the bound).  Each sample
// reads two to four texels of a texture that stays in L2 (the atlas is
// 1 MB as float32).
//
// Design: one pass, no weights in device memory, the work only where the
// quads are.
// - Tile-major, no atomics: one block a colour tile (the zeros row that pad
//   and untextured slots read among them), the tiles with the most pairs
//   first (the host's tile order), so that the longest blocks do not start
//   last.  The host sorts the (entry, quad) pairs by tile, keeping their
//   row order inside a tile (ops/sampling_device.build_tile_index): the
//   order in which the twin's index_add_ adds them on the CPU.  Pad rows
//   are not indexed.
// - Set-up once a pair, not once a pixel: the block stages its tile's pairs
//   kChunk at a time in shared memory, in row order, a thread a pair: the
//   group's row of the table (texture pointer, h, w, C, flags, kind,
//   separable), the colour, and for a quad the inverse (four divisions),
//   the coverage widths wa and wb (two square roots) and its footprint.
// - The footprint (quad_box) is the rectangle of the tile's pixels where
//   the quad's coverage can be nonzero: the quad's band a in (-wa/2, 1 +
//   wa/2), b likewise, mapped back to pixels, grown by 1 px for rounding.
//   Outside it the twin adds texel * colour * 0, an exact zero, so a pixel
//   skips those pairs and its float32 sum keeps every bit.  A quad whose
//   box cannot be trusted (non-finite inverse, degenerate or strongly
//   sheared, or coordinates past kMaxSpan) and every pattern fill (P_IMAGE,
//   written, not summed) take the whole tile.
// - Compacted samples: the (pair, pixel) items inside the chunk's
//   footprints (2% of the slots on the map) are numbered pair by pair and
//   sampled kItems at a time, a thread an item, so every lane of a warp
//   samples while items last; then the pairs' items are added into the
//   pixels' sums in shared memory pair by pair, the twin's order.  At a
//   sample, the twin's texel coordinates, then a two-tap lookup per axis:
//   the hat (bilinear) or indicator (nearest) weight that the twin's dense
//   weight tensor holds is zero outside the two taps, so evaluating the
//   twin's weight formula at the taps gives the same weights.  Rotated
//   groups take the twin's exact gather (_sample_gather).  Every group form
//   in one code path: glyph and image quads (P_TEXTURE: coverage, colour
//   modulation, summed, A8 or RGBA), pattern fills (the tile's one entry),
//   separable or not, nearest or bilinear, clamp or repeat.
// - A block holds little (kThreads threads, ~28 KB of shared memory), so
//   seven or eight tiles are in flight on an SM and one tile's set-up
//   latency hides behind another's samples and writes.  A tile of textured
//   quads is clamped to [0, 1] (the twin's clipmask); each pixel is written
//   channel-major, out[tile, ch * TH*TW + pixel], K2's colour-tile layout.
// Rounding: float32 throughout, -fmad=false, and the twin's fused sites
// (ops/coverage.fma) as __fmaf_rn; nearest rounds half to even (rintf, as
// torch.round), repeat wraps by floor modulo (fmodf then + size, as
// torch.remainder), hypot in double (as the CPU's hypotf).  Only the
// separable product's summation order differs from the twin's matrix
// products: a few float32 ulps.  ops/sampling_device.footprint_boxes is
// quad_box in numpy, the same float32 operations.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPix = 8;          // output pixels a thread writes in one pass
constexpr int kChunk = 32;       // pairs set up in shared memory at a time
constexpr int kItems = 512;      // (pair, pixel) samples held in shared memory at a time
constexpr float kMaxSpan = 1e6f; // px: past it a quad's footprint is not trusted
constexpr int kRowWords = 17;    // params 12, colour 4, ct 1 (float32)
constexpr int kGroupWords = 8;   // texture pointer (2), h, w, C, flags, kind, separable

// vgtpu_torch/core.py ImageFlags and raster/binning.py P_TEXTURE
// (tests/test_torch_sampling_index.py holds them to the Python values)
constexpr int kNearestUV = 1 << 0;
constexpr int kLinearUV = 1 << 2;
constexpr int kClampU = 1 << 10;
constexpr int kClampV = 1 << 11;
constexpr int kTextureQuad = 3;

struct Group {
  const float* tex;
  int h, w, c, flags, quad, separable;
};

__device__ __forceinline__ Group load_group(const int* table, int g) {
  const int* t = table + g * kGroupWords;
  Group out;
  out.tex = reinterpret_cast<const float*>(
      *reinterpret_cast<const unsigned long long*>(t));
  out.h = t[2];
  out.w = t[3];
  out.c = t[4];
  out.flags = t[5];
  out.quad = t[6] == kTextureQuad;
  out.separable = t[7];
  return out;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

// torch.remainder(a, b) for b > 0: fmod, then + b where the sign differs
__device__ __forceinline__ float remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && m < 0.f) m += b;
  return m;
}

__device__ __forceinline__ int wrap_index(int i, int n, bool clamp) {
  if (clamp) return min(max(i, 0), n - 1);
  if ((n & (n - 1)) == 0) return i & (n - 1);   // the same floor modulo
  const int m = i % n;
  return m < 0 ? m + n : m;
}

// One axis of the separable sampler: the texels (i0, i1) and the weights
// (w0, w1) the twin's _axis_weights gives them at texel coordinate t; w1 is
// 0 where the axis has one tap.
struct Taps {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Taps axis_taps(float t, int size, bool clamp,
                                          bool nearest) {
  const float x = t - 0.5f;
  const float fs = static_cast<float>(size);
  Taps k;
  if (nearest) {
    float xr = rintf(x);
    if (clamp) xr = fminf(fmaxf(xr, 0.f), fs - 1.f);
    k.i0 = wrap_index(static_cast<int>(xr), size, false);
    k.i1 = k.i0;
    k.w0 = 1.f;
    k.w1 = 0.f;
    return k;
  }
  if (clamp) {
    const float xc = fminf(fmaxf(x, 0.f), fs - 1.f);
    k.i0 = static_cast<int>(floorf(xc));
    k.i1 = min(k.i0 + 1, size - 1);
    k.w0 = fmaxf(1.f - fabsf(xc - static_cast<float>(k.i0)), 0.f);
    k.w1 = k.i1 == k.i0
               ? 0.f
               : fmaxf(1.f - fabsf(xc - static_cast<float>(k.i1)), 0.f);
    return k;
  }
  const int x0 = static_cast<int>(floorf(x));
  k.i0 = wrap_index(x0, size, false);
  k.i1 = wrap_index(x0 + 1, size, false);
  const float d0 = remainder(x - static_cast<float>(k.i0), fs);
  k.w0 = fmaxf(1.f - d0, 0.f) + fmaxf(1.f - (fs - d0), 0.f);
  if (k.i1 == k.i0) {
    k.w1 = 0.f;
  } else {
    const float d1 = remainder(x - static_cast<float>(k.i1), fs);
    k.w1 = fmaxf(1.f - d1, 0.f) + fmaxf(1.f - (fs - d1), 0.f);
  }
  return k;
}

// The twin's _sample_separable at one pixel: the row weights against the
// texture, then the column weights (its two matrix products, two taps each)
__device__ __forceinline__ void sample_separable(const Group& g, float tu,
                                                 float tv, float* s) {
  const bool nearest = !(g.flags & kLinearUV) && (g.flags & kNearestUV);
  const Taps ty = axis_taps(tv, g.h, g.flags & kClampV, nearest);
  const Taps tx = axis_taps(tu, g.w, g.flags & kClampU, nearest);
  const float* r0 = g.tex + static_cast<size_t>(ty.i0) * g.w * g.c;
  const float* r1 = g.tex + static_cast<size_t>(ty.i1) * g.w * g.c;
  for (int ch = 0; ch < g.c; ++ch) {
    const float t0 = __fmaf_rn(ty.w1, __ldg(r1 + tx.i0 * g.c + ch),
                               ty.w0 * __ldg(r0 + tx.i0 * g.c + ch));
    const float t1 = __fmaf_rn(ty.w1, __ldg(r1 + tx.i1 * g.c + ch),
                               ty.w0 * __ldg(r0 + tx.i1 * g.c + ch));
    s[ch] = __fmaf_rn(tx.w1, t1, tx.w0 * t0);
  }
}

__device__ __forceinline__ float texel(const Group& g, int y, int x, int ch) {
  return __ldg(g.tex + (static_cast<size_t>(y) * g.w + x) * g.c + ch);
}

// The twin's _sample_gather at one pixel (rotated groups)
__device__ __forceinline__ void sample_gather(const Group& g, float u, float v,
                                              float* s) {
  const bool cu = g.flags & kClampU, cv = g.flags & kClampV;
  const float x = u - 0.5f, y = v - 0.5f;
  if (!(g.flags & kLinearUV) && (g.flags & kNearestUV)) {
    const int yi = wrap_index(static_cast<int>(rintf(y)), g.h, cv);
    const int xi = wrap_index(static_cast<int>(rintf(x)), g.w, cu);
    for (int ch = 0; ch < g.c; ++ch) s[ch] = texel(g, yi, xi, ch);
    return;
  }
  const float xf = floorf(x), yf = floorf(y);
  const int x0 = static_cast<int>(xf), y0 = static_cast<int>(yf);
  const float fx = x - xf, fy = y - yf;
  const int xa = wrap_index(x0, g.w, cu), xb = wrap_index(x0 + 1, g.w, cu);
  const int ya = wrap_index(y0, g.h, cv), yb = wrap_index(y0 + 1, g.h, cv);
  for (int ch = 0; ch < g.c; ++ch) {
    float acc = texel(g, ya, xa, ch) * (1.f - fx) * (1.f - fy);
    acc = __fmaf_rn(texel(g, ya, xb, ch) * fx, 1.f - fy, acc);
    acc = __fmaf_rn(texel(g, yb, xa, ch) * (1.f - fx), fy, acc);
    s[ch] = __fmaf_rn(texel(g, yb, xb, ch) * fx, fy, acc);
  }
}

// One pair as the block stages it: its group, its footprint (pixels
// [x0, x1) x [y0, y1) of the tile), the tile origin plus the shift
// (sample_groups' ox, oy before the pixel centre), its colour and
//   quads:    p0x, p0y, i00, i01, i10, i11, wa, wb, u0, v0, u1 - u0, v1 - v0
//   patterns: m0 .. m5
struct Slot {
  Group g;
  int x0, x1, y0, y1;
  float gx, gy;
  float f[12];
  float col[4];
};

// The footprint of a quad in a tile: the pixels whose centre lies within
// 1 px of the band where cov_a and cov_b are both nonzero (a in (-wa/2,
// 1 + wa/2), b likewise).  Separable groups compute a = i00 * rx and
// b = i11 * ry, so the band maps to x and y through i00 and i11; rotated
// ones compute (a, b) = inverse * r, so r = a * (exx, exy) + b * (eyx, eyy)
// over the band's corners.  The 1 px takes the float32 rounding of those
// maps and of the pixel's own coordinates (a few ulps of values up to
// kMaxSpan); a quad that is non-finite, degenerate (shear ~ 1 / sin of the
// angle between its edges) or too large for that bound covers the tile.
// (qx, qy): the quad's origin relative to the pixel grid's, p0 - (gx, gy).
__device__ __forceinline__ void quad_box(float qx, float qy, float gx, float gy,
                                         float exx, float exy, float eyx,
                                         float eyy, float i00, float i01,
                                         float i10, float i11, float wa,
                                         float wb, bool separable, int th,
                                         int tw, Slot& s) {
  const float a0 = -0.5f * wa, a1 = 1.f + 0.5f * wa;
  const float b0 = -0.5f * wb, b1 = 1.f + 0.5f * wb;
  float xlo, xhi, ylo, yhi;
  if (separable) {
    xlo = fminf(a0 / i00, a1 / i00);
    xhi = fmaxf(a0 / i00, a1 / i00);
    ylo = fminf(b0 / i11, b1 / i11);
    yhi = fmaxf(b0 / i11, b1 / i11);
  } else {
    xlo = fminf(a0 * exx, a1 * exx) + fminf(b0 * eyx, b1 * eyx);
    xhi = fmaxf(a0 * exx, a1 * exx) + fmaxf(b0 * eyx, b1 * eyx);
    ylo = fminf(a0 * exy, a1 * exy) + fminf(b0 * eyy, b1 * eyy);
    yhi = fmaxf(a0 * exy, a1 * exy) + fmaxf(b0 * eyy, b1 * eyy);
  }
  const float ea = fabsf(exx) + fabsf(exy), eb = fabsf(eyx) + fabsf(eyy);
  const float shear = fmaxf(wa * ea, wb * eb);
  const float span = shear * (ea + eb + 4.f * shear) + fabsf(qx) + fabsf(qy) +
                     fabsf(gx) + fabsf(gy);
  const float x0 = ceilf(qx + xlo - 1.5f), x1 = floorf(qx + xhi + 0.5f) + 1.f;
  const float y0 = ceilf(qy + ylo - 1.5f), y1 = floorf(qy + yhi + 0.5f) + 1.f;
  const bool finite = isfinite(i00) && isfinite(i01) && isfinite(i10) &&
                      isfinite(i11);
  if (!finite || !(span <= kMaxSpan) || !(x0 <= x1 && y0 <= y1)) {
    s.x0 = 0, s.x1 = tw, s.y0 = 0, s.y1 = th;
    return;
  }
  s.x0 = static_cast<int>(fmaxf(x0, 0.f));
  s.x1 = static_cast<int>(fminf(x1, static_cast<float>(tw)));
  s.y0 = static_cast<int>(fmaxf(y0, 0.f));
  s.y1 = static_cast<int>(fminf(y1, static_cast<float>(th)));
}

// Stages pair row p of group g, for a tile th x tw at shift (sx, sy): the
// twin's per-pair expressions, computed once
__device__ __forceinline__ void setup_pair(const Group& g, const float* p,
                                           float sx, float sy, int th, int tw,
                                           Slot& s) {
  s.g = g;
  s.gx = p[0] + sx;
  s.gy = p[1] + sy;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) s.col[ch] = p[12 + ch];
  if (!g.quad) {
#pragma unroll
    for (int i = 0; i < 6; ++i) s.f[i] = p[2 + i];
    s.x0 = 0, s.x1 = tw, s.y0 = 0, s.y1 = th;
    return;
  }
  const float p0x = p[2], p0y = p[3];
  const float exx = p[4], exy = p[5], eyx = p[6], eyy = p[7];
  const float det = exx * eyy - exy * eyx;
  const float i00 = eyy / det, i01 = -eyx / det;
  const float i10 = -exy / det, i11 = exx / det;
  const float wa = fmaxf(static_cast<float>(sqrt(
                             static_cast<double>(i00) * i00 +
                             static_cast<double>(i01) * i01)),
                         1e-9f);
  const float wb = fmaxf(static_cast<float>(sqrt(
                             static_cast<double>(i10) * i10 +
                             static_cast<double>(i11) * i11)),
                         1e-9f);
  const float f[12] = {p0x, p0y, i00, i01, i10, i11, wa, wb,
                       p[8], p[9], p[10] - p[8], p[11] - p[9]};
#pragma unroll
  for (int i = 0; i < 12; ++i) s.f[i] = f[i];
  quad_box(p0x - s.gx, p0y - s.gy, s.gx, s.gy, exx, exy, eyx, eyy, i00, i01,
           i10, i11, wa, wb, g.separable, th, tw, s);
}

// One staged pair's premultiplied RGBA at one output pixel, (cx, cy) its
// centre in the tile: sample_groups' body for the pair's row
__device__ __forceinline__ void pair_rgba(const Slot& s, float cx, float cy,
                                          float* out) {
  const Group& g = s.g;
  const float ox = s.gx + cx, oy = s.gy + cy;
  float sm[4];
  if (g.quad) {
    const float* q = s.f;
    const float i00 = q[2], i01 = q[3], i10 = q[4], i11 = q[5];
    const float rx = ox - q[0], ry = oy - q[1];
    const float a = g.separable ? i00 * rx : i00 * rx + i01 * ry;
    const float b = g.separable ? i11 * ry : i10 * rx + i11 * ry;
    const float cov_a = clamp01((0.5f - fabsf(a - 0.5f)) / q[6] + 0.5f);
    const float cov_b = clamp01((0.5f - fabsf(b - 0.5f)) / q[7] + 0.5f);
    const float qcov = cov_b * cov_a;
    if (qcov == 0.f) {
      // the twin adds texel * colour * 0 here, an exact zero
      out[0] = out[1] = out[2] = out[3] = 0.f;
      return;
    }
    const float tu = __fmaf_rn(clamp01(a), q[10], q[8]) * static_cast<float>(g.w);
    const float tv = __fmaf_rn(clamp01(b), q[11], q[9]) * static_cast<float>(g.h);
    if (g.separable) {
      sample_separable(g, tu, tv, sm);
    } else {
      sample_gather(g, tu, tv, sm);
    }
    float aq;
    if (g.c == 1) {
      aq = sm[0] * s.col[3] * qcov;
      out[0] = s.col[0] * aq;
      out[1] = s.col[1] * aq;
      out[2] = s.col[2] * aq;
    } else {
      aq = sm[3] * s.col[3] * qcov;
      out[0] = sm[0] * s.col[0] * aq;
      out[1] = sm[1] * s.col[1] * aq;
      out[2] = sm[2] * s.col[2] * aq;
    }
    out[3] = aq;
    return;
  }
  const float* m = s.f;
  if (g.separable) {
    const float tu = __fmaf_rn(m[0], ox, m[4]) * static_cast<float>(g.w);
    const float tv = __fmaf_rn(m[3], oy, m[5]) * static_cast<float>(g.h);
    sample_separable(g, tu, tv, sm);
  } else {
    const float tu = (__fmaf_rn(m[0], ox, m[2] * oy) + m[4]) * static_cast<float>(g.w);
    const float tv = (__fmaf_rn(m[1], ox, m[3] * oy) + m[5]) * static_cast<float>(g.h);
    sample_gather(g, tu, tv, sm);
  }
  if (g.c == 1) {
    sm[3] = sm[0];
    sm[0] = sm[1] = sm[2] = 1.f;
  }
  const float alpha = sm[3] * s.col[3];
  out[0] = sm[0] * s.col[0] * alpha;
  out[1] = sm[1] * s.col[1] * alpha;
  out[2] = sm[2] * s.col[2] * alpha;
  out[3] = alpha;
}

// Exclusive prefix sums of the n <= kChunk staged footprints' pixel
// counts into base[0..n] (base[n] the chunk's total), by warp 0,
// kChunk / 32 slots a lane
__device__ __forceinline__ void footprint_bases(const Slot* slots, int n,
                                                int* base) {
  constexpr int kPer = kChunk / 32;
  static_assert(kChunk % 32 == 0 && kChunk <= kThreads, "whole warps of slots");
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int carry = 0;
#pragma unroll
  for (int h = 0; h < kPer; ++h) {
    const int j = lane + 32 * h;
    int area = 0;
    if (j < n) {
      const Slot& s = slots[j];
      area = max(s.x1 - s.x0, 0) * max(s.y1 - s.y0, 0);
    }
    int incl = area;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    base[j] = carry + incl - area;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) base[kChunk] = carry;
}

// buf: the int32 words of ops/sampling_device.DeviceGroups (group table at
// word 0, then the rows, the tile offsets, the clip flags, the tile order,
// the pairs); out: (nct + 1, 4 * th * tw) float32.  Block b takes colour
// tile order[b]: the tiles with the most pairs first, so that the longest
// blocks do not start last.
//
// Per chunk of staged pairs, the (pair, pixel) items inside the footprints
// are numbered pair by pair, row-major inside each footprint (base[j] +
// (r - y0) * (x1 - x0) + (c - x0)), and evaluated kItems at a time, a
// thread an item, into shared memory; then the pairs' items are added into
// the pixels' sums in shared memory pair by pair, the twin's order, a
// thread an item.  So a lane samples and adds only where a quad is, and
// every lane of a warp has an item while items last.
__global__ void __launch_bounds__(kThreads)
sample_tiles_kernel(const int* __restrict__ buf, int rows_at, int offsets_at,
                    int clip_at, int order_at, int pairs_at,
                    float* __restrict__ out, int nct, int th, int tw, float sx,
                    float sy) {
  constexpr int kPass = kThreads * kPix;   // pixels summed in shared memory at a time
  __shared__ Slot slots[kChunk];
  __shared__ int base[kChunk + 1];
  __shared__ float4 items[kItems];
  __shared__ float4 acc[kPass];
  const int t = threadIdx.x;
  const int tile = buf[order_at + blockIdx.x];
  const int npx = th * tw;
  const int begin = tile < nct ? buf[offsets_at + tile] : 0;
  const int end = tile < nct ? buf[offsets_at + tile + 1] : 0;
  const bool clip = tile < nct && buf[clip_at + tile];
  const float* rows = reinterpret_cast<const float*>(buf + rows_at);
  const int* pairs = buf + pairs_at;
  float* o = out + static_cast<size_t>(tile) * 4 * npx;
  for (int pass = 0; pass < npx; pass += kPass) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) acc[k * kThreads + t] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = begin; j0 < end; j0 += kChunk) {
      const int n = min(kChunk, end - j0);
      __syncthreads();   // every thread is done with the last chunk's slots
      if (t < n) {
        const int i = j0 + t;
        setup_pair(load_group(buf, pairs[2 * i + 1]),
                   rows + static_cast<size_t>(pairs[2 * i]) * kRowWords, sx, sy,
                   th, tw, slots[t]);
      }
      __syncthreads();
      footprint_bases(slots, n, base);
      __syncthreads();
      const int total = base[n];
      for (int i0 = 0; i0 < total; i0 += kItems) {
        const int i1 = min(i0 + kItems, total);
#pragma unroll 1
        for (int i = i0 + t; i < i1; i += kThreads) {
          int lo = 0, hi = n - 1;   // the slot j with base[j] <= i < base[j + 1]
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (base[mid] <= i) {
              lo = mid;
            } else {
              hi = mid - 1;
            }
          }
          const Slot& s = slots[lo];
          const int bw = s.x1 - s.x0;
          const int l = i - base[lo];
          const int ly = l / bw;
          float v[4];
          pair_rgba(s, static_cast<float>(s.x0 + l - ly * bw) + 0.5f,
                    static_cast<float>(s.y0 + ly) + 0.5f, v);
          items[i - i0] = make_float4(v[0], v[1], v[2], v[3]);
        }
        for (int j = 0; j < n; ++j) {
          const int b0 = max(base[j], i0), b1 = min(base[j + 1], i1);
          if (b0 >= b1) continue;   // no item of pair j in this round
          __syncthreads();   // the items, and pair j - 1's sums, are written
          const Slot& s = slots[j];
          const int bw = s.x1 - s.x0;
#pragma unroll 1
          for (int i = b0 + t; i < b1; i += kThreads) {
            const int l = i - base[j];
            const int ly = l / bw;
            const int pix = (s.y0 + ly) * tw + s.x0 + (l - ly * bw) - pass;
            if (pix < 0 || pix >= kPass) continue;   // another pass's pixel
            const float4 v = items[i - i0];
            if (s.g.quad) {
              float4& a = acc[pix];
              a.x += v.x;
              a.y += v.y;
              a.z += v.z;
              a.w += v.w;
            } else {
              acc[pix] = v;
            }
          }
        }
        __syncthreads();   // the sums are done and the items read
      }
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int pix = pass + k * kThreads + t;
      if (pix >= npx) continue;
      const float4 a = acc[k * kThreads + t];
      const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        o[static_cast<size_t>(ch) * npx + pix] = clip ? clamp01(v[ch]) : v[ch];
      }
    }
  }
}

}  // namespace

// buf: DeviceGroups' int32 words on `device`; out: (nct + 1) x 4*th*tw
// float32.  Launches on `stream`, does not synchronise; returns
// cudaGetLastError().
extern "C" int vg_sample_tiles(const int* buf, int rows_at, int offsets_at,
                               int clip_at, int order_at, int pairs_at,
                               float* out, int nct, int th, int tw, float sx,
                               float sy, int device, cudaStream_t stream) {
  if (nct < 0 || th < 1 || tw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const vg::DeviceScope scope(device);
  sample_tiles_kernel<<<nct + 1, kThreads, 0, stream>>>(
      buf, rows_at, offsets_at, clip_at, order_at, pairs_at, out, nct, th, tw,
      sx, sy);
  return static_cast<int>(cudaGetLastError());
}
