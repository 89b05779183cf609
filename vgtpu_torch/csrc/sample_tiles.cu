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
// (1.5 MB for the 1080p frame's 94 rows, ~0.5 us at 3.35 TB/s), and one
// launch's latency.  Each output pixel of each pair reads two to four texels
// of a texture that stays in L2 (the atlas is 1 MB as float32).
//
// Design: one pass, no weights in device memory.
// - Tile-major, no atomics: blockIdx.x is a colour tile (the last block row
//   writes the zeros row that pad and untextured slots read), blockIdx.y a
//   run of kThreads of its TH*TW output pixels, one thread a pixel.  The
//   host sorts the (entry, quad) pairs by tile, keeping their row order
//   inside a tile (ops/sampling_device.build_tile_index): the order in which
//   the twin's index_add_ adds them on the CPU.  Pad rows are not indexed.
// - Per pixel, the twin's texel coordinates, then a two-tap lookup per axis:
//   the hat (bilinear) or indicator (nearest) weight that the twin's dense
//   weight tensor holds is zero outside the two taps, so evaluating the
//   twin's weight formula at the taps gives the same weights.  Rotated
//   groups take the twin's exact gather (_sample_gather).
// - Every group form in one code path: each pair reads its group's row of
//   the table (texture pointer, h, w, C, flags, kind, separable) and adapts
//   to it: glyph and image quads (P_TEXTURE: coverage, colour modulation,
//   summed, A8 or RGBA), pattern fills (P_IMAGE: the tile's one entry,
//   written), separable or not, nearest or bilinear, clamp or repeat.
// - A quad's pixel whose coverage is 0 skips the lookup: the twin adds an
//   exact zero there, so the sum is the same.
// - The sums stay in registers; a tile of textured quads is clamped to
//   [0, 1] (the twin's clipmask); the thread writes its pixel channel-major,
//   out[tile, ch * TH*TW + pixel], K2's colour-tile layout.
// Rounding: float32 throughout, -fmad=false, and the twin's fused sites
// (ops/coverage.fma) as __fmaf_rn; nearest rounds half to even (rintf, as
// torch.round), repeat wraps by floor modulo (fmodf then + size, as
// torch.remainder), hypot in double (as the CPU's hypotf).  Only the
// separable product's summation order differs from the twin's matrix
// products: a few float32 ulps.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
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

// One pair's premultiplied RGBA at one output pixel: sample_groups' body
// for one (entry, quad) row p of group g; (ox, oy) is the pixel centre,
// the twin's (tile origin + shift) + centre
__device__ __forceinline__ void pair_rgba(const Group& g, const float* p,
                                          float ox, float oy, float* out) {
  const float* col = p + 12;
  float s[4];
  if (g.quad) {
    const float p0x = p[2], p0y = p[3];
    const float exx = p[4], exy = p[5], eyx = p[6], eyy = p[7];
    const float u0 = p[8], v0 = p[9], u1 = p[10], v1 = p[11];
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
    const float rx = ox - p0x, ry = oy - p0y;
    const float a = g.separable ? i00 * rx : i00 * rx + i01 * ry;
    const float b = g.separable ? i11 * ry : i10 * rx + i11 * ry;
    const float cov_a = clamp01((0.5f - fabsf(a - 0.5f)) / wa + 0.5f);
    const float cov_b = clamp01((0.5f - fabsf(b - 0.5f)) / wb + 0.5f);
    const float qcov = cov_b * cov_a;
    if (qcov == 0.f) {
      // outside the quad: the twin adds texel * colour * 0, an exact zero,
      // so the lookup is skipped (most of a tile's pixels for a glyph)
      out[0] = out[1] = out[2] = out[3] = 0.f;
      return;
    }
    const float tu = __fmaf_rn(clamp01(a), u1 - u0, u0) * static_cast<float>(g.w);
    const float tv = __fmaf_rn(clamp01(b), v1 - v0, v0) * static_cast<float>(g.h);
    if (g.separable) {
      sample_separable(g, tu, tv, s);
    } else {
      sample_gather(g, tu, tv, s);
    }
    float aq;
    if (g.c == 1) {
      aq = s[0] * col[3] * qcov;
      out[0] = col[0] * aq;
      out[1] = col[1] * aq;
      out[2] = col[2] * aq;
    } else {
      aq = s[3] * col[3] * qcov;
      out[0] = s[0] * col[0] * aq;
      out[1] = s[1] * col[1] * aq;
      out[2] = s[2] * col[2] * aq;
    }
    out[3] = aq;
    return;
  }
  const float m0 = p[2], m1 = p[3], m2 = p[4], m3 = p[5], m4 = p[6], m5 = p[7];
  if (g.separable) {
    const float tu = __fmaf_rn(m0, ox, m4) * static_cast<float>(g.w);
    const float tv = __fmaf_rn(m3, oy, m5) * static_cast<float>(g.h);
    sample_separable(g, tu, tv, s);
  } else {
    const float tu = (__fmaf_rn(m0, ox, m2 * oy) + m4) * static_cast<float>(g.w);
    const float tv = (__fmaf_rn(m1, ox, m3 * oy) + m5) * static_cast<float>(g.h);
    sample_gather(g, tu, tv, s);
  }
  if (g.c == 1) {
    s[3] = s[0];
    s[0] = s[1] = s[2] = 1.f;
  }
  const float alpha = s[3] * col[3];
  out[0] = s[0] * col[0] * alpha;
  out[1] = s[1] * col[1] * alpha;
  out[2] = s[2] * col[2] * alpha;
  out[3] = alpha;
}

// buf: the int32 words of ops/sampling_device.DeviceGroups (group table at
// word 0, then the rows, the tile offsets, the clip flags, the pairs);
// out: (nct + 1, 4 * th * tw) float32.
__global__ void __launch_bounds__(kThreads)
sample_tiles_kernel(const int* __restrict__ buf, int rows_at, int offsets_at,
                    int clip_at, int pairs_at, float* __restrict__ out,
                    int nct, int th, int tw, float sx, float sy) {
  const int tile = blockIdx.x;
  const int npx = th * tw;
  const int pix = blockIdx.y * kThreads + threadIdx.x;
  if (pix >= npx) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (tile < nct) {
    const int r = pix / tw, c = pix - r * tw;
    const float cx = static_cast<float>(c) + 0.5f;
    const float cy = static_cast<float>(r) + 0.5f;
    const float* rows = reinterpret_cast<const float*>(buf + rows_at);
    const int* pairs = buf + pairs_at;
    const int end = buf[offsets_at + tile + 1];
    for (int i = buf[offsets_at + tile]; i < end; ++i) {
      const int row = pairs[2 * i], grp = pairs[2 * i + 1];
      const Group g = load_group(buf, grp);
      const float* p = rows + static_cast<size_t>(row) * kRowWords;
      float v[4];
      pair_rgba(g, p, (p[0] + sx) + cx, (p[1] + sy) + cy, v);
      if (g.quad) {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) acc[ch] += v[ch];
      } else {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) acc[ch] = v[ch];
      }
    }
    if (buf[clip_at + tile]) {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) acc[ch] = clamp01(acc[ch]);
    }
  }
  float* o = out + static_cast<size_t>(tile) * 4 * npx + pix;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) o[static_cast<size_t>(ch) * npx] = acc[ch];
}

}  // namespace

// buf: DeviceGroups' int32 words on `device`; out: (nct + 1) x 4*th*tw
// float32.  Launches on `stream`, does not synchronise; returns
// cudaGetLastError().
extern "C" int vg_sample_tiles(const int* buf, int rows_at, int offsets_at,
                               int clip_at, int pairs_at, float* out, int nct,
                               int th, int tw, float sx, float sy, int device,
                               cudaStream_t stream) {
  if (nct < 0 || th < 1 || tw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const vg::DeviceScope scope(device);
  const dim3 grid(nct + 1, (th * tw + kThreads - 1) / kThreads);
  sample_tiles_kernel<<<grid, kThreads, 0, stream>>>(
      buf, rows_at, offsets_at, clip_at, pairs_at, out, nct, th, tw, sx, sy);
  return static_cast<int>(cudaGetLastError());
}
