// K3: chunk winding coverage with the resolve epilogue, for supersampled
// (ss > 1) frames.
//
// Replaces the Pallas TPU kernel vgtpu/ops/coverage_resolve.py::_kernel_t2_res
// (driven by coverage_chunks_pallas_res).  Same function: for chunk c of CH
// tile-local edges over a tile of TH = ss * TH_OUT sub-rows, K1's winding
// (csrc/edge_coverage.cuh, summed in edge order) per sub-pixel, then per
// sub-row, in the order of coverage_resolve.py:269-286:
//   w = winding + backdrop[r]             (rparams row RP_BD + r)
//   cov = min(|w|, 1); even-odd 1-|mod(w,2)-1| (floored mod, as jnp.mod)
//   non-AA threshold >= 0.5; textured quads forced to 1
//   pixel-centre scissor on the sub-row centre (tile-local, sub-row y)
// and the ss sub-rows of an output row summed in order k = 0..ss-1 and
// multiplied by 1/ss.  Output: chunk-major (NC, TH_OUT*TW) final coverage.
// The plain twin is vgtpu_torch/ops/coverage_resolve.py::
// coverage_chunks_res_torch.
//
// A second entry point, vg_resolve_rows, applies the same epilogue to rows
// gathered by id from the folded sub-row coverage (the multi-chunk "XE"
// entries, whose total winding exists only after the extras fold); its twin
// is resolve_cov_rows_torch.  The epilogue is one __device__ function.
//
// What bounds it on an H100: arithmetic, as K1.  Per output pixel it costs
// ss * CH edge evaluations (~25 float ops each) plus ~15 ops of epilogue per
// sub-pixel, and it writes 1/ss of K1's bytes; the edge lists and params are
// a few hundred bytes per chunk.  Far from the 3.35 TB/s roof; limited by
// FP32 issue rate and occupancy.
//
// Design: the TPU kernel keeps a (NPX, BC) VMEM accumulator across a grid
// axis of edge slots, then transposes; none of that survives.  One block per
// group of kChunksPerBlock chunks stages each chunk's per-edge scalars and
// its rparams column (RP_ROWS x NC, a strided column, read once per block)
// in shared memory.  Tiles of up to kStaticTh = 64 sub-rows (every tile at
// tile_h 8, the default) stage the rparams in a static array with a
// compile-time row stride; taller tiles (up to 256 sub-rows: tile_h 32 at
// ss = 8) take an instantiation whose staging is dynamic shared memory
// sized at launch, kChunksPerBlock * (RP_BD + TH) floats, so no tile
// height vgtpu admits is refused (ops/coverage_resolve_cuda.k3_geometry
// mirrors the sizing).  The static form keeps the source of the kernel as
// it was before the dynamic one existed: builds that reached the staging
// through one pointer for both forms compiled to a reordered body whose
// 1080p ss=2 launches took ~5% more device time (NVIDIA H100 80GB HBM3,
// 700 W).  One thread owns an output pixel (column x of output row ro):
// it accumulates the winding of its ss sub-pixels over the CH edges in a
// register, one sub-row after the other, resolves each, sums them and
// stores one float — consecutive threads store consecutive pixels, so the
// store coalesces.  No accumulator round-trips memory.
//
// Rounding: as K1 (the two explicit __fmaf_rn, -fmad=false, IEEE division);
// 1/ss is a power of two, so the final product is exact.

#include <cuda_runtime.h>

#include "common.cuh"
#include "edge_coverage.cuh"

namespace {

constexpr int kChunksPerBlock = 4;
constexpr int kMaxCh = 32;
constexpr int kThreads = 256;
// rparams rows (vgtpu/ops/coverage_resolve.py RP_*)
constexpr int RP_EO = 0, RP_NOAA = 1, RP_TEXF = 2, RP_SC = 3, RP_BD = 8;
constexpr int kStaticTh = 64;  // sub-rows the static rparams staging holds

struct ResolveParams {
  float eo, noaa, texf, sx0, sy0, sx1, sy1;
};

// One sub-pixel's resolved coverage from its total winding w (backdrop
// included) at tile-local pixel centre (pxl, pyl).
__device__ __forceinline__ float resolve_sub(float w, const ResolveParams& r,
                                             float pxl, float pyl) {
  float cov = fminf(fabsf(w), 1.f);
  const float md = w - 2.f * floorf(w * 0.5f);  // floored, as jnp.mod
  const float cov_eo = 1.f - fabsf(md - 1.f);
  cov = r.eo > 0.f ? cov_eo : cov;
  cov = r.noaa > 0.f ? (cov >= 0.5f ? 1.f : 0.f) : cov;
  cov = r.texf > 0.f ? 1.f : cov;
  const bool inside =
      (pxl >= r.sx0) && (pyl >= r.sy0) && (pxl < r.sx1) && (pyl < r.sy1);
  return cov * (inside ? 1.f : 0.f);
}

// kRows > 0: each chunk's rparams column is staged in a static array of
// kRows rows (tiles of up to kRows - RP_BD sub-rows); kRows == 0: in dynamic
// shared memory of RP_BD + TH rows per chunk, sized at launch.
template <int kRows>
__global__ void __launch_bounds__(kThreads)
coverage_res_kernel(const float* __restrict__ edges,
                    const float* __restrict__ rp, float* __restrict__ out,
                    int nc, int ch, int tile_w, int ss, int th_out) {
  __shared__ float sp[kChunksPerBlock][kMaxCh][vg::kEdgeScalars];
  __shared__ float srp[kChunksPerBlock][kRows > 0 ? kRows : 1];
  const int c0 = blockIdx.x * kChunksPerBlock;
  const int th = th_out * ss;
  const int nrp = RP_BD + th;

  for (int i = threadIdx.x; i < kChunksPerBlock * ch; i += blockDim.x) {
    const int lc = i / ch;
    const int e = i - lc * ch;
    const int c = c0 + lc;
    if (c >= nc) continue;
    vg::stage_edge(edges + (static_cast<size_t>(c) * ch + e) * 4, sp[lc][e]);
  }
  // rparams column of each chunk; neighbouring threads read neighbouring
  // chunks of one row
  for (int i = threadIdx.x; i < kChunksPerBlock * nrp; i += blockDim.x) {
    const int k = i / kChunksPerBlock;
    const int lc = i - k * kChunksPerBlock;
    const int c = c0 + lc;
    if (c < nc) {
      if constexpr (kRows > 0) {
        srp[lc][k] = rp[static_cast<size_t>(k) * nc + c];
      } else {
        extern __shared__ float srp_dynamic[];
        srp_dynamic[lc * nrp + k] = rp[static_cast<size_t>(k) * nc + c];
      }
    }
  }
  __syncthreads();

  const int npx_out = th_out * tile_w;
  const float inv_ss = 1.f / static_cast<float>(ss);
  for (int lc = 0; lc < kChunksPerBlock; ++lc) {
    const int c = c0 + lc;
    if (c >= nc) break;
    const float* q;
    if constexpr (kRows > 0) {
      q = srp[lc];
    } else {
      extern __shared__ float srp_dynamic[];
      q = srp_dynamic + lc * nrp;
    }
    const ResolveParams r{q[RP_EO],     q[RP_NOAA],   q[RP_TEXF],   q[RP_SC],
                          q[RP_SC + 1], q[RP_SC + 2], q[RP_SC + 3]};
    float* orow = out + static_cast<size_t>(c) * npx_out;
    for (int p = threadIdx.x; p < npx_out; p += blockDim.x) {
      const int ro = p / tile_w;
      const float px = static_cast<float>(p - ro * tile_w);
      float c_sum = 0.f;
      for (int k = 0; k < ss; ++k) {
        const int sr = ro * ss + k;
        const float py = static_cast<float>(sr);
        float acc = 0.f;
        for (int e = 0; e < ch; ++e) acc += vg::edge_contribution(sp[lc][e], px, py);
        const float cv = resolve_sub(acc + q[RP_BD + sr], r, px + 0.5f, py + 0.5f);
        c_sum = k == 0 ? cv : c_sum + cv;
      }
      orow[p] = c_sum * inv_ss;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
resolve_rows_kernel(const float* __restrict__ cov_sub,
                    const int* __restrict__ ids, const float* __restrict__ rp,
                    float* __restrict__ out, int n, int tile_w, int ss,
                    int th_out) {
  const int i = blockIdx.x;
  const int npx_out = th_out * tile_w;
  const float* src = cov_sub + static_cast<size_t>(ids[i]) * npx_out * ss;
  // block-uniform loads of row i's params column (RP_ROWS, n)
  auto P = [&](int k) { return __ldg(rp + static_cast<size_t>(k) * n + i); };
  const ResolveParams r{P(RP_EO),     P(RP_NOAA),   P(RP_TEXF),   P(RP_SC),
                        P(RP_SC + 1), P(RP_SC + 2), P(RP_SC + 3)};
  const float inv_ss = 1.f / static_cast<float>(ss);
  for (int p = threadIdx.x; p < npx_out; p += blockDim.x) {
    const int ro = p / tile_w;
    const int x = p - ro * tile_w;
    float c_sum = 0.f;
    for (int k = 0; k < ss; ++k) {
      const int sr = ro * ss + k;
      const float cv = resolve_sub(src[sr * tile_w + x] + P(RP_BD + sr), r,
                                   static_cast<float>(x) + 0.5f,
                                   static_cast<float>(sr) + 0.5f);
      c_sum = k == 0 ? cv : c_sum + cv;
    }
    out[static_cast<size_t>(i) * npx_out + p] = c_sum * inv_ss;
  }
}

}  // namespace

// edges: (nc, ch, 4) f32; rp: (RP_BD + th rows padded, nc) f32, row stride
// nc; out: (nc, th_out*tile_w) f32 rows (a row range of the caller's
// cov_final); all on `device`.  ch <= 32 (checked by the Python wrapper,
// which also computes smem_bytes, the launch's dynamic shared memory, with
// k3_geometry: 0 up to kStaticTh sub-rows, else the staging's bytes; a
// value other than this file's sizing is refused).  Launches on `stream`,
// does not synchronise; returns cudaGetLastError().
extern "C" int vg_coverage_chunks_res(const float* edges, const float* rp,
                                      float* out, int nc, int ch, int tile_w,
                                      int ss, int th_out, int smem_bytes,
                                      int device, cudaStream_t stream) {
  const int th = th_out * ss;
  const size_t smem = th <= kStaticTh ? 0 : sizeof(float) * kChunksPerBlock *
                                                static_cast<size_t>(RP_BD + th);
  if (ch < 1 || ch > kMaxCh || ss < 1 || th_out < 1 ||
      smem != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vg::DeviceScope scope(device);
  if (nc > 0) {
    const int blocks = (nc + kChunksPerBlock - 1) / kChunksPerBlock;
    if (th <= kStaticTh) {
      coverage_res_kernel<RP_BD + kStaticTh><<<blocks, kThreads, 0, stream>>>(
          edges, rp, out, nc, ch, tile_w, ss, th_out);
    } else {
      static unsigned raised = 0;
      if (smem > 48 * 1024) {
        vg::allow_dynamic_smem(coverage_res_kernel<0>, &raised);
      }
      coverage_res_kernel<0><<<blocks, kThreads, smem, stream>>>(
          edges, rp, out, nc, ch, tile_w, ss, th_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// cov_sub: (R, th_out*ss*tile_w) f32 folded sub-row coverage; ids: (n,) i32
// rows of cov_sub; rp: (RP_ROWS, n) f32, row stride n; out: (n,
// th_out*tile_w) f32 rows; all on `device`.  Launches on `stream`, does not
// synchronise; returns cudaGetLastError().
extern "C" int vg_resolve_rows(const float* cov_sub, const int* ids,
                               const float* rp, float* out, int n, int tile_w,
                               int ss, int th_out, int device,
                               cudaStream_t stream) {
  if (ss < 1 || th_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const vg::DeviceScope scope(device);
  if (n > 0) {
    resolve_rows_kernel<<<n, kThreads, 0, stream>>>(cov_sub, ids, rp, out, n,
                                                    tile_w, ss, th_out);
  }
  return static_cast<int>(cudaGetLastError());
}
