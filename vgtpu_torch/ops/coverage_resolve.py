"""In-kernel coverage RESOLUTION for the supersampled (conflation-free) path.

Twin of vgtpu/ops/coverage_resolve.py (without the retained-pan
entry_resolve_rparams, which belongs to the pan port).  Every stage between
the coverage kernel and the composite's shading scales with the SUB-row
domain; resolving inside the coverage kernel, where the accumulated winding
is already on chip, shrinks it: per chunk the kernel adds the entry's
backdrop, applies the fill rule / AA threshold / texture force / scissor per
SUB-row, averages each group of ss sub-rows and writes OUTPUT-domain
coverage, (NC, NPX/ss) instead of (NC, NPX).  The composite then reads final
coverage (ops/composite.py, form (e)).

Only chunks whose entry can be fully resolved take this path (one chunk per
entry, no clip in the entry's tile); raster/resolve.py splits the pools.
Multi-chunk non-clip entries ("XE") are resolved after the extras fold by
the same epilogue over gathered rows.

Semantics, expression for expression (vgtpu/ops/coverage_resolve.py:269-286):
cov = min(|w|,1); even-odd 1-|mod(w,2)-1| when the chunk's RP_EO says so;
non-AA >= 0.5; textured quads forced to 1; pixel-centre scissor; the ss
sub-rows of an output row summed in order k = 0..ss-1 and multiplied by 1/ss.
Bucket-lane gating is baked into the per-chunk params on the host.

On a CUDA tensor `cov_split_resolved` launches kernel K3
(csrc/coverage_resolve.cu, via ops/coverage_resolve_cuda.py) once over all
RES pools and once (vg_resolve_rows) over the XE rows, and K1 once over
the RAW pools; on a CPU tensor it runs the plain twins.  Any other device
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from vgtpu_torch.ops.coverage import (
    cov_all_torch,
    coverage_chunks_torch,
    fold_extras,
)

# rparams rows (f32, columns = chunks)
RP_EO = 0        # 1.0: apply the even-odd rule (bucket lane AND entry rule)
RP_NOAA = 1      # 1.0: threshold coverage at 0.5 (bucket lane AND not aa)
RP_TEXF = 2      # 1.0: force coverage to 1 (textured quads carry alpha)
RP_SC = 3        # 3..6 scissor x0,y0,x1,y1 (TILE-LOCAL px; y in sub-rows)
RP_BD = 8        # 8..8+tile_h  per-sub-row backdrop winding
_SC_SENTINEL = 1e9


def rp_rows(tile_h: int) -> int:
    """rparams row count, padded to a multiple of 8 (copied from vgtpu)."""
    return -(-(RP_BD + tile_h) // 8) * 8


def build_chunk_rparams(
    cent: np.ndarray,            # (NC,) chunk -> entry
    entry_rule: np.ndarray,
    entry_aa: np.ndarray,
    entry_paint_kind: np.ndarray,
    entry_scissor: np.ndarray,   # (NE, 4) screen px (sub-row y units)
    entry_backdrop: np.ndarray,  # (NE, tile_h)
    entry_tile: np.ndarray,      # (NE,) flat tile id
    entry_flags,                 # (NE, 4) bool [eo, noaa, tex, scissor] lanes
    *, tile_h: int, tile_w: int, ntx: int,
) -> np.ndarray:
    """(RP_ROWS, NC) per-chunk resolve params (host numpy, copied from
    vgtpu).  entry_flags carries the ENTRY'S BUCKET lane gates so resolution
    matches the lane-specialized composite exactly (a disabled lane is a
    no-op here too)."""
    from vgtpu_torch.raster.binning import P_TEXTURE

    e = np.clip(cent, 0, entry_rule.shape[0] - 1).astype(np.int64)
    nc = len(cent)
    rp = np.zeros((rp_rows(tile_h), nc), np.float32)
    eo_l, noaa_l, tex_l, sc_l = (entry_flags[e, k] for k in range(4))
    rp[RP_EO] = (eo_l & (entry_rule[e] != 0)).astype(np.float32)
    rp[RP_NOAA] = (noaa_l & (entry_aa[e] == 0)).astype(np.float32)
    rp[RP_TEXF] = (tex_l & (entry_paint_kind[e] == P_TEXTURE)).astype(np.float32)
    ox = ((entry_tile[e] % ntx) * tile_w).astype(np.float32)
    oy = ((entry_tile[e] // ntx) * tile_h).astype(np.float32)
    sc = entry_scissor[e].astype(np.float32)
    rp[RP_SC + 0] = np.where(sc_l, sc[:, 0] - ox, -_SC_SENTINEL)
    rp[RP_SC + 1] = np.where(sc_l, sc[:, 1] - oy, -_SC_SENTINEL)
    rp[RP_SC + 2] = np.where(sc_l, sc[:, 2] - ox, _SC_SENTINEL)
    rp[RP_SC + 3] = np.where(sc_l, sc[:, 3] - oy, _SC_SENTINEL)
    rp[RP_BD : RP_BD + tile_h] = entry_backdrop[e].astype(np.float32).T
    return rp


def resolve_cov_rows_torch(w_rows: torch.Tensor, rp: torch.Tensor, *,
                           tile_h: int, tile_w: int, ss: int) -> torch.Tensor:
    """The resolve epilogue: (N, tile_h*tile_w) raw winding (WITHOUT
    backdrop) + (RP_ROWS, N) params -> (N, (tile_h//ss)*tile_w) resolved
    output-domain coverage.  The plain twin of K3's epilogue and of
    vg_resolve_rows."""
    n = w_rows.shape[0]
    dev = w_rows.device
    w = (w_rows.reshape(n, tile_h, tile_w)
         + rp[RP_BD : RP_BD + tile_h].T[:, :, None])
    cov = torch.clamp_max(torch.abs(w), 1.0)
    cov_eo = 1.0 - torch.abs(torch.remainder(w, 2.0) - 1.0)

    def lane(k):
        return rp[k][:, None, None]

    cov = torch.where(lane(RP_EO) > 0, cov_eo, cov)
    cov = torch.where(lane(RP_NOAA) > 0, (cov >= 0.5).to(torch.float32), cov)
    cov = torch.where(lane(RP_TEXF) > 0, 1.0, cov)
    pxl = torch.arange(tile_w, dtype=torch.float32, device=dev)[None, None, :] + 0.5
    pyl = torch.arange(tile_h, dtype=torch.float32, device=dev)[None, :, None] + 0.5
    inside = ((pxl >= lane(RP_SC + 0)) & (pyl >= lane(RP_SC + 1))
              & (pxl < lane(RP_SC + 2)) & (pyl < lane(RP_SC + 3)))
    cov = (cov * inside.to(torch.float32)).reshape(n, tile_h // ss, ss, tile_w)
    c_sum = cov[:, :, 0]
    for k in range(1, ss):                 # the kernel's order, k = 0..ss-1
        c_sum = c_sum + cov[:, :, k]
    return (c_sum * (1.0 / ss)).reshape(n, (tile_h // ss) * tile_w)


def coverage_chunks_res_torch(chunk_edges: torch.Tensor, rparams: torch.Tensor,
                              tile_h: int, tile_w: int, ss: int) -> torch.Tensor:
    """(NC, CH, 4) edges + (RP_ROWS, NC) params -> (NC, NPX_OUT) resolved
    coverage: the plain twin of kernel K3 (K1's accumulation, then the
    epilogue).  tile_h counts sub-rows."""
    nc = chunk_edges.shape[0]
    w = coverage_chunks_torch(chunk_edges, tile_h, tile_w).reshape(nc, -1)
    return resolve_cov_rows_torch(w, rparams, tile_h=tile_h, tile_w=tile_w, ss=ss)


def _plain_backend():
    def res_fn(pools, rps, out, tile_h, tile_w, ss):
        row = 0
        for ce, rp in zip(pools, rps):
            n = int(ce.shape[0])
            if n:
                out[row : row + n] = coverage_chunks_res_torch(ce, rp, tile_h,
                                                               tile_w, ss)
            row += n

    def rows_fn(cov_sub, ids, rp, out, tile_h, tile_w, ss):
        out.copy_(resolve_cov_rows_torch(cov_sub[ids], rp, tile_h=tile_h,
                                         tile_w=tile_w, ss=ss))

    return cov_all_torch, res_fn, rows_fn


def _cuda_backend():
    from vgtpu_torch.ops.coverage_cuda import cov_all_cuda
    from vgtpu_torch.ops.coverage_resolve_cuda import (
        coverage_chunks_res_cuda,
        resolve_rows_cuda,
    )

    return cov_all_cuda, coverage_chunks_res_cuda, resolve_rows_cuda


def _cov_split(chunk_edges: list, res: dict, tile_h: int, tile_w: int,
               ss: int, backend) -> tuple:
    cov_all_fn, res_fn, rows_fn = backend
    k = len(res["rparams"])
    res_pools, raw_pools = chunk_edges[:k], chunk_edges[k:]
    dev = chunk_edges[0].device
    npx, npx_out = tile_h * tile_w, (tile_h // ss) * tile_w
    if raw_pools:
        cov_sub = cov_all_fn(raw_pools, tile_h, tile_w)     # (NXraw+1, NPX)
    else:
        cov_sub = torch.zeros((1, npx), dtype=torch.float32, device=dev)
    fold_extras(cov_sub, {"extra_chunk": res["extra_chunk_raw"],
                          "extra_primary": res["extra_primary_raw"]})
    nr = sum(int(ce.shape[0]) for ce in res_pools)
    nxe = int(res["xe_primary_raw"].shape[0])
    cov_final = torch.empty((nr + nxe + 1, npx_out), dtype=torch.float32,
                            device=dev)
    cov_final[nr + nxe].zero_()             # the dead row
    if res_pools:
        res_fn(res_pools, res["rparams"], cov_final[:nr], tile_h, tile_w, ss)
    rows_fn(cov_sub, res["xe_primary_raw"], res["xe_rparams"],
            cov_final[nr : nr + nxe], tile_h, tile_w, ss)
    return cov_final, cov_sub


def cov_split_resolved(chunk_edges: list, res: dict, tile_h: int, tile_w: int,
                       ss: int) -> tuple:
    """Device coverage for a resolve-split plan (raster/resolve.py), the K3
    dispatcher: kernels K3 and K1 on CUDA, the plain twins on the CPU.

    chunk_edges: every pool, the res["rparams"]-many RES pools first.
    Returns
      cov_final (NR + NXE_P + 1, NPX_OUT) — RES rows (K3), XE rows
          (vg_resolve_rows over the folded cov_sub), the zero dead row, all
          written into one preallocated tensor;
      cov_sub  (NXraw + 1, NPX) — RAW pools (K1) + dead row, extras folded.
    """
    dev = chunk_edges[0].device
    if dev.type == "cuda":
        backend = _cuda_backend()
    elif dev.type == "cpu":
        backend = _plain_backend()
    else:
        raise ValueError(f"cov_split_resolved: unsupported device {dev}")
    return _cov_split(chunk_edges, res, tile_h, tile_w, ss, backend)


def cov_split_resolved_torch(chunk_edges: list, res: dict, tile_h: int,
                             tile_w: int, ss: int) -> tuple:
    """cov_split_resolved through the plain twins on the tensors' own device
    (the reference the CUDA path is held against)."""
    return _cov_split(chunk_edges, res, tile_h, tile_w, ss, _plain_backend())
