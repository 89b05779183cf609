"""Analytic winding-coverage accumulation (device half of the port).

Twin of vgtpu/ops/coverage.py: each edge's exact box-filtered signed-area
contribution is accumulated per pixel of an 8x128 tile, chunk by chunk (see
ARCHITECTURE.md for the derivation).  Chunks of the same entry sum
independently, so every chunk is CHUNK edges by TH*TW pixels.

Input layout (from vgtpu_torch.raster.binning):
  chunk_edges: (NC, CHUNK, 4) f32 — edge segments, tile-origin-relative

On a CUDA tensor `cov_all` launches kernel K1 (csrc/coverage.cu, via
ops/coverage_cuda.py); on a CPU tensor it runs the plain torch twin
`cov_all_torch`.  Any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-6


def fma(a, b, c):
    """a*b + c rounded once to float32 (a fused multiply-add), computed in
    float64: the 48-bit product is exact there."""
    return (a.double() * b.double() + c.double()).float()


def _edge_contribution(px, py, x0, y0, x1, y1):
    """Signed pixel-area contribution of one edge batch to pixel grid
    (px, py); the expressions and their order are vgtpu's
    _edge_contribution.

    The G-form divides by m, so an ulp of error in u is amplified up to
    1/0.01 = 100x in the result (pixels far right of a near-vertical edge).
    The two a*b+c sites that XLA on the CPU contracts into fused
    multiply-adds — x(ytop) and u1 — are therefore written as explicit FMAs
    here and in kernel K1, which is built without other contraction; the
    twin then tracks XLA's rounding instead of differing by ~1e-4."""
    ymin = torch.minimum(y0, y1)
    ymax = torch.maximum(y0, y1)
    s = torch.sign(y1 - y0)
    dy = y1 - y0
    m = (x1 - x0) / torch.where(torch.abs(dy) < _EPS, 1.0, dy)
    steep = torch.abs(m) < 0.01
    s_over_m = s / torch.where(steep, 1.0, m)     # per-edge scalars

    ytop = torch.maximum(ymin, py)
    h = torch.clamp_min(torch.minimum(ymax, py + 1.0) - ytop, 0.0)
    u0 = (px + 1.0) - fma(m, ytop - y0, x0)
    u1 = fma(-m, h, u0)

    c0 = torch.clamp(u0, 0.0, 1.0)
    c1 = torch.clamp(u1, 0.0, 1.0)
    g0 = c0 * (u0 - 0.5 * c0)
    g1 = c1 * (u1 - 0.5 * c1)
    general = (g0 - g1) * s_over_m
    vertical = s * h * c0
    return torch.where(steep, vertical, general)


def coverage_chunks_torch(chunk_edges: torch.Tensor, tile_h: int = 8,
                          tile_w: int = 128) -> torch.Tensor:
    """(NC, CH, 4) edges -> (NC, TH, TW) summed winding contributions: the
    plain twin of vgtpu's coverage_chunks_body and of kernel K1.  Edges are
    summed in slot order, as the scan does."""
    nc, ch, _ = chunk_edges.shape
    dev = chunk_edges.device
    px = torch.arange(tile_w, dtype=torch.float32, device=dev).expand(tile_h, tile_w)
    py = torch.arange(tile_h, dtype=torch.float32, device=dev)[:, None].expand(tile_h, tile_w)
    acc = torch.zeros((nc, tile_h, tile_w), dtype=torch.float32, device=dev)
    for e in range(ch):
        x0, y0, x1, y1 = (chunk_edges[:, e, k][:, None, None] for k in range(4))
        acc = acc + _edge_contribution(px, py, x0, y0, x1, y1)
    return acc


def build_cov_gather_map(chunk_pools, num_entries: int) -> dict:
    """Host-side (numpy) inverse of the chunk->entry map (copied from
    vgtpu/ops/coverage.py).

    Most entries own exactly ONE chunk, so the chunk->entry reduction is a
    near-permutation: entry coverage = one gather of each entry's primary
    chunk + a small scatter-add of the leftover chunks of multi-chunk
    entries.

    Returns numpy arrays:
      primary (NE,) i32   — global chunk id per entry (dead id = all-zeros)
      extra_chunk (K,)    — leftover chunk ids (padded with the dead id)
      extra_entry (K,)    — their entries (padded with NE-1, a pad entry)
      extra_primary (K,)  — the rows the extras fold into (cov_all_resolved)
    """
    from vgtpu_torch.raster.binning import _bucket

    cents = [np.asarray(cent) for _ce, cent in chunk_pools]
    cent_all = np.concatenate(cents) if cents else np.zeros(0, np.int64)
    total = len(cent_all)
    # liveness: a chunk with only zero-height edges contributes exactly zero
    alive = np.concatenate([
        (np.abs(np.asarray(ce)[:, :, 3] - np.asarray(ce)[:, :, 1]) > 1e-12).any(axis=1)
        for ce, _cent in chunk_pools
    ]) if cents else np.zeros(0, bool)

    dead_id = total             # index of the appended all-zeros row
    primary = np.full(num_entries, dead_id, np.int32)
    # first chunk per entry without a sort: reversed assignment makes the
    # FIRST occurrence win
    valid = (cent_all >= 0) & (cent_all < num_entries)
    idxs = np.arange(total, dtype=np.int32)
    primary[cent_all[valid][::-1]] = idxs[valid][::-1]
    is_first = np.zeros(total, bool)
    first_idx = primary[cent_all[valid]]
    is_first[first_idx] = True
    em = alive & ~is_first
    extra_chunk = np.nonzero(em)[0].astype(np.int32)
    extra_entry = cent_all[em].astype(np.int32)
    k = _bucket(max(len(extra_chunk), 1), minimum=8)
    ec = np.full(k, dead_id, np.int32)
    ee = np.full(k, num_entries - 1, np.int32)   # pad entry: zero adds land there
    ec[: len(extra_chunk)] = extra_chunk
    ee[: len(extra_entry)] = extra_entry
    return {
        "primary": primary,
        "extra_chunk": ec,
        "extra_entry": ee,
        "extra_primary": primary[ee],
    }


def cov_all_torch(chunk_edges: list, tile_h: int, tile_w: int) -> torch.Tensor:
    """All pools' per-chunk coverage as ONE (NC+1, NPX) tensor, the last row
    the all-zeros dead chunk that chunkless entries index: the plain twin of
    vgtpu's _cov_all, on the tensors' own device."""
    npx = tile_h * tile_w
    covs = [coverage_chunks_torch(ce, tile_h, tile_w).reshape(-1, npx)
            for ce in chunk_edges]
    covs.append(torch.zeros((1, npx), dtype=torch.float32,
                            device=chunk_edges[0].device))
    return torch.cat(covs, dim=0)


def cov_all(chunk_edges: list, tile_h: int, tile_w: int) -> torch.Tensor:
    """(NC+1, NPX) chunk coverage of every pool: kernel K1 on CUDA (every
    pool, written in place into one preallocated tensor), the plain twin on
    the CPU."""
    dev = chunk_edges[0].device
    if dev.type == "cuda":
        from vgtpu_torch.ops.coverage_cuda import cov_all_cuda

        return cov_all_cuda(chunk_edges, tile_h, tile_w)
    if dev.type == "cpu":
        return cov_all_torch(chunk_edges, tile_h, tile_w)
    raise ValueError(f"cov_all: unsupported device {dev}")


def fold_extras(cov: torch.Tensor, cov_map: dict) -> torch.Tensor:
    """Fold multi-chunk entries' extra chunk rows into their primary row, in
    place on `cov` (returned).  The sources are gathered before the add, as
    in vgtpu's `.at[extra_primary].add(cov_all[extra_chunk])`; primary rows
    are unique per entry and extra rows are only ever sources."""
    src = cov.index_select(0, cov_map["extra_chunk"])
    return cov.index_add_(0, cov_map["extra_primary"], src)


def cov_all_resolved(chunk_edges: list, cov_map: dict, tile_h: int,
                     tile_w: int) -> torch.Tensor:
    """Chunk coverage with extras folded in, so entry coverage ==
    cov_all[primary[e]]: the fused composite gathers straight from it and
    the (NE, NPX) entry coverage is never materialized."""
    return fold_extras(cov_all(chunk_edges, tile_h, tile_w), cov_map)


def cov_all_resolved_torch(chunk_edges: list, cov_map: dict, tile_h: int,
                           tile_w: int) -> torch.Tensor:
    """cov_all_resolved through the plain twin, on the tensors' own device
    (the reference the CUDA path is held against)."""
    return fold_extras(cov_all_torch(chunk_edges, tile_h, tile_w), cov_map)
