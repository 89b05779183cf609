"""Analytic winding-coverage accumulation (device half of the port).

Twin of vgtpu/ops/coverage.py: each edge's exact box-filtered signed-area
contribution is accumulated per pixel of an 8x128 tile, chunk by chunk (see
ARCHITECTURE.md for the derivation).  Chunks of the same entry sum
independently, so every chunk is CHUNK edges by TH*TW pixels.

Input layout (from vgtpu_torch.raster.binning):
  chunk_edges: (NC, CHUNK, 4) f32 — edge segments, tile-origin-relative

On a CUDA tensor `cov_all` launches kernel K1 (csrc/coverage.cu, via
ops/coverage_cuda.py; one launch over every pool), `coverage_chunks`
kernel K6 (csrc/coverage_slots.cu, via ops/coverage_slots_cuda.py),
`coverage_pools_t` kernel K4 (csrc/coverage_t.cu, via
ops/coverage_t_cuda.py; one launch over every pool) and `coverage_chunks_t`
K4 on one pool or, with variant="flat", K5 (csrc/coverage_t_flat.cu, via
ops/coverage_t_flat_cuda.py); on a CPU tensor they run the plain torch
twins `cov_all_torch`, `coverage_chunks_torch` and
`coverage_chunks_t_torch`.  Any other device raises.
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


def edge_row_live(chunk_edges: torch.Tensor, tile_h: int,
                  row0: int = 0) -> torch.Tensor:
    """(NC, CH, TH) bool: edge e of chunk c spans tile row row0 + r (h > 0,
    by _edge_contribution's own expressions).  These are the row masks
    kernels K1, K3 and K4 walk, a window of rows from row0 at a time: an
    edge with h == 0 on a row adds exactly +0 or -0 to each of its pixels,
    which leaves the edge-order sum bit for bit as it was."""
    y0, y1 = chunk_edges[:, :, 1:2], chunk_edges[:, :, 3:4]
    py = torch.arange(row0, row0 + tile_h, dtype=torch.float32,
                      device=chunk_edges.device)
    ytop = torch.maximum(torch.minimum(y0, y1), py)
    h = torch.clamp_min(torch.minimum(torch.maximum(y0, y1), py + 1.0) - ytop, 0.0)
    return h > 0


def _padding_chunks(chunk_edges: torch.Tensor):
    """The indices of the chunks that hold a nonzero coordinate, or None
    when every chunk does.  An all-zero chunk (a pool's padding) sums to +0
    at every pixel: each zero edge adds s * h * c0 = +0 to a sum that
    starts at +0.  So the twins evaluate only the others and leave +0 in
    the rest, bit for bit the dense result, at a fraction of its cost for a
    deep pool padded to 128 chunks."""
    keep = chunk_edges.flatten(1).ne(0).any(dim=1).nonzero().flatten()
    return None if keep.numel() == chunk_edges.shape[0] else keep


def coverage_chunks_torch(chunk_edges: torch.Tensor, tile_h: int = 8,
                          tile_w: int = 128) -> torch.Tensor:
    """(NC, CH, 4) edges -> (NC, TH, TW) summed winding contributions: the
    plain twin of vgtpu's coverage_chunks_body and of kernels K1 and K6.
    Edges are summed in slot order, as the scan does."""
    nc, ch, _ = chunk_edges.shape
    keep = _padding_chunks(chunk_edges)
    if keep is not None:
        out = torch.zeros((nc, tile_h, tile_w), dtype=torch.float32,
                          device=chunk_edges.device)
        if keep.numel():
            out[keep] = coverage_chunks_torch(chunk_edges[keep], tile_h, tile_w)
        return out
    dev = chunk_edges.device
    px = torch.arange(tile_w, dtype=torch.float32, device=dev).expand(tile_h, tile_w)
    py = torch.arange(tile_h, dtype=torch.float32, device=dev)[:, None].expand(tile_h, tile_w)
    acc = torch.zeros((nc, tile_h, tile_w), dtype=torch.float32, device=dev)
    for e in range(ch):
        x0, y0, x1, y1 = (chunk_edges[:, e, k][:, None, None] for k in range(4))
        acc = acc + _edge_contribution(px, py, x0, y0, x1, y1)
    return acc


def coverage_chunks_t_torch(chunk_edges: torch.Tensor, tile_h: int = 8,
                            tile_w: int = 128) -> torch.Tensor:
    """(NC, CH, 4) edges -> (TH*TW, NC) pixel-major coverage: the plain twin
    of kernels K4 and K5 and of vgtpu's coverage_chunks_pallas_t_raw
    (_kernel_t2 and _kernel_t).  The same arithmetic as
    coverage_chunks_torch, in edge order: _kernel_t2's
    (g0 - g1) * b_gen + a_vert * c0 always has one exact-zero term, so it
    equals the select form of _edge_contribution bit for bit."""
    nc, ch, _ = chunk_edges.shape
    dev = chunk_edges.device
    keep = _padding_chunks(chunk_edges)
    if keep is not None:
        out = torch.zeros((tile_h * tile_w, nc), dtype=torch.float32, device=dev)
        if keep.numel():
            out[:, keep] = coverage_chunks_t_torch(chunk_edges[keep], tile_h, tile_w)
        return out
    flat = torch.arange(tile_h * tile_w, device=dev)
    px = (flat % tile_w).to(torch.float32)[:, None]        # (NPX, 1)
    py = (flat // tile_w).to(torch.float32)[:, None]
    acc = torch.zeros((tile_h * tile_w, nc), dtype=torch.float32, device=dev)
    for e in range(ch):
        x0, y0, x1, y1 = (chunk_edges[:, e, k][None, :] for k in range(4))
        acc = acc + _edge_contribution(px, py, x0, y0, x1, y1)
    return acc


def coverage_chunks(chunk_edges: torch.Tensor, tile_h: int = 8,
                    tile_w: int = 128) -> torch.Tensor:
    """(NC, TH, TW) chunk coverage: the counterpart of vgtpu's
    coverage_chunks_pallas, kernel K6 on CUDA, the plain twin on the CPU.
    Both sum the edges in slot order."""
    dev = chunk_edges.device
    if dev.type == "cuda":
        from vgtpu_torch.ops.coverage_slots_cuda import coverage_chunks_slots_cuda

        return coverage_chunks_slots_cuda(chunk_edges, tile_h, tile_w)
    if dev.type == "cpu":
        return coverage_chunks_torch(chunk_edges, tile_h, tile_w)
    raise ValueError(f"coverage_chunks: unsupported device {dev}")


def coverage_chunks_t(chunk_edges: torch.Tensor, tile_h: int, tile_w: int,
                      variant: str = "row", unroll: int = 0) -> torch.Tensor:
    """(TH*TW, NC) pixel-major chunk coverage: the counterpart of vgtpu's
    coverage_chunks_pallas_t_raw.  On CUDA variant "row" launches kernel K4
    (the TPU kernel _kernel_t2) and "flat" kernel K5 (_kernel_t); on the
    CPU both take the plain twin.  Every route sums the edges in edge order:
    `unroll` is accepted for vgtpu's signature, and its grouping of edges
    (a reassociation of the TPU kernel's sum) is ignored, as K1 and K4
    ignore it."""
    if variant not in ("row", "flat"):
        raise ValueError(f"coverage_chunks_t: unknown variant {variant!r}")
    dev = chunk_edges.device
    if dev.type == "cuda":
        if variant == "flat":
            from vgtpu_torch.ops.coverage_t_flat_cuda import (
                coverage_chunks_t_flat_cuda,
            )

            return coverage_chunks_t_flat_cuda(chunk_edges, tile_h, tile_w)
        from vgtpu_torch.ops.coverage_t_cuda import coverage_chunks_t_cuda

        return coverage_chunks_t_cuda(chunk_edges, tile_h, tile_w)
    if dev.type == "cpu":
        return coverage_chunks_t_torch(chunk_edges, tile_h, tile_w)
    raise ValueError(f"coverage_chunks_t: unsupported device {dev}")


def coverage_pools_t(chunk_edges: list, tile_h: int, tile_w: int) -> list:
    """[(TH*TW, NC_i)] pixel-major coverage of every pool: kernel K4 on CUDA
    (one launch over all the pools), the plain twin per pool on the CPU."""
    dev = chunk_edges[0].device
    if dev.type == "cuda":
        from vgtpu_torch.ops.coverage_t_cuda import coverage_pools_t_cuda

        return coverage_pools_t_cuda(chunk_edges, tile_h, tile_w)
    if dev.type == "cpu":
        return [coverage_chunks_t_torch(ce, tile_h, tile_w) for ce in chunk_edges]
    raise ValueError(f"coverage_pools_t: unsupported device {dev}")


def entry_coverage_from_pools(chunk_edges: list, chunk_entry: list,
                              num_entries: int, tile_h: int,
                              tile_w: int) -> torch.Tensor:
    """Per-entry coverage (NE, TH, TW) of pooled chunks: the twin of vgtpu's
    entry_coverage_from_pools, which the sharded frame and the variant-sharded
    batch take.  Every pool's pixel-major coverage (kernel K4 on CUDA, one
    launch over the pools) is segment-summed over its chunk -> entry map
    (index_add_ over chunks into an (NE, NPX) accumulator), and the pools'
    sums add in pool order.  On CUDA index_add_ is atomic, so a multi-chunk
    entry's adds land in no fixed order; on the CPU they run in chunk order,
    as XLA's segment_sum does."""
    npx = tile_h * tile_w
    if not chunk_edges:
        raise ValueError("entry_coverage_from_pools: no chunk pools")
    acc = None
    covs = coverage_pools_t(chunk_edges, tile_h, tile_w)
    for cov_t, cent in zip(covs, chunk_entry, strict=True):
        part = torch.zeros((num_entries, npx), dtype=torch.float32,
                           device=cov_t.device)
        part.index_add_(0, cent, cov_t.t())
        acc = part if acc is None else acc + part
    return acc.reshape(num_entries, tile_h, tile_w)


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
    """(NC+1, NPX) chunk coverage of every pool: kernel K1 on CUDA (one
    launch over every pool and the dead row, written in place into one
    preallocated tensor), the plain twin on the CPU."""
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
