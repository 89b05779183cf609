# Copied from vgtpu/raster/resolve.py: the jax-free host half of the PyTorch port.
"""Host-side plan aux for the in-kernel coverage resolution path
(ops/coverage_resolve.py — see that module's header for the design).

Chunk classification (per chunk, via its entry):
  RES — the entry owns exactly one chunk and its tile has no clip commands:
        the coverage kernel resolves it (rule/AA/scissor + ss-average) and
        emits OUTPUT-domain coverage.
  RAW — everything else (multi-chunk entries, clip-tile entries): sub-row
        winding exactly as before; multi-chunk NON-clip entries ("XE") get a
        small resolve over their folded totals.

The frame then gathers from TWO coverage arrays:
  cov_final (NR + NXE + 1, NPX_OUT) — res chunks ++ resolved XE ++ dead row;
        non-clip buckets read it with rule/backdrop work already done.
  cov_sub  (NXraw + 1, NPX_SUB)     — raw chunks ++ dead row, extras folded;
        clip buckets keep the in-composite resolution on it.

Chunkless entries (interior tiles: backdrop only, no edges) stay free: their
resolved backdrop is CONSTANT along x (modulo the x-scissor test, which the
composite applies from its existing params rows), so it rides as
per-output-row lane values in a per-bucket `rbd` array and never costs
coverage rows.  See ops/composite.composite_bucket_torch (cov_final form).

Everything here is host numpy executed once per plan (plan-static)."""

from __future__ import annotations

import numpy as np

from vgtpu_torch.ops.coverage_resolve import build_chunk_rparams


def entry_bucket_flags(plan) -> np.ndarray:
    """(NE, 5) bool per-entry lane gates of the entry's OWN bucket:
    [eo, noaa, tex, scissor, clip].  Bucket flags order is
    (grad, tri, tex, clip, eo, noaa, scissor) — see binning bucket build."""
    ne = plan.entry_backdrop.shape[0]
    out = np.zeros((ne, 5), bool)
    for te_b, _ids, fl in plan.tile_buckets:
        e = te_b[te_b >= 0]
        out[e] = (fl[4], fl[5], fl[2], fl[6], fl[3])
    return out


def build_resolve_split(plan):
    """Partition plan.chunk_pools into RES pools (first) then RAW pools, and
    build the per-chunk resolve params.  Mutates plan.chunk_pools ONCE
    (idempotent via plan.resolve_host); returns the host aux dict or None
    when the path does not apply (no res chunks / pan backdrops)."""
    if getattr(plan, "resolve_host", None) is not None:
        return plan.resolve_host or None
    plan.resolve_host = {}          # mark visited even on bail-out
    if plan.entry_backdrop_pan is not None or plan.tile_buckets is None:
        return None
    ne = plan.entry_backdrop.shape[0]
    flags = entry_bucket_flags(plan)

    ref = np.zeros(ne, bool)
    for te_b, _ids, _fl in plan.tile_buckets:
        ref[te_b[te_b >= 0]] = True

    counts = np.zeros(ne, np.int64)
    for _ce, cent in plan.chunk_pools:
        cent = np.asarray(cent)
        v = (cent >= 0) & (cent < ne)
        np.add.at(counts, cent[v], 1)

    entry_res = ref & (counts == 1) & ~flags[:, 4]
    if not entry_res.any():
        return None

    from vgtpu_torch.raster.frame import _bucket128

    th, tw = plan.tile_h, plan.tile_w
    res_pools, raw_pools, rparams, res_real = [], [], [], []
    for ce, cent in plan.chunk_pools:
        ce, cent = np.asarray(ce), np.asarray(cent)
        is_res = entry_res[np.clip(cent, 0, ne - 1)] & (cent >= 0) & (cent < ne)
        for pick, into in ((is_res, res_pools), (~is_res, raw_pools)):
            ce2, cent2 = ce[pick], cent[pick]
            if not len(ce2):
                continue
            nc = _bucket128(len(ce2))
            cep = np.zeros((nc,) + ce.shape[1:], ce.dtype)
            cep[: len(ce2)] = ce2
            centp = np.full(nc, ne - 1, cent.dtype)
            centp[: len(cent2)] = cent2
            into.append((cep, centp))
            if into is res_pools:
                res_real.append(len(cent2))
    for (cep, centp), n in zip(res_pools, res_real):
        rparams.append(build_chunk_rparams(
            centp, plan.entry_rule, plan.entry_aa, plan.entry_paint_kind,
            plan.entry_scissor, plan.entry_backdrop, plan.entry_tile,
            flags[:, :4], tile_h=th, tile_w=tw, ntx=plan.ntx))
        # the pad RES chunks (all-zero edges, read by no gather) then point
        # at the pool's first entry: it owns one chunk, which precedes them,
        # so that chunk stays its primary.  Left at entry NE-1 (vgtpu's
        # choice, kept for the rparams above) they break plans without a
        # pad entry: NE-1 is then a real RAW entry, a res pad becomes its
        # primary and its real chunk an extra folding into a res row.
        centp[n:] = centp[0]

    plan.chunk_pools = res_pools + raw_pools
    plan.stats["chunks"] = sum(len(ce) for ce, _ in plan.chunk_pools)
    aux = {
        "npools_res": len(res_pools),
        "rparams": tuple(rparams),
        "nres": int(sum(len(ce) for ce, _ in res_pools)),
        "nraw": int(sum(len(ce) for ce, _ in raw_pools)),
        "entry_res": entry_res,
        "entry_ref": ref,
        "entry_flags": flags,
    }
    plan.resolve_host = aux
    return aux


def _resolved_backdrop_rows(plan, e, valid, chunkless, fl, ss) -> np.ndarray:
    """(Nb, MO, TH_OUT) resolved per-output-row backdrop coverage for the
    CHUNKLESS slots of one bucket (zeros elsewhere).  Mirrors the composite's
    cov expressions with w == backdrop (x-constant), y-scissor included; the
    x-scissor factor is applied by the composite (exact: the inside mask is
    0/1)."""
    from vgtpu_torch.raster.binning import P_TEXTURE

    th = plan.tile_h
    th_out = th // ss
    bd = plan.entry_backdrop[e].astype(np.float32)          # (Nb, MO, TH)
    cov = np.minimum(np.abs(bd), 1.0)
    if fl[4]:  # eo lane
        cov_eo = 1.0 - np.abs(np.mod(bd, 2.0) - 1.0)
        cov = np.where((plan.entry_rule[e] != 0)[..., None], cov_eo, cov)
    if fl[5]:  # noaa lane
        cov = np.where((plan.entry_aa[e] == 0)[..., None],
                       (cov >= 0.5).astype(np.float32), cov)
    if fl[2]:  # tex lane
        cov = np.where(
            (plan.entry_paint_kind[e] == P_TEXTURE)[..., None], 1.0, cov)
    if fl[6]:  # scissor lane: y test per sub-row (x test stays in-kernel)
        oy = ((plan.entry_tile[e] // plan.ntx) * th).astype(np.float32)
        sc = plan.entry_scissor[e].astype(np.float32)
        pyl = np.arange(th, dtype=np.float32) + 0.5          # (TH,)
        iy = ((pyl >= (sc[..., 1] - oy)[..., None])
              & (pyl < (sc[..., 3] - oy)[..., None]))
        cov = cov * iy.astype(np.float32)
    rbd = cov.reshape(cov.shape[0], cov.shape[1], th_out, ss).mean(axis=3)
    rbd = rbd * (valid & chunkless)[..., None].astype(np.float32)
    return rbd.astype(np.float32)


def build_resolve_aux(plan, m: dict, split: dict, dead_id: int):
    """Per-bucket gather tables + chunkless-backdrop rows + the XE (multi-
    chunk non-clip entry) resolve inputs, all against the SPLIT pool order
    (res pools first).  m is build_cov_gather_map on the split pools."""
    from vgtpu_torch.ops.composite import _pad_tiles
    from vgtpu_torch.raster.binning import _bucket

    ne = plan.entry_backdrop.shape[0]
    nres, nraw = split["nres"], split["nraw"]
    primary = m["primary"]
    ss = plan.supersample
    th, tw = plan.tile_h, plan.tile_w
    th_out = th // ss

    # extras (multi-chunk folds) involve only RAW chunks by construction;
    # PAD extra slots (extra_chunk == dead) may carry primary[pad-entry],
    # which can be a res-pool pad chunk — they fold zeros, remap them to the
    # raw dead row wholesale
    extra_pad = m["extra_chunk"] == dead_id
    for k in ("extra_chunk", "extra_primary"):
        bad = (m[k] < nres) & ~extra_pad
        if bad.any():
            raise AssertionError("resolve split: extras touched a res chunk")

    # XE: non-clip entries whose winding needs the raw fold (multi-chunk)
    is_clip_tile = split["entry_flags"][:, 4]
    xe_mask = (split["entry_ref"] & ~is_clip_tile
               & (primary >= nres) & (primary != dead_id))
    xe_entries = np.nonzero(xe_mask)[0].astype(np.int32)
    nxe = len(xe_entries)
    nxe_p = _bucket(max(nxe, 1), minimum=8)
    xe_pad = np.full(nxe_p, ne - 1, np.int32)
    xe_pad[:nxe] = xe_entries
    xe_index = np.full(ne, -1, np.int64)
    xe_index[xe_entries] = np.arange(nxe)
    xe_is_pad = np.arange(nxe_p) >= nxe    # pad entries' primary may be a
    xe_primary_raw = np.where(             # res-pool pad chunk — dead them
        xe_is_pad | (primary[xe_pad] == dead_id), nraw,
        primary[xe_pad] - nres).astype(np.int32)
    xe_rparams = build_chunk_rparams(
        xe_pad, plan.entry_rule, plan.entry_aa, plan.entry_paint_kind,
        plan.entry_scissor, plan.entry_backdrop, plan.entry_tile,
        split["entry_flags"][:, :4], tile_h=th, tile_w=tw, ntx=plan.ntx)
    # the fold already added the entry's TOTAL winding into its primary row;
    # backdrop is all resolve_cov_rows must add on top (rparams carry it)

    fin_dead = nres + nxe_p
    rbr = -(-th_out // 8) * 8
    ptebs, rbds = [], []
    for te_b, _ids, fl in plan.tile_buckets:
        nbp = _pad_tiles(te_b.shape[0])
        te_p = te_b
        if nbp != te_b.shape[0]:
            te_p = np.concatenate(
                [te_b, np.full((nbp - te_b.shape[0], te_b.shape[1]), -1,
                               te_b.dtype)])
        valid = te_p >= 0
        e = np.maximum(te_p, 0)
        p = np.where(valid, primary[e], dead_id)
        if fl[3]:   # clip bucket: raw sub-row coverage, local ids
            if ((p < nres) & (p != dead_id)).any():
                raise AssertionError("clip bucket references a res chunk")
            pteb = np.where(p == dead_id, nraw, p - nres).astype(np.int32)
            rbd_t = None
        else:
            chunkless = valid & (p == dead_id)
            is_xe = valid & (p >= nres) & (p != dead_id)
            pteb = np.where(p < nres, p, fin_dead)
            pteb = np.where(is_xe, nres + xe_index[e], pteb).astype(np.int32)
            rbd = _resolved_backdrop_rows(plan, e, valid, chunkless, fl, ss)
            # kernel layout (MO, RBR, NbP): output-row lanes per slot
            rbd_t = np.zeros((te_p.shape[1], rbr, nbp), np.float32)
            rbd_t[:, :th_out, :] = rbd.transpose(1, 2, 0)
        ptebs.append(pteb)
        rbds.append(rbd_t)

    return {
        "rparams": split["rparams"],
        "extra_chunk_raw": np.where(
            extra_pad | (m["extra_chunk"] == dead_id), nraw,
            m["extra_chunk"] - nres).astype(np.int32),
        "extra_primary_raw": np.where(
            extra_pad | (m["extra_primary"] == dead_id), nraw,
            m["extra_primary"] - nres).astype(np.int32),
        "xe_primary_raw": xe_primary_raw,
        "xe_rparams": xe_rparams.astype(np.float32),
        "pteb": tuple(ptebs),
        "rbd": tuple(rbds),
    }
