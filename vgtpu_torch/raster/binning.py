# Copied from vgtpu/raster/binning.py: the jax-free host half of the PyTorch port.
"""Coarse rasterization: draw ops -> per-tile edge chunks + backdrops + op tables.

This replaces the reference's draw-command batching (allocDrawCommand,
vg.cpp:5359-5407) *and* libtess2's topology pass: instead of tessellating
polygons into triangles, edges are binned to 8x128-pixel screen tiles and the
device computes analytic winding coverage per tile (see ARCHITECTURE.md).

Key invariants consumed by the device kernels:
  - an edge is binned to every tile whose y-rows it overlaps and whose x-range
    it does not lie entirely left of; edges entirely left of a tile fold into
    the tile's per-row 'backdrop' vector (winding is column-independent there
    because the coverage kernel's K() saturates at 1);
  - tiles right of the op's rightmost edge are skipped entirely — closed
    contours wind to zero there;
  - zero-height edges contribute exactly zero coverage, so chunk padding is
    all-zeros with no masks;
  - per-tile entry lists are in draw order (painter's algorithm).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# op kinds in the linearized per-tile command stream
K_DRAW = 0
K_CLIP_ADD = 1      # rasterize a clip shape into the clip accumulator
K_CLIP_COMMIT = 2   # accumulated shapes -> binary mask (rule = In/Out)
K_CLIP_RESET = 3    # mask := 1 everywhere

# paint kinds
P_SOLID = 0
P_GRADIENT = 1
P_IMAGE = 2         # image-pattern fill: rule coverage x pre-sampled color tile
P_TEXTURE = 3       # textured quads (text/user quads): color tile carries alpha
P_TRI = 4           # per-vertex-color triangle: linearly interpolated RGBA

PAINT_NF = 18       # mat(6) + params(4) + inner(4) + outer(4)

# Split each composite depth class into plain/fancy tile buckets (cheap vs
# full shading lanes).  Module-level so experiments can A/B the launch-count
# vs per-pixel-work trade without re-plumbing configs.
BUCKET_SPLIT_FANCY = True
STATIC_CLIP_RESOLVE = True   # debug/experiment gate for the static-clip pass


@dataclass(slots=True)
class RasterOp:
    """One linearized frame command (the currency between the API layer and
    the rasterizer — the analogue of the reference's DrawCommand,
    vg.cpp:216-247)."""

    kind: int = K_DRAW
    edges: np.ndarray | None = None          # (E,4) f32 screen-space segments
    fill_rule: int = 0                       # FillRule.NonZero / EvenOdd
    aa: bool = True
    paint_kind: int = P_SOLID
    paint: np.ndarray | None = None          # (PAINT_NF,) f32; solid color in inner slot
    scissor: tuple | None = None             # (x0,y0,x1,y1) or None = viewport
    image_id: int = -1                       # for P_IMAGE / P_TEXTURE
    tex_quads: np.ndarray | None = None      # (Q,12) f32 parallelogram + uv rect
    mergeable: bool = False                  # orientation-normalized geometry
    # batched user triangles (indexedTriList): edges holds (3K,4) with 3 edges
    # per triangle and tri_paints carries that triangle's paint — the binner
    # expands to K per-triangle pseudo-ops without K python objects
    tri_paints: np.ndarray | None = None     # (K, PAINT_NF) f32
    # deferred geometry recipes (batched native frame bake, vg_frame_geom):
    # list of (path_snapshot, mode, xform6, width, cap, join, render_scale);
    # Context._finalize_geometry resolves these into edges before binning
    geom: list | None = None
    # cached content keys (frame-fingerprint CRC triple / bin key): valid
    # only while the op's content is frozen — which holds for command-list
    # memo ops shared across frames (immutable after their first frame's
    # finalize) and trivially for per-frame ops (fresh objects).  __copy__
    # clears them so the shallow-copy-then-mutate helpers (scale_ops_y,
    # translate_ops, finalize splits) never inherit a stale key.
    fp_cache: tuple | None = field(default=None, compare=False, repr=False)
    bin_key_cache: tuple | None = field(default=None, compare=False,
                                        repr=False)

    def __copy__(self):
        o = object.__new__(RasterOp)
        for f in _RASTEROP_FIELDS:
            object.__setattr__(o, f, getattr(self, f))
        o.fp_cache = None
        o.bin_key_cache = None
        return o


_RASTEROP_FIELDS = tuple(f.name for f in RasterOp.__dataclass_fields__.values())


def make_solid_paint(rgba: np.ndarray) -> np.ndarray:
    p = np.zeros(PAINT_NF, np.float32)
    p[10:14] = rgba
    return p


def make_gradient_paint(mat6, params4, inner4, outer4) -> np.ndarray:
    p = np.zeros(PAINT_NF, np.float32)
    p[0:6] = mat6
    p[6:10] = params4
    p[10:14] = inner4
    p[14:18] = outer4
    return p


@dataclass
class FramePlan:
    """Padded, device-ready frame description."""

    width: int
    height: int
    ntx: int
    nty: int
    tile_h: int
    tile_w: int
    # chunk pools: [(edges (NCp, CHp, 4) f32 tile-relative, entry (NCp,) i32)]
    chunk_pools: list
    # entries (one per (tile, op) pair, draw-ordered within each tile)
    entry_tile: np.ndarray       # (NE,) i32
    entry_backdrop: np.ndarray   # (NE, tile_h) f32
    entry_kind: np.ndarray       # (NE,) i32  K_*
    entry_rule: np.ndarray       # (NE,) i32
    entry_aa: np.ndarray         # (NE,) i32
    entry_paint_kind: np.ndarray # (NE,) i32
    entry_paint: np.ndarray      # (NE, PAINT_NF) f32
    entry_scissor: np.ndarray    # (NE, 4) f32
    entry_image: np.ndarray      # (NE,) i32 image id or -1
    entry_op: np.ndarray         # (NE,) i32 index into the source op list
    entry_color_tile: np.ndarray # (NE,) i32 -> aux color tile index or -1
    # per-tile op table
    tile_entries: np.ndarray     # (T, MAX_OPS) i32 entry ids, -1 padded
    # aux color tiles for textured entries (text/images), premultiplied RGBA
    color_tiles: np.ndarray      # (NCT, tile_h//supersample, tile_w, 4) f32
    tile_buckets: list | None = None  # [(tile_entries_b, tile_ids_b)] by op count
    # upload dedup (native binner only): per-PSEUDO-op tables + per-entry
    # pseudo-op index.  Entries of one pseudo-op share kind/rule/aa/paint_kind/
    # paint/scissor, so the device plan uploads the compact tables and expands
    # them with gathers inside the jitted frame (plan_to_device/frame._frame_fn)
    pop: dict | None = None           # {"kind","rule","aa","paint_kind": (P,) i32,
                                      #  "paint": (P,18) f32, "scissor": (P,4) f32}
    entry_pop: np.ndarray | None = None  # (NE,) i32 pseudo-op id (pad rows -> pad id)
    # retained-pan plans (bin_frame_numpy(pan_margin=True)): 2*tile_h backdrop
    # row window per entry; entry_backdrop is its [0, tile_h) slice
    entry_backdrop_pan: np.ndarray | None = None  # (NE, 2*tile_h) f32
    n_real_entries: int = 0
    n_real_chunks: int = 0
    depth_cap: int = 256     # max composite painter slots per tile (see
                             # ContextConfig.max_ops_per_tile_cap)
    # y-supersampling factor: >1 means all y geometry (edges, quads, scissors,
    # backdrops, tile_h) is in sub-row units; height stays in real pixels and
    # the composite averages ss sub-rows per output row after rule application
    supersample: int = 1
    stats: dict = field(default_factory=dict)


def plan_from_numpy(fields: dict) -> FramePlan:
    """A FramePlan of this package from the numpy fields of any FramePlan —
    this package's or vgtpu's, e.g. dataclasses.asdict(plan) or vars(plan).
    Arrays are copied, so the two plans never share mutable state; unknown
    field names raise."""
    import dataclasses

    names = {f.name for f in dataclasses.fields(FramePlan)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"plan_from_numpy: unknown FramePlan fields {sorted(unknown)}")

    def arr(x):
        return None if x is None else np.array(x)

    kw = {}
    for k, v in fields.items():
        if k == "chunk_pools":
            v = [(np.array(ce), np.array(cent)) for ce, cent in v]
        elif k == "tile_buckets":
            v = None if v is None else [
                (np.array(te), np.array(ids), tuple(bool(f) for f in fl))
                for te, ids, fl in v]
        elif k == "pop":
            v = None if v is None else {pk: np.array(pv) for pk, pv in v.items()}
        elif k == "stats":
            v = dict(v)
        elif isinstance(v, np.ndarray) or v is None:
            v = arr(v)
        kw[k] = v
    return FramePlan(**kw)


def compute_tile_buckets(
    tile_entries: np.ndarray,
    num_tiles: int,
    entry_kind: np.ndarray | None = None,
    plan: "FramePlan" = None,
    view_static: bool = False,
) -> list:
    """Group tiles by painter-depth: tiles with n ops scan only the smallest
    power-of-two slot count >= n; op-free tiles are skipped entirely.  Padding
    rows target the scratch tile id == num_tiles.

    When entry_kind is given, control entries (clip commit/reset — present in
    EVERY tile by construction) trailing the tile's last draw are pruned: they
    cannot affect output, and pruning turns pure-background tiles op-free.

    With a full plan, OCCLUSION culling also applies: an entry that covers its
    whole tile with an opaque solid NonZero fill (no edges in the tile, every
    backdrop row winding >= 1, full-tile scissor) overwrites everything below
    it, so earlier entries in that tile are dropped.  Deeply stacked opaque
    artwork (the tiger) collapses to the visible top layers.

    STATIC CLIP resolution (also plan-gated): clip commit/reset are global
    control entries present in every tile, but in a tile with NO clip-add
    entry their effect is static — the accumulator is zero, so commit(In)
    pins the mask to 0 (draws until the next control are fully clipped) and
    commit(Out)/reset pin it to 1 (no-ops).  Such tiles drop all control
    entries plus the statically-clipped draws; only tiles actually touched
    by a clip shape keep the dynamic mask lanes (this is what keeps the
    fused composite's clip lanes out of ~99% of tiles on clipped frames)."""
    resolved_fancy = None
    if plan is not None and entry_kind is not None and tile_entries.size:
        # native fast path: one C pass over the tile table does all four
        # per-tile resolutions (the numpy passes below are its oracle)
        from vgtpu_torch import native

        r = (native.resolve_tiles(tile_entries, plan, view_static,
                                  STATIC_CLIP_RESOLVE)
             if native.available() else None)
        if r is not None:
            tile_entries, resolved_fancy, capped = r
            if capped:
                import warnings

                warnings.warn(
                    f"tile op depth exceeds cap {plan.depth_cap}; dropping "
                    f"oldest draw entries in {capped} tiles",
                    RuntimeWarning, stacklevel=2)
                plan.stats["depth_capped_tiles"] = capped

    if (resolved_fancy is None and plan is not None and tile_entries.size
            and STATIC_CLIP_RESOLVE):
        te0 = tile_entries
        e0 = np.maximum(te0, 0)
        v0 = te0 >= 0
        kind0 = np.where(v0, entry_kind[e0], K_DRAW)
        no_cadd = ~((kind0 == K_CLIP_ADD) & v0).any(axis=1)
        # commit(In) is the ONLY control whose static resolution drops draws;
        # rows with just commit(Out)/reset keep every draw and only shed the
        # no-op controls — a plain mask.  The full state machine runs only on
        # the (rare) commit(In) rows: ~4x cheaper on typical frames.
        entry_rule0 = np.where(v0, plan.entry_rule[e0], 0)
        is_in_commit0 = (kind0 == K_CLIP_COMMIT) & v0 & (entry_rule0 == 0)
        rows = no_cadd & is_in_commit0.any(axis=1)
        te0 = te0.copy()
        changed = False
        easy = no_cadd & ~rows
        if easy.any():
            te0[easy] = np.where((kind0[easy] == K_DRAW) & v0[easy],
                                 te0[easy], -1)
            changed = True
        if rows.any():
            k = kind0[rows]
            v = v0[rows]
            is_commit = (k == K_CLIP_COMMIT) & v
            ctrl = is_commit | ((k == K_CLIP_RESET) & v)
            rule = entry_rule0[rows]
            # mask value AFTER each control entry: commit(In)=0, else 1
            setval = np.where(is_commit & (rule == 0), 0, 1)
            pos = np.broadcast_to(np.arange(te0.shape[1])[None, :], k.shape)
            last = np.maximum.accumulate(np.where(ctrl, pos, -1), axis=1)
            mval = np.where(
                last >= 0,
                np.take_along_axis(setval, np.maximum(last, 0), axis=1), 1)
            # mask in effect BEFORE each entry = state set by the prior control
            mprev = np.concatenate(
                [np.ones((k.shape[0], 1), mval.dtype), mval[:, :-1]], axis=1)
            keep = v & (k == K_DRAW) & (mprev == 1)
            te0[rows] = np.where(keep, te0[rows], -1)
            changed = True
        if changed:
            # compact the holes NOW: bucketing slices leading slots, and the
            # occlusion block's compaction doesn't run under view_static
            order = np.argsort(te0 < 0, axis=1, kind="stable")
            tile_entries = np.take_along_axis(te0, order, axis=1)

    if entry_kind is not None and tile_entries.size and resolved_fancy is None:
        te = tile_entries
        kinds = np.where(te >= 0, entry_kind[np.maximum(te, 0)], -1)
        is_draw = (kinds == K_DRAW) & (te >= 0)
        rev_any = np.cumsum(is_draw[:, ::-1], axis=1)[:, ::-1]  # draws at/after pos
        tile_entries = np.where(rev_any > 0, te, -1)

        if plan is not None:
            # occlusion culling.  view_static (retained pan) variant uses
            # VIEW-INVARIANT tests: full winding over the whole 2*tile_h
            # backdrop window (any y-residual slice stays >= 1), no edges in
            # the margin-inflated chunk set (no edge can enter at any
            # residual), and the scissor containing the tile's whole
            # reachable sample window [x0, x0+2*tw) x [y0, y0+2*th).
            # per-entry full-opaque-cover flag (conservative)
            ne = plan.entry_backdrop.shape[0]
            has_edges = np.zeros(ne, bool)
            for _ce, cent in plan.chunk_pools:
                has_edges[cent] = True
            solid_opaque = (
                (plan.entry_paint_kind == P_SOLID)
                & (plan.entry_kind == K_DRAW)
                & (plan.entry_rule == 0)
                & (plan.entry_paint[:, 13] >= 1.0)
            )
            bd_for_cover = (plan.entry_backdrop_pan
                            if view_static and plan.entry_backdrop_pan is not None
                            else plan.entry_backdrop)
            full_wind = (np.abs(bd_for_cover) >= 1.0).all(axis=1)
            covers = solid_opaque & full_wind & ~has_edges

            # restrict the heavy per-slot work (scissor gather, state tests,
            # compaction) to rows that contain a covering candidate at all —
            # typically the densely-stacked artwork tiles, a fraction of T
            cand = covers[np.maximum(tile_entries, 0)] & (tile_entries >= 0)
            rows2 = np.nonzero(cand.any(axis=1))[0]
            if len(rows2):
                te2 = tile_entries[rows2]
                e = np.maximum(te2, 0)
                valid = te2 >= 0
                # scissor must contain the whole (reachable) tile window
                ntx = max(1, int(np.ceil(plan.width / plan.tile_w)))
                tx0 = (rows2 % ntx) * plan.tile_w
                ty0 = (rows2 // ntx) * plan.tile_h
                reach = 2 if view_static else 1
                tx1 = np.minimum(tx0 + reach * plan.tile_w, plan.width)
                ty1 = np.minimum(ty0 + reach * plan.tile_h,
                                 plan.height * plan.supersample)
                sc = plan.entry_scissor[e]
                sc_ok = (
                    (sc[:, :, 0] <= tx0[:, None])
                    & (sc[:, :, 1] <= ty0[:, None])
                    & (sc[:, :, 2] >= tx1[:, None])
                    & (sc[:, :, 3] >= ty1[:, None])
                )
                cover_grid = cand[rows2] & sc_ok
                # clip state is per-tile dynamic; only cull in clip-free tiles
                has_clip = ((plan.entry_kind[e] != K_DRAW) & valid).any(axis=1)
                cover_grid &= ~has_clip[:, None]
                # keep from the LAST covering entry onward
                pos = np.arange(te2.shape[1])
                last_cover = np.where(
                    cover_grid.any(axis=1),
                    te2.shape[1] - 1 - np.argmax(cover_grid[:, ::-1], axis=1),
                    0,
                )
                te2 = np.where(pos[None, :] >= last_cover[:, None], te2, -1)
                # compact: culling leaves -1 prefixes; buckets slice leading
                order = np.argsort(te2 < 0, axis=1, kind="stable")
                tile_entries = tile_entries.copy()
                tile_entries[rows2] = np.take_along_axis(te2, order, axis=1)
    counts = (tile_entries >= 0).sum(axis=1)
    cap = plan.depth_cap if plan is not None else 0
    if cap and (counts > cap).any():
        n_capped = int((counts > cap).sum())
        # hard safety cap on composite depth (ContextConfig.max_ops_per_tile_cap):
        # keep the LAST cap entries per overflowing tile — later draws paint
        # over earlier ones, so the dropped tail is the most-occluded content.
        # The reference has no depth limit (it draws triangles), but unbounded
        # painter depth here means unbounded kernel slots; degrade loudly.
        import warnings

        warnings.warn(
            f"tile op depth {int(counts.max())} exceeds cap {cap}; "
            f"dropping oldest draw entries in {int((counts > cap).sum())} tiles",
            RuntimeWarning, stacklevel=2)
        # drop the oldest DRAW entries only: dropping a clip-add or commit
        # would silently change the clip state of every surviving draw (a
        # commit whose adds were dropped pins the mask to 0; a dropped
        # commit leaks clipped draws).  Control entries are scarce, so
        # keeping them all still lands at <= cap except in the pathological
        # >cap-controls case, where the trailing slice below degrades as
        # before.
        valid = tile_entries >= 0
        if entry_kind is not None:
            is_draw = valid & (entry_kind[np.maximum(tile_entries, 0)] == K_DRAW)
        else:
            is_draw = valid
        n_draws = is_draw.sum(axis=1)
        to_drop = np.maximum(counts - cap, 0)
        draw_rank = np.cumsum(is_draw, axis=1) - 1       # 0-based among draws
        keep = valid & (~is_draw | (draw_rank >= np.minimum(
            to_drop, n_draws)[:, None]))
        tile_entries = np.where(keep, tile_entries, -1)
        order = np.argsort(tile_entries < 0, axis=1, kind="stable")
        tile_entries = np.take_along_axis(tile_entries, order, axis=1)
        tile_entries = tile_entries[:, :cap]
        counts = (tile_entries >= 0).sum(axis=1)
        if plan is not None:
            # tiles that actually overflowed (same metric as the native path)
            plan.stats["depth_capped_tiles"] = n_capped
    width = tile_entries.shape[1]

    # per-tile feature signature: tiles whose entries are all simple
    # (solid paint, pure draws) compile to a much cheaper composite variant —
    # split each depth class so artwork tiles don't inherit UI tiles' lanes
    if resolved_fancy is not None:
        tile_fancy = resolved_fancy
    elif plan is not None and tile_entries.size:
        e_all = np.maximum(tile_entries, 0)
        v_all = tile_entries >= 0
        fancy_entry = (plan.entry_paint_kind != P_SOLID) | (plan.entry_kind != K_DRAW)
        tile_fancy = (fancy_entry[e_all] & v_all).any(axis=1)
    else:
        tile_fancy = np.zeros(tile_entries.shape[0], bool)

    buckets = []
    prev = 0
    mo = 4
    while prev < width:
        mo_c = min(mo, width)
        in_class = (counts > prev) & (counts <= mo_c)
        if BUCKET_SPLIT_FANCY:
            groups = (
                np.nonzero(in_class & ~tile_fancy)[0],
                np.nonzero(in_class & tile_fancy)[0],
            )
        else:
            groups = (np.nonzero(in_class)[0],)
        for sel in groups:
            if not len(sel):
                continue
            n_pad = _bucket(len(sel), minimum=8)
            ids = np.full(n_pad, num_tiles, np.int32)
            ids[: len(sel)] = sel
            te_b = np.full((n_pad, mo_c), -1, np.int32)
            te_b[: len(sel)] = tile_entries[sel, :mo_c]
            if plan is not None:
                es = te_b[te_b >= 0]
                pk = plan.entry_paint_kind[es]
                kd = plan.entry_kind[es]
                sc = plan.entry_scissor[es]
                full_vp = np.array(
                    [0.0, 0.0, plan.width, plan.height * plan.supersample], np.float32)
                flags = (
                    bool((pk == P_GRADIENT).any()),
                    bool((pk == P_TRI).any()),
                    bool(((pk == P_IMAGE) | (pk == P_TEXTURE)).any()),
                    bool((kd != K_DRAW).any()),
                    bool((plan.entry_rule[es] == 1).any()),
                    bool((plan.entry_aa[es] == 0).any()),
                    bool(len(sc) > 0 and not np.all(sc == full_vp)),
                )
            else:
                flags = (True,) * 7
            buckets.append((te_b, ids, flags))
        prev = mo_c
        mo *= 2
    return buckets


def _bucket(n: int, minimum: int = 16) -> int:
    """Round up to the next {2^k, 1.5*2^k} size: bounds compiled-program count
    while keeping padding waste under ~25%."""
    b = minimum
    while True:
        if b >= n:
            return b
        if (b * 3) // 2 >= n:
            return (b * 3) // 2
        b *= 2


def _bucket_pow2(n: int, minimum: int = 4) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def patch_entry_paint(plan, n_ops: int, changed, new_rows) -> None:
    """In-place patch of plan.entry_paint rows for the changed op ids
    (via the plan's entry_op map).  The ONE definition shared by the frame
    paint-memo fast path (Context._value_only_update) and retained scenes
    (RetainedScene.update_paint_values) — the patch semantics must not
    drift between them (any new plan-build dependence on paint values must
    be gated in BOTH)."""
    lut = np.zeros((n_ops, PAINT_NF), np.float32)
    lut[np.asarray(changed)] = np.asarray(new_rows, np.float32)
    eo = plan.entry_op
    chmask = np.zeros(n_ops, bool)
    chmask[np.asarray(changed)] = True
    mask = (eo >= 0) & chmask[np.clip(eo, 0, n_ops - 1)]
    if mask.any():
        plan.entry_paint[mask] = lut[eo[mask]]


def expand_tri_batches(ops: list[RasterOp]) -> list[RasterOp]:
    """Per-triangle pseudo-ops from batched tri-list ops (oracle path; the
    native packing expands vectorized without python objects)."""
    out = []
    for op in ops:
        if op.tri_paints is None:
            out.append(op)
            continue
        e = np.asarray(op.edges, np.float32).reshape(-1, 3, 4)
        for k in range(len(e)):
            out.append(RasterOp(
                kind=op.kind, edges=e[k], fill_rule=op.fill_rule, aa=op.aa,
                paint_kind=op.paint_kind, paint=op.tri_paints[k],
                scissor=op.scissor, image_id=op.image_id,
            ))
    return out


def scale_ops_y(ops: list[RasterOp], ss: int) -> list[RasterOp]:
    """Shallow-copied ops with all y geometry scaled into sub-row units
    (edges, textured quads, scissors).  Paints stay in pixel space — shading
    and sampling run at output resolution."""
    import copy

    out = []
    for op in ops:
        o = copy.copy(op)
        if o.edges is not None and len(o.edges):
            e = np.asarray(o.edges, np.float32).copy()
            e[:, 1] *= ss
            e[:, 3] *= ss
            o.edges = e
        if o.tex_quads is not None and len(o.tex_quads):
            q = np.asarray(o.tex_quads, np.float32).copy()
            q[:, 1] *= ss    # p0y
            q[:, 3] *= ss    # ex_y
            q[:, 5] *= ss    # ey_y
            o.tex_quads = q
        if o.scissor is not None:
            s = o.scissor
            o.scissor = (s[0], s[1] * ss, s[2], s[3] * ss)
        out.append(o)
    return out


def _op_bin_key(op: RasterOp) -> tuple:
    """Content key for one op's binning result: everything the native binner
    reads from the op (geometry, paint rows, scissor, flags).  Frame-level
    parameters (canvas size, tile shape, pools, supersample) are part of the
    cache's meta key, not repeated per op.

    Memoized on the op (RasterOp.bin_key_cache): command-list memo replays
    re-emit the SAME frozen op objects every frame (command_list.py
    op-list memoization), so re-CRCing their full edge sets per frame —
    ~MBs on the tiger list — was pure waste on the app pattern's layer
    split + incremental-bin key scans."""
    k = op.bin_key_cache
    if k is not None:
        return k
    import zlib

    def crc(a, c=0):
        if a is None:
            return c
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
        return zlib.crc32(a, c)

    k = (
        op.kind, op.fill_rule, bool(op.aa), op.paint_kind, op.image_id,
        op.scissor,
        crc(op.edges), crc(op.tex_quads), crc(op.tri_paints), crc(op.paint),
    )
    op.bin_key_cache = k
    return k


def _raw_op_offsets(raw: dict, ops: list[RasterOp]) -> dict:
    """Per-op boundaries into a raw bin result: entry, pseudo-op, and
    per-pool chunk offsets (all op-contiguous by binner construction)."""
    counts = np.array(
        [len(op.tri_paints) if op.tri_paints is not None else 1 for op in ops],
        np.int64)
    p_off = np.concatenate([[0], np.cumsum(counts)])
    entry_op = raw["entry_op"]
    e_off = np.searchsorted(entry_op, p_off)
    c_offs = []
    for _ce, cent in raw["chunk_pools"]:
        c_op = entry_op[cent] if len(cent) else np.zeros(0, np.int64)
        c_offs.append(np.searchsorted(c_op, p_off))
    return {"e": e_off, "p": p_off, "c": c_offs}


_RAW_ENTRY_KEYS = ("entry_tile", "entry_backdrop", "entry_kind", "entry_rule",
                   "entry_aa", "entry_paint_kind", "entry_paint",
                   "entry_scissor", "entry_image")
_POP_KEYS = ("kind", "rule", "aa", "paint_kind", "paint", "scissor")


def bin_frame_incremental(ops, width, height, tile_h, tile_w, pools,
                          cache: dict):
    """Native binning with a frame-over-frame run cache: ops positionally
    identical to the previous frame reuse that frame's binning result as
    contiguous slices; only changed ops go through the native binner.  The
    practical retained-scene path (ROUND_NOTES): a mostly-static re-recorded
    frame re-bins only what moved (~3x cheaper than a full bin at 7% churn
    on the benchmark scene).  Falls back to a full native bin — while still
    priming the cache — when the op count changes (scene-graph edits) or the
    native backend is unavailable (returns None)."""
    from vgtpu_torch import native

    if not native.available():
        return None
    meta = (width, height, tile_h, tile_w, tuple(pools))
    keys = [_op_bin_key(op) for op in ops]
    prev_keys = cache.get("keys")
    match = (np.array([a == b for a, b in zip(keys, prev_keys)], bool)
             if (cache.get("meta") == meta and prev_keys is not None
                 and len(prev_keys) == len(ops) and len(ops))
             else np.zeros(len(ops), bool))
    cache["hits"] = int(match.sum())

    if not match.any():
        raw = native.bin_frame_native(ops, width, height, tile_h, tile_w, pools)
        if raw is None:
            return None
    else:
        prev_raw, prev_off = cache["raw"], cache["off"]
        misses = np.nonzero(~match)[0]
        if len(misses):
            raw_new = native.bin_frame_native(
                [ops[i] for i in misses], width, height, tile_h, tile_w, pools)
            if raw_new is None:
                return None
            new_off = _raw_op_offsets(raw_new, [ops[i] for i in misses])
            # position of op i within the miss batch
            miss_pos = np.full(len(ops), -1, np.int64)
            miss_pos[misses] = np.arange(len(misses))
        # segments: maximal runs of same-source ops, each one slice per array
        segs = []       # (src_raw, src_off, src_i0, src_i1) in op units
        i = 0
        while i < len(ops):
            j = i
            if match[i]:
                while j < len(ops) and match[j]:
                    j += 1
                segs.append((prev_raw, prev_off, i, j))
            else:
                while j < len(ops) and not match[j]:
                    j += 1
                segs.append((raw_new, new_off, int(miss_pos[i]),
                             int(miss_pos[j - 1]) + 1))
            i = j

        def seg_cat(get_slice, shapes):
            parts = [get_slice(*s) for s in segs]
            parts = [p for p in parts if len(p)]
            if not parts:
                return np.zeros(shapes[0], shapes[1])
            return np.concatenate(parts, axis=0)

        raw = {}
        for k in _RAW_ENTRY_KEYS:
            tail = {"entry_backdrop": (tile_h,), "entry_paint": (PAINT_NF,),
                    "entry_scissor": (4,)}.get(k, ())
            dt = (np.float32 if k in ("entry_backdrop", "entry_paint",
                                      "entry_scissor") else np.int32)
            raw[k] = seg_cat(
                lambda r, o, a, b, k=k: r[k][o["e"][a] : o["e"][b]],
                ((0,) + tail, dt))
        # entry_op / pop: rebase each segment by the output pop offset
        out_p = np.concatenate(
            [[0], np.cumsum([o["p"][b] - o["p"][a] for _r, o, a, b in segs])])
        parts = []
        for si, (r, o, a, b) in enumerate(segs):
            sl = r["entry_op"][o["e"][a] : o["e"][b]]
            if len(sl):
                parts.append(sl + np.int32(out_p[si] - o["p"][a]))
        raw["entry_op"] = (np.concatenate(parts) if parts
                           else np.zeros(0, np.int32))
        raw["pop"] = {}
        for k in _POP_KEYS:
            tail = {"paint": (PAINT_NF,), "scissor": (4,)}.get(k, ())
            dt = np.float32 if k in ("paint", "scissor") else np.int32
            raw["pop"][k] = seg_cat(
                lambda r, o, a, b, k=k: r["pop"][k][o["p"][a] : o["p"][b]],
                ((0,) + tail, dt))
        # chunk pools: rebase entry ids by the output entry offset
        out_e = np.concatenate(
            [[0], np.cumsum([o["e"][b] - o["e"][a] for _r, o, a, b in segs])])
        raw["chunk_pools"] = []
        for pi, ch in enumerate(pools):
            eparts, cparts = [], []
            for si, (r, o, a, b) in enumerate(segs):
                c0, c1 = o["c"][pi][a], o["c"][pi][b]
                if c1 > c0:
                    ce, cent = r["chunk_pools"][pi]
                    eparts.append(ce[c0:c1])
                    cparts.append(cent[c0:c1]
                                  + np.int32(out_e[si] - o["e"][a]))
            raw["chunk_pools"].append((
                np.concatenate(eparts) if eparts
                else np.zeros((0, int(ch), 4), np.float32),
                np.concatenate(cparts) if cparts else np.zeros(0, np.int32),
            ))
        n_entries = int(out_e[-1])
        raw["n_entries"] = n_entries
        # per-tile draw-ordered table (entry index order IS draw order)
        T = (-(-width // tile_w)) * (-(-height // tile_h))
        et = raw["entry_tile"].astype(np.int64)
        max_ops = int(np.bincount(et, minlength=T).max()) if n_entries else 0
        MO = _bucket_pow2(max(max_ops, 1), minimum=4)
        tile_entries = np.full((T, MO), -1, np.int32)
        if n_entries:
            order = np.lexsort((np.arange(n_entries), et))
            sorted_tiles = et[order]
            first = np.concatenate([[True], sorted_tiles[1:] != sorted_tiles[:-1]])
            firsts_idx = np.nonzero(first)[0]
            grp = np.cumsum(first) - 1
            pos = np.arange(n_entries) - firsts_idx[grp]
            tile_entries[sorted_tiles, pos] = order.astype(np.int32)
        raw["tile_entries"] = tile_entries
        raw["max_ops"] = MO

    cache["meta"] = meta
    cache["keys"] = keys
    cache["raw"] = raw
    cache["off"] = _raw_op_offsets(raw, ops)
    return raw


def bin_frame(
    ops: list[RasterOp],
    width: int,
    height: int,
    tile_h: int = 8,
    tile_w: int = 128,
    chunk: int = 8,
    color_tiles: np.ndarray | None = None,
    backend: str = "auto",
    pools: tuple = (2, 4, 8, 24),
    supersample: int = 1,
    bin_cache: dict | None = None,
    depth_cap: int = 256,
) -> FramePlan:
    """Coarse-rasterize a frame.  backend: 'auto' uses the native C++ engine
    when built (vgtpu_torch/native), 'numpy' forces the reference implementation
    (single chunk pool of `chunk` edges — the oracle layout).

    supersample > 1: y geometry is scaled into sub-row units and tiles carry
    tile_h*ss sub-rows (conflation-free coverage, see ContextConfig)."""
    for op in ops:
        if isinstance(op.edges, list):   # finalize merged draw batches
            op.edges = np.concatenate(op.edges, axis=0)
    ss = supersample
    if ss > 1:
        ops = scale_ops_y(ops, ss)
    h_ss = height * ss
    th_ss = tile_h * ss
    # tri batches expand to per-triangle pseudo-ops: entry_op must map back
    # to the CALLER's op indices (texture sampling reads the original list)
    counts = np.array(
        [len(op.tri_paints) if op.tri_paints is not None else 1 for op in ops],
        np.int64)
    orig_of = np.repeat(np.arange(len(ops), dtype=np.int32), counts) if len(ops) else None

    def remap(plan):
        if orig_of is not None and len(orig_of) != len(ops) and plan.n_real_entries:
            valid = plan.entry_op >= 0
            plan.entry_op = np.where(
                valid, orig_of[np.maximum(plan.entry_op, 0)], plan.entry_op)
        plan.height = height
        plan.supersample = ss
        plan.depth_cap = depth_cap
        if ss > 1 and plan.color_tiles.shape[1] != tile_h:
            plan.color_tiles = np.zeros((1, tile_h, tile_w, 4), np.float32)
        return plan

    if backend == "auto":
        from vgtpu_torch import native

        raw = None
        if bin_cache is not None:
            raw = bin_frame_incremental(
                ops, width, h_ss, th_ss, tile_w, pools, bin_cache)
        if raw is None:
            raw = native.bin_frame_native(ops, width, h_ss, th_ss, tile_w, pools)
        if raw is not None:
            return remap(_assemble_native(raw, width, h_ss, th_ss, tile_w, color_tiles))
    return remap(bin_frame_numpy(expand_tri_batches(ops), width, h_ss, th_ss,
                                 tile_w, chunk, color_tiles))


def _assemble_native(raw, width, height, tile_h, tile_w, color_tiles) -> FramePlan:
    """Pad the native binner's raw arrays to device buckets (same padding as
    the numpy assembly below)."""
    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    n_entries = raw["n_entries"]
    n_chunks = sum(len(ce) for ce, _ in raw["chunk_pools"])
    NE = _bucket(max(n_entries, 1))

    def pad(a, n, fill=0):
        # np.zeros is calloc-backed (no fill pass) — this padding runs on
        # every dynamic-frame upload over ~MB of entry/chunk arrays
        out = (np.zeros((n,) + a.shape[1:], a.dtype) if fill == 0
               else np.full((n,) + a.shape[1:], fill, a.dtype))
        out[: len(a)] = a
        return out

    chunk_pools = []
    for ce, cent in raw["chunk_pools"]:
        NC = _bucket(max(len(ce), 1))
        chunk_pools.append((pad(ce, NC), pad(cent, NC, fill=NE - 1)))
    if color_tiles is None or len(color_tiles) == 0:
        color_tiles = np.zeros((1, tile_h, tile_w, 4), np.float32)

    # compact pseudo-op tables, bucketed so jit signatures stay stable:
    # row P is the pad pseudo-op (zero paint alpha + empty scissor -> no-op,
    # matching the dense pad rows below); entry_pop pad rows point at it
    P = len(raw["pop"]["kind"])
    NP = _bucket(P + 1)
    pop = {k: pad(v, NP) for k, v in raw["pop"].items()}
    entry_pop = pad(raw["entry_op"], NE, fill=P)

    return FramePlan(
        pop=pop, entry_pop=entry_pop,
        width=width, height=height, ntx=ntx, nty=nty,
        tile_h=tile_h, tile_w=tile_w,
        chunk_pools=chunk_pools,
        entry_tile=pad(raw["entry_tile"], NE),
        entry_backdrop=pad(raw["entry_backdrop"], NE),
        entry_kind=pad(raw["entry_kind"], NE, fill=K_DRAW),
        entry_rule=pad(raw["entry_rule"], NE),
        entry_aa=pad(raw["entry_aa"], NE),
        entry_paint_kind=pad(raw["entry_paint_kind"], NE),
        entry_paint=pad(raw["entry_paint"], NE),
        entry_scissor=pad(raw["entry_scissor"], NE),
        entry_image=pad(raw["entry_image"], NE, fill=-1),
        entry_op=pad(raw["entry_op"], NE, fill=-1),
        entry_color_tile=np.full(NE, -1, np.int32),
        tile_entries=raw["tile_entries"],
        color_tiles=color_tiles.astype(np.float32),
        n_real_entries=n_entries,
        n_real_chunks=n_chunks,
        stats={
            "entries": n_entries, "chunks": n_chunks,
            "max_ops_per_tile": int(
                np.bincount(raw["entry_tile"], minlength=ntx * nty).max()
            ) if n_entries else 0,
            "tiles": ntx * nty,
            "backend": "native",
        },
    )


def bin_frame_numpy(
    ops: list[RasterOp],
    width: int,
    height: int,
    tile_h: int = 8,
    tile_w: int = 128,
    chunk: int = 8,
    color_tiles: np.ndarray | None = None,
    pan_margin: bool = False,
) -> FramePlan:
    """pan_margin=True bins a RETAINED scene for device-resident panning
    (raster/retained.py): every edge is additionally assigned to the tile
    column left / tile row above its span (content only ever shifts by a
    LEFT/UP sub-tile residual in [0, tile) — whole-tile shifts are a tile
    relabel), and entry backdrops carry a 2*tile_h row window starting at the
    tile top so a y-residual becomes a dynamic row slice on device.  The
    zero-shift slice (rows [0, tile_h)) is stored as the regular
    entry_backdrop, so a pan plan also renders normally."""
    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    T = ntx * nty
    mx = float(tile_w) if pan_margin else 0.0   # leftward x-residual reach
    my = float(tile_h) if pan_margin else 0.0   # upward y-residual reach
    bd_rows = 2 * tile_h if pan_margin else tile_h

    # accumulators across ops (entry-major)
    ent_tile: list[np.ndarray] = []
    ent_backdrop: list[np.ndarray] = []
    ent_kind: list[np.ndarray] = []
    ent_rule: list[np.ndarray] = []
    ent_aa: list[np.ndarray] = []
    ent_pk: list[np.ndarray] = []
    ent_paint: list[np.ndarray] = []
    ent_scissor: list[np.ndarray] = []
    ent_image: list[np.ndarray] = []
    ent_op: list[np.ndarray] = []
    ent_ctile: list[np.ndarray] = []
    chunk_blocks: list[np.ndarray] = []
    chunk_entry: list[np.ndarray] = []
    n_entries = 0
    n_chunks = 0

    def _append_entries(tiles_flat, backdrops, op: RasterOp, op_index: int, ctile=None):
        nonlocal n_entries
        k = len(tiles_flat)
        if k == 0:
            return np.zeros(0, np.int64)
        ids = np.arange(n_entries, n_entries + k, dtype=np.int64)
        n_entries += k
        ent_tile.append(tiles_flat.astype(np.int32))
        ent_backdrop.append(backdrops.astype(np.float32))
        ent_kind.append(np.full(k, op.kind, np.int32))
        ent_rule.append(np.full(k, op.fill_rule, np.int32))
        ent_aa.append(np.full(k, 1 if op.aa else 0, np.int32))
        ent_pk.append(np.full(k, op.paint_kind, np.int32))
        paint = op.paint if op.paint is not None else np.zeros(PAINT_NF, np.float32)
        ent_paint.append(np.broadcast_to(paint, (k, PAINT_NF)).copy())
        sc = op.scissor if op.scissor is not None else (0.0, 0.0, float(width), float(height))
        ent_scissor.append(np.broadcast_to(np.asarray(sc, np.float32), (k, 4)).copy())
        ent_image.append(np.full(k, op.image_id, np.int32))
        ent_op.append(np.full(k, op_index, np.int32))
        if ctile is None:
            ent_ctile.append(np.full(k, -1, np.int32))
        else:
            ent_ctile.append(ctile.astype(np.int32))
        return ids

    for op_index, op in enumerate(ops):
        if op.kind in (K_CLIP_COMMIT, K_CLIP_RESET):
            # global control ops: present in every tile
            tiles = np.arange(T, dtype=np.int64)
            _append_entries(tiles, np.zeros((T, bd_rows), np.float32), op, op_index)
            continue

        if op.paint_kind == P_TEXTURE:
            # textured quads (parallelograms p0 + a*ex + b*ey): entries for
            # every tile a quad bbox overlaps; color tiles are filled by the
            # sampling pass (raster/sampling.py).  pan margin: content only
            # shifts left/up by a sub-tile residual, so the bbox extends one
            # tile on the min side (the left/upper neighbour tiles need
            # entries for quads that can shift into them)
            q = np.asarray(op.tex_quads, np.float64)
            if len(q) == 0:
                continue
            cx = np.stack([q[:, 0], q[:, 0] + q[:, 2], q[:, 0] + q[:, 4], q[:, 0] + q[:, 2] + q[:, 4]])
            cy = np.stack([q[:, 1], q[:, 1] + q[:, 3], q[:, 1] + q[:, 5], q[:, 1] + q[:, 3] + q[:, 5]])
            sc = op.scissor if op.scissor is not None else (0.0, 0.0, float(width), float(height))
            qx0 = np.maximum(cx.min(axis=0) - 1.0 - mx, max(0.0, sc[0] - mx))
            qy0 = np.maximum(cy.min(axis=0) - 1.0 - my, max(0.0, sc[1] - my))
            qx1 = np.minimum(cx.max(axis=0) + 1.0, min(float(width), sc[2]))
            qy1 = np.minimum(cy.max(axis=0) + 1.0, min(float(height), sc[3]))
            live = (qx1 > qx0) & (qy1 > qy0)
            grid = np.zeros((nty, ntx), bool)
            qtx0 = (qx0[live] // tile_w).astype(np.int64)
            qtx1 = (np.ceil(qx1[live] / tile_w)).astype(np.int64) - 1
            qty0 = (qy0[live] // tile_h).astype(np.int64)
            qty1 = (np.ceil(qy1[live] / tile_h)).astype(np.int64) - 1
            for a, b, c2, d2 in zip(qty0, qty1, qtx0, qtx1):
                grid[a : b + 1, c2 : d2 + 1] = True
            lty, ltx = np.nonzero(grid)
            if len(lty) == 0:
                continue
            tiles = lty * ntx + ltx
            _append_entries(tiles.astype(np.int64),
                            np.zeros((len(tiles), bd_rows), np.float32), op, op_index)
            continue

        e = op.edges
        if e is None or len(e) == 0:
            continue
        e = np.asarray(e, np.float64)
        finite = np.isfinite(e).all(axis=1)
        live = finite & (np.abs(e[:, 3] - e[:, 1]) > 1e-9)
        e = e[live]
        if len(e) == 0:
            continue

        ex0, ey0, ex1, ey1 = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
        exmin = np.minimum(ex0, ex1)
        exmax = np.maximum(ex0, ex1)
        eymin = np.minimum(ey0, ey1)
        eymax = np.maximum(ey0, ey1)

        sc = op.scissor if op.scissor is not None else (0.0, 0.0, float(width), float(height))
        rx0 = max(0.0, sc[0] - mx)
        ry0 = max(0.0, sc[1] - my)
        rx1 = min(float(width), sc[2], float(np.ceil(exmax.max())))
        ry1 = min(float(height), sc[3], float(np.ceil(eymax.max())))
        ry0 = max(ry0, float(np.floor(eymin.min() - my)))
        if rx1 <= rx0 or ry1 <= ry0:
            continue
        tx0 = int(rx0 // tile_w)
        tx1 = int(np.ceil(rx1 / tile_w)) - 1
        ty0 = int(ry0 // tile_h)
        ty1 = int(np.ceil(ry1 / tile_h)) - 1
        ntx_op = tx1 - tx0 + 1
        nty_op = ty1 - ty0 + 1

        # per-edge tile ranges (pan margin: also the tile column left / tile
        # row above the span — residual shifts only move content left/up)
        ety_lo = np.maximum(np.floor((eymin - my) / tile_h).astype(np.int64), ty0)
        ety_hi = np.minimum(((np.ceil(eymax) - 1) // tile_h).astype(np.int64), ty1)
        etx_lo = np.maximum(np.floor((exmin - 1.0 - mx) / tile_w).astype(np.int64), tx0)
        etx_hi_e = np.minimum(((np.ceil(exmax) - 1) // tile_w).astype(np.int64), tx1)
        ok = (ety_lo <= ety_hi) & (etx_lo <= tx1)
        idx = np.nonzero(ok)[0]
        if len(idx) == 0:
            continue

        sgn = np.sign(ey1 - ey0)

        # ---- expand (edge, ty) pairs ----
        nty_e = (ety_hi[idx] - ety_lo[idx] + 1)
        pe = np.repeat(idx, nty_e)                       # edge index per pair
        base = np.concatenate([[0], np.cumsum(nty_e)[:-1]])
        loc = np.arange(nty_e.sum(), dtype=np.int64) - np.repeat(base, nty_e)
        pty = ety_lo[idx].repeat(nty_e) + loc            # tile row per pair

        # per-(edge,ty) row overlaps for backdrop use (pan: 2*tile_h window
        # rows starting at the tile top, sliced by the y-residual on device)
        rowy = (pty * tile_h)[:, None] + np.arange(bd_rows)[None, :]
        ov = np.clip(
            np.minimum(eymax[pe][:, None], rowy + 1.0)
            - np.maximum(eymin[pe][:, None], rowy),
            0.0,
            1.0,
        ) * sgn[pe][:, None]

        # split pairs into edge-class x-span and backdrop-class x-span
        p_etx_lo = etx_lo[pe]
        p_etx_hi = etx_hi_e[pe]                          # may be < p_etx_lo (edge fully left)
        has_edge_span = p_etx_hi >= p_etx_lo
        b_lo = np.maximum(p_etx_hi + 1, tx0)             # backdrop span: (edge-hi, tx1]

        # ---- edge-class (edge, ty, tx) triples ----
        e_cnt = np.where(has_edge_span, p_etx_hi - p_etx_lo + 1, 0)
        te = np.repeat(np.arange(len(pe)), e_cnt)        # pair index per triple
        base2 = np.concatenate([[0], np.cumsum(e_cnt)[:-1]])
        loc2 = np.arange(e_cnt.sum(), dtype=np.int64) - np.repeat(base2, e_cnt)
        ttx = p_etx_lo[te] + loc2
        tty = pty[te]
        tedge = pe[te]

        # ---- backdrop accumulation on the op's dense tile grid ----
        # difference-array along tx then cumsum: ov added to [b_lo, tx1]
        bgrid = np.zeros((nty_op, ntx_op + 1, bd_rows), np.float64)
        bsel = b_lo <= tx1
        np.add.at(bgrid, (pty[bsel] - ty0, b_lo[bsel] - tx0), ov[bsel])
        bgrid = np.cumsum(bgrid, axis=1)[:, :-1, :]

        # ---- entries: tiles with edges or nonzero backdrop ----
        egrid = np.zeros((nty_op, ntx_op), np.int64)
        np.add.at(egrid, (tty - ty0, ttx - tx0), 1)
        tile_live = (egrid > 0) | (np.abs(bgrid).max(axis=2) > 1e-9)
        lty, ltx = np.nonzero(tile_live)
        if len(lty) == 0:
            continue
        tiles_flat = (lty + ty0) * ntx + (ltx + tx0)
        # entry index per live tile on the op grid
        entry_of_tile = np.full((nty_op, ntx_op), -1, np.int64)
        ids = _append_entries(tiles_flat, bgrid[lty, ltx], op, op_index)
        entry_of_tile[lty, ltx] = ids

        # ---- chunks: group edge-class triples by tile, split by CHUNK ----
        if len(te):
            order = np.lexsort((np.arange(len(te)), tty * ntx + ttx))
            s_tty = tty[order] - ty0
            s_ttx = ttx[order] - tx0
            s_edge = tedge[order]
            tkey = s_tty * ntx_op + s_ttx
            # position within tile group
            grp_start = np.concatenate([[True], tkey[1:] != tkey[:-1]])
            grp_id = np.cumsum(grp_start) - 1
            first_of_grp = np.nonzero(grp_start)[0]
            pos_in_grp = np.arange(len(tkey)) - first_of_grp[grp_id]
            cidx_in_grp = pos_in_grp // chunk
            # global chunk ids: number chunks per group
            chunks_per_grp = (np.bincount(grp_id) + chunk - 1) // chunk
            chunk_base = np.concatenate([[0], np.cumsum(chunks_per_grp)[:-1]])
            gchunk = chunk_base[grp_id] + cidx_in_grp
            n_op_chunks = int(chunks_per_grp.sum())
            pos_in_chunk = pos_in_grp % chunk

            ce = np.zeros((n_op_chunks, chunk, 4), np.float32)
            # tile-origin-relative coordinates
            tile_ox = (s_ttx + tx0) * tile_w
            tile_oy = (s_tty + ty0) * tile_h
            rel = e[s_edge].copy()
            rel[:, 0] -= tile_ox
            rel[:, 2] -= tile_ox
            rel[:, 1] -= tile_oy
            rel[:, 3] -= tile_oy
            ce[gchunk, pos_in_chunk] = rel.astype(np.float32)

            centry = np.zeros(n_op_chunks, np.int64)
            centry[gchunk] = entry_of_tile[s_tty, s_ttx]
            chunk_blocks.append(ce)
            chunk_entry.append(centry)
            n_chunks += n_op_chunks

    # ---- assemble + pad ----
    NE = _bucket(max(n_entries, 1))
    NC = _bucket(max(n_chunks, 1))

    def cat(parts, shape_tail, dtype, fill=0):
        out = np.full((NE,) + shape_tail, fill, dtype)
        if parts:
            data = np.concatenate(parts, axis=0)
            out[: len(data)] = data
        return out

    entry_tile = cat(ent_tile, (), np.int32, fill=0)
    bd_full = cat(ent_backdrop, (bd_rows,), np.float32)
    entry_backdrop = bd_full[:, :tile_h]   # zero-shift rows
    entry_kind = cat(ent_kind, (), np.int32, fill=K_DRAW)
    entry_rule = cat(ent_rule, (), np.int32)
    entry_aa = cat(ent_aa, (), np.int32)
    entry_paint_kind = cat(ent_pk, (), np.int32)
    entry_paint = cat(ent_paint, (PAINT_NF,), np.float32)
    entry_scissor = cat(ent_scissor, (4,), np.float32)
    entry_image = cat(ent_image, (), np.int32, fill=-1)
    entry_op = cat(ent_op, (), np.int32, fill=-1)
    entry_ctile = cat(ent_ctile, (), np.int32, fill=-1)
    # padding entries: draw with zero paint alpha and empty scissor -> no-ops
    entry_scissor[n_entries:] = 0.0

    chunk_edges = np.zeros((NC, chunk, 4), np.float32)
    chunk_entry_arr = np.full((NC,), NE - 1, np.int32)  # pad chunks -> last pad entry
    if chunk_blocks:
        cb = np.concatenate(chunk_blocks, axis=0)
        centry = np.concatenate(chunk_entry, axis=0)
        chunk_edges[: len(cb)] = cb
        chunk_entry_arr[: len(centry)] = centry.astype(np.int32)
    chunk_pools = [(chunk_edges, chunk_entry_arr)]

    # per-tile draw-ordered entry table
    et = entry_tile[:n_entries].astype(np.int64)
    counts = np.bincount(et, minlength=T)
    max_ops = int(counts.max()) if n_entries else 0
    MAX_OPS = _bucket_pow2(max(max_ops, 1), minimum=4)  # matches native table stride
    tile_entries = np.full((T, MAX_OPS), -1, np.int32)
    if n_entries:
        order = np.lexsort((np.arange(n_entries), et))
        sorted_tiles = et[order]
        first = np.concatenate([[True], sorted_tiles[1:] != sorted_tiles[:-1]])
        firsts_idx = np.nonzero(first)[0]
        grp = np.cumsum(first) - 1
        pos = np.arange(n_entries) - firsts_idx[grp]
        tile_entries[sorted_tiles, pos] = order.astype(np.int32)

    if color_tiles is None or len(color_tiles) == 0:
        color_tiles = np.zeros((1, tile_h, tile_w, 4), np.float32)

    return FramePlan(
        width=width,
        height=height,
        ntx=ntx,
        nty=nty,
        tile_h=tile_h,
        tile_w=tile_w,
        chunk_pools=chunk_pools,
        entry_tile=entry_tile,
        entry_backdrop=entry_backdrop,
        entry_backdrop_pan=bd_full if pan_margin else None,
        entry_kind=entry_kind,
        entry_rule=entry_rule,
        entry_aa=entry_aa,
        entry_paint_kind=entry_paint_kind,
        entry_paint=entry_paint,
        entry_scissor=entry_scissor,
        entry_image=entry_image,
        entry_op=entry_op,
        entry_color_tile=entry_ctile,
        tile_entries=tile_entries,
        color_tiles=color_tiles.astype(np.float32),
        n_real_entries=n_entries,
        n_real_chunks=n_chunks,
        stats={
            "entries": n_entries,
            "chunks": n_chunks,
            "max_ops_per_tile": max_ops,
            "tiles": T,
        },
    )
