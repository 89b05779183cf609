# Copied from vgtpu/api/command_list.py: the jax-free host half of the PyTorch port.
"""Command lists: retained, replayable scenes + geometry caching.

Reference: vg.cpp:2323-2966 (byte-buffer recording), :4273-4637 (interpreter),
:5674-6211 (tessellation cache).  Differences by design:

  - recording is a python op list, not a 16-byte-aligned byte stream — the
    device-facing retained format is the cached geometry itself;
  - the Cacheable cache stores stroked/flattened EDGES in submit-base-local
    space, keyed by the base transform's avgScale (the reference caches
    stroker meshes the same way and with the same invalidation rule,
    vg.cpp:4287-4300): translation/rotation re-submits re-transform the cached
    edges, scale changes re-tessellate;
  - gradient/pattern handles created inside a list are local and re-created at
    each submit (the reference rebases local handles, vg.cpp:2732-2734,:4423).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vgtpu_torch import core
from vgtpu_torch.core import CommandListFlags


# commands that create/advance path geometry (skippable on cached replay)
_PATH_CMDS = frozenset(
    "beginPath moveTo lineTo cubicTo quadraticTo arcTo arc rect roundedRect "
    "roundedRectVarying circle ellipse polyline closePath "
    "appendPackedPath".split()
)
_DRAW_CMDS = frozenset("fillPath strokePath".split())
_GRADIENT_CMDS = frozenset(
    "createLinearGradient createBoxGradient createRadialGradient createImagePattern".split()
)
# context-state mutators that LEAK out of a submit unless wrapped in a
# balanced pushState/popState (op-list memoization refuses such lists when
# command_list_preserve_state is off)
_STATE_MUT_CMDS = frozenset(
    "setScissor intersectScissor resetScissor setGlobalAlpha setViewBox "
    "transformTranslate transformScale transformRotate transformMult "
    "transformIdentity".split()
)


def _commands_state_clean(cmds) -> bool:
    """True when replaying `cmds` cannot change observable context state:
    state mutators only inside balanced pushState/popState, clips balanced,
    no nested submits."""
    depth = 0
    clip = 0
    for name, _a, _k in cmds:
        if name == "pushState":
            depth += 1
        elif name == "popState":
            if depth == 0:
                return False
            depth -= 1
        elif name == "beginClip":
            clip += 1
        elif name == "endClip":
            clip -= 1
            if clip < 0:
                return False
        elif name == "submitCommandList":
            return False
        elif name in _STATE_MUT_CMDS and depth == 0:
            return False
    return depth == 0 and clip == 0


@dataclass
class CommandList:
    handle_idx: int
    flags: int
    commands: list = field(default_factory=list)
    n_local_gradients: int = 0
    n_local_patterns: int = 0
    # geometry cache (Cacheable)
    cache_valid: bool = False
    cache_avg_scale: float = -1.0
    cache_dpr: float = -1.0
    cache_inv_base: np.ndarray | None = None
    cache_slots: dict[int, list] = field(default_factory=dict)  # cmd idx -> [(edges_local, closed_meta)]
    # batched-replay cache: every cached edge concatenated + per-slot spans
    cache_concat: np.ndarray | None = None
    cache_spans: dict[int, list] | None = None

    def _rec(self, name, *args, **kwargs):
        self.commands.append((name, args, kwargs))
        self.cache_valid = False

    # -- recording surface (mirrors Context's mutator API) ------------------
    def __getattr__(self, name):
        # only called for missing attributes: record-through for mutators.
        # Restricted to names that exist on Context — a catch-all would also
        # swallow getattr/hasattr probes for genuinely absent attributes
        # (returning a recorder closure where e.g. cl_save expected None) and
        # would silently record typo'd calls instead of raising.
        from vgtpu_torch.api.context import Context

        # submitCommandList is a free function (nested submit records here)
        if name.startswith("_") or (
            name != "submitCommandList"
            and not callable(getattr(Context, name, None))
        ):
            raise AttributeError(name)

        def rec(*args, **kwargs):
            self._rec(name, *args, **kwargs)

        return rec

    def createLinearGradient(self, *args):
        from vgtpu_torch.api.context import GradientHandle

        self._rec("createLinearGradient", *args)
        self.n_local_gradients += 1
        return GradientHandle(idx=self.n_local_gradients - 1, flags=1)  # local

    def createBoxGradient(self, *args):
        from vgtpu_torch.api.context import GradientHandle

        self._rec("createBoxGradient", *args)
        self.n_local_gradients += 1
        return GradientHandle(idx=self.n_local_gradients - 1, flags=1)

    def createRadialGradient(self, *args):
        from vgtpu_torch.api.context import GradientHandle

        self._rec("createRadialGradient", *args)
        self.n_local_gradients += 1
        return GradientHandle(idx=self.n_local_gradients - 1, flags=1)

    def createImagePattern(self, *args):
        from vgtpu_torch.api.context import ImagePatternHandle

        self._rec("createImagePattern", *args)
        self.n_local_patterns += 1
        return ImagePatternHandle(idx=self.n_local_patterns - 1, flags=1)

    def reset(self):
        self.commands.clear()
        self.n_local_gradients = 0
        self.n_local_patterns = 0
        self.cache_valid = False
        self.cache_slots.clear()
        self.cache_concat = None
        self.cache_spans = None


# ---------------------------------------------------------------------------
# free functions used by vgtpu_torch.api.context
# ---------------------------------------------------------------------------

def cl_create(ctx, flags: int):
    from vgtpu_torch.api.context import CommandListHandle

    if len(ctx.command_lists) >= ctx.cfg.max_command_lists:
        return CommandListHandle()
    idx = ctx._next_cl_idx
    ctx._next_cl_idx += 1
    ctx.command_lists[idx] = CommandList(idx, flags)
    return CommandListHandle(idx=idx)


def cl_destroy(ctx, handle):
    ctx.command_lists.pop(handle.idx, None)


def cl_reset(ctx, handle):
    cl = ctx.command_lists.get(handle.idx)
    if cl is not None:
        cl.reset()


def cl_begin_recording(ctx, handle):
    cl = ctx.command_lists.get(handle.idx)
    if cl is None:
        raise ValueError("invalid command list")
    ctx._active_cl = cl


def cl_end_recording(ctx):
    ctx._active_cl = None


_CL_SNAPSHOT_VERSION = 1


def cl_save(ctx, handle, path: str) -> bool:
    """Serialize a command list — commands, local-handle counts, and (when
    built) the tessellation cache — to `path`.

    This is the checkpoint/resume analogue of the reference's retained
    byte stream + shape cache (SURVEY §5; vg.cpp:2323-2966, :5674-6211
    are memory-resident only).  A Cacheable list restored via cl_load
    renders WITHOUT re-tessellating: the cached base-local edges travel in
    the snapshot.

    Global resource handles (images, fonts) serialize by VALUE; the loading
    context must recreate those resources in the same order.  The format is
    a version-tagged pickle — load only files you saved.  The pickle names
    the classes of the recorded arguments by module path, so a snapshot
    saved by vgtpu_torch loads in vgtpu_torch; one saved by vgtpu would
    need the vgtpu package to load, and loading it here is not supported."""
    import pickle

    cl = ctx.command_lists.get(handle.idx)
    if cl is None:
        return False
    snap = {
        "version": _CL_SNAPSHOT_VERSION,
        "flags": cl.flags,
        "commands": cl.commands,
        "n_local_gradients": cl.n_local_gradients,
        "n_local_patterns": cl.n_local_patterns,
        "cache_valid": cl.cache_valid,
        "cache_avg_scale": cl.cache_avg_scale,
        "cache_dpr": cl.cache_dpr,
        "cache_slots": cl.cache_slots,
        "cache_concat": cl.cache_concat,
        "cache_spans": cl.cache_spans,
    }
    with open(path, "wb") as f:
        pickle.dump(snap, f)
    return True


def cl_load(ctx, path: str):
    """Restore a command list saved by cl_save into this context; returns a
    fresh CommandListHandle.  Raises on any unusable file — OSError for a
    missing/unreadable path, pickle errors for a corrupt file, ValueError
    for a version mismatch — one loud failure contract rather than a
    silently-invalid handle."""
    import pickle

    with open(path, "rb") as f:
        snap = pickle.load(f)
    if snap.get("version") != _CL_SNAPSHOT_VERSION:
        raise ValueError(
            f"command-list snapshot version {snap.get('version')} != "
            f"{_CL_SNAPSHOT_VERSION}")
    h = cl_create(ctx, snap["flags"])
    cl = ctx.command_lists.get(h.idx)
    if cl is None:
        return h
    cl.commands = snap["commands"]
    cl.n_local_gradients = snap["n_local_gradients"]
    cl.n_local_patterns = snap["n_local_patterns"]
    cl.cache_valid = snap["cache_valid"]
    cl.cache_avg_scale = snap["cache_avg_scale"]
    cl.cache_dpr = snap["cache_dpr"]
    cl.cache_slots = snap["cache_slots"]
    if snap.get("cache_concat") is not None:
        cl.cache_concat = snap["cache_concat"]
        cl.cache_spans = snap["cache_spans"]
    return h


def cl_submit(ctx, handle):
    """ctxSubmitCommandList (vg.cpp:4273-4637) + clCacheRender (vg.cpp:5845)."""
    from vgtpu_torch.api.context import GradientHandle, ImagePatternHandle

    cl = ctx.command_lists.get(handle.idx)
    if cl is None:
        return
    if ctx._submit_depth >= ctx.cfg.max_command_list_depth:
        return
    ctx._submit_depth += 1
    try:
        cacheable = ctx.cfg.enable_shape_caching and (cl.flags & CommandListFlags.Cacheable)
        culling = bool(cl.flags & CommandListFlags.AllowCommandCulling)
        preserve = ctx.cfg.command_list_preserve_state
        if preserve:
            ctx.pushState()

        base_transform = ctx.state.transform.copy()
        base_avg_scale = ctx.state.avg_scale

        use_cache = (
            cacheable
            and cl.cache_valid
            and abs(cl.cache_avg_scale - base_avg_scale) < 1e-6
            and abs(cl.cache_dpr - ctx.dpr) < 1e-6
        )
        build_cache = cacheable and not use_cache
        if build_cache:
            cl.cache_slots.clear()
            cl._ops_memo = None
            cl._layer_scene = None
            cl._layer_last = None

        # --- translated-layer fast path (clCacheRender generalized) --------
        # the reference re-submits cached meshes under ANY new transform at
        # memcpy cost (vg.cpp:5845-6120); the op-list memo below only covers
        # the IDENTICAL transform.  A Cacheable list re-submitted FIRST in
        # the frame with the same linear transform but a new translation
        # renders as a retained-scene LAYER instead (backdrop windows + tile
        # relabel, zero host replay); end() bins only the ops drawn after it.
        if (use_cache and ctx.cfg.layer_memo and ctx.cfg.frame_memo
                and ctx._submit_depth == 1 and not ctx.ops
                and not ctx._recording_clip
                and not ctx.state.scissor_explicit
                and (preserve or _commands_state_clean(cl.commands))):
            if _layer_submit(ctx, cl, base_transform):
                if preserve:
                    ctx.popState()
                    ctx.resetClip()
                return

        # --- op-list memoization -------------------------------------------
        # A cached-replay submit is a pure function of (commands, base
        # transform, state, atlas revision): when NOTHING it depends on
        # changed since the last submit, re-emit the SAME RasterOp objects
        # instead of re-walking the interpreter (the reference replays a
        # byte stream in ~µs, vg.cpp:4332; the Python walk costs ~10 ms on
        # the tiger list).  Shared ops are immutable after their first
        # frame's finalize; the _block_merge_once fences stop _emit from
        # merging a neighbour INTO a shared op.
        memo_ok = (use_cache and not ctx._recording_clip
                   and (preserve or _commands_state_clean(cl.commands)))
        memo_key = None
        if memo_ok:
            fs = getattr(ctx, "font_system", None)
            atlas_rev = ((fs.atlas.generation, fs.atlas.revision)
                         if fs is not None else None)
            memo_key = (
                base_transform.tobytes(), float(ctx.dpr),
                float(ctx.state.global_alpha),
                tuple(float(x) for x in ctx.state.scissor),
                bool(ctx.state.scissor_explicit),
                culling, ctx.fb_width, ctx.fb_height, atlas_rev,
            )
            memo = getattr(cl, "_ops_memo", None)
            if memo is not None and memo[0] == memo_key:
                ctx.ops.extend(memo[1])
                ctx._block_merge_once = True   # fence: next _emit must not
                if preserve:                   # merge into a shared op
                    ctx.popState()
                    ctx.resetClip()
                return
        n_ops0 = len(ctx.ops)
        has_nested = False
        if memo_ok:
            # fence: the first list op must not merge backward into a
            # pre-submit op, or the captured segment would be incomplete
            ctx._block_merge_once = True
        cache_fb = None
        if use_cache and cl.cache_concat is not None:
            # ONE batched transform of every cached edge for this submit (the
            # rebase matrix is submit-constant); per-draw replay then slices.
            # The reference's analogue is batchTransformPositions over the
            # cached mesh (submitCachedMesh, vg.cpp:6137-6211) — but per mesh.
            rb = core.xform_multiply(
                core.xform_scale(ctx.dpr, ctx.dpr), base_transform)
            cc = cl.cache_concat
            cache_fb = np.concatenate(
                [core.xform_points(rb, cc[:, 0:2]),
                 core.xform_points(rb, cc[:, 2:4])], axis=1).astype(np.float32)

        # rebase matrix for cached replay: new_base . old_base^-1 is folded by
        # storing edges in base-local space and applying the current base.
        local_gradients: list[GradientHandle] = []
        local_patterns: list[ImagePatternHandle] = []

        def xlat(h):
            if isinstance(h, GradientHandle) and h.flags == 1:
                return local_gradients[h.idx]
            if isinstance(h, ImagePatternHandle) and h.flags == 1:
                return local_patterns[h.idx]
            return h

        # cached op edges live in FRAMEBUFFER space (they went through
        # _render_transform, which pre-multiplies the dpr viewport scale), so
        # the rebase must use the full render transform, not the logical one
        render_base = core.xform_multiply(
            core.xform_scale(ctx.dpr, ctx.dpr), base_transform)
        inv_base = core.xform_invert(render_base)

        for ci, (name, args, kwargs) in enumerate(cl.commands):
            if name in _GRADIENT_CMDS:
                h = getattr(ctx, name)(*args, **kwargs)
                if name == "createImagePattern":
                    local_patterns.append(h)
                else:
                    local_gradients.append(h)
                continue

            if use_cache and name in _PATH_CMDS:
                continue  # geometry comes from the cache

            if name in _DRAW_CMDS:
                s = ctx.state.scissor
                # culling NEVER applies while BUILDING the cache: a draw
                # skipped during the build would have no cache slot, and a
                # later (differently-scissored) cached replay would fall back
                # to drawing whatever transient path state happens to exist.
                # Cached replays cull per-slot from the cached bounds instead.
                if culling and not build_cache and (s[2] < 1.0 or s[3] < 1.0):
                    continue
                args = tuple(xlat(a) for a in args)
                if use_cache:
                    _replay_cached_draw(ctx, cl, ci, name, args, kwargs,
                                        base_transform, culling=culling,
                                        cache_fb=cache_fb)
                    continue
                if culling and not build_cache and _draw_outside_scissor(ctx, name, args):
                    continue
                n_ops_before = len(ctx.ops)
                if build_cache:
                    # merging would fold this draw into an earlier op and the
                    # cache slot would come out empty — suppress while caching;
                    # geometry must also be immediate (the cache captures this
                    # draw's edges right below)
                    ctx._suppress_merge = True
                    ctx._immediate_geom = True
                try:
                    getattr(ctx, name)(*args, **kwargs)
                finally:
                    ctx._suppress_merge = False
                    ctx._immediate_geom = False
                if build_cache:
                    slot = []
                    for op in ctx.ops[n_ops_before:]:
                        if op.edges is not None and len(op.edges):
                            pts0 = core.xform_points(inv_base, np.ascontiguousarray(op.edges[:, 0:2]))
                            pts1 = core.xform_points(inv_base, np.ascontiguousarray(op.edges[:, 2:4]))
                            slot.append((np.concatenate([pts0, pts1], axis=1), op.kind))
                        else:
                            slot.append(None)
                    cl.cache_slots[ci] = slot
                continue

            if name == "submitCommandList":
                has_nested = True
                cl_submit(ctx, args[0])
                continue

            # state / path / clip / text commands replay directly
            args = tuple(xlat(a) for a in args)
            getattr(ctx, name)(*args, **kwargs)

        if (memo_ok and not has_nested
                and all(op.geom is None for op in ctx.ops[n_ops0:])):
            # nested submits' ops depend on the CHILD list's state, which
            # this key can't see, and ops with unresolved deferred geometry
            # may SPLIT during finalize — don't memoize either
            cl._ops_memo = (memo_key, list(ctx.ops[n_ops0:]))
            ctx._block_merge_once = True   # next op must not merge into the
                                           # now-shared segment tail
        note = getattr(ctx, "_layer_bake_note", None)
        if note is not None and note[0] is cl and ctx._submit_depth == 1:
            # _layer_submit saw the translation start moving: hand end()
            # this submit's op range to bake as the list's retained scene
            ctx._layer_bake_note = None
            ctx._layer_bake_req = note + (len(ctx.ops),)
            ctx._block_merge_once = True   # keep the range self-contained
        if build_cache:
            cl.cache_valid = True
            cl.cache_avg_scale = base_avg_scale
            cl.cache_dpr = ctx.dpr
            # concatenated base-local edges + per-(cmd, item) spans for the
            # batched per-submit transform above
            parts, spans, off = [], {}, 0
            for ci2, slot in cl.cache_slots.items():
                ss = []
                for item in slot:
                    if item is None or not len(item[0]):
                        ss.append(None)
                    else:
                        n = len(item[0])
                        parts.append(item[0])
                        ss.append((off, n))
                        off += n
                spans[ci2] = ss
            cl.cache_concat = (np.concatenate(parts, axis=0)
                               if parts else np.zeros((0, 4), np.float32))
            cl.cache_spans = spans
        if preserve:
            ctx.popState()
            ctx.resetClip()
    finally:
        ctx._submit_depth -= 1


def _stroke_pad_fb(ctx, name, args) -> float:
    """Conservative framebuffer-space bbox inflation for a draw command:
    AA fringe, plus (for strokes) the scaled width times the miter-limit
    factor — mirrors the bounds test of the reference's command culling
    (skipCmds, vg.cpp:4338-4341, :4534-4567)."""
    pad = ctx.fringe * ctx.dpr
    if name == "strokePath":
        width = args[1]
        flags = args[2]
        sw = (width if (flags & core.StrokeFlags.FixedWidth)
              else float(min(max(width * ctx.state.avg_scale, 0.0), 200.0)) * ctx.dpr)
        pad += 2.0 * max(sw, ctx.fringe * ctx.dpr)   # half-width x miter limit 4
    return pad


def _bbox_outside_scissor(ctx, x0, y0, x1, y1, pad: float) -> bool:
    sc = ctx._scissor_rect()
    return (x1 + pad <= sc[0] or x0 - pad >= sc[2]
            or y1 + pad <= sc[1] or y0 - pad >= sc[3])


def _draw_outside_scissor(ctx, name, args) -> bool:
    """Per-command scissor culling on the direct replay path: conservative
    control-hull bounds from the RAW path data (no flattening — a per-path
    bake here would re-introduce the marshalling the batched vg_frame_geom
    call removed), transformed corner-wise, against the current scissor.

    The transform must be the one the draw would RENDER with: the first-draw
    capture when a prior draw of this path already captured it
    (Context._draw_xf_tuple), else the live transform — without capturing,
    since a culled draw must not capture (the reference's skipped commands
    never run transformPath)."""
    b = ctx.path.control_bounds()
    if b is None:
        return False
    m = ctx._path_xf
    if m is None:
        m = ctx._render_transform()
    xs, ys = [], []
    for cx, cy in ((b[0], b[1]), (b[2], b[1]), (b[0], b[3]), (b[2], b[3])):
        x, y = core.xform_point(m, cx, cy)
        xs.append(x)
        ys.append(y)
    return _bbox_outside_scissor(
        ctx, min(xs), min(ys), max(xs), max(ys), _stroke_pad_fb(ctx, name, args))


def _layer_submit(ctx, cl, base_transform) -> bool:
    """Translation-generalized cached replay (missing reference parity:
    clCacheRender re-transforms cached meshes under any new matrix at
    ~memcpy cost, vg.cpp:5845-6120 + the avgScale-only invalidation rule
    vg.cpp:4287-4300; the op-list memo covers only the IDENTICAL
    transform).

    When this list's submit translation starts MOVING, one normal replay
    bakes its ops as a RetainedScene (Context._layer_cl_bake); every later
    submit with the same linear transform + dpr + alpha renders the scene
    at the new offset as the frame's layer tiles — zero host replay, zero
    rebin of the artwork.  view_y must land on whole sub-rows (integer
    pixels at ss=1; 1/ss-pixel steps on supersampled scenes — the retained
    formulation's constraint); other fractional vertical pans fall back to
    the host replay.  Pixel parity is float-level, exactly like the reference's
    re-transformed cached meshes vs retessellated geometry.

    Returns True when the submit is satisfied by a scheduled layer."""
    key = (base_transform[:4].tobytes(), float(ctx.dpr),
           float(ctx.state.global_alpha), ctx.fb_width, ctx.fb_height)
    tx, ty = float(base_transform[4]), float(base_transform[5])
    st = getattr(cl, "_layer_scene", None)
    if st is not None and st["key"] == key:
        dx = (tx - st["tx"]) * ctx.dpr
        dy = (ty - st["ty"]) * ctx.dpr
        # vertical offsets must land on whole sub-rows (integer pixels at
        # ss=1; 1/ss-pixel granularity on supersampled scenes)
        ssq = st["scene"].ss
        dyq = round(dy * ssq) / ssq
        if abs(dy - dyq) > 1e-6:
            return False
        ctx._pending_layer = {
            "scene": st["scene"],
            "view": (-dx, -dyq),
            "token": (id(cl), st["gen"], dx, dyq),
        }
        ctx.profiler.count("layer_cl_hits", 1)
        return True
    last = getattr(cl, "_layer_last", None)
    cl._layer_last = (key, tx, ty)
    if (last is not None and last[0] == key
            and (last[1] != tx or last[2] != ty)):
        ctx._layer_bake_note = (cl, key, tx, ty)
    return False


def _replay_cached_draw(ctx, cl, ci, name, args, kwargs, base_transform,
                        culling: bool = False, cache_fb=None):
    """Re-emit cached geometry under the current base transform, resolving the
    paint with current state (submitCachedMesh, vg.cpp:6137-6211).

    The op kind is derived from the CURRENT clip-recording state, not from the
    kind recorded at cache-build time: the reference routes cached meshes
    through the stencil path per the live m_RecordClipCommands, so a cache
    primed outside a clip replays correctly inside beginClip/endClip and vice
    versa.  Stroke paints go through the thin-stroke alpha law
    (vg.cpp:3416-3420) exactly like the direct path."""
    import numpy as _np

    from vgtpu_torch.raster.binning import K_CLIP_ADD, K_DRAW, RasterOp, make_solid_paint

    slot = cl.cache_slots.get(ci)
    if slot is None:
        # never built (e.g. draw was culled during caching) — fall back
        getattr(ctx, name)(*args, **kwargs)
        return

    # resolve paint exactly like the non-cached path would (clip recording
    # forces black solid + no AA, ctxFillPathColor vg.cpp:3070-3082)
    if name == "fillPath":
        if ctx._recording_clip:
            resolved = (0, make_solid_paint(_np.array([0, 0, 0, 1], _np.float32)), None)
        else:
            resolved = ctx._resolve_paint(args[0], kwargs.get("color_modulate"))
        flags = args[1]
        from vgtpu_torch.core import fill_flags_aa, fill_flags_rule

        aa = (not ctx.cfg.force_aa_off) and (not ctx._recording_clip) and fill_flags_aa(flags)
        rule = fill_flags_rule(flags)
    else:
        # strokePath(paint, width, flags): thin-stroke alpha from the recorded
        # width and the CURRENT state (clip recording handled inside)
        resolved, _sw = ctx._resolve_stroke_paint(
            args[0], args[1], args[2], kwargs.get("color_modulate"))
        flags = args[2]
        from vgtpu_torch.core import FillRule, stroke_flags_aa

        aa = (not ctx.cfg.force_aa_off) and (not ctx._recording_clip) and stroke_flags_aa(flags)
        rule = FillRule.NonZero
    if resolved is None:
        return
    pk, paint, img = resolved

    kind = K_CLIP_ADD if ctx._recording_clip else K_DRAW
    sciss = ctx._op_scissor()
    # cached edges are the final stroked outline, so only the AA fringe pads
    pad = ctx.fringe * ctx.dpr if culling else 0.0
    spans = (cl.cache_spans or {}).get(ci) if cache_fb is not None else None
    render_base = None
    if spans is None:
        render_base = core.xform_multiply(
            core.xform_scale(ctx.dpr, ctx.dpr), base_transform)
    for ii, item in enumerate(slot):
        if item is None:
            continue
        edges_local, _built_kind = item
        if not len(edges_local):
            continue
        if spans is not None and spans[ii] is not None:
            off, n = spans[ii]
            edges = cache_fb[off : off + n]
        else:
            p0 = core.xform_points(render_base, np.ascontiguousarray(edges_local[:, 0:2]))
            p1 = core.xform_points(render_base, np.ascontiguousarray(edges_local[:, 2:4]))
            edges = np.concatenate([p0, p1], axis=1).astype(np.float32)
        if culling and _bbox_outside_scissor(
            ctx,
            min(float(edges[:, 0].min()), float(edges[:, 2].min())),
            min(float(edges[:, 1].min()), float(edges[:, 3].min())),
            max(float(edges[:, 0].max()), float(edges[:, 2].max())),
            max(float(edges[:, 1].max()), float(edges[:, 3].max())),
            pad,
        ):
            continue
        ctx._emit(
            RasterOp(
                kind=kind,
                edges=edges,
                fill_rule=rule,
                aa=aa,
                paint_kind=pk,
                paint=paint,
                scissor=sciss,
                image_id=(img.idx if img is not None else -1),
            )
        )
        if ctx._recording_clip:
            ctx._clip_shapes_recorded += 1
