# Copied from vgtpu/api/context.py: the recorder and vg:: surface; end() is
# rewritten for the PyTorch device half.
"""Context + public API: the vg:: namespace of the reference
(include/vg/vg.h:399-607) as free functions over a Context.

The reference dispatches through a function-pointer vtable that command-list
recording swaps out (vg.cpp:292-338, 599-645); here the same seam is a
`_sink` attribute: direct mode appends RasterOps to the frame, recording mode
appends serialized commands to the active CommandList (api/command_list.py).

Frame model (reference: begin/end/frame, vg.cpp:1034-1328): begin() resets the
frame op list; draw calls append ops; end() bins on the host, uploads the plan
to the context's torch device and runs the coverage + composite kernels
(raster/frame.py).  vgtpu's three pixel-exact shortcuts are ported: the frame
memo (an identical re-record re-renders the resident plan), the paint memo
(a values-only delta patches the resident paint rows in place) and the layer
memo (a stable op prefix bakes once into resident tiles the suffix
composites over, K2 form (b)).  A Cacheable command list re-submitted under
a moving translation renders as a retained-scene layer
(command_list._layer_submit, raster/retained.PendingPanLayer): its pan
tiles, a transparent overlay of the static ops drawn above it and the
suffix frame over both.  vgtpu's VGTPU_PAN_NO_OVERLAY switch is not ported:
the overlay is always on under the layer-memo gate.  end(dispatch=False) +
renderFrames serve
several contexts back to back.  ContextConfig.device_sampling (default
True, as in vgtpu) samples textures on the context's device
(ops/sampling_device.py), with False the numpy sampler on the host;
use_pallas has no effect: the port always runs its CUDA kernels (or their
plain twins on the CPU).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from vgtpu_torch import core
from vgtpu_torch.api.config import ContextConfig
from vgtpu_torch.core import (
    ClipRule,
    Colors,
    FillRule,
    LineCap,
    LineJoin,
    PathType,
    TransformOrder,
    Winding,
    color_to_rgba_f32,
    colorGetAlpha,
    colorSetAlpha,
    fill_flags_aa,
    fill_flags_path_type,
    fill_flags_rule,
    stroke_flags_aa,
    stroke_flags_line_cap,
    stroke_flags_line_join,
)
from vgtpu_torch.geometry.path import PathBuilder, make_path_builder, replay_packed
from vgtpu_torch.geometry.stroker import contours_to_edges, polyline_to_fill_edges, stroke_outline
from vgtpu_torch.raster.binning import (
    K_CLIP_ADD,
    K_CLIP_COMMIT,
    K_CLIP_RESET,
    K_DRAW,
    P_GRADIENT,
    P_IMAGE,
    P_SOLID,
    P_TEXTURE,
    P_TRI,
    RasterOp,
    _op_bin_key,
    bin_frame,
    make_gradient_paint,
    make_solid_paint,
    patch_entry_paint,
)
from vgtpu_torch.raster.frame import (
    color_tiles_flat,
    execute_plan,
    execute_plan_tiles,
    image_to_u8,
    patch_bucket_paint,
    plan_to_device,
)
from vgtpu_torch.raster.retained import PendingPanLayer, RetainedScene


# ---------------------------------------------------------------------------
# handles (16-bit idx semantics of VG_HANDLE, vg.h:75-78)
# ---------------------------------------------------------------------------

INVALID_IDX = 0xFFFF


@dataclass(frozen=True)
class GradientHandle:
    idx: int = INVALID_IDX
    flags: int = 0


@dataclass(frozen=True)
class ImagePatternHandle:
    idx: int = INVALID_IDX
    flags: int = 0


@dataclass(frozen=True)
class ImageHandle:
    idx: int = INVALID_IDX


@dataclass(frozen=True)
class FontHandle:
    idx: int = INVALID_IDX


@dataclass(frozen=True)
class CommandListHandle:
    idx: int = INVALID_IDX


def isValid(handle) -> bool:
    return handle is not None and handle.idx != INVALID_IDX


@dataclass
class TextConfig:
    font: FontHandle
    font_size: float
    alignment: int
    color: int


@dataclass
class TextRow:
    start: int = 0      # byte offsets into the input string (reference uses char*)
    end: int = 0
    next: int = 0
    width: float = 0.0
    minx: float = 0.0
    maxx: float = 0.0


@dataclass
class GlyphPosition:
    index: int = 0      # char offset of the glyph in the input string
    x: float = 0.0
    minx: float = 0.0
    maxx: float = 0.0


@dataclass
class Stats:
    cmd_list_memory_total: int = 0
    cmd_list_memory_used: int = 0


# ---------------------------------------------------------------------------
# internal state (reference State struct, vg.cpp:62-69)
# ---------------------------------------------------------------------------


@dataclass
class _State:
    transform: np.ndarray = field(default_factory=core.xform_identity)
    scissor: np.ndarray = field(default_factory=lambda: np.zeros(4))  # x,y,w,h
    global_alpha: float = 1.0
    avg_scale: float = 1.0
    font_scale: float = 1.0
    # False until setScissor/intersectScissor: ops record scissor=None so a
    # viewport-sized DEFAULT is distinguishable from an explicit rect that
    # happens to equal it (retained bake keeps explicit rects scene-space)
    scissor_explicit: bool = False
    # lazy cache of tuple(transform) — the per-draw transform tuple was a
    # measurable slice of the re-record cost (deferred draws ship the
    # transform as a hashable tuple); invalidated by update()
    xf_tuple: tuple | None = None

    def copy(self) -> "_State":
        return _State(
            self.transform.copy(), self.scissor.copy(), self.global_alpha,
            self.avg_scale, self.font_scale, self.scissor_explicit,
            self.xf_tuple,
        )

    def update(self) -> None:
        """updateState (vg.cpp:4926-4944): avgScale + quantized font scale."""
        m0, m1, m2, m3, _m4, _m5 = self.transform.tolist()
        sx = math.sqrt(m0 * m0 + m2 * m2)
        sy = math.sqrt(m1 * m1 + m3 * m3)
        self.avg_scale = (sx + sy) * 0.5
        quant = 0.1
        self.font_scale = math.floor((self.avg_scale / quant) + 0.5) * quant
        self.xf_tuple = None

    def render_xf_tuple(self, dpr: float) -> tuple:
        """tuple(dpr_scale @ transform) — a uniform dpr scale multiplies all
        six affine entries, so the cached logical tuple just scales."""
        t = self.xf_tuple
        if t is None:
            t = self.xf_tuple = tuple(self.transform.tolist())
        if dpr == 1.0:
            return t
        return tuple(v * dpr for v in t)


@dataclass
class _Image:
    data: np.ndarray            # (h,w,4) uint8
    flags: int
    generation: int = 0


class Context:
    def __init__(self, cfg: ContextConfig | None,
                 device: torch.device | str) -> None:
        self.cfg = cfg or ContextConfig()
        self.device = torch.device(device)   # where end() uploads and renders
        self.view_id = 0
        self.canvas_width = 0
        self.canvas_height = 0
        self.dpr = 1.0
        self.tess_tol = self.cfg.tess_tol
        self.fringe = self.cfg.fringe

        self.state_stack: list[_State] = [_State()]
        self.path = make_path_builder()
        self._path_transformed = None   # ((version, xf), (verts, subs))
        self._path_xf = None            # first-draw transform capture
        self._bind_fast_path()

        self.gradients: list[np.ndarray] = []
        self.image_patterns: list[tuple[np.ndarray, ImageHandle]] = []
        self.images: dict[int, _Image] = {}
        self._next_image_idx = 0

        self.ops: list[RasterOp] = []
        self._recording_clip = False
        self._clip_shapes_recorded = 0
        self._clip_rule = ClipRule.In
        self._block_merge_once = False
        self._suppress_merge = False
        self._immediate_geom = False
        # per-draw native.available() lookups were ~5% of a re-record
        from vgtpu_torch import native as _native

        self._native_geom = _native.available()
        # solid-paint rows by final u32 color: shared, frozen arrays (draws
        # never mutate paint rows; gradients copy before modulating)
        self._solid_paint_cache: dict[int, np.ndarray] = {}

        self._ct_memo = {}           # device colour tiles by sampling payload (LRU of 4)
        self._tex_dev_cache = {}     # image id -> ((generation, shape), f32 texture)

        self.frame_image = None      # premultiplied (H,W,4) device tensor after end()
        self.last_plan = None
        self.last_device_arrays = None
        self._frame_prepared = False
        self._last_frame_fp = None   # frame/paint memo: the resident plan's fingerprint
        self._bin_cache = {}         # incremental_bin's per-op run cache
        self.background = (1.0, 1.0, 1.0, 1.0)

        # static-prefix layer memo (cfg.layer_memo, _layer_split)
        self._layer_state = None     # {"meta","keys","len","tiles"}
        self._layer_prev = None      # (meta, keys) of the previous frame
        self._layer_render = None    # init_tiles the resident plan draws over
        self._layer_render_bg = None  # the background _layer_render was baked on
        self._layer_used = 0         # prefix ops the resident plan omits
        self._suppress_layer = False  # VariantBatch records need full single plans
        # translated cached-list layer (api/command_list._layer_submit)
        self._pending_layer = None   # {"scene","view","token"}
        self._layer_bake_note = None  # set by submit, resolved in the same call
        self._layer_bake_req = None  # (cl, key, tx, ty, n_ops) -> end() bakes

        # command lists
        self.command_lists: dict[int, object] = {}
        self._next_cl_idx = 0
        self._active_cl = None       # beginCommandList/endCommandList redirection
        self._submit_depth = 0

        # text
        self.fonts: list[object] = []
        self._font_by_name: dict[str, int] = {}
        self.font_system = None      # lazily created FontSystem

        self.stats = Stats()
        from vgtpu_torch.utils.profiler import FrameProfiler

        self.profiler = FrameProfiler()

    # -- state helpers ------------------------------------------------------
    @property
    def state(self) -> _State:
        return self.state_stack[-1]

    def _sink(self):
        """Direct-or-recording dispatch (the reference's vtable swap)."""
        return self._active_cl

    # -- frame lifecycle ----------------------------------------------------
    def begin(self, view_id: int, w: int, h: int, dpr: float = 1.0) -> None:
        self.view_id = view_id
        self.canvas_width = int(w)
        self.canvas_height = int(h)
        self.dpr = dpr
        # canvas units are logical; the framebuffer is dpr x denser (the
        # reference's ortho viewport scaling, vg.cpp:1148-1154)
        self.fb_width = int(round(w * dpr))
        self.fb_height = int(round(h * dpr))
        self.tess_tol = self.cfg.tess_tol / dpr
        self.fringe = self.cfg.fringe / dpr
        self.state_stack = [_State()]
        self.resetScissor()
        self.transformIdentity()
        self.ops = []
        self.gradients = []
        self.image_patterns = []
        self._recording_clip = False
        self._submit_depth = 0
        self._active_cl = None
        self._block_merge_once = False
        self._path_xf = None
        self._frame_prepared = False   # set by end(); renderFrames guard
        self._pending_layer = None     # translated cached-list layer
        self._layer_bake_note = None
        self._layer_bake_req = None

    def end(self, background=None, dispatch=True):
        """Bin + execute the frame on the context's device; returns the
        premultiplied (H,W,4) float32 tensor.

        In vgtpu's order: fingerprint -> frame-memo hit (re-render the
        resident plan) -> paint patch (values-only delta) -> finalize ->
        layer split -> bin -> textures (device or numpy sampler) -> upload
        -> dispatch.

        dispatch=False prepares the resident plan but skips the device render
        and returns None: end(dispatch=False) each context, then one
        renderFrames(ctxs) for all of them."""
        if background is not None:
            self.background = tuple(background)
        self._frame_prepared = True
        prof = self.profiler
        if (self._layer_render is not None
                and tuple(self.background) != self._layer_render_bg):
            # the resident plan composites over layer tiles rendered with
            # another background: the memo and patch shortcuts would show
            # stale pixels in uncovered tiles, so take the full path
            self._last_frame_fp = None
        with prof.stage("fingerprint"):
            # before geometry finalization: memo hits skip the native
            # bake/stroke call too (deferred recipes fingerprint by content)
            fp = self._frame_fingerprint() if self.cfg.frame_memo else None
        last_fp = self._last_frame_fp
        if (fp is not None and fp == last_fp
                and self.last_device_arrays is not None):
            self._maybe_dispatch(prof, dispatch)
            prof.count("memo_hits", 1)
            prof.frame_done()
            return self.frame_image
        if (fp is not None and last_fp is not None and fp[0] == last_fp[0]
                and self.cfg.paint_memo
                and self.last_device_arrays is not None):
            # geometry-identical frame, only paint values changed: patch the
            # resident paint rows / colour tiles instead of rebinning
            with prof.stage("paint_patch"):
                patched = self._value_only_update(last_fp, fp)
            if patched:
                self._last_frame_fp = fp
                self._maybe_dispatch(prof, dispatch)
                prof.count("memo_paint_hits", 1)
                prof.frame_done()
                return self.frame_image
        with prof.stage("finalize"):
            self._finalize_ops()
        layer = None
        req, self._layer_bake_req = self._layer_bake_req, None
        if req is not None:
            # a Cacheable list started MOVING (translation-only delta):
            # bake its op range as a retained scene for future submits
            with prof.stage("layer"):
                self._layer_cl_bake(req)
        if self._pending_layer is not None:
            pend = self._pending_layer
            with prof.stage("layer"):
                # lazy: the pan renders inside the frame's dispatch
                # (retained._pan_frame_fused).  The static prefix of the
                # ops ABOVE the panned list (fixed UI chrome) bakes as a
                # transparent floating layer blended over the pan tiles,
                # so only the truly dynamic suffix re-bins per frame.
                split = None
                if (self.cfg.layer_memo and self.cfg.frame_memo
                        and not self._suppress_layer):
                    split = self._layer_split(transparent=True)
                layer = (split[0] if split else 0, PendingPanLayer(
                    pend["scene"], pend["view"], tuple(self.background),
                    over_tiles=split[1] if split else None))
        elif (self.cfg.layer_memo and self.cfg.frame_memo
              and not self._suppress_layer):
            with prof.stage("layer"):
                layer = self._layer_split()
        ops_binned = self.ops[layer[0]:] if layer else self.ops
        with prof.stage("bin"):
            plan = bin_frame(
                ops_binned,
                self.fb_width,
                self.fb_height,
                tile_h=self.cfg.tile_h,
                tile_w=self.cfg.tile_w,
                chunk=self.cfg.edges_per_chunk,
                pools=self.cfg.chunk_pools,
                supersample=self.cfg.coverage_supersample,
                bin_cache=self._bin_cache if self.cfg.incremental_bin else None,
                depth_cap=self.cfg.max_ops_per_tile_cap,
            )
            if self.cfg.incremental_bin:
                prof.count("bin_hits", self._bin_cache.get("hits", 0))
        with prof.stage("textures"):
            self._fill_textures(plan, ops=ops_binned)
        self._layer_render = layer[1] if layer else None
        self._layer_render_bg = tuple(self.background) if layer else None
        self._layer_used = layer[0] if layer else 0
        if layer:
            prof.count("layer_hits", 1)
            prof.count("layer_prefix_ops", layer[0])
        self.last_plan = plan
        with prof.stage("upload"):
            self.last_device_arrays = plan_to_device(plan, self.device,
                                                     profiler=prof)
        self._last_frame_fp = fp
        self._maybe_dispatch(prof, dispatch)
        prof.count("ops", len(self.ops))
        prof.count("entries", plan.stats.get("entries", 0))
        prof.count("chunks", plan.stats.get("chunks", 0))
        prof.frame_done()
        return self.frame_image

    def _maybe_dispatch(self, prof, dispatch: bool) -> None:
        """Render the resident plan over the resident layer, if any (or
        leave frame_image None when the caller defers to renderFrames)."""
        if dispatch:
            with prof.stage("device_dispatch"):
                lr = self._layer_render
                if isinstance(lr, PendingPanLayer):
                    self.frame_image = lr.execute_over(
                        self.last_plan, self.last_device_arrays,
                        self.background)
                else:
                    self.frame_image = execute_plan(
                        self.last_plan, background=self.background,
                        device_arrays=self.last_device_arrays,
                        init_tiles=lr)
        else:
            self.frame_image = None

    def _layer_split(self, transparent: bool = False):
        """Static-prefix layer memo: the device-resident analogue of the
        reference's cached-list replay (clCacheRender, vg.cpp:5845-6120).
        When the leading run of ops is bit-identical across frames, the
        prefix bakes ONCE into resident framebuffer tiles; each frame then
        bins, uploads and composites only the dynamic suffix over them
        (execute_plan init_tiles, K2 form (b)).  Pixel-exact: painter's
        order makes fb-after-prefix a true checkpoint, and per-op coverage is
        independent of other ops.

        transparent=True bakes the prefix over a TRANSPARENT background: the
        floating-layer form used when the frame already has a moving base
        underneath (the translated cached-list pan).  src-over is
        associative, so (static over pan(list) over bg) composites exactly
        as the baked static tiles blended over the per-frame pan tiles
        (PendingPanLayer.over_tiles).

        Returns (prefix_len, tiles) or None.  The cut never crosses an
        active clip (suffix frames start with an identity mask)."""
        ops = self.ops
        # texture CONTENT rides the meta (op keys cover only tex_quads and
        # image ids): an updateImage or atlas rebake must re-bake the layer
        tex_sig = tuple(sorted(
            (i, img.generation) for i, img in self.images.items()))
        atlas_rev = (self.font_system.atlas.revision
                     if self.font_system is not None else -1)
        meta = (self.fb_width, self.fb_height, self.cfg.coverage_supersample,
                self.cfg.tile_h, self.cfg.tile_w, tuple(self.cfg.chunk_pools),
                "transparent" if transparent else tuple(self.background),
                tex_sig, atlas_rev)
        min_prefix = self.cfg.layer_min_prefix
        if len(ops) <= min_prefix:
            self._layer_prev = None
            return None
        keys = [_op_bin_key(op) for op in ops]
        st = self._layer_state
        if (st is not None and st["meta"] == meta and len(keys) > st["len"]
                and keys[: st["len"]] == st["keys"]):
            self._layer_prev = (meta, keys)
            return st["len"], st["tiles"]
        self._layer_state = None
        prev, self._layer_prev = self._layer_prev, (meta, keys)
        if prev is None or prev[0] != meta:
            return None
        pk = prev[1]
        n = min(len(keys), len(pk), len(ops) - 1)
        P = 0
        while P < n and keys[P] == pk[P]:
            P += 1
        P = self._layer_clean_cut(ops, P)
        if P < min_prefix:
            return None
        # bake: one full bin + tile render of the prefix, kept on the device
        # (no bin_cache: it tracks the per-frame suffix stream)
        lplan = bin_frame(
            ops[:P], self.fb_width, self.fb_height,
            tile_h=self.cfg.tile_h, tile_w=self.cfg.tile_w,
            chunk=self.cfg.edges_per_chunk, pools=self.cfg.chunk_pools,
            supersample=self.cfg.coverage_supersample,
            depth_cap=self.cfg.max_ops_per_tile_cap,
        )
        self._fill_textures(lplan, ops=ops[:P])
        bake_bg = (0.0, 0.0, 0.0, 0.0) if transparent else self.background
        tiles = execute_plan_tiles(
            lplan, background=bake_bg,
            device_arrays=plan_to_device(lplan, self.device))
        self._layer_state = {"meta": meta, "keys": keys[:P], "len": P,
                             "tiles": tiles}
        self.profiler.count("layer_bakes", 1)
        return P, tiles

    def _layer_cl_bake(self, req) -> None:
        """Bake a Cacheable command list's just-replayed op range as a
        retained scene (api/command_list._layer_submit scheduled it when the
        list's translation started moving).  Ops are finalized by the
        caller.  An open clip across the list's end skips the bake, and the
        list keeps the host replay path."""
        cl, key, tx, ty, n = req
        ops = self.ops[:n]
        if n == 0 or len(self.ops) < n:
            return
        if self._layer_clean_cut(ops, n) != n:
            return   # an open clip crosses the list boundary
        scene = RetainedScene.bake(self, background=self.background,
                                   ops=list(ops))
        gen = getattr(cl, "_layer_gen", 0) + 1
        cl._layer_gen = gen
        cl._layer_scene = {"key": key, "tx": tx, "ty": ty, "scene": scene,
                           "gen": gen}
        self.profiler.count("layer_cl_bakes", 1)

    @staticmethod
    def _layer_clean_cut(ops, P: int) -> int:
        """Largest p <= P where the clip state is identity (no committed
        mask, no pending clip shapes): the suffix renders standalone, so a
        prefix clip leaking across the boundary would be dropped."""
        active = pending = False
        last = 0
        for i in range(P):
            k = ops[i].kind
            if k == K_CLIP_ADD:
                pending = True
            elif k == K_CLIP_COMMIT:
                active, pending = True, False
            elif k == K_CLIP_RESET:
                active = pending = False
            if not active and not pending:
                last = i + 1
        return last

    def _frame_fingerprint(self):
        """Content fingerprint of the recorded frame: per-op scalar fields +
        CRCs of the geometry/paint arrays (zlib.crc32 via the buffer
        protocol, no copies), plus the texture inputs (image generations,
        atlas revision) and framebuffer/config state.  Collisions are not
        adversarial here.  The per-snapshot crc is cached on the snapshot
        dict (fill+stroke of the same path share it).

        Returns (structural hash, paint signature, texture signature): paint
        VALUES of solid/gradient draws and of texture/pattern draws are
        split out of the structural hash so a values-only delta can patch
        the resident plan (_value_only_update)."""
        import zlib

        crc32 = zlib.crc32

        def crc(a, c=0):
            if a is None:
                return c
            if not a.flags.c_contiguous:
                a = np.ascontiguousarray(a)
            return crc32(a, c)

        def snap_crc(s):
            c = s.get("fp_crc")
            if c is None:
                c = 0
                for k in ("verbs", "sf", "cf", "af", "pa", "pp"):
                    c = crc(s[k], c)
                c ^= hash((s["scale"], s["tol"])) & 0xFFFFFFFF
                s["fp_crc"] = c
            return c

        parts = [self.fb_width, self.fb_height, self.cfg.coverage_supersample,
                 len(self.ops)]
        paint_sig = []
        tex_sig = []
        for i, op in enumerate(self.ops):
            # the CRC triple (geometry, paint row, quads/tri-paints) is
            # memoized on the op; the image GENERATION stays outside the
            # cache (updateImage bumps it under the same op object)
            cached = op.fp_cache
            if cached is not None:
                g, pc, tt = cached
            else:
                if op.geom is not None:
                    g = tuple(
                        (mode, xf, w, cap, join, scale, snap_crc(s))
                        for (s, mode, xf, w, cap, join, scale) in op.geom
                    )
                elif isinstance(op.edges, list):
                    g = tuple(crc(e) for e in op.edges)
                else:
                    g = crc(op.edges)
                # solid/gradient rows are pure kernel-side inputs (their one
                # plan-shaping use, the occlusion cover test, is checked at
                # patch time); texture/pattern rows feed the TEXTURES stage.
                # Tri paints shape per-triangle pseudo-op rows at bin time,
                # so they stay structural, textured tri batches included.
                pc = crc(op.paint)
                tt = crc(op.tri_paints, crc(op.tex_quads))
                op.fp_cache = (g, pc, tt)
            gen = None
            if op.image_id is not None:
                img = self.images.get(op.image_id)
                gen = img.generation if img is not None else -1
            if op.kind == K_DRAW and op.paint_kind in (P_SOLID, P_GRADIENT):
                paint_sig.append((i, pc))
                pc = None
            elif (op.kind == K_DRAW and op.paint_kind in (P_IMAGE, P_TEXTURE)
                  and op.paint is not None and op.tri_paints is None):
                tex_sig.append((i, (pc, gen)))
                pc = gen = None
            parts.append((
                op.kind, op.fill_rule, op.aa, op.paint_kind, op.image_id,
                op.scissor, g, pc, gen, tt,
            ))
        # image ids are never reused, and the generations of DRAWN images
        # ride each op's signature: no global image table is hashed
        if self.font_system is not None:
            parts.append(self.font_system.atlas.revision)
        if self._pending_layer is not None:
            # translated cached-list layer: the frame's pixels depend on the
            # scene identity + view offset (the list's ops are NOT in ops)
            parts.append(self._pending_layer["token"])
        return (hash(tuple(parts)), tuple(paint_sig), tuple(tex_sig))

    @staticmethod
    def _sig_changed(old_sig, new_sig):
        """Aligned per-op signature diff; None when structure diverges
        (defensive: the structural hash matching should preclude it)."""
        if len(old_sig) != len(new_sig):
            return None
        changed = []
        for (i0, c0), (i1, c1) in zip(old_sig, new_sig):
            if i0 != i1:
                return None
            if c0 != c1:
                changed.append(i0)
        return changed

    def _value_only_update(self, old_fp, new_fp) -> bool:
        """Patch the resident plan for a values-only frame delta.

        Called when the structural fingerprint matched but paint VALUES
        changed (the colour/alpha/pattern-animation pattern):

        - solid/gradient rows are consumed inside the composite kernel,
          EXCEPT for one plan-shaping use: occlusion culling treats solid
          alpha>=1 draws as covers (binning.compute_tile_buckets).  The
          patch is only taken when every changed solid row keeps its opacity
          class.
        - texture/pattern rows (text colour, pattern transform/tint) feed
          the TEXTURES stage: the patch re-runs the sampler (device or
          numpy, as cfg.device_sampling says) against the resident plan and
          swaps the colour tiles (ct_flat), giving up when the entry ->
          colour-tile map changed.

        The resident params hold the paint on the device (built on the host
        by build_bucket_aux), so the patch uploads the patched (NE, 18)
        entry paint table and rewrites every bucket's 18 paint rows in place
        with one gather each (frame.patch_bucket_paint).  Any ineligibility
        returns False and end() takes the full path."""
        plan = self.last_plan
        d = self.last_device_arrays
        if plan is None or d is None:
            return False
        changed_k = self._sig_changed(old_fp[1], new_fp[1])
        changed_t = self._sig_changed(old_fp[2], new_fp[2])
        if changed_k is None or changed_t is None:
            return False
        if not changed_k and not changed_t:
            return False
        base = self._layer_used
        if base:
            # the resident plan covers only the dynamic suffix; a paint
            # change inside the baked prefix needs the full path (the layer
            # keys include paint values, so the bake invalidates there)
            if min(changed_k + changed_t) < base:
                return False
            changed_k = [i - base for i in changed_k]
            changed_t = [i - base for i in changed_t]

        ops = self.ops[base:] if base else self.ops
        changed = changed_k + changed_t
        if any(ops[i].paint is None for i in changed):
            return False  # value rows live elsewhere (tri_paints): full path
        new_rows = np.stack(
            [np.asarray(ops[i].paint, np.float32) for i in changed])

        # pseudo-op ids: tri batches expand to one pseudo-op per triangle,
        # everything else is 1:1 (binning.bin_frame orig_of)
        pids = None
        if plan.pop is not None:
            counts = np.fromiter(
                (len(op.tri_paints) if op.tri_paints is not None else 1
                 for op in ops), np.int64, count=len(ops))
            if np.any(counts[changed] != 1):
                # a multi-pseudo-op op (tri batch) in the changed set: the
                # fingerprint keeps those structural, so this is defensive
                return False
            prefix = np.concatenate(([0], np.cumsum(counts)[:-1]))
            pids = prefix[changed]
            old_rows = np.asarray(plan.pop["paint"])[pids]
        else:
            # numpy binner: recover old rows from the dense entry table via
            # each op's first entry (ops with no entries never cover a tile,
            # so their opacity class is unconstrained)
            old_rows = new_rows.copy()
            eo = plan.entry_op
            op_ids, first_entry = np.unique(eo, return_index=True)
            first_of = dict(zip(op_ids.tolist(), first_entry.tolist()))
            for k, i in enumerate(changed):
                e = first_of.get(i)
                if e is not None:
                    old_rows[k] = plan.entry_paint[e]

        nk = len(changed_k)
        solid = np.fromiter(
            (ops[i].paint_kind == P_SOLID for i in changed_k), bool, count=nk)
        if nk and np.any(solid & ((old_rows[:nk, 13] >= 1.0)
                                  != (new_rows[:nk, 13] >= 1.0))):
            return False

        # ---- all checks passed: mutate host plan + device arrays ----
        prof = self.profiler
        with prof.stage("patch.host"):
            patch_entry_paint(plan, len(ops), changed, new_rows)
            if plan.pop is not None:
                plan.pop["paint"][pids] = new_rows
        ct_flat = None
        if changed_t:
            # resample against the resident plan (the sampler reads the
            # patched entry_paint rows; the entry -> tile assignment is
            # deterministic in entry order, so a geometry-identical frame
            # keeps the mapping)
            with prof.stage("patch.textures"):
                old_map = plan.entry_color_tile.copy()
                old_ct = plan.color_tiles
                self._fill_textures(plan, ops=ops)
                if (plan.color_tiles is old_ct
                        or not np.array_equal(plan.entry_color_tile, old_map)):
                    return False  # the full path rebuilds the plan
                ct_flat = color_tiles_flat(plan)
        with prof.stage("patch.put"):
            entry_paint = torch.as_tensor(plan.entry_paint).to(self.device)
            patch_bucket_paint(d["bucket_params"], d["bucket_te"], entry_paint)
            nbytes = plan.entry_paint.nbytes
            if ct_flat is not None:
                if isinstance(ct_flat, np.ndarray):
                    nbytes += ct_flat.nbytes
                d["ct_flat"] = torch.as_tensor(ct_flat).to(self.device)
        prof.count("upload_bytes", nbytes)
        return True

    def _fill_textures(self, plan, ops=None) -> None:
        """Colour tiles for the plan's textured entries: with
        cfg.device_sampling on the context's device (plan.color_tiles
        becomes a tensor there, which the upload passes through), else from
        the numpy sampler.  ops: the list the plan was binned from (a
        suffix slice when the layer memo split the frame: plan.entry_op
        indexes into it)."""
        if ops is None:
            ops = self.ops
        image_map = {
            idx: (img.data, img.flags, img.generation)
            for idx, img in self.images.items()
        }
        if self.font_system is not None:
            image_map.update(self.font_system.atlas_image_map())
        if self.cfg.device_sampling:
            self._sample_on_device(plan, ops, image_map)
            return
        from vgtpu_torch.raster.sampling import fill_color_tiles

        if not hasattr(self, "_tile_sample_cache"):
            self._tile_sample_cache = {}
        fill_color_tiles(plan, ops, image_map, cache=self._tile_sample_cache)

    def _sample_on_device(self, plan, ops, image_map: dict) -> None:
        """vgtpu's device-sampling branch of _fill_textures: the sampling
        plan on the host, then one sampler run on self.device, skipped when
        the 4-entry LRU _ct_memo holds the same sampling payload (text and
        pattern tiles of a steady UI loop are frame-static even when the
        geometry around them animates; ct_memo_hits counts the hits)."""
        import zlib

        from vgtpu_torch.ops.sampling_device import (
            build_sampling_plan,
            sample_color_tiles_device,
        )

        sp = build_sampling_plan(plan, ops, image_map)
        if not sp.num_tiles:
            if len(ops) == len(self.ops):
                # the plan covers the WHOLE frame and draws no textures:
                # the memo's tiles can never hit again, release them.  A
                # texture-less SUFFIX plan under a layer split keeps the
                # memo: the layer plan's entry is still live
                self._ct_memo = {}
            return
        needed = {g.image_id for g in sp.groups}

        def _crc(a):
            return 0 if a is None else zlib.crc32(np.ascontiguousarray(a))

        # keyed on the FULL group payload (ct ids, params incl. tile
        # origins, modulation colours) and every source generation, so any
        # layout shift or paint change misses
        key = (
            sp.num_tiles, plan.tile_h, plan.tile_w, plan.supersample,
            tuple(sorted(
                (i, image_map[i][2] if len(image_map[i]) > 2 else 0)
                for i in needed)),
            tuple((g.image_id, g.flags, g.kind, g.separable,
                   _crc(g.ct), _crc(g.params), _crc(g.color))
                  for g in sp.groups),
            _crc(sp.tex_tile_mask),
        )
        # a small LRU, not one slot: a frame whose baked layer AND dynamic
        # suffix both carry textures samples two plans per frame
        memo = self._ct_memo
        hit = memo.pop(key, None)
        if hit is not None:
            memo[key] = hit       # move to the end (dict insert order)
            plan.color_tiles = hit
            self.profiler.count("ct_memo_hits", 1)
            return
        tex = self._device_textures(image_map, needed)
        ct = sample_color_tiles_device(
            sp, tex, plan.tile_h // plan.supersample, plan.tile_w)
        plan.color_tiles = ct
        memo[key] = ct
        while len(memo) > 4:
            memo.pop(next(iter(memo)))

    def _device_textures(self, image_map: dict, needed: set) -> dict:
        """f32 textures in [0, 1] on self.device, (h, w, C) with C=1 for A8,
        uploaded again only when the source's (generation, shape) changes
        (updateImage bumps an image's generation, an atlas bake its
        revision)."""
        cache = self._tex_dev_cache
        out = {}
        for img_id in needed:
            rec = image_map[img_id]
            data = rec[0]
            key = (rec[2] if len(rec) > 2 else 0, data.shape)
            hit = cache.get(img_id)
            if hit is None or hit[0] != key:
                arr = np.asarray(data)
                if arr.ndim == 2:
                    arr = arr[..., None]
                dev = torch.as_tensor(arr).to(self.device).to(torch.float32) / 255.0
                hit = cache[img_id] = (key, dev)
            out[img_id] = hit[1]
        return out

    def frame(self) -> None:
        """Per-app-frame housekeeping (reference: font-atlas GC, vg.cpp:1290)."""
        if self.font_system is not None:
            self.font_system.end_frame()

    def readback_u8(self) -> np.ndarray:
        return image_to_u8(self.frame_image)

    # -- path building ------------------------------------------------------
    def _bind_fast_path(self) -> None:
        """With the C recorder, bind its methods as INSTANCE attributes so a
        public verb call is one Python frame + one C call (the largest single
        cost of a dynamic re-record was pure Python call overhead on ~3k verb
        calls/frame).  Cache invalidation needs no per-verb hook: the
        transformed-bake cache is keyed on path.version (see
        _transformed_path)."""
        impl = getattr(self.path, "_impl", None)
        if impl is None:
            return
        self.moveTo = impl.move_to
        self.lineTo = impl.line_to
        self.cubicTo = impl.cubic_to
        self.quadraticTo = impl.quadratic_to
        self.arcTo = impl.arc_to
        self.arc = impl.arc
        self.rect = impl.rect
        self.roundedRect = impl.rounded_rect
        self.roundedRectVarying = impl.rounded_rect_varying
        self.circle = impl.circle
        self.ellipse = impl.ellipse
        self.closePath = impl.close

    def beginPath(self) -> None:
        self.path.reset(self.state.avg_scale, self.tess_tol)
        self._path_xf = None

    def moveTo(self, x, y):
        self.path.move_to(x, y)

    def lineTo(self, x, y):
        self.path.line_to(x, y)

    def cubicTo(self, c1x, c1y, c2x, c2y, x, y):
        self.path.cubic_to(c1x, c1y, c2x, c2y, x, y)

    def quadraticTo(self, cx, cy, x, y):
        self.path.quadratic_to(cx, cy, x, y)

    def arcTo(self, x1, y1, x2, y2, r):
        self.path.arc_to(x1, y1, x2, y2, r)

    def arc(self, cx, cy, r, a0, a1, direction):
        self.path.arc(cx, cy, r, a0, a1, direction)

    def rect(self, x, y, w, h):
        self.path.rect(x, y, w, h)

    def roundedRect(self, x, y, w, h, r):
        self.path.rounded_rect(x, y, w, h, r)

    def roundedRectVarying(self, x, y, w, h, rtl, rtr, rbr, rbl):
        self.path.rounded_rect_varying(x, y, w, h, rtl, rtr, rbr, rbl)

    def circle(self, cx, cy, r):
        self.path.circle(cx, cy, r)

    def ellipse(self, cx, cy, rx, ry):
        self.path.ellipse(cx, cy, rx, ry)

    def polyline(self, coords):
        self.path.polyline(coords)

    def closePath(self):
        self.path.close()

    def appendPackedPath(self, verbs, args) -> None:
        """Append a packed path program (geometry.path.pack_path_program) to
        the current path in one call — the analogue of replaying the
        reference's recorded byte stream through the interpreter
        (vg.cpp:4332-4625).  Scene loaders use this to feed a pre-compiled
        path without per-verb Python dispatch.  Both recorder backends
        coerce dtypes (the C replay reinterprets raw buffers)."""
        p = self.path
        if p.is_native:
            p.replay(verbs, args)
        else:
            replay_packed(p, verbs, args)

    def _render_transform(self):
        """state transform composed with the dpr viewport scale: logical
        canvas units -> framebuffer pixels."""
        if self.dpr == 1.0:
            return self.state.transform
        return core.xform_multiply(core.xform_scale(self.dpr, self.dpr), self.state.transform)

    def _draw_xf_tuple(self) -> tuple:
        """The render transform a draw of the CURRENT path uses: captured at
        the first fill/stroke after beginPath and reused for later draws of
        the same path — exactly the reference's transformPath caching
        (vg.cpp:4957-4975, m_PathTransformed reset only in ctxBeginPath), and
        the contract that keeps the deferred and immediate backends
        identical."""
        xf = self._path_xf
        if xf is None:
            xf = self._path_xf = self.state.render_xf_tuple(self.dpr)
        return xf

    def _transformed_path(self):
        """transformPath (vg.cpp:4957-4975): lazy, cached per path edit (the
        version key changes on any verb append or beginPath reset); the
        transform is the first-draw capture (_draw_xf_tuple)."""
        cached = self._path_transformed
        key = (self.path.version, self._draw_xf_tuple())
        if cached is None or cached[0] != key:
            verts, subs = self.path.bake()
            cached = (key, (core.xform_points(key[1], verts), subs))
            self._path_transformed = cached
        return cached[1]

    # -- paints -------------------------------------------------------------
    def _solid_paint(self, col: int):
        """Shared frozen paint row for a final u32 color (draws never mutate
        paint rows — modulating resolvers copy first, asserted by the
        read-only flag)."""
        cache = self._solid_paint_cache
        paint = cache.get(col)
        if paint is None:
            if len(cache) > 4096:
                cache.clear()
            paint = make_solid_paint(color_to_rgba_f32(col))
            paint.flags.writeable = False
            cache[col] = paint
        return paint

    def _resolve_paint(self, paint_or_color, color_modulate=None):
        """Returns (paint_kind, paint_array, image_handle, alpha_of_solid)."""
        ga = self.state.global_alpha
        if isinstance(paint_or_color, GradientHandle):
            if not isValid(paint_or_color) or paint_or_color.idx >= len(self.gradients):
                return None   # stale handle from a previous frame: skip cleanly
            p = self.gradients[paint_or_color.idx].copy()
            # global alpha modulates the gradient (vertex alpha in the shader)
            p[13] *= ga
            p[17] *= ga
            return (P_GRADIENT, p, None)
        if isinstance(paint_or_color, ImagePatternHandle):
            if not isValid(paint_or_color) or paint_or_color.idx >= len(self.image_patterns):
                return None
            mat, img = self.image_patterns[paint_or_color.idx]
            rgba = color_to_rgba_f32(color_modulate if color_modulate is not None else Colors.White)
            rgba[3] *= ga
            p = np.zeros(18, np.float32)
            p[0:6] = mat
            p[10:14] = rgba
            return (P_IMAGE, p, img)
        # plain color
        col = int(paint_or_color)
        if ga != 1.0:
            col = colorSetAlpha(col, int(ga * colorGetAlpha(col)))
        if colorGetAlpha(col) == 0:
            return None
        return (P_SOLID, self._solid_paint(col), None)

    def _op_scissor(self):
        """Scissor as recorded on ops: None while the scissor is the untouched
        viewport default (RasterOp semantics treat None as the full canvas),
        the explicit framebuffer-space rect otherwise.  The distinction lets
        retained bakes keep explicit rects scene-space while the default
        stays screen-space (raster/retained.py)."""
        return self._scissor_rect() if self.state.scissor_explicit else None

    def _scissor_rect(self):
        s = self.state.scissor
        if s[2] <= 0 or s[3] <= 0:
            return (0.0, 0.0, 0.0, 0.0)
        d = self.dpr
        return (float(s[0] * d), float(s[1] * d),
                float((s[0] + s[2]) * d), float((s[1] + s[3]) * d))

    def _emit(self, op: RasterOp) -> None:
        """Append a frame op, merging with the previous one when safe — the
        analogue of allocDrawCommand's same-state batching (vg.cpp:5359-5380).
        Merging is restricted to opaque solid NonZero draws whose geometry is
        orientation-normalized, where union coverage == sequential blending."""
        prev = self.ops[-1] if self.ops else None
        if self._block_merge_once:
            # one-shot backward-merge fence: set around memoized command-list
            # segments whose ops are SHARED across frames — merging into a
            # shared op would mutate it (command_list.cl_submit)
            self._block_merge_once = False
            prev = None
        if (
            prev is not None
            and not self._suppress_merge
            and op.mergeable
            and prev.mergeable
            and op.kind == 0
            and prev.kind == 0
            and op.paint_kind == P_SOLID
            and prev.paint_kind == P_SOLID
            and op.fill_rule == FillRule.NonZero
            and prev.fill_rule == FillRule.NonZero
            and op.aa == prev.aa
            and op.scissor == prev.scissor
            and op.paint is not None
            and prev.paint is not None
            and op.paint[13] >= 1.0
            and (op.paint is prev.paint or np.array_equal(op.paint, prev.paint))
            and (op.geom is None) == (prev.geom is None)
        ):
            # in-place content mutation: drop any cached content keys so a
            # violated merge fence (ADVICE r04 — cached ops shared across
            # frames must never be merged into) degrades to a re-fingerprint
            # instead of silently serving stale frames
            prev.fp_cache = None
            prev.bin_key_cache = None
            if op.geom is not None:
                prev.geom.extend(op.geom)
                return
            if not isinstance(prev.edges, list):
                prev.edges = [prev.edges]
            prev.edges.append(op.edges)
            return
        self.ops.append(op)

    def _finalize_ops(self) -> None:
        self._finalize_geometry()
        for op in self.ops:
            if isinstance(op.edges, list):
                op.edges = np.concatenate(op.edges, axis=0)

    def _defer_geometry(self) -> bool:
        """Draws defer bake/stroke/edge assembly to ONE batched native call
        at end() (vg_frame_geom) — the per-path ctypes round-trips measured
        ~30 ms/frame of marshalling on the tiger re-record.  Clip recording
        stays immediate (per-subpath coverage accumulation semantics), as do
        command-list cache builds (they capture per-draw edges)."""
        if self._recording_clip or self._immediate_geom:
            return False
        return self._native_geom

    def _finalize_geometry(self) -> None:
        """Resolve deferred geometry recipes into op edges (idempotent).

        Split rule, mirroring the immediate path's per-subpath emission: a
        deferred op stays ONE op when it is opaque-solid-NonZero-mergeable
        (where union winding == sequential blending, exactly the _emit merge
        precondition) or a concave fill (one winding body by design);
        otherwise it splits into per-piece ops in place."""
        import copy as _copy

        from vgtpu_torch import native

        deferred = [op for op in self.ops if op.geom is not None]
        if not deferred:
            return
        snaps: list = []
        snap_idx: dict = {}
        draws: list = []
        owners: list = []     # (op, first_draw, n_draws)
        for op in deferred:
            first = len(draws)
            for (snap, mode, xf, w, cap, join, scale) in op.geom:
                key = id(snap)
                pi = snap_idx.get(key)
                if pi is None:
                    pi = snap_idx[key] = len(snaps)
                    snaps.append(snap)
                draws.append((pi, mode, xf, w, cap, join, scale))
            owners.append((op, first, len(draws) - first))

        res = native.frame_geom(snaps, draws, self.tess_tol)
        if res is None:  # pragma: no cover - native gated at defer time
            raise RuntimeError("deferred geometry without native backend")
        edges, piece_off, piece_draw = res

        # pieces grouped per draw: draw ids are non-decreasing by build order,
        # so each op's pieces are the contiguous index range [lo, hi)
        firsts = np.fromiter((f for _op, f, _n in owners), np.int64, len(owners))
        ends = np.fromiter((f + n for _op, f, n in owners), np.int64, len(owners))
        los = np.searchsorted(piece_draw, firsts, side="left")
        his = np.searchsorted(piece_draw, ends, side="left")
        split_ops: dict = {}
        for (op, _first, _nd), lo, hi in zip(owners, los, his):
            if lo >= hi:
                op.geom = None
                op.edges = np.zeros((0, 4), np.float32)
                continue
            keep_whole = (
                op.geom[0][1] == 1      # concave fill: one winding body
                or (op.mergeable and op.paint_kind == P_SOLID
                    and op.fill_rule == FillRule.NonZero
                    and op.paint is not None and op.paint[13] >= 1.0)
            )
            op.geom = None
            if keep_whole:
                op.edges = edges[piece_off[lo] : piece_off[hi]]
            else:
                op.edges = edges[piece_off[lo] : piece_off[lo + 1]]
                extra = []
                for p in range(lo + 1, hi):
                    o2 = _copy.copy(op)
                    o2.edges = edges[piece_off[p] : piece_off[p + 1]]
                    extra.append(o2)
                if extra:
                    split_ops[id(op)] = extra
        if split_ops:
            new_ops = []
            for op in self.ops:
                new_ops.append(op)
                extra = split_ops.get(id(op))
                if extra:
                    new_ops.extend(extra)
            self.ops = new_ops

    # -- fills / strokes ----------------------------------------------------
    def fillPath(self, paint_or_color, flags: int, color_modulate=None) -> None:
        if self._recording_clip:
            resolved = (P_SOLID, make_solid_paint(np.array([0, 0, 0, 1], np.float32)), None)
        else:
            resolved = self._resolve_paint(paint_or_color, color_modulate)
        if resolved is None:
            return
        pk, paint, img = resolved
        aa = (not self.cfg.force_aa_off) and (not self._recording_clip) and fill_flags_aa(flags)
        rule = fill_flags_rule(flags)
        path_type = fill_flags_path_type(flags)

        if self._defer_geometry():
            if not self.path.n_verbs:
                return
            mode = 0 if path_type == PathType.Convex else 1
            self._emit(RasterOp(
                kind=K_DRAW, edges=None, fill_rule=rule, aa=aa,
                paint_kind=pk, paint=paint, scissor=self._op_scissor(),
                image_id=(img.idx if img is not None else -1),
                mergeable=(path_type == PathType.Convex),
                geom=[(self.path.snapshot(), mode,
                       self._draw_xf_tuple(),
                       0.0, 0, 0, 0.0)],
            ))
            return

        verts, subs = self._transformed_path()
        if len(subs) == 0:
            return
        sciss = self._op_scissor()
        kind = K_CLIP_ADD if self._recording_clip else 0

        def mk(edges):
            return RasterOp(
                kind=kind, edges=edges, fill_rule=rule, aa=aa,
                paint_kind=pk, paint=paint, scissor=sciss,
                image_id=(img.idx if img is not None else -1),
            )

        if path_type == PathType.Convex:
            # per-subpath independent fills (vg.cpp:3092-3131)
            for first, count, _closed in subs:
                if count < 3:
                    continue
                op = mk(polyline_to_fill_edges(verts[first : first + count], normalize=True))
                op.mergeable = not self._recording_clip
                self._emit(op)
                if self._recording_clip:
                    self._clip_shapes_recorded += 1
        else:
            # all subpaths as one winding body (libtess2 path, holes included)
            parts = [
                polyline_to_fill_edges(verts[f : f + c]) for f, c, _cl in subs if c >= 3
            ]
            parts = [p for p in parts if len(p)]
            if not parts:
                return
            self._emit(mk(np.concatenate(parts, axis=0)))
            if self._recording_clip:
                self._clip_shapes_recorded += 1

    def _resolve_stroke_paint(self, paint_or_color, width: float, flags: int,
                              color_modulate=None):
        """Stroke paint resolution including the thin-stroke alpha law
        (vg.cpp:3416-3420): strokes thinner than one framebuffer pixel render
        at fringe width with alpha scaled by clamp(scaledWidth,0,fringe)^2.
        Returns (resolved_paint_or_None, stroke_width_fb)."""
        st = self.state
        if flags & core.StrokeFlags.FixedWidth:
            scaled_width = width
        else:
            sw = width * st.avg_scale
            scaled_width = (0.0 if sw < 0.0 else 200.0 if sw > 200.0 else sw) * self.dpr
        fringe_fb = self.fringe * self.dpr   # = 1 framebuffer pixel
        is_thin = scaled_width <= fringe_fb
        if is_thin:
            a = scaled_width / self.dpr
            a = 0.0 if a < 0.0 else self.fringe if a > self.fringe else a
            alpha_scale = a * a
            stroke_width = fringe_fb
        else:
            alpha_scale = 1.0
            stroke_width = scaled_width

        if self._recording_clip:
            resolved = (P_SOLID, make_solid_paint(np.array([0, 0, 0, 1], np.float32)), None)
        else:
            if isinstance(paint_or_color, (GradientHandle, ImagePatternHandle)):
                resolved = self._resolve_paint(paint_or_color, color_modulate)
                if resolved is not None and alpha_scale < 1.0:
                    pk_, p_, img_ = resolved
                    p_ = p_.copy()
                    p_[13] *= alpha_scale
                    p_[17] *= alpha_scale
                    resolved = (pk_, p_, img_)
            else:
                col = int(paint_or_color)
                mod = alpha_scale * self.state.global_alpha
                if mod != 1.0:
                    col = colorSetAlpha(col, int(mod * colorGetAlpha(col)))
                if colorGetAlpha(col) == 0:
                    return None, stroke_width
                resolved = (P_SOLID, self._solid_paint(col), None)
        return resolved, stroke_width

    def strokePath(self, paint_or_color, width: float, flags: int, color_modulate=None) -> None:
        st = self.state
        render_scale = st.avg_scale * self.dpr
        resolved, stroke_width = self._resolve_stroke_paint(
            paint_or_color, width, flags, color_modulate)
        if resolved is None:
            return
        pk, paint, img = resolved

        aa = (not self.cfg.force_aa_off) and (not self._recording_clip) and stroke_flags_aa(flags)
        cap = stroke_flags_line_cap(flags)
        join = stroke_flags_line_join(flags)

        if self._defer_geometry():
            if not self.path.n_verbs:
                return
            self._emit(RasterOp(
                kind=K_DRAW, edges=None, fill_rule=FillRule.NonZero, aa=aa,
                paint_kind=pk, paint=paint, scissor=self._op_scissor(),
                image_id=(img.idx if img is not None else -1),
                mergeable=True,
                geom=[(self.path.snapshot(), 2,
                       self._draw_xf_tuple(),
                       float(stroke_width), int(cap), int(join),
                       float(render_scale))],
            ))
            return

        verts, subs = self._transformed_path()
        sciss = self._op_scissor()
        kind = K_CLIP_ADD if self._recording_clip else 0
        for first, count, closed in subs:
            if count < 2:
                continue
            contours = stroke_outline(
                verts[first : first + count], bool(closed), stroke_width, cap, join,
                scale=render_scale, tol=self.tess_tol,
            )
            edges = contours_to_edges(contours)
            if not len(edges):
                continue
            self._emit(
                RasterOp(
                    kind=kind, edges=edges, fill_rule=FillRule.NonZero, aa=aa,
                    paint_kind=pk, paint=paint, scissor=sciss,
                    image_id=(img.idx if img is not None else -1),
                    mergeable=not self._recording_clip,
                )
            )
            if self._recording_clip:
                self._clip_shapes_recorded += 1

    # -- clip ---------------------------------------------------------------
    def beginClip(self, rule: int) -> None:
        self._recording_clip = True
        self._clip_rule = rule
        self._clip_shapes_recorded = 0

    def endClip(self) -> None:
        self._recording_clip = False
        if self._clip_shapes_recorded == 0:
            self._emit(RasterOp(kind=K_CLIP_RESET))
        else:
            # ClipRule.In -> NonZero-style commit; Out -> inverted
            self._emit(
                RasterOp(
                    kind=K_CLIP_COMMIT,
                    fill_rule=0 if self._clip_rule == ClipRule.In else 1,
                )
            )

    def resetClip(self) -> None:
        self._emit(RasterOp(kind=K_CLIP_RESET))

    # -- gradients / patterns (math from vg.cpp:3712-3931) ------------------
    def createLinearGradient(self, sx, sy, ex, ey, icol, ocol) -> GradientHandle:
        if len(self.gradients) >= self.cfg.max_gradients:
            return GradientHandle()
        large = 1e5
        dx, dy = ex - sx, ey - sy
        d = math.sqrt(dx * dx + dy * dy)
        if d > 1e-4:
            dx /= d
            dy /= d
        else:
            dx, dy = 0.0, 1.0
        gm = np.array([dy, -dx, dx, dy, sx - dx * large, sy - dy * large])
        params = np.array([large, large + d * 0.5, 0.0, max(1.0, d)], np.float32)
        return self._store_gradient(gm, params, icol, ocol)

    def createBoxGradient(self, x, y, w, h, r, f, icol, ocol) -> GradientHandle:
        if len(self.gradients) >= self.cfg.max_gradients:
            return GradientHandle()
        gm = np.array([1.0, 0.0, 0.0, 1.0, x + w * 0.5, y + h * 0.5])
        params = np.array([w * 0.5, h * 0.5, r, max(1.0, f)], np.float32)
        return self._store_gradient(gm, params, icol, ocol)

    def createRadialGradient(self, cx, cy, inr, outr, icol, ocol) -> GradientHandle:
        if len(self.gradients) >= self.cfg.max_gradients:
            return GradientHandle()
        gm = np.array([1.0, 0.0, 0.0, 1.0, cx, cy])
        r = (inr + outr) * 0.5
        f = outr - inr
        params = np.array([r, r, r, max(1.0, f)], np.float32)
        return self._store_gradient(gm, params, icol, ocol)

    def _store_gradient(self, grad_mtx, params, icol, ocol) -> GradientHandle:
        patt = core.xform_multiply(self._render_transform(), grad_mtx)
        inv = core.xform_invert(patt)
        paint = make_gradient_paint(
            inv.astype(np.float32), params,
            color_to_rgba_f32(icol), color_to_rgba_f32(ocol),
        )
        self.gradients.append(paint)
        return GradientHandle(idx=len(self.gradients) - 1)

    def createImagePattern(self, cx, cy, w, h, angle, image: ImageHandle) -> ImagePatternHandle:
        if not isValid(image) or len(self.image_patterns) >= self.cfg.max_image_patterns:
            return ImagePatternHandle()
        cs, sn = math.cos(angle), math.sin(angle)
        mtx = np.array([cs, sn, -sn, cs, cx, cy])
        patt = core.xform_multiply(self._render_transform(), mtx)
        inv = core.xform_invert(patt)
        # normalize UVs by pattern size (vg.cpp:3921-3926)
        inv = inv / np.array([w, h, w, h, w, h], np.float64)
        self.image_patterns.append((inv.astype(np.float32), image))
        return ImagePatternHandle(idx=len(self.image_patterns) - 1)

    # -- state --------------------------------------------------------------
    def setGlobalAlpha(self, alpha: float) -> None:
        self.state.global_alpha = float(alpha)

    def pushState(self) -> None:
        if len(self.state_stack) >= self.cfg.max_state_stack_size:
            raise RuntimeError("state stack overflow")
        self.state_stack.append(self.state.copy())

    def popState(self) -> None:
        if len(self.state_stack) <= 1:
            raise RuntimeError("state stack underflow")
        self.state_stack.pop()

    def resetScissor(self) -> None:
        self.state.scissor[:] = (0.0, 0.0, float(self.canvas_width), float(self.canvas_height))
        self.state.scissor_explicit = False

    def setScissor(self, x, y, w, h) -> None:
        """ctxSetScissor (transform pos + vec, clamp to canvas)."""
        m = self.state.transform
        px, py = core.xform_point(m, x, y)
        sx = m[0] * w + m[2] * h
        sy = m[1] * w + m[3] * h
        cw, chh = float(self.canvas_width), float(self.canvas_height)
        minx = float(np.clip(px, 0.0, cw))
        miny = float(np.clip(py, 0.0, chh))
        maxx = float(np.clip(px + sx, 0.0, cw))
        maxy = float(np.clip(py + sy, 0.0, chh))
        self.state.scissor[:] = (minx, miny, maxx - minx, maxy - miny)
        self.state.scissor_explicit = True

    def intersectScissor(self, x, y, w, h) -> bool:
        m = self.state.transform
        px, py = core.xform_point(m, x, y)
        sx = m[0] * w + m[2] * h
        sy = m[1] * w + m[3] * h
        s = self.state.scissor
        minx = max(px, s[0])
        miny = max(py, s[1])
        maxx = min(px + sx, s[0] + s[2])
        maxy = min(py + sy, s[1] + s[3])
        nw = max(0.0, maxx - minx)
        nh = max(0.0, maxy - miny)
        self.state.scissor[:] = (minx, miny, nw, nh)
        self.state.scissor_explicit = True
        return nw >= 1.0 and nh >= 1.0

    def transformIdentity(self) -> None:
        self.state.transform = core.xform_identity()
        self.state.update()

    def transformScale(self, x, y) -> None:
        self.state.transform = core.xform_multiply(self.state.transform, core.xform_scale(x, y))
        self.state.update()

    def transformTranslate(self, x, y) -> None:
        self.state.transform = core.xform_multiply(self.state.transform, core.xform_translate(x, y))
        self.state.update()

    def transformRotate(self, ang) -> None:
        self.state.transform = core.xform_multiply(self.state.transform, core.xform_rotate(ang))
        self.state.update()

    def transformMult(self, mtx, order: int) -> None:
        mtx = np.asarray(mtx, np.float64)
        if order == TransformOrder.Pre:
            self.state.transform = core.xform_multiply(self.state.transform, mtx)
        else:
            self.state.transform = core.xform_multiply(mtx, self.state.transform)
        self.state.update()

    def setViewBox(self, x, y, w, h) -> None:
        """ctxSetViewBox: scale canvas/viewbox then translate by -x,-y."""
        m = self.state.transform
        sx = self.canvas_width / w
        sy = self.canvas_height / h
        m[0] *= sx
        m[1] *= sx
        m[2] *= sy
        m[3] *= sy
        m[4] -= m[0] * x + m[2] * y
        m[5] -= m[1] * x + m[3] * y
        self.state.update()

    def getTransform(self):
        return self.state.transform.copy()

    def getScissor(self):
        return self.state.scissor.copy()

    # -- images -------------------------------------------------------------
    def createImage(self, w: int, h: int, flags: int, data) -> ImageHandle:
        if len(self.images) >= self.cfg.max_images:
            return ImageHandle()
        idx = self._next_image_idx
        self._next_image_idx += 1
        arr = np.zeros((h, w, 4), np.uint8)
        if data is not None:
            src = np.asarray(data, np.uint8)
            if src.size != w * h * 4:
                # the reference copies exactly w*h*4 bytes (vg.cpp:2227);
                # silently reshaping mismatched data hid caller bugs
                raise ValueError(
                    f"createImage: data has {src.size} bytes, expected "
                    f"{w * h * 4} for a {w}x{h} RGBA8 image")
            arr[:] = src.reshape(h, w, 4)
        self.images[idx] = _Image(arr, flags)
        return ImageHandle(idx=idx)

    def updateImage(self, handle: ImageHandle, x, y, w, h, data) -> bool:
        if not self.isImageValid(handle):
            return False
        img = self.images[handle.idx]
        img.data[y : y + h, x : x + w] = np.asarray(data, np.uint8).reshape(h, w, 4)
        img.generation += 1
        return True

    def destroyImage(self, handle: ImageHandle) -> bool:
        if not self.isImageValid(handle):
            return False
        del self.images[handle.idx]
        return True

    def isImageValid(self, handle: ImageHandle) -> bool:
        return isValid(handle) and handle.idx in self.images

    def getImageSize(self, handle: ImageHandle):
        if not self.isImageValid(handle):
            return None
        d = self.images[handle.idx].data
        return d.shape[1], d.shape[0]

    # -- user triangle lists (ctxIndexedTriList, vg.cpp:4129-4175) ----------
    def indexedTriList(self, pos, uv, colors, indices, img: ImageHandle | None) -> None:
        """pos: (N,2) f32; uv: (N,2) normalized or None; colors: scalar Color,
        (1,) or (N,) of Colors; indices: (K,) triangle list.

        Per-vertex colors become P_TRI entries (linear barycentric
        interpolation as linear-in-(x,y) coefficients); textured tri-lists
        become P_IMAGE entries whose paint matrix is the triangle's exact
        screen->uv affine map.  Solid single-color lists collapse to one
        winding op.
        """
        pos = np.asarray(pos, np.float32).reshape(-1, 2)
        spos = core.xform_points(self._render_transform(), pos)
        idx = np.asarray(indices, np.int64).reshape(-1, 3)
        ga = self.state.global_alpha
        sciss = self._op_scissor()

        colors = np.atleast_1d(np.asarray(colors, np.uint32))
        col_f = core.colors_to_rgba_f32(colors)
        col_f[:, 3] *= ga

        tri = spos[idx]                                   # (K,3,2)
        ones = np.ones((len(idx), 3, 1), np.float64)
        A = np.concatenate([tri.astype(np.float64), ones], axis=2)  # (K,3,3)
        det = np.linalg.det(A)
        good = np.abs(det) > 1e-9

        if uv is None and len(col_f) == 1:
            # one solid op; union coverage over all triangles
            edges = np.concatenate(
                [np.concatenate([tri, np.roll(tri, -1, axis=1)], axis=2).reshape(-1, 4)]
            ).astype(np.float32)
            self._emit(
                RasterOp(
                    edges=edges, fill_rule=FillRule.NonZero, aa=False,
                    paint_kind=P_SOLID, paint=make_solid_paint(col_f[0]),
                    scissor=sciss,
                )
            )
            return

        # batched: ONE op carries all triangles with per-triangle paints
        # (expanded without python objects in the binner); the barycentric
        # solves run as one batched np.linalg.solve
        tri = tri[good]
        Ag = A[good]
        idx = idx[good]
        if len(idx) == 0:
            return
        nxt = np.empty_like(tri)
        nxt[:, :-1] = tri[:, 1:]
        nxt[:, -1] = tri[:, 0]
        edges = np.concatenate([tri, nxt], axis=2).astype(np.float32)  # (K,3,4)

        paints = np.zeros((len(idx), 18), np.float32)
        if uv is not None:
            uvt = np.asarray(uv, np.float32).reshape(-1, 2)[idx]        # (K,3,2)
            coef = np.linalg.solve(Ag, uvt.astype(np.float64))          # (K,3,2)
            paints[:, 0] = coef[:, 0, 0]
            paints[:, 1] = coef[:, 0, 1]
            paints[:, 2] = coef[:, 1, 0]
            paints[:, 3] = coef[:, 1, 1]
            paints[:, 4] = coef[:, 2, 0]
            paints[:, 5] = coef[:, 2, 1]
            mod = col_f[0][None, :] if len(col_f) == 1 else col_f[idx[:, 0]]
            paints[:, 10:14] = mod
            pk_, img_id = P_IMAGE, (img.idx if img is not None and isValid(img) else -1)
        else:
            ck = (col_f[idx] if len(col_f) > 1
                  else np.broadcast_to(col_f[0], (len(idx), 3, 4)))      # (K,3,4)
            coef = np.linalg.solve(Ag, ck.astype(np.float64))            # (K,3,4)
            paints[:, 0:4] = coef[:, 0]
            paints[:, 4:8] = coef[:, 1]
            paints[:, 8:12] = coef[:, 2]
            pk_, img_id = P_TRI, -1
        self._emit(
            RasterOp(
                edges=edges.reshape(-1, 4), fill_rule=FillRule.NonZero, aa=False,
                paint_kind=pk_, paint=None, scissor=sciss, image_id=img_id,
                tri_paints=paints,
            )
        )

    # -- text (methods so command lists can record them) --------------------
    def text(self, cfg, x, y, s) -> None:
        from vgtpu_torch.fonts.system import ctx_text

        ctx_text(self, cfg, x, y, s)

    def textBox(self, cfg, x, y, break_width, s, flags=0) -> None:
        from vgtpu_torch.fonts.system import ctx_text_box

        ctx_text_box(self, cfg, x, y, break_width, s, flags)

    # -- misc ---------------------------------------------------------------
    def getStats(self) -> Stats:
        """Reference-parity Stats (vg.h:339-343) — command-list memory — plus
        extended frame counters via ctx.profiler.report()."""
        total = used = 0
        for cl in self.command_lists.values():
            n = len(cl.commands)
            used += n * 64            # rough per-command footprint
            total += max(n, 16) * 64
            for slot in cl.cache_slots.values():
                for item in slot or []:
                    if item is not None:
                        used += item[0].nbytes
                        total += item[0].nbytes
        self.stats.cmd_list_memory_used = used
        self.stats.cmd_list_memory_total = total
        return self.stats

# ---------------------------------------------------------------------------
# free-function API (vg.h parity)
# ---------------------------------------------------------------------------

def createContext(allocator=None, cfg: ContextConfig | None = None, *,
                  device: torch.device | str = "cuda") -> Context:
    """vg::createContext (vg.cpp:717) on an explicit torch device.
    `allocator` exists for signature parity and is unused (torch owns device
    memory); passing a ContextConfig positionally is treated as the config.
    A CUDA device without CUDA raises: the port never falls back to the CPU
    on its own — pass device="cpu" for the plain torch path."""
    if isinstance(allocator, ContextConfig):
        if cfg is not None:
            raise TypeError("createContext got two ContextConfigs")
        cfg = allocator
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "createContext(device='cuda'): torch sees no CUDA device; pass "
            "device='cpu' to render with the plain torch path")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"createContext: unsupported device {device}")
    return Context(cfg, device)


def destroyContext(ctx: Context) -> None:
    pass


def begin(ctx, view_id, w, h, dpr=1.0):
    ctx.begin(view_id, w, h, dpr)


def end(ctx, background=None, dispatch=True):
    return ctx.end(background, dispatch=dispatch)


def renderFrames(ctxs, backgrounds=None):
    """Render several contexts' resident frames in one go.

    The multi-canvas serving pattern: record each canvas through its own
    context and `end(ctx, dispatch=False)`, then call this once.  Each
    context's `frame_image` is assigned and the image tuple returned; scenes
    may differ arbitrarily (geometry, size, config).  vgtpu compiles the K
    frames into one XLA program; here their kernels launch back to back on
    the current stream with no synchronisation in between, so the device
    runs the K frames as one stream of work.  Each profiler records the
    total host time under "fused_dispatch"."""
    ctxs = list(ctxs)
    if backgrounds is None:
        backgrounds = [c.background for c in ctxs]
    elif len(backgrounds) != len(ctxs):
        raise ValueError(f"backgrounds has {len(backgrounds)} entries for "
                         f"{len(ctxs)} contexts")
    for c in ctxs:
        if c.last_plan is None or c.last_device_arrays is None:
            raise ValueError("renderFrames needs resident plans: call "
                             "end(ctx, dispatch=False) on every context first")
        if not c._frame_prepared:
            raise ValueError("a context was begun but not ended this frame: "
                             "its resident plan is STALE — call "
                             "end(ctx, dispatch=False) before renderFrames")
    t0 = time.perf_counter()
    imgs = tuple(
        execute_plan(c.last_plan, bg, device_arrays=c.last_device_arrays,
                     init_tiles=(c._layer_render.materialize()
                                 if isinstance(c._layer_render, PendingPanLayer)
                                 else c._layer_render))
        for c, bg in zip(ctxs, backgrounds))
    dt = (time.perf_counter() - t0) * 1e3
    for c, img in zip(ctxs, imgs):
        c.frame_image = img
        c.profiler.times_ms["fused_dispatch"] += dt
    return imgs


def frame(ctx):
    ctx.frame()


def getStats(ctx):
    return ctx.getStats()


def beginPath(ctx):
    (ctx._sink() or ctx).beginPath()


def moveTo(ctx, x, y):
    (ctx._sink() or ctx).moveTo(x, y)


def lineTo(ctx, x, y):
    (ctx._sink() or ctx).lineTo(x, y)


def cubicTo(ctx, c1x, c1y, c2x, c2y, x, y):
    (ctx._sink() or ctx).cubicTo(c1x, c1y, c2x, c2y, x, y)


def quadraticTo(ctx, cx, cy, x, y):
    (ctx._sink() or ctx).quadraticTo(cx, cy, x, y)


def arcTo(ctx, x1, y1, x2, y2, r):
    (ctx._sink() or ctx).arcTo(x1, y1, x2, y2, r)


def arc(ctx, cx, cy, r, a0, a1, direction):
    (ctx._sink() or ctx).arc(cx, cy, r, a0, a1, direction)


def rect(ctx, x, y, w, h):
    (ctx._sink() or ctx).rect(x, y, w, h)


def roundedRect(ctx, x, y, w, h, r):
    (ctx._sink() or ctx).roundedRect(x, y, w, h, r)


def roundedRectVarying(ctx, x, y, w, h, rtl, rtr, rbr, rbl):
    (ctx._sink() or ctx).roundedRectVarying(x, y, w, h, rtl, rtr, rbr, rbl)


def circle(ctx, cx, cy, r):
    (ctx._sink() or ctx).circle(cx, cy, r)


def ellipse(ctx, cx, cy, rx, ry):
    (ctx._sink() or ctx).ellipse(cx, cy, rx, ry)


def polyline(ctx, coords, num_points=None):
    (ctx._sink() or ctx).polyline(coords)


def closePath(ctx):
    (ctx._sink() or ctx).closePath()


def fillPath(ctx, paint_or_color, *args):
    """fillPath(ctx, color, flags) / (ctx, gradient, flags) /
    (ctx, pattern, color, flags) — the three reference overloads."""
    if isinstance(paint_or_color, ImagePatternHandle):
        color_mod, flags = args
        (ctx._sink() or ctx).fillPath(paint_or_color, flags, color_modulate=color_mod)
    else:
        (flags,) = args
        (ctx._sink() or ctx).fillPath(paint_or_color, flags)


def strokePath(ctx, paint_or_color, *args):
    if isinstance(paint_or_color, ImagePatternHandle):
        color_mod, width, flags = args
        (ctx._sink() or ctx).strokePath(paint_or_color, width, flags, color_modulate=color_mod)
    else:
        width, flags = args
        (ctx._sink() or ctx).strokePath(paint_or_color, width, flags)


def beginClip(ctx, rule):
    (ctx._sink() or ctx).beginClip(rule)


def endClip(ctx):
    (ctx._sink() or ctx).endClip()


def resetClip(ctx):
    (ctx._sink() or ctx).resetClip()


def createLinearGradient(ctx, sx, sy, ex, ey, icol, ocol):
    return (ctx._sink() or ctx).createLinearGradient(sx, sy, ex, ey, icol, ocol)


def createBoxGradient(ctx, x, y, w, h, r, f, icol, ocol):
    return (ctx._sink() or ctx).createBoxGradient(x, y, w, h, r, f, icol, ocol)


def createRadialGradient(ctx, cx, cy, inr, outr, icol, ocol):
    return (ctx._sink() or ctx).createRadialGradient(cx, cy, inr, outr, icol, ocol)


def createImagePattern(ctx, cx, cy, w, h, angle, image):
    return (ctx._sink() or ctx).createImagePattern(cx, cy, w, h, angle, image)


def setGlobalAlpha(ctx, alpha):
    (ctx._sink() or ctx).setGlobalAlpha(alpha)


def pushState(ctx):
    (ctx._sink() or ctx).pushState()


def popState(ctx):
    (ctx._sink() or ctx).popState()


def resetScissor(ctx):
    (ctx._sink() or ctx).resetScissor()


def setScissor(ctx, x, y, w, h):
    (ctx._sink() or ctx).setScissor(x, y, w, h)


def intersectScissor(ctx, x, y, w, h):
    return (ctx._sink() or ctx).intersectScissor(x, y, w, h)


def transformIdentity(ctx):
    (ctx._sink() or ctx).transformIdentity()


def transformScale(ctx, x, y):
    (ctx._sink() or ctx).transformScale(x, y)


def transformTranslate(ctx, x, y):
    (ctx._sink() or ctx).transformTranslate(x, y)


def transformRotate(ctx, ang):
    (ctx._sink() or ctx).transformRotate(ang)


def transformMult(ctx, mtx, order):
    (ctx._sink() or ctx).transformMult(mtx, order)


def setViewBox(ctx, x, y, w, h):
    (ctx._sink() or ctx).setViewBox(x, y, w, h)


def getTransform(ctx):
    return ctx.getTransform()


def getScissor(ctx):
    return ctx.getScissor()


def indexedTriList(ctx, pos, uv, num_vertices, colors, num_colors, indices, num_indices, img):
    (ctx._sink() or ctx).indexedTriList(pos, uv, colors, indices, img)


def getImageSize(ctx, handle):
    return ctx.getImageSize(handle)


def createImage(ctx, w, h, flags, data):
    return ctx.createImage(w, h, flags, data)


def updateImage(ctx, handle, x, y, w, h, data):
    return ctx.updateImage(handle, x, y, w, h, data)


def destroyImage(ctx, handle):
    return ctx.destroyImage(handle)


def isImageValid(ctx, handle):
    return ctx.isImageValid(handle)


# -- text (implemented in vgtpu_torch/text; wired here) ---------------------------

def createFont(ctx, name, data, size=None, flags=0):
    from vgtpu_torch.fonts.system import ctx_create_font

    return ctx_create_font(ctx, name, data, flags)


def getFontByName(ctx, name):
    idx = ctx._font_by_name.get(name)
    return FontHandle(idx=idx) if idx is not None else FontHandle()


def setFallbackFont(ctx, base, fallback):
    from vgtpu_torch.fonts.system import ctx_set_fallback_font

    return ctx_set_fallback_font(ctx, base, fallback)


def makeTextConfig(ctx, font, font_size, alignment, color):
    if isinstance(font, str):
        font = getFontByName(ctx, font)
    return TextConfig(font, font_size, alignment, color)


def text(ctx, cfg, x, y, s, end=None):
    (ctx._sink() or ctx).text(cfg, x, y, s if end is None else s[:end])


def textBox(ctx, cfg, x, y, break_width, s, end=None, flags=0):
    (ctx._sink() or ctx).textBox(cfg, x, y, break_width, s if end is None else s[:end], flags)


def measureText(ctx, cfg, x, y, s, end=None):
    from vgtpu_torch.fonts.system import ctx_measure_text

    return ctx_measure_text(ctx, cfg, x, y, s if end is None else s[:end])


def measureTextBox(ctx, cfg, x, y, break_width, s, end=None, flags=0):
    from vgtpu_torch.fonts.system import ctx_measure_text_box

    return ctx_measure_text_box(ctx, cfg, x, y, break_width, s if end is None else s[:end], flags)


def getTextLineHeight(ctx, cfg):
    from vgtpu_torch.fonts.system import ctx_text_line_height

    return ctx_text_line_height(ctx, cfg)


def textBreakLines(ctx, cfg, s, end, break_width, max_rows, flags=0):
    from vgtpu_torch.fonts.system import ctx_text_break_lines

    return ctx_text_break_lines(ctx, cfg, s if end is None else s[:end], break_width, max_rows, flags)


def textGlyphPositions(ctx, cfg, x, y, s, end=None, max_positions=None):
    from vgtpu_torch.fonts.system import ctx_text_glyph_positions

    return ctx_text_glyph_positions(ctx, cfg, x, y, s if end is None else s[:end], max_positions)


# -- command lists (api/command_list.py) ------------------------------

def createCommandList(ctx, flags):
    from vgtpu_torch.api.command_list import cl_create

    return cl_create(ctx, flags)


def destroyCommandList(ctx, handle):
    from vgtpu_torch.api.command_list import cl_destroy

    cl_destroy(ctx, handle)


def clReset(ctx, handle):
    """vg.h alias for resetCommandList."""
    return resetCommandList(ctx, handle)


def saveCommandList(ctx, handle, path) -> bool:
    """Serialize a command list (+ its tessellation cache) to disk — the
    checkpoint/resume analogue of the reference's retained byte stream
    (vg.cpp:2323-2966) and shape cache (:5674-6211), which are
    memory-resident only.  See command_list.cl_save for the format contract."""
    from vgtpu_torch.api.command_list import cl_save

    return cl_save(ctx, handle, path)


def loadCommandList(ctx, path):
    """Restore a command list saved by saveCommandList; returns a handle."""
    from vgtpu_torch.api.command_list import cl_load

    return cl_load(ctx, path)


def resetCommandList(ctx, handle):
    from vgtpu_torch.api.command_list import cl_reset

    cl_reset(ctx, handle)


def submitCommandList(ctx, handle):
    from vgtpu_torch.api.command_list import cl_submit

    sink = ctx._sink()
    if sink is not None:
        sink.submitCommandList(handle)   # record nested submit (vg.cpp:1704)
    else:
        cl_submit(ctx, handle)


def beginCommandList(ctx, handle):
    from vgtpu_torch.api.command_list import cl_begin_recording

    cl_begin_recording(ctx, handle)


def endCommandList(ctx):
    from vgtpu_torch.api.command_list import cl_end_recording

    cl_end_recording(ctx)


# ---------------------------------------------------------------------------
# Direct command-list recording API (vg.h:495-541): record into a specific
# list without making it active — the clXXX function family.
# ---------------------------------------------------------------------------

def _cl(ctx, handle):
    cl = ctx.command_lists.get(handle.idx)
    if cl is None:
        raise ValueError("invalid command list handle")
    return cl


def clBeginPath(ctx, handle):
    _cl(ctx, handle).beginPath()


def clMoveTo(ctx, handle, x, y):
    _cl(ctx, handle).moveTo(x, y)


def clLineTo(ctx, handle, x, y):
    _cl(ctx, handle).lineTo(x, y)


def clCubicTo(ctx, handle, c1x, c1y, c2x, c2y, x, y):
    _cl(ctx, handle).cubicTo(c1x, c1y, c2x, c2y, x, y)


def clQuadraticTo(ctx, handle, cx, cy, x, y):
    _cl(ctx, handle).quadraticTo(cx, cy, x, y)


def clArcTo(ctx, handle, x1, y1, x2, y2, r):
    _cl(ctx, handle).arcTo(x1, y1, x2, y2, r)


def clArc(ctx, handle, cx, cy, r, a0, a1, direction):
    _cl(ctx, handle).arc(cx, cy, r, a0, a1, direction)


def clRect(ctx, handle, x, y, w, h):
    _cl(ctx, handle).rect(x, y, w, h)


def clRoundedRect(ctx, handle, x, y, w, h, r):
    _cl(ctx, handle).roundedRect(x, y, w, h, r)


def clRoundedRectVarying(ctx, handle, x, y, w, h, rtl, rtr, rbr, rbl):
    _cl(ctx, handle).roundedRectVarying(x, y, w, h, rtl, rtr, rbr, rbl)


def clCircle(ctx, handle, cx, cy, r):
    _cl(ctx, handle).circle(cx, cy, r)


def clEllipse(ctx, handle, cx, cy, rx, ry):
    _cl(ctx, handle).ellipse(cx, cy, rx, ry)


def clPolyline(ctx, handle, coords, num_points=None):
    _cl(ctx, handle).polyline(coords)


def clClosePath(ctx, handle):
    _cl(ctx, handle).closePath()


def clFillPath(ctx, handle, paint_or_color, *args):
    if isinstance(paint_or_color, ImagePatternHandle):
        color_mod, flags = args
        _cl(ctx, handle).fillPath(paint_or_color, flags, color_modulate=color_mod)
    else:
        (flags,) = args
        _cl(ctx, handle).fillPath(paint_or_color, flags)


def clStrokePath(ctx, handle, paint_or_color, *args):
    if isinstance(paint_or_color, ImagePatternHandle):
        color_mod, width, flags = args
        _cl(ctx, handle).strokePath(paint_or_color, width, flags, color_modulate=color_mod)
    else:
        width, flags = args
        _cl(ctx, handle).strokePath(paint_or_color, width, flags)


def clBeginClip(ctx, handle, rule):
    _cl(ctx, handle).beginClip(rule)


def clEndClip(ctx, handle):
    _cl(ctx, handle).endClip()


def clResetClip(ctx, handle):
    _cl(ctx, handle).resetClip()


def clCreateLinearGradient(ctx, handle, sx, sy, ex, ey, icol, ocol):
    return _cl(ctx, handle).createLinearGradient(sx, sy, ex, ey, icol, ocol)


def clCreateBoxGradient(ctx, handle, x, y, w, h, r, f, icol, ocol):
    return _cl(ctx, handle).createBoxGradient(x, y, w, h, r, f, icol, ocol)


def clCreateRadialGradient(ctx, handle, cx, cy, inr, outr, icol, ocol):
    return _cl(ctx, handle).createRadialGradient(cx, cy, inr, outr, icol, ocol)


def clCreateImagePattern(ctx, handle, cx, cy, w, h, angle, image):
    return _cl(ctx, handle).createImagePattern(cx, cy, w, h, angle, image)


def clPushState(ctx, handle):
    _cl(ctx, handle).pushState()


def clPopState(ctx, handle):
    _cl(ctx, handle).popState()


def clResetScissor(ctx, handle):
    _cl(ctx, handle).resetScissor()


def clSetScissor(ctx, handle, x, y, w, h):
    _cl(ctx, handle).setScissor(x, y, w, h)


def clIntersectScissor(ctx, handle, x, y, w, h):
    _cl(ctx, handle).intersectScissor(x, y, w, h)


def clTransformIdentity(ctx, handle):
    _cl(ctx, handle).transformIdentity()


def clTransformScale(ctx, handle, x, y):
    _cl(ctx, handle).transformScale(x, y)


def clTransformTranslate(ctx, handle, x, y):
    _cl(ctx, handle).transformTranslate(x, y)


def clTransformRotate(ctx, handle, ang):
    _cl(ctx, handle).transformRotate(ang)


def clTransformMult(ctx, handle, mtx, order):
    _cl(ctx, handle).transformMult(mtx, order)


def clSetViewBox(ctx, handle, x, y, w, h):
    _cl(ctx, handle).setViewBox(x, y, w, h)


def clSetGlobalAlpha(ctx, handle, alpha):
    _cl(ctx, handle).setGlobalAlpha(alpha)


def clText(ctx, handle, cfg, x, y, s, end=None):
    _cl(ctx, handle).text(cfg, x, y, s if end is None else s[:end])


def clTextBox(ctx, handle, cfg, x, y, break_width, s, end=None, flags=0):
    _cl(ctx, handle).textBox(cfg, x, y, break_width, s if end is None else s[:end], flags)


def clIndexedTriList(ctx, handle, pos, uv, num_vertices, colors, num_colors,
                     indices, num_indices, img):
    _cl(ctx, handle).indexedTriList(pos, uv, colors, indices, img)


def clSubmitCommandList(ctx, parent, child):
    _cl(ctx, parent).submitCommandList(child)


class CommandListRef:
    """vg.h:556-607 convenience: carries (Context, CommandListHandle) so call
    sites don't thread both around."""

    def __init__(self, ctx, handle):
        self.ctx = ctx
        self.handle = handle

    def __getattr__(self, name):
        cl = _cl(self.ctx, self.handle)
        return getattr(cl, name)

    def reset(self):
        from vgtpu_torch.api.command_list import cl_reset

        cl_reset(self.ctx, self.handle)

    def submit(self):
        submitCommandList(self.ctx, self.handle)


def makeCommandListRef(ctx, handle) -> CommandListRef:
    return CommandListRef(ctx, handle)


# star-import hygiene: export everything defined here (the vg.h surface)
# but not modules or the geometry/raster internals imported above
import types as _types  # noqa: E402

__all__ = [
    _n for _n, _v in list(globals().items())
    if not _n.startswith("_")
    and not isinstance(_v, _types.ModuleType)
    and _n not in {
        "annotations", "dataclass", "field",
        "contours_to_edges", "polyline_to_fill_edges", "stroke_outline",
        "PathBuilder", "RasterOp", "bin_frame",
        "make_gradient_paint", "make_solid_paint",
        "execute_plan", "image_to_u8", "plan_to_device",
        "PendingPanLayer", "RetainedScene",
    }
]