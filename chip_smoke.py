#!/usr/bin/env python3
"""Smoke test of vgtpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):
  1. CUDA present; print the card's name and power limit (nvidia-smi).
  2. Build kernels K1 (csrc/coverage.cu), K2 (csrc/composite.cu), K3
     (csrc/coverage_resolve.cu), K4 (csrc/coverage_t.cu), K5
     (csrc/coverage_t_flat.cu), K6 (csrc/coverage_slots.cu), K7
     (csrc/composite_flat.cu) and K8 (csrc/probe.cu) with nvcc from the
     checkout, one nvcc each, all started together; print the build seconds
     and ptxas's register and spill report.
  3. K1 against its plain twin coverage_chunks_torch on the card: random
     chunks (horizontal, near-vertical, tiny-dy, zero-length, out-of-tile
     edges) at CH = 2, 4, 8, 24, 40, 64 (over the 32 edges K1 once
     staged), 2,048 and 8,192 (deeper than one edge window: the deep form)
     and the 1080p frame's pool sizes, then all of them in one launch
     (within K1_BOUND; kernel and twin round alike, so 0.0 is what a
     correct kernel gives).
  3c. K4 (pixel-major chunk coverage) against coverage_chunks_t_torch: the
     same random chunks (2,048 and 8,192 in the deep form) and the 1080p
     frame's pools, one at a time and all in one launch.
  3d. K6 (chunk coverage of one pool, K1's design) against
     coverage_chunks_torch and K1: random
     chunks at CH = 2, 6, 24, 40, 64, 2,048 and 8,192 on 8x128 and 8x256
     tiles and the 1080p frame's pools ([4g] and [4h] add the tall tiles'
     and the deep-tile scene's pools).
  3e. K5 (pixel-major coverage of one pool, K4's design) against
     coverage_chunks_t_torch and K4: the same random chunks, the
     1080p frame's pools and the pools of its n = 1 partition.
  3b. K3 against coverage_chunks_res_torch: random chunks at ss = 2, 4 and
     CH = 2, 4, 6, 12, 24, 40, 64, 2,048, 8,192 with random resolve params
     (even-odd, non-AA, texture, scissor, backdrop), and the RES pools of
     the 1080p ss=2 plan (one launch); K3's vg_resolve_rows against
     resolve_cov_rows_torch on its XE rows.
  4. K2 against its plain twin composite_bucket_into_torch on every bucket of
     the 1080p tiger + demo-UI plan and of the two 512x256 scenes of
     vgtpu_torch.scenes.small (an image pattern covers the texture lane,
     the feature scene the scissor, even-odd, non-AA, clip, gradient and
     triangle lanes).
  4b. K2's forms (d) (sub-row coverage, ss-averaged) and (e) (final
     coverage + resolved-backdrop rows) against the twin at ss=2 on every
     bucket of the 1080p plan and of the small, feature and resolve scenes,
     split (clip buckets take (d), the others (e)) and unsplit (every
     bucket takes (d)); each form must cover every lane it reads.
  4c. K2's forms (b) (per-tile init planes: a random plane per tile) and
     (c) (k_rep=3 variant blocks over one block of coverage rows, three
     random paint variants, the batch's own tables) against the twin on
     every bucket of the 1080p plan at ss=1 and of the ss=2 split plan, so
     (b) runs with forms (a), (d) and (e).
  4d. K7 (the flat composite) against composite_bucket_torch on every
     bucket of phase 4's scenes at ss=1: over chunk coverage with the
     backdrop rows added (add_backdrop), over entry winding gathered by the
     bucket's entry table, from a random init plane, and k_rep=3 (on every
     bucket: the kernel takes any Nb, the entry point as vgtpu only
     Nb % 128 == 0); every lane must be covered.  Then the same four
     settings on buckets built from those buckets' tiles for each of the
     16 template instantiations, in the narrow form (a grid of fewer
     blocks than the card's SMs) and the wide one: every (G, pixels a
     thread) instantiation must have been held to the twin.
  4e. Tile shapes beyond 8x128 (runs after 5b): the small scene through
     end() at ContextConfig(tile_w=256) and (tile_h=16), each at ss = 1, 2
     and 8 (up to 128 sub-rows per tile), through K1, K3 and K2 with their
     launch counts > 0, 0 u8 levels from the plain twins on the same plan.
  4f. Chunks over 32 edges (runs after 4e): ContextConfig(chunk_pools=(2,
     8, 48)) through end() at ss = 1 and 2, on the 512x256 deep-chunk scene
     (scenes.small.draw_deep_chunk_scene: 48-edge chunks in RES and RAW
     pools; 0 u8 levels from the plain twins on the same plan) and on the
     1080p frame (within 1 u8 level: the extras fold is atomic), with K1
     (and K3) launched and a 48-edge pool in the plan.
  4g. Tiles taller than one staging window (runs after 4f): the small
     scene with ContextConfig(chunk_pools=(2, 8, 48)) through end() at ss=1
     with tile_h=16384 and at ss=2 with tile_h=8192 (16,384 sub-rows), so
     K1's and K3's row masks take several windows a tile; K1 (K3) and K2
     launched, 0 u8 levels from the plain twins on the same plan; K4, K5
     and K6 over the plan's pools against their twins.
  4h. Chunks deeper than one edge window (runs after 4g): the deep-tile
     scene (scenes.small.draw_deep_tile_scene: 2,001 edges of one path in
     one tile) with ContextConfig(chunk_pools=(2, 8, CH_DEEP)) through
     end() at ss = 1 and 2: its chunk is deeper than the 1,808 edges a
     shallow K1 block held, so K1 (and at ss=2 K3) launch in their deep
     form; 0 u8 levels from the plain twins on the same plan; K4, K5 and
     K6 over the plan's pools against their twins.
  5. The main path: createContext(device="cuda"), begin 1920x1080,
     scenes.demo_ui.draw_benchmark_frame, end().  Both kernels' launch
     counts must be > 0; the image must match the same plan through the
     plain twins on the card within 1 u8 level, and the small scene must
     match the CPU path within 1 u8 level.
  5c. The 1080p frame assembled through the entry points of this slice's
     kernels (raster/frame.execute_plan_flat): chunk coverage per pool through K5 (then again
     through K6), the chunk -> entry index_add_, + backdrop, per bucket K7
     over the gathered entry winding; K5 (K6) and K7 launch counts > 0, the
     image within 1 u8 level of phase 5's.
  5b. The main path in parity mode: createContext(ContextConfig(
     coverage_supersample=2), device="cuda"), the same frame; K1, K2 and K3
     launch counts > 0; the image within 1 u8 level of the plain twins on
     the same plan; the small scene at ss = 2, 4 and 8 within 1 u8 level of
     the CPU path.
  7. The serving paths at 1080p through the entry points, each run with the
     launch counts set to 0 just before it and read just after (counter and
     launch checks first, then the images, each within 1 u8 level):
     redraw (5 identical frames: 4 frame-memo hits, each image against the
     first), anim (bench.py's overlay recolour: 5 paint patches, against a
     full-path context), layer (tiger + demo UI with a moving UI: one bake,
     then K2 (b) frames, against a layer_memo=False context; at ss=1 and
     ss=2), renderFrames (the frame at ss=1 and ss=2 and the small scene,
     ended with end(dispatch=False), against fresh end()s) and batch
     (VariantBatch of bench.py's K=6 overlay variants through K2 (c),
     against per-variant full-path renders).
  8. The multi-GPU paths at 1080p over meshes of n shards, one per card
     while cards last, then repeating them (one card: n shards on cuda:0),
     each run with the launch counts zeroed before and read after, each
     image within 1 u8 level of its single-device reference:
     render_frame_sharded (K4 + the oracle composite) at n = 1, 2, 4 against
     the phase 5 end() image; render_frame_sharded_fused (K1, the fold, K2)
     at n = 2, 4 and ss = 1, 2 against the phase 5 and 5b images; and
     VariantBatch.render_sharded of the phase 7 batch (K=6) over 4 shards
     (padded to 8) against each variant's full-path render.
  10a. Device texture sampling: the 1080p tiger + demo UI plus
     scenes.small.draw_pattern_panels (seeded RGBA patterns, repeat and
     clamp, linear and nearest, one rotated: the gather fallback) through
     end() with ContextConfig(device_sampling=True) against
     device_sampling=False (the numpy sampler), within 1 u8 level; the
     colour tiles against the same sampler on the CPU (CT_BOUND) and the
     numpy sampler (CT_NUMPY_BOUND); the frame again (one ct_memo_hit, the
     same image); the textures stage's host ms of both samplers and the
     device sampler's device ms; the steady textured frame's CPU trace,
     which must hold no host-side wait.
  10b. The retained pan: the 1080p frame baked over PAN_SCENE at ss = 1 and
     2 and the [10a] frame at ss=1 (RetainedScene.bake), each PAN_VIEWS
     view through render() (K1 + the fold, K2 (a) at ss=1, (d) on every
     bucket at ss=2) against the same body through the plain twins on the
     card (K2_BOUND) and a direct end() of the translated frame (1 u8
     level); render_views against per-view renders; update_paint_values
     against a fresh bake; chunk_pools=(2, 8, 48); K2 (d) against its twin
     on every bucket of the ss=2 scene and of the small resolve scene
     baked at ss = 2 and 4 (every lane held).  Each path's launch counts
     zeroed before and read after.
  11. The cached-list app at 1920x1080, bench.py's two app patterns over
     the tiger in a Cacheable command list with the demo UI drawn over it,
     at ss = 1 and 2 (phase_11): the app frame (the list at a fixed
     transform) against the same ops ended on the full path; the pan-layer
     frame (the list under transformTranslate(2.5 k, 2 k): K1 + the fold
     and K2 (a)/(d) for the pan tiles, the transparent static-UI overlay
     blended over them, K1, K3 at ss=2 and K2 (b) for the suffix) after
     PAN_APP_WARM frames against PAN_APP_COUNTS (vgtpu's counts on the
     CPU), then at four offsets against a layer_memo=False context, each
     within 1 u8 level; the last frame's pan tiles and frame against
     render_tiles(use_pallas=False) and execute_plan_torch over the twin
     tiles (K2_BOUND, 1 u8 level: the fold is atomic); per setting
     end()'s host ms, the steady frame's ms (CUDA events), busy share and
     launches (torch.profiler) and its host-side waits (must be none).  11b. diff.render_edges on the card
     against the CPU at 64x64, the image and loss.backward()'s gradients.
  6. Times (CUDA events, median of 12 runs after warm-up): the steady frame
     from resident arrays at ss=1 and ss=2, K1, K2 (each form) and K3 beside
     their plain twins; each kernel's device time per steady frame and the
     device's busy share (torch.profiler over 10 frames), also for a layer
     frame (K2 (b)) and a batch render (K2 (c)); end() host time (median of
     5, ending in torch.cuda.synchronize()) for a full-path frame, a redraw,
     an anim frame and a layer frame; renderFrames over three contexts; and
     measure_batch_ms_per_frame at K=6; the sharded frames per n (CUDA
     events, median of 12, from resident shards), K4 beside its twin and
     its device time in the n = 1 sharded frame, render_sharded per
     variant; K7 against its twin on every [5c] bucket in phase 4d's four
     settings (both block forms must be among them); K5, K6, K7 and K8
     beside their twins (K8 also beside torch.add(1, x, alpha=2)), the
     [5c] frames beside the steady frame;
     the coverage work recounted: the (edge, row) pairs live in this run's
     pools (h > 0, the masks K1 and K3 walk) beside the dense count, both
     bounds of K1 and K3-K6 (the kernels line's bound_ms is the live one),
     K1's, K3's, K4's, K5's, K6's and K7's ptxas registers and spills (K5,
     K6 and K7 per kernel), K7's valid (tile, slot) share and skipped
     (warp, slot) share on the [5c] buckets, K4's launches per shard, the
     coverage kernels' device ms and the launches per steady frame; K5's
     and K6's device ms per [5c] frame, their live share and both bounds;
     the launch route (utils/launch_route.py): host us per call of K8's
     wrapper and of torch.add over 2,000 back-to-back calls and of each
     step of the route (launch_route.ROUTE_STEPS), the steady ss=1
     frame's host ms from call to return, and torch.profiler's CPU trace
     of 5 steady frames
     (ss=1, ss=2 and the layer frame), which must hold no host-side wait
     (a stream or device synchronise, a synchronous cudaMemcpy, a scalar
     read back); the pan scenes of [10b]: measure_pan_ms_per_frame, the
     device's busy share, launches and K1's and K2's device ms per pan
     frame, one render's host ms from call to return, the bake's host ms,
     and the CPU trace of 5 pan frames (no host-side wait); the textures
     stage of [10a].
     Phase 6 runs after phases 7, 8, 10a, 10b and 11, whose contexts it
     times.
  9. Cold start (vgtpu_torch.utils.cold_probe): torch's context and first
     cuBLAS call, K8's load and first launch, and the first 1080p frame,
     each in a fresh process with jax blocked, after phase 2 has built the
     kernels.

The last two lines are the kernels' JSON record (K1, K2's forms (a)-(e),
K3-K8: launches on the main paths, error against the twin, times, and the
bound from this run's shapes; K2's pipeline depth and shared bytes; K1's
and K2's launches include the pan's) and the contract line
{"ok": true, "device": {...}}.  Imports neither jax nor vgtpu.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
BG = (1.0, 1.0, 1.0, 1.0)
BG_APP = (0.12, 0.12, 0.13, 1.0)   # bench.py's background for the serving paths
K_REP = 3                          # phase 4c's variant blocks
K_BATCH = 6                        # bench.py batch_diag's K
# the random chunks' depths: the shallow form's (up to 64) and two deeper
# than one edge window (coverage_cuda.EDGE_WINDOW), 2,048 over the 1,808
# edges a shallow K1 block held and 8,192 over K4's 6,980; the deep ones
# with fewer chunks (their twins loop over the edges)
CH_RANDOM = (2, 4, 6, 8, 24, 40, 64, 2048, 8192)
NC_DEEP = {2048: 512, 8192: 128}
CH_DEEP = 2048                     # [4h]'s chunk_pools=(2, 8, CH_DEEP)
# the card's peaks for the bound (H100 SXM at 700 W): FP32 outside the
# tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# K1 vs its twin: the same roundings in the same order (explicit FMAs on
# both sides, -fmad=false), so they agree to a few ulps; the bound allows a
# one-ulp flip in u (|u| <= ~160 here, ulp 1.5e-5) amplified by the
# G-form's 1/m (<= 100) on near-vertical edges.
K1_BOUND = 2e-3
# K2 vs its twin: the same roundings; a one-ulp flip in a linear gradient's
# paint-space coordinate (~1e5, ulp 7.8e-3) moves the colour by ~3e-5.
K2_BOUND = 1e-4
# K3 vs its twin: K1's winding (the same roundings) then the resolve
# epilogue, whose min/abs/floor/compare steps have slope <= 1 — K1's bound
# carries over.  The non-AA threshold could turn a one-ulp flip at 0.5 into
# a full sub-pixel, but kernel and twin round identically (K1 measured 0.0).
K3_BOUND = 2e-3
U8_BOUND = 1          # images: at most 1 u8 level after image_to_u8
# [11]'s pan-layer pieces vs their twins, both folded in one fixed order
# (deterministic_fold): the same roundings, so 0.0 is expected.  With CUDA's
# atomic fold they read 1.8e-7 to 2.4e-7 on an H100 and could flip one u8
# level; 2e-6 is about 8 times that reading.
PIECES_BOUND = 2e-6
# [11] bench.py's cached-list app: 8 warm pan-layer frames (cache build,
# first cached replay, the moved replay that asks for the bake, the bake,
# then the static-UI overlay settling), then these layer counters, which
# vgtpu's run of the same frames gives on the CPU
# (tests/test_torch_pan_app.py holds both packages to them)
PAN_APP_WARM = 8
PAN_APP_COUNTS = {"layer_cl_hits": 5, "layer_cl_bakes": 1, "layer_bakes": 1}


@contextlib.contextmanager
def deterministic_fold():
    """torch's deterministic algorithms inside the block: CUDA's index_add_
    (the chunk -> entry fold) then sums in a fixed order instead of with
    atomics, so two routes that fold equal coverage give equal sums.  Memory
    torch leaves uninitialised stays so, as outside the block."""
    import torch
    import torch.utils.deterministic as det

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        det.fill_uninitialized_memory = was[2]


def u8_levels(a, b) -> int:
    """Largest per-channel difference after image_to_u8."""
    from vgtpu_torch.raster.frame import image_to_u8

    return int(np.abs(image_to_u8(a).astype(np.int16)
                      - image_to_u8(b).astype(np.int16)).max())


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the HBM rate and the operations over the FP32 peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_work(buckets, npx_out: int, ss: int, scratch: int,
            init: bool = False) -> tuple:
    """K2's least (bytes, operations) over buckets of (cov, pteb, params,
    ct_flat, ctile, ids, rbd), counting the real tiles only (the pad tiles,
    ids == scratch, write the framebuffer's scratch row, which nothing
    reads): each coverage row, colour tile and params plane read once, each
    tile written once (and read once more from an init plane); ~20
    operations per valid slot and sub-pixel (rule, AA, shade, blend; form
    (e) reads final coverage, one sample per pixel)."""
    from vgtpu_torch.ops.composite import _P_VALID

    nbytes = ops = 0
    for cov, pteb, pp, ct_flat, ctile, ids, rbd in buckets:
        real = ids < scratch
        n_real = int(real.sum())
        pteb_r = pteb[real[:pteb.shape[0]]]     # form (c): one variant block
        pp_r = pp[:, :, real]
        nbytes += int(pteb_r.unique().numel()) * cov.shape[1] * 4
        nbytes += (pp_r.numel() + pteb_r.numel() + n_real) * 4
        if ctile is not None:
            nbytes += int(ctile[real].unique().numel()) * ct_flat.shape[1] * 4
        if rbd is not None:
            nbytes += rbd[:, :, real].numel() * 4
        nbytes += n_real * npx_out * 16 * (2 if init else 1)
        valid = int((pp_r[:, _P_VALID, :] > 0).sum())
        ops += valid * npx_out * (1 if rbd is not None else ss) * 20
    return nbytes, ops


def k7_work(buckets, npx: int, scratch: int) -> tuple:
    """K7's least (bytes, operations) over buckets of (ew_t, params, ct_t,
    ids), counting the real tiles only (ids < scratch), as k2_work: of the
    dense ew_t and colour tiles the valid slots' values (invalid slots
    composite nothing), the params columns, the background column, each
    tile written once; ~20 operations per valid slot and pixel."""
    from vgtpu_torch.ops.composite import _P_VALID

    nbytes = 4 * npx * 4
    ops = 0
    for _ew, pp, ct, ids in buckets:
        real = ids < scratch
        pp_r = pp[:, :, real]
        valid = int((pp_r[:, _P_VALID, :] > 0).sum())
        nbytes += (valid * npx * (5 if ct is not None else 1) + pp_r.numel()
                   + int(real.sum()) * 4 * npx) * 4
        ops += valid * npx * 20
    return nbytes, ops


def k7_settings(rng, ew_cov, ew_ent, pp, ct_t, bg_col) -> list:
    """K7's four settings on one bucket, as (name, ew_t, params, ct_t, bg,
    add_backdrop, k_rep): chunk coverage gathered by pteb (ew_cov) with the
    backdrop rows added in the kernel; entry winding gathered by the
    bucket's entry table (ew_ent, vgtpu's composite_bucketed_pallas_body);
    the same from a random init plane; and K_REP paint variants over one
    block of ew_t (the entry point, as vgtpu, takes k_rep only where
    Nb % 128 == 0; the kernel takes any Nb)."""
    import torch
    from vgtpu_torch.ops.composite import _P_PAINT

    dev = pp.device
    mo, _npp, nb = pp.shape
    plane = torch.from_numpy(
        rng.uniform(0, 1, (bg_col.shape[0], nb)).astype(np.float32)).to(dev)
    blocks = [pp]
    for _v in range(1, K_REP):
        q = pp.clone()
        q[:, _P_PAINT + 10 : _P_PAINT + 18] *= torch.from_numpy(
            rng.uniform(0.3, 1.0, (mo, 8, nb)).astype(np.float32)).to(dev)
        blocks.append(q)
    ct3 = None if ct_t is None else torch.cat([ct_t * 0.5 ** v for v in range(K_REP)],
                                              dim=2)
    return [("add_backdrop", ew_cov, pp, ct_t, bg_col, True, 1),
            ("entry_w", ew_ent, pp, ct_t, bg_col, False, 1),
            ("init plane", ew_ent, pp, ct_t, plane, False, 1),
            (f"k_rep={K_REP}", ew_ent, torch.cat(blocks, dim=2), ct3, bg_col, False,
             K_REP)]


def check_k7(label: str, flags, settings, sms: int, tally: dict) -> float:
    """Each setting (k7_settings) of one bucket through K7's entry point and
    its twin composite_bucket_torch at 8x128 tiles; raises past K2_BOUND.
    tally["runs"] counts the settings by name; tally["forms"] gathers the
    (G, pixels a thread) instantiations launched (k7_geometry on the card's
    `sms` SMs: the kernel's own choice of the wide or narrow form).
    Returns the largest difference."""
    import torch
    from vgtpu_torch.ops import composite_flat_cuda as k7
    from vgtpu_torch.ops.composite import composite_bucket_torch

    g = k7.k7_instantiation(flags)[0]
    worst = 0.0
    for name, ew, pp, ct, bg, ab, kr in settings:
        got = k7.composite_bucket_flat_cuda(ew, pp, ct, bg, tile_w=128, flags=flags,
                                            add_backdrop=ab, k_rep=kr)
        ref = composite_bucket_torch(ew, pp, ct, bg, tile_w=128, flags=flags,
                                     add_backdrop=ab, k_rep=kr)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        tally["runs"][name] = tally["runs"].get(name, 0) + 1
        mo, npx, _nb = (int(n) for n in ew.shape)
        tally["forms"].add((g, k7.k7_geometry(mo, npx, 128, int(pp.shape[2]), ab, g,
                                              sms)["pixels_per_thread"]))
        if not err <= K2_BOUND:
            raise AssertionError(f"K7 ({name}) disagrees on {label}, flags {flags}: {err}")
    return worst


def k7_sweep_buckets(pool, sms: int) -> list:
    """Buckets that drive every K7 instantiation in both block forms.  For
    each template mask G in 0..15: the tiles of every bucket in `pool`
    whose template lanes G holds (G's lanes are a superset of each tile's,
    as a real bucket's flags are of its tiles'), with the OR of their
    runtime lanes, slots padded to the deepest with invalid ones, and the
    tiles repeated to a grid of fewer blocks than the card's `sms` SMs
    (the narrow form) and to one of more (the wide form).  pool: (ew_cov,
    ew_ent, params, ct_t or None, flags) of real buckets of 8x128 tiles.
    Returns (label, flags, ew_cov, ew_ent, params, ct_t) per (G, form)."""
    import torch
    from vgtpu_torch.ops import composite_flat_cuda as k7

    npx = int(pool[0][1].shape[1])
    grid_y = -(-npx // k7.GROUP)
    sizes = {"narrow": k7.TILES * max(1, (sms - 1) // grid_y),
             "wide": k7.TILES * (sms // grid_y + 1)}
    out = []
    for g in range(1 << k7.TEMPLATE_LANES):
        members = [e for e in pool if k7.k7_instantiation(e[4])[0] & ~g == 0]
        rt = 0
        for e in members:
            rt |= k7.k7_instantiation(e[4])[1]
        bits = g | rt
        flags = tuple(bool(bits >> i & 1) for i in range(7))
        mo = max(int(e[2].shape[0]) for e in members)

        def cat(parts):
            padded = []
            for t in parts:
                z = t.new_zeros((mo, *t.shape[1:]))
                z[: t.shape[0]] = t
                padded.append(z)
            return torch.cat(padded, dim=2)

        ew_cov = cat([e[0] for e in members])
        ew_ent = cat([e[1] for e in members])
        pp = cat([e[2] for e in members])
        ct = cat([e[3] if e[3] is not None else
                  e[2].new_zeros((e[2].shape[0], 4 * npx, e[2].shape[2]))
                  for e in members])
        for form, nb in sizes.items():
            idx = torch.arange(nb, device=pp.device) % pp.shape[2]
            out.append((f"G={g} {form} ({nb} tiles of {len(members)} buckets, MO {mo})",
                        flags, ew_cov[:, :, idx].contiguous(),
                        ew_ent[:, :, idx].contiguous(), pp[:, :, idx].contiguous(),
                        ct[:, :, idx].contiguous() if flags[2] else None))
    return out


# [10b]: the retained scene's bounds (beyond the 1080p view, so views pan
# over content) and its views: integer, negative, fractional x, and one
# partly off the scene
PAN_SCENE = (2560, 1440)
PAN_VIEWS = ((0, 0), (37, 5), (-45, -13), (128.5, 8), (1200, 900))
# [10a] colour tiles, the device sampler against the same sampler on the
# CPU: the same float32 roundings (explicit FMAs in both), the products'
# accumulation order apart
CT_BOUND = 2e-5
# ... and against the numpy sampler, which computes texel coordinates in
# float64: the device sampler's float32 u = m0*x + m4 cancels two terms
# near 15-20 (x up to 1,900 px over a 96-px pattern), each within half an
# ulp (9.5e-7), times the 64-texel width: ~1.2e-4 texel per axis, which the
# bilinear weights turn into up to that much colour per unit texel step
# (the random panels step by up to 1) on each axis
CT_NUMPY_BOUND = 5e-4


def textured_frame(c, images) -> None:
    """[10a]'s frame: the tiger and demo UI plus the pattern panels."""
    from vgtpu_torch.scenes import demo_ui
    from vgtpu_torch.scenes.small import draw_pattern_panels

    demo_ui.draw_benchmark_frame(c, 0.0)
    draw_pattern_panels(c, images)


def hold_pan_buckets(scene, view, label: str, flags_held: set) -> float:
    """K2 against its twin on every bucket of a retained scene at one view,
    on the pan's own inputs (shifted coverage, patched params, resampled
    colour tiles); adds each bucket's lane flags to flags_held and returns
    the largest difference (raises past K2_BOUND)."""
    import torch
    from vgtpu_torch.ops.composite import background_tensor, composite_bucket_into_torch
    from vgtpu_torch.ops.composite_cuda import composite_bucket_cuda

    _vx, _vy, rx, ry = scene._offsets(*view)
    cov, ct_flat = scene._pan_inputs(rx, ry)
    d, plan = scene.d, scene.plan
    nt = plan.ntx * plan.nty
    bg = background_tensor(scene.background, cov.device)
    shape = (nt + 1, scene.tile_h // scene.ss, scene.tile_w, 4)
    fa = bg.expand(*shape).clone()
    fb = fa.clone()
    worst = 0.0
    for ids, pteb, pp, ctile, fl in zip(d["bucket_ids"], d["bucket_pteb"],
                                        d["bucket_params"], d["bucket_ctile"],
                                        d["bucket_flags"]):
        kw = dict(tile_w=scene.tile_w, flags=fl, ss=scene.ss)
        composite_bucket_cuda(fa, cov, pteb, pp, ct_flat, ctile, ids, scene.background, **kw)
        composite_bucket_into_torch(fb, cov, pteb, pp, ct_flat, ctile, ids,
                                    scene.background, **kw)
        err = float((fa[ids.long()] - fb[ids.long()]).abs().max())
        worst = max(worst, err)
        flags_held.add((scene.ss, fl))
        if not err <= K2_BOUND:
            raise AssertionError(f"[10b] K2 disagrees with its twin on a {label} bucket "
                                 f"at {view}, flags {fl}: {err}")
    return worst


def phase_10a(vg, card, zero_counts, read_counts, check_path) -> dict:
    """[10a] device texture sampling on the card: the textured 1080p frame
    through end() with device_sampling on, against device_sampling=False
    (the numpy sampler) and, for the colour tiles, against the same sampler
    on the CPU; the textures stage's times, the colour-tile memo and the
    steady frame's host waits."""
    import torch
    from vgtpu_torch.ops.sampling_device import (
        build_sampling_plan,
        sample_color_tiles_device,
    )
    from vgtpu_torch.raster.sampling import fill_color_tiles
    from vgtpu_torch.scenes import demo_ui
    from vgtpu_torch.scenes.small import draw_pattern_panels, make_pattern_images

    ctxs, imgs, stage_ms, plans = {}, {}, {}, {}
    counts = None
    for ds in (False, True):
        c = vg.createContext(vg.ContextConfig(device_sampling=ds, frame_memo=False),
                             device="cuda")
        images = make_pattern_images(c)
        vg.begin(c, 0, 1920, 1080, 1.0)
        textured_frame(c, images)
        if ds:
            zero_counts()
        imgs[ds] = vg.end(c, background=BG_APP)
        if ds:
            counts = read_counts()
        plans[ds] = c.last_plan
        t_first = c.profiler.times_ms["textures"]
        vg.begin(c, 0, 1920, 1080, 1.0)        # the same frame again: a memo hit
        textured_frame(c, images)
        again = vg.end(c, background=BG_APP)
        t_again = c.profiler.times_ms["textures"]
        # the panels 3 px lower: every colour tile sampled anew, past the
        # first frame's one-time costs (texture upload, library handles)
        vg.begin(c, 0, 1920, 1080, 1.0)
        demo_ui.draw_benchmark_frame(c, 0.0)
        draw_pattern_panels(c, images, y0=43.0)
        vg.end(c, background=BG_APP)
        stage_ms[ds] = (t_first, t_again - t_first,
                        c.profiler.times_ms["textures"] - t_again)
        ctxs[ds] = (c, images, again)
    cd, images_d, again_d = ctxs[True]
    ch = ctxs[False][0]
    # the first frame's plans (the third frame moved the panels)
    ct_d, ct_h = plans[True].color_tiles, plans[False].color_tiles
    if not (isinstance(ct_d, torch.Tensor) and ct_d.is_cuda and isinstance(ct_h, np.ndarray)):
        raise AssertionError(f"[10a] colour tiles: {type(ct_d)}, {type(ct_h)}")
    if not np.array_equal(plans[True].entry_color_tile, plans[False].entry_color_tile):
        raise AssertionError("[10a] the two samplers assigned other colour-tile ids")
    hits = cd.profiler.counters.get("ct_memo_hits", 0)
    print(f"[10a] textured 1080p frame: {ct_d.shape[0]} colour tiles; ct_memo_hits "
          f"{hits} after the frame rendered again and once with the panels moved "
          f"(frame_memo off)")
    if hits != 1:
        raise AssertionError(f"[10a] {hits} colour-tile memo hits, not 1")
    image_map = {i: (im.data, im.flags, im.generation) for i, im in cd.images.items()}
    vg.begin(cd, 0, 1920, 1080, 1.0)      # the first frame's ops again
    textured_frame(cd, images_d)
    cd._finalize_ops()
    sp = build_sampling_plan(plans[True], cd.ops, image_map)
    tex = cd._device_textures(image_map, {g.image_id for g in sp.groups})
    ct_cpu = sample_color_tiles_device(sp, {k: v.cpu() for k, v in tex.items()}, 8, 128)
    err_cpu = float((ct_d.cpu() - ct_cpu).abs().max())
    err_np = float(np.abs(ct_d.cpu().numpy() - ct_h).max())
    groups = [(g.kind, g.separable, g.flags, len(g.ct)) for g in sp.groups]
    print(f"[10a] sampling groups (kind, separable, flags, K): {groups}")
    print(f"[10a] colour tiles: max|card - the same sampler on the CPU| = {err_cpu:.3e} "
          f"(bound {CT_BOUND:.0e}); max|card - numpy sampler| = {err_np:.3e} (bound "
          f"{CT_NUMPY_BOUND:.0e}, float32 texel coordinates)")
    if not (err_cpu <= CT_BOUND and err_np <= CT_NUMPY_BOUND):
        raise AssertionError(f"[10a] colour tiles off: {err_cpu}, {err_np}")
    check_path("sampled frame", counts, ("K1", "K2", "K2 (a)"),
               [(imgs[True], imgs[False]), (again_d, imgs[True])], tag="[10a]")

    # the sampler alone: CUDA events around one run (its one upload of the
    # group params included), the numpy sampler on the host clock
    ms_dev = time_ms(lambda: sample_color_tiles_device(sp, tex, 8, 128))
    plan_h = ch.last_plan
    t_np = []
    for _ in range(3):
        t0 = time.perf_counter()
        fill_color_tiles(plan_h, ch.ops, {i: (im.data, im.flags, im.generation)
                                          for i, im in ch.images.items()})
        t_np.append((time.perf_counter() - t0) * 1e3)
    for ds, name in ((False, "numpy sampler (device_sampling=False)"),
                     (True, "device sampler (device_sampling=True)")):
        print(f"[10a] textures stage, {name}: {stage_ms[ds][0]:.3f} ms host on the first "
              f"frame, {stage_ms[ds][1]:.3f} on the same frame again (its memo), "
              f"{stage_ms[ds][2]:.3f} with the panels moved (host clock; {card})")
    print(f"[10a] sampler alone: device {ms_dev:.4f} ms (CUDA events, median of 12); "
          f"numpy, no tile cache {statistics.median(t_np):.3f} ms host (median of 3; "
          f"{card})")

    # the steady textured frame (a frame-memo hit) holds no host-side wait
    cm = vg.createContext(device="cuda")
    images_m = make_pattern_images(cm)

    def steady():
        vg.begin(cm, 0, 1920, 1080, 1.0)
        textured_frame(cm, images_m)
        return vg.end(cm, background=BG_APP)

    waits = host_waits(steady)
    print(f"[10a] steady textured frame, CPU trace of 5 frames: host-side waits "
          f"{waits['waits']}; {waits['launch_events'] / 5:g} kernel launches per frame")
    if waits["waits"]:
        raise AssertionError(f"[10a] the steady textured frame waits on the host: {waits}")
    return {"stage_ms": stage_ms, "sampler_ms": ms_dev,
            "numpy_ms": statistics.median(t_np), "ct_err": (err_cpu, err_np)}


def phase_10b(vg, card, zero_counts, read_counts, check_path) -> dict:
    """[10b] the retained pan at full width: the 1080p tiger + demo UI baked
    over PAN_SCENE at ss = 1 and 2 and the [10a] textured frame at ss=1,
    each view through render() (K1 + the fold, K2 (a) or (d) on every
    bucket) against the same body through the plain twins on the card and
    against a direct end() of the translated frame; render_views,
    update_paint_values, chunk_pools=(2, 8, 48), and K2 against its twin on
    every bucket of the ss=2 scene and of the small resolve scene at ss = 2
    and 4.  Returns the scenes [6] times and the bake host ms."""
    import torch
    from vgtpu_torch.raster.retained import RetainedScene
    from vgtpu_torch.scenes import demo_ui
    from vgtpu_torch.scenes.small import (
        HEIGHT,
        WIDTH,
        draw_resolve_scene,
        make_pattern_images,
    )

    def bench(c, _st):
        demo_ui.draw_benchmark_frame(c, 0.0)

    def overlay(k):
        def draw(c, _st):
            demo_ui.draw_benchmark_frame(c, 0.0)
            vg.beginPath(c)
            vg.rect(c, 1800, 1000, 60, 40)
            vg.fillPath(c, vg.color4ub(50 + 17 * k, 120, 200, 180), vg.FillFlags.ConvexAA)
        return draw

    def context(ss, setup, **cfg):
        c = vg.createContext(vg.ContextConfig(coverage_supersample=ss, **cfg),
                             device="cuda")
        return c, (setup(c) if setup else None)

    def bake(ss, draw, setup=None, size=PAN_SCENE, w=1920, h=1080, **cfg):
        c, st = context(ss, setup, **cfg)
        vg.begin(c, 0, w, h, 1.0)
        draw(c, st)
        t0 = time.perf_counter()
        s = RetainedScene.bake(c, *size, background=BG_APP)
        torch.cuda.synchronize()
        return s, (time.perf_counter() - t0) * 1e3, c, st

    def direct(view, ss, draw, setup=None, **cfg):
        c, st = context(ss, setup, **cfg)
        vg.begin(c, 0, 1920, 1080, 1.0)
        vg.pushState(c)
        vg.transformTranslate(c, -view[0], -view[1])
        draw(c, st)
        vg.popState(c)
        return vg.end(c, background=BG_APP)

    def textured(c, images):
        textured_frame(c, images)

    cases = (("ss=1", 1, bench, None, "K2 (a)"), ("ss=2", 2, bench, None, "K2 (d)"),
             ("textured ss=1", 1, textured, make_pattern_images, "K2 (a)"))
    scenes, bake_ms = {}, {}
    for label, ss, draw, setup, form in cases:
        t_case = time.perf_counter()
        s, bake_ms[label], _c, _st = bake(ss, draw, setup)
        p = s.plan
        print(f"[10b] pan {label}: baked {p.ntx}x{p.nty} tiles over {PAN_SCENE} in "
              f"{bake_ms[label]:.1f} ms host; pools "
              f"{[tuple(ce.shape[:2]) for ce, _ in p.chunk_pools]}; "
              f"{len(s.d['bucket_flags'])} buckets; sampling groups "
              f"{len(s.samp_meta or ())} ({s.samp_nct} colour tiles)")
        zero_counts()
        imgs = [s.render(*v) for v in PAN_VIEWS]
        counts = read_counts()
        twins = [s.render(*v, use_pallas=False) for v in PAN_VIEWS]
        err = max(float((a - b).abs().max()) for a, b in zip(imgs, twins))
        lv = max(u8_levels(a, b) for a, b in zip(imgs, twins))
        print(f"[10b] pan {label}: {len(PAN_VIEWS)} views {PAN_VIEWS}, max|render - "
              f"plain twins| = {err:.3e} (bound {K2_BOUND:.0e}), {lv} u8 levels")
        if not err <= K2_BOUND:
            raise AssertionError(f"[10b] pan {label} is {err} from its plain twins")
        if form == "K2 (d)" and counts["K2 (a)"]:
            raise AssertionError(f"[10b] pan {label} took form (a): {counts}")
        check_path(f"pan {label}", counts, ("K1", "K2", form),
                   [(a, direct(v, ss, draw, setup)) for a, v in zip(imgs, PAN_VIEWS)],
                   tag="[10b]")
        scenes[label] = s
        print(f"[10b] pan {label} checked in {time.perf_counter() - t_case:.1f} s "
              f"(host clock)")

    # render_views against the per-view renders
    s1 = scenes["ss=1"]
    views = PAN_VIEWS[1:4]
    zero_counts()
    stack = s1.render_views(views)
    counts = read_counts()
    check_path("render_views ss=1", counts, ("K1", "K2", "K2 (a)"),
               [(stack[k], s1.render(*v)) for k, v in enumerate(views)], tag="[10b]")
    # update_paint_values against a fresh bake of the new values
    sa, _ms, ca, _st = bake(1, overlay(0))
    vg.begin(ca, 0, 1920, 1080, 1.0)
    overlay(3)(ca, None)
    sa.update_paint_values(ca)
    sb = bake(1, overlay(3))[0]
    zero_counts()
    got = [sa.render(*v) for v in views]
    counts = read_counts()
    check_path("update_paint_values", counts, ("K1", "K2", "K2 (a)"),
               [(g, sb.render(*v)) for g, v in zip(got, views)], tag="[10b]")
    # chunks over 32 edges: the bake's ladder from ContextConfig.chunk_pools
    s48 = bake(1, bench, chunk_pools=(2, 8, 48))[0]
    view = (37, 5)
    zero_counts()
    img48 = s48.render(*view)
    counts = read_counts()
    err48 = float((img48 - s48.render(*view, use_pallas=False)).abs().max())
    print(f"[10b] chunk_pools=(2, 8, 48): pools "
          f"{[tuple(ce.shape[:2]) for ce, _ in s48.plan.chunk_pools]}; max|render - "
          f"plain twins| = {err48:.3e}")
    if not err48 <= K2_BOUND:
        raise AssertionError(f"[10b] chunk_pools=(2, 8, 48) pan is {err48} from the twins")
    check_path("pan chunk_pools=(2, 8, 48)", counts, ("K1", "K2", "K2 (a)"),
               [(img48, direct(view, 1, bench, chunk_pools=(2, 8, 48)))], tag="[10b]")
    # K2 on every bucket: the ss=2 scene and the small resolve scene at
    # ss = 2 and 4 (image pattern, gradient, triangles, clip, scissor, both
    # rules, non-AA) take form (d) on every bucket
    flags_held = set()
    worst = hold_pan_buckets(scenes["ss=2"], (37, 5), "1080p ss=2", flags_held)
    for ss in (2, 4):
        sr = bake(ss, lambda c, _st: draw_resolve_scene(c), w=WIDTH, h=HEIGHT,
                  size=(WIDTH, HEIGHT))[0]
        for view in ((37.5, 5), (-45, -13)):
            worst = max(worst, hold_pan_buckets(sr, view, f"resolve scene ss={ss}",
                                                flags_held))
    print(f"[10b] K2 (d) against its twin on every bucket of the pan scenes: "
          f"max|K2 - plain| = {worst:.3e} (bound {K2_BOUND:.0e}); (ss, flags "
          f"(grad, tri, tex, clip, eo, noaa, scissor)) held: {sorted(flags_held)}")
    lanes = {i for _ss, fl in flags_held for i, f in enumerate(fl) if f}
    if lanes != set(range(7)) or {ss for ss, _fl in flags_held} != {2, 4}:
        raise AssertionError(f"[10b] the pan buckets left lanes out: {sorted(flags_held)}")
    return {"scenes": scenes, "bake_ms": bake_ms}


def tiger_list(vg, ctx, draw_tiger):
    """bench.py's app artwork: the tiger recorded in a Cacheable command
    list (draw_tiger(ctx, 20, 60, 1.06))."""
    cl = vg.createCommandList(ctx, vg.CommandListFlags.Cacheable)
    vg.beginCommandList(ctx, cl)
    draw_tiger(ctx, 20, 60, 1.06)
    vg.endCommandList(ctx)
    return cl


def app_frame_cl(vg, ctx, cl, draw_ui, k, dpr=1.0, end=True):
    """bench.py's app frame k (:311-325): the list submitted at a fixed
    transform (the op-list memo and the incremental rebin), the demo UI
    (draw_ui, scenes.demo_ui.draw_demo_ui) drawn over it.  end=False
    records the frame and leaves end() to the caller."""
    vg.begin(ctx, 0, 1920, 1080, dpr)
    vg.submitCommandList(ctx, cl)
    draw_ui(ctx, 0.3 + 0.05 * k)
    return vg.end(ctx, background=BG_APP) if end else None


def pan_app_frame(vg, ctx, cl, draw_ui, k, dpr=1.0, end=True):
    """bench.py's pan_diag frame k (:362-389): the list under
    transformTranslate(2.5 k, 2 k) (a translated cached-list layer once it
    moves), the demo UI over it cycling over 0.3 + 0.05 (k mod 4)."""
    vg.begin(ctx, 0, 1920, 1080, dpr)
    vg.pushState(ctx)
    vg.transformTranslate(ctx, 2.5 * k, 2 * k)
    vg.submitCommandList(ctx, cl)
    vg.popState(ctx)
    draw_ui(ctx, 0.3 + 0.05 * (k % 4))
    return vg.end(ctx, background=BG_APP) if end else None


def phase_11(vg, card, zero_counts, read_counts, check_path) -> dict:
    """[11] bench.py's cached-list app at full width (1920x1080 at dpr 1):
    the tiger in a Cacheable command list with the demo UI over it.

    The app frame (the list at a fixed transform: op-list memo, layer memo)
    is held to the same ops ended on the full path (frame_memo=False), the
    pan-layer frame (the
    list under a moving translation: the translated cached-list layer with
    the static UI as a transparent overlay) after PAN_APP_WARM frames to
    PAN_APP_COUNTS and, at four offsets (two fractional in x), to a context
    with layer_memo=False, each within U8_BOUND, at ss = 1 and 2.  One
    pan-layer frame's pieces are held to their twins: the pan tiles to
    render_tiles(use_pallas=False), the frame to execute_plan_torch over the
    twin tiles blended with the overlay, both routes folded in one fixed
    order (deterministic_fold), within PIECES_BOUND and 0 u8 levels.  For
    each setting:
    end()'s host ms (median of 5), the steady frame's dispatch (what end()
    runs on the resident plan) in ms with CUDA events, its device busy share
    and launches (torch.profiler, 10 frames), and its host-side waits, which
    must be none; a whole frame's waits (the upload included) are printed."""
    import torch

    from vgtpu_torch.raster.frame import execute_plan_torch
    from vgtpu_torch.raster.retained import PendingPanLayer, _blend_over_tiles
    from vgtpu_torch.scenes.demo_ui import draw_demo_ui
    from vgtpu_torch.scenes.tiger import draw_tiger

    def app(c, cl, k, end=True):
        return app_frame_cl(vg, c, cl, draw_demo_ui, k, end=end)

    def pan(c, cl, k, end=True):
        return pan_app_frame(vg, c, cl, draw_demo_ui, k, end=end)

    out = {}

    def end_ms(c, record):
        """Host ms of vg.end() alone, median of 5 frames record(i)."""
        ts = []
        for i in range(5):
            record(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vg.end(c, background=BG_APP)
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    def times(tag, c, record):
        """The setting's numbers; c holds a steady frame's resident plan."""
        ms_end = end_ms(c, record)
        frame = [0]

        def whole():                  # frames 5, 6, ... after end_ms's 0-4
            frame[0] += 1
            record(4 + frame[0])
            vg.end(c, background=BG_APP)

        dispatch = lambda: c._maybe_dispatch(c.profiler, True)   # noqa: E731
        zero_counts()
        dispatch()
        per_frame = read_counts()
        ms = time_ms(dispatch)
        by, calls, busy, window = device_breakdown(dispatch)
        waits = host_waits(dispatch)
        whole_waits = host_waits(whole)
        r = {"end_ms": ms_end, "frame_ms": ms, "busy_ms": busy, "device_ms": by,
             "window_ms": window, "device_events": sum(calls.values()),
             "launch_events": waits["launch_events"] / 5,
             "kernels": {k: v for k, v in per_frame.items() if v},
             "waits": waits["waits"], "whole_frame_waits": whole_waits["waits"]}
        print(f"[11] {tag}: end() {ms_end:.3f} ms host (median of 5); steady frame "
              f"{ms:.4f} ms (CUDA events, median of 12); device busy {busy:.4f} of "
              f"{window:.4f} ms ({100 * busy / window:.1f}% busy; torch.profiler, 10 "
              f"frames); {r['launch_events']:g} kernel launches and "
              f"{r['device_events']:g} device events per frame, ours {r['kernels']}; "
              f"host-side waits {waits['waits']} (a whole frame, upload included: "
              f"{whole_waits['waits']}); {card}")
        print(f"[11]    device ms per frame: " + ", ".join(
            f"{key} {v:.4f}" for key, v in sorted(by.items(), key=lambda kv: -kv[1])
        )[:600])
        if waits["waits"]:
            raise AssertionError(f"[11] the steady {tag} frame waits on the host: "
                                 f"{waits}")
        out[tag] = r

    for ss in (1, 2):
        cfg = vg.ContextConfig(coverage_supersample=ss)
        # -- the app frame: bench.py's app pattern
        c = vg.createContext(cfg, device="cuda")
        cl = tiger_list(vg, c, draw_tiger)
        for k in range(6):            # cache build, memo capture, layer bake
            app(c, cl, k)
        # the reference ends the same ops on the full path (frame_memo=False:
        # no frame, paint or layer memo); the same list, since a draw
        # recorded in a list never merges with its neighbours, which changes
        # overlapping translucent fills (vgtpu's semantics too)
        ref = vg.createContext(vg.ContextConfig(coverage_supersample=ss,
                                                frame_memo=False), device="cuda")
        ref_cl = tiger_list(vg, ref, draw_tiger)
        zero_counts()
        imgs = [app(c, cl, k) for k in (6, 7)]
        counts = read_counts()
        refs = [app(ref, ref_cl, k) for k in (6, 7)]
        n = c.profiler.counters
        print(f"[11] app ss={ss}: layer_hits {n.get('layer_hits', 0)} layer_bakes "
              f"{n.get('layer_bakes', 0)}, prefix {c._layer_used} of {len(c.ops)} ops")
        check_path(f"cached-list app ss={ss}", counts, ("K1", "K2"),
                   list(zip(imgs, refs)), tag="[11]")
        times(f"app frame ss={ss}",
              c, lambda i: app(c, cl, 6 + i % 2, end=False))
        del c, ref, imgs, refs

        # -- the pan-layer frame: bench.py's pan_diag pattern
        c = vg.createContext(cfg, device="cuda")
        cl = tiger_list(vg, c, draw_tiger)
        for k in range(PAN_APP_WARM):
            pan(c, cl, k)
        n = c.profiler.counters
        got = {k: n.get(k, 0) for k in PAN_APP_COUNTS}
        print(f"[11] pan ss={ss}: after {PAN_APP_WARM} frames {got} (vgtpu's on the "
              f"CPU: {PAN_APP_COUNTS})")
        if got != PAN_APP_COUNTS:
            raise AssertionError(f"[11] pan ss={ss}: {dict(n)}")
        held = (8, 9, 10, 11)          # offsets (20, 16), (22.5, 18), ...
        zero_counts()
        imgs = [pan(c, cl, k) for k in held]
        counts = read_counts()
        lr = c._layer_render
        if not isinstance(lr, PendingPanLayer) or lr.over_tiles is None:
            raise AssertionError(f"[11] pan ss={ss}: the frame's layer is {lr!r}")
        ref = vg.createContext(vg.ContextConfig(coverage_supersample=ss,
                                                layer_memo=False), device="cuda")
        ref_cl = tiger_list(vg, ref, draw_tiger)
        refs = [pan(ref, ref_cl, k) for k in held]
        need = ("K1", "K2", "K2 (b)") + (("K3", "K2 (d)") if ss > 1 else ("K2 (a)",))
        check_path(f"cached-list pan ss={ss}", counts, need, list(zip(imgs, refs)),
                   tag="[11]")
        # the last frame's pieces against their twins on the same inputs,
        # both folded in one fixed order
        sc = lr.scene
        with deterministic_fold():
            t_k = sc.render_tiles(*lr.view, lr.background)
            t_p = sc.render_tiles(*lr.view, lr.background, use_pallas=False)
            f_k = lr.execute_over(c.last_plan, c.last_device_arrays, c.background)
            twin = execute_plan_torch(c.last_plan, BG_APP,
                                      device_arrays=c.last_device_arrays,
                                      init_tiles=_blend_over_tiles(lr.over_tiles, t_p))
        e_t, e_f = float((t_k - t_p).abs().max()), float((f_k - twin).abs().max())
        lv = max(u8_levels(t_k, t_p), u8_levels(f_k, twin))
        print(f"[11] pan ss={ss} pieces vs twins at view {lr.view}, fixed fold order: "
              f"tiles max|diff| {e_t:.3e}, frame max|diff| {e_f:.3e} (bound "
              f"{PIECES_BOUND:.0e}), {lv} u8 levels (bound 0); overlay "
              f"{tuple(lr.over_tiles.shape)}; the frame against end()'s (atomic "
              f"fold) {float((f_k - imgs[-1]).abs().max()):.3e}")
        if not (e_t <= PIECES_BOUND and e_f <= PIECES_BOUND and lv == 0):
            raise AssertionError(f"[11] pan ss={ss} pieces are off their twins")
        times(f"pan-layer frame ss={ss}",
              c, lambda i: pan(c, cl, 12 + i, end=False))
        del c, ref, imgs, refs, f_k, twin
    return out


def phase_11b(card) -> dict:
    """[11b] diff.render_edges on the card against the CPU at 64x64: the
    image and, through loss.backward(), the gradients with respect to the
    shapes' vertices and colours (within 1e-4)."""
    import torch

    from vgtpu_torch.diff import polygon_edges, render_edges

    rng = np.random.default_rng(SEED)
    ang = np.linspace(0.0, 2.0 * np.pi, 7)[:-1]
    shapes = [np.stack([cx + r * np.cos(ang + a), cy + r * np.sin(ang + a)], 1)
              for cx, cy, r, a in ((20, 24, 14, 0.2), (40, 36, 18, 0.9),
                                   (30, 30, 9, 1.7))]
    cols = rng.uniform(0.2, 1.0, (3, 4))
    w = rng.uniform(size=(64, 64, 4))
    res = {}
    for dev in ("cpu", "cuda"):
        pts = [torch.tensor(p, dtype=torch.float32, device=dev, requires_grad=True)
               for p in shapes]
        c = torch.tensor(cols, dtype=torch.float32, device=dev, requires_grad=True)
        ids = torch.repeat_interleave(torch.arange(3, device=dev), 6)
        img = render_edges(torch.cat([polygon_edges(p) for p in pts]), c, ids, 64, 64,
                           background=torch.tensor([0.1, 0.1, 0.1, 1.0], device=dev))
        loss = (img * torch.tensor(w, dtype=torch.float32, device=dev)).sum()
        loss.backward()
        res[dev] = [img.detach().cpu()] + [p.grad.cpu() for p in pts] + [c.grad.cpu()]
    finite = all(bool(torch.isfinite(t).all()) for t in res["cuda"])
    e_img = float((res["cuda"][0] - res["cpu"][0]).abs().max())
    e_grad = max(float((a - b).abs().max()) for a, b in zip(res["cuda"][1:],
                                                           res["cpu"][1:]))
    g_max = max(float(t.abs().max()) for t in res["cpu"][1:])
    print(f"[11b] render_edges 64x64 on the card vs the CPU: image max|diff| "
          f"{e_img:.3e}, gradients max|diff| {e_grad:.3e} (largest {g_max:.3f}, bound "
          f"1e-4), finite {finite} ({card})")
    if not (finite and e_img <= 1e-5 and e_grad <= 1e-4):
        raise AssertionError("[11b] render_edges on the card is off the CPU")
    return {"img_err": e_img, "grad_err": e_grad}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_chunks(rng, nc: int, ch: int) -> np.ndarray:
    """(nc, ch, 4) tile-local edges mixing the hard cases in."""
    e = np.stack([rng.uniform(-20, 148, (nc, ch)), rng.uniform(-4, 12, (nc, ch)),
                  rng.uniform(-20, 148, (nc, ch)), rng.uniform(-4, 12, (nc, ch))],
                 axis=-1)
    kind = rng.integers(0, 8, (nc, ch))
    x0, y0 = e[..., 0], e[..., 1]
    e[..., 3] = np.where(kind == 1, y0, e[..., 3])                       # horizontal
    e[..., 2] = np.where(kind == 2, x0 + rng.uniform(-0.05, 0.05, (nc, ch)), e[..., 2])
    e[..., 3] = np.where(kind == 3, y0 + 5e-7, e[..., 3])                 # |dy| < 1e-6
    e[..., 2:4] = np.where((kind == 4)[..., None], e[..., 0:2], e[..., 2:4])
    e[..., 0] = np.where(kind == 5, -30.0, e[..., 0])                     # left of tile
    e[..., 2] = np.where(kind == 5, -10.0, e[..., 2])
    e[..., 1] = np.where(kind == 6, 11.0, e[..., 1])                      # below it
    e[..., 3] = np.where(kind == 6, 17.0, e[..., 3])
    e[..., :] = np.where((kind == 7)[..., None], 0.0, e)                  # pad edge
    return e.astype(np.float32)


def random_rparams(rng, nc: int, tile_h: int, tile_w: int) -> np.ndarray:
    """(RP_ROWS, nc) resolve params: even-odd, non-AA, texture force,
    scissor rects (half of them the no-scissor sentinel), backdrops."""
    from vgtpu_torch.ops.coverage_resolve import (
        _SC_SENTINEL, RP_BD, RP_EO, RP_NOAA, RP_SC, RP_TEXF, rp_rows)

    rp = np.zeros((rp_rows(tile_h), nc), np.float32)
    rp[RP_EO] = rng.uniform(size=nc) < 0.3
    rp[RP_NOAA] = rng.uniform(size=nc) < 0.3
    rp[RP_TEXF] = rng.uniform(size=nc) < 0.15
    has = rng.uniform(size=nc) < 0.5
    x0, y0 = rng.uniform(-4, tile_w, nc), rng.uniform(-4, tile_h, nc)
    rp[RP_SC + 0] = np.where(has, x0, -_SC_SENTINEL)
    rp[RP_SC + 1] = np.where(has, y0, -_SC_SENTINEL)
    rp[RP_SC + 2] = np.where(has, x0 + rng.uniform(1, tile_w, nc), _SC_SENTINEL)
    rp[RP_SC + 3] = np.where(has, y0 + rng.uniform(1, tile_h, nc), _SC_SENTINEL)
    rp[RP_BD : RP_BD + tile_h] = rng.integers(-2, 3, (tile_h, nc))
    return rp


def time_ms(fn, runs: int = 12, warmup: int = 3) -> float:
    """Median device time of fn() over `runs` calls, CUDA events per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def record_plan(vg, draw, w, h, device, ss=1, split=True):
    """Record a scene through the port's vg:: surface and upload its plan.
    split=False uploads a supersampled plan without the resolve split (the
    fallback where every bucket takes K2's form (d))."""
    from vgtpu_torch.raster.frame import plan_to_device

    ctx = vg.createContext(vg.ContextConfig(coverage_supersample=ss),
                           device=device)
    vg.begin(ctx, 0, w, h, 1.0)
    draw(ctx)
    ctx._finalize_ops()
    from vgtpu_torch.raster.binning import bin_frame

    cfg = ctx.cfg
    plan = bin_frame(ctx.ops, ctx.fb_width, ctx.fb_height, tile_h=cfg.tile_h,
                     tile_w=cfg.tile_w, chunk=cfg.edges_per_chunk,
                     pools=cfg.chunk_pools, supersample=ss,
                     depth_cap=cfg.max_ops_per_tile_cap)
    ctx._fill_textures(plan)
    if not split:
        plan.resolve_host = {}     # marks the split as done and empty
    return ctx, plan, plan_to_device(plan, device)


def device_breakdown(run, frames: int = 10, zero=None):
    """torch.profiler over `frames` calls of run(): device ms per call by
    kernel (K1, K2 forms, K3 entry points, the rest by name), recorded
    device events per call by the same keys, device-busy ms per call, and
    the window from the first device op to the last.  zero() runs just
    before the profiled calls (the caller's launch counts to 0)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(min(frames, 3)):
        run()
    torch.cuda.synchronize()
    # CUPTI now and then hands back a window without its device records
    # (K8's 1-us launches once came back empty): take the window again, at
    # most three times
    for _attempt in range(3):
        if zero is not None:
            zero()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                run()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if ev:
            break
    if not ev:
        raise AssertionError("torch.profiler recorded no device time")
    names = (("coverage_chunks_t_kernel", "K4"), ("coverage_chunks_t_deep", "K4"),
             ("coverage_chunks_kernel", "K1"), ("coverage_chunks_deep", "K1"),
             ("coverage_res_", "K3"),
             ("resolve_rows_kernel", "K3 rows"), ("composite_final_kernel", "K2 (e)"),
             ("composite_bucket_kernel", "K2 (a)/(d)"),
             ("coverage_t_flat_", "K5"), ("coverage_slots_", "K6"),
             ("composite_flat_kernel", "K7"), ("probe_affine_kernel", "K8"))
    by, calls = {}, {}
    for e in ev:
        key = next((k for n, k in names if n in e.name), e.name[:48])
        by[key] = by.get(key, 0.0) + e.device_time / 1e3 / frames
        calls[key] = calls.get(key, 0.0) + 1.0 / frames
    busy = sum(e.device_time for e in ev) / 1e3 / frames
    window = (max(e.time_range.end for e in ev)
              - min(e.time_range.start for e in ev)) / 1e3 / frames
    return by, calls, busy, window


# runtime calls on which the host waits for the card
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "aten::_local_scalar_dense", "aten::item")


def host_waits(run, frames: int = 5) -> dict:
    """torch.profiler's CPU trace of `frames` calls of run() (warmed up,
    no synchronise inside the window): the host-side waits it holds
    (HOST_WAITS: a stream, device or event synchronise, a synchronous
    cudaMemcpy, a scalar read back) before the last kernel launch, and the
    count of every CUDA runtime call by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            run()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    launches = [e.time_range.end for e in ev if "Launch" in e.name]
    last = max(launches) if launches else float("inf")
    waits, runtime = {}, {}
    for e in ev:
        if e.name.startswith("cu"):
            runtime[e.name] = runtime.get(e.name, 0) + 1
        if e.name in HOST_WAITS and e.time_range.start < last:
            waits[e.name] = waits.get(e.name, 0) + 1
    torch.cuda.synchronize()
    return {"waits": waits, "runtime": runtime, "launch_events": len(launches)}


def ptxas_by_kernel(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes)} from ptxas's -v
    report."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)), spill)
    return out


def ptxas_summary(log: str) -> str:
    """Registers per thread and spill stores over a library's kernels."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    if not regs:
        return "no ptxas report"
    spilled = [s for s in spills if s]
    return (f"{len(regs)} kernel(s), {min(regs)}-{max(regs)} registers, "
            f"{len(spilled)} spill ({max(spilled, default=0)} bytes max)")


def main() -> int:
    t_start = time.perf_counter()

    import torch

    # ---- 1. the card ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    try:
        import vgtpu_torch as vg
    except ImportError as e:
        print(f"chip_smoke: run from the root of a vgtpu checkout ({e})",
              file=sys.stderr)
        return 1
    from vgtpu_torch import native
    from vgtpu_torch.ops import (
        composite_cuda,
        composite_flat_cuda,
        coverage_cuda,
        coverage_resolve_cuda,
        coverage_slots_cuda,
        coverage_t_cuda,
        coverage_t_flat_cuda,
        probe_cuda,
    )
    from vgtpu_torch.ops.composite import (
        composite_bucket_into_torch,
        composite_bucket_torch,
        frame_fb,
    )
    from vgtpu_torch.ops.coverage import (
        cov_all_resolved,
        cov_all_resolved_torch,
        cov_all_torch,
        coverage_chunks_t_torch,
        coverage_chunks_torch,
        edge_row_live,
        entry_coverage_from_pools,
        fold_extras,
    )
    from vgtpu_torch.ops.coverage_resolve import (
        cov_split_resolved,
        cov_split_resolved_torch,
        coverage_chunks_res_torch,
        resolve_cov_rows_torch,
    )
    from vgtpu_torch.raster.retained import measure_pan_ms_per_frame
    from vgtpu_torch.raster.batch import (
        VariantBatch,
        _batch_tables,
        _batch_values,
        measure_batch_ms_per_frame,
    )
    from vgtpu_torch.parallel.sharded_fused import (
        render_frame_sharded_fused,
        shard_frame_fused,
    )
    from vgtpu_torch.parallel.sharding import (
        Mesh,
        partition_plan_for_mesh,
        plan_dense_arrays,
        render_frame_sharded,
        shard_frame,
    )
    from vgtpu_torch.raster.frame import (
        execute_plan,
        execute_plan_flat,
        execute_plan_torch,
        image_to_u8,
    )
    from vgtpu_torch.scenes import demo_ui
    from vgtpu_torch.scenes.small import (
        HEIGHT,
        WIDTH,
        draw_deep_chunk_scene,
        draw_deep_tile_scene,
        draw_feature_scene,
        draw_resolve_scene,
        draw_small_scene,
    )
    from vgtpu_torch.utils import cold_probe, launch_route

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")

    # ---- 2. build -------------------------------------------------------
    K1, K2, K3 = coverage_cuda.K1, composite_cuda.K2, coverage_resolve_cuda.K3
    kernels = {"K1": K1, "K2": K2, "K3": K3, "K4": coverage_t_cuda.K4,
               "K5": coverage_t_flat_cuda.K5, "K6": coverage_slots_cuda.K6,
               "K7": composite_flat_cuda.K7, "K8": probe_cuda.K8}
    form_launches = composite_cuda.FORM_LAUNCHES

    def zero_counts():
        """Every kernel's and K2 form's launch count to 0."""
        for k in kernels.values():
            k.launches = 0
        for f in form_launches:
            form_launches[f] = 0

    def read_counts() -> dict:
        torch.cuda.synchronize()
        out = {name: k.launches for name, k in kernels.items()}
        out.update({f"K2 ({f})": n for f, n in form_launches.items()})
        return out
    # one nvcc per source, all started together (nvcc runs outside the GIL)
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        builds = {name: pool.submit(k.build) for name, k in kernels.items()}
    for name, k in kernels.items():
        secs = builds[name].result()
        print(f"[2] built {name} from vgtpu_torch/csrc/{k.name}.cu in "
              f"{secs:.1f} s -> {os.path.relpath(k.path())}; ptxas: "
              f"{ptxas_summary(k.build_log)}")
    print(f"[2] geometry recorder: {'C pathrec' if native.pathrec() else 'pure Python'}; "
          f"binner: {'native' if native.available() else 'numpy'}")

    # the 1080p plan (host) gives phase 3 its pool sizes and phase 4 its buckets
    def draw_frame(ctx):
        demo_ui.draw_benchmark_frame(ctx, 0.0)

    t0 = time.perf_counter()
    _ctx, plan, d = record_plan(vg, draw_frame, 1920, 1080, dev)
    print(f"[2] 1080p plan recorded, binned and uploaded in "
          f"{time.perf_counter() - t0:.2f} s (host clock)")

    # ---- 3. K1 vs plain -------------------------------------------------
    rng = np.random.default_rng(SEED)
    k1_err = 0.0
    rand_edges = []                    # phases 3c-3e hold K4-K6 to the same chunks
    pools_nc = [int(ce.shape[0]) for ce in d["chunk_edges"]]
    twins = {}

    def plain(edges, th, tw, pixel_major=False):
        """The plain twin's coverage of a pool (coverage_chunks_torch, or
        coverage_chunks_t_torch pixel_major), computed once per pool and
        layout for phases 3-3e (a deep pool's twin loops over its edges)."""
        key = (edges.data_ptr(), tuple(edges.shape), th, tw, pixel_major)
        if key not in twins:
            fn = coverage_chunks_t_torch if pixel_major else coverage_chunks_torch
            twins[key] = fn(edges, th, tw)
        return twins[key]

    def stamp(tag):
        print(f"{tag} done at {time.perf_counter() - t_start:.1f} s (host clock)")

    def random_nc(ch):
        """The random pool's chunk count: the 1080p pool of that depth's,
        within 2,048 .. 8,192, or NC_DEEP's for the deep ones."""
        nc = next((n for n, ce in zip(pools_nc, d["chunk_edges"])
                   if ce.shape[1] == ch), 2048)
        return NC_DEEP.get(ch, min(max(nc, 2048), 8192))

    for ch in CH_RANDOM:
        nc = random_nc(ch)
        edges = torch.from_numpy(random_chunks(rng, nc, ch)).to(dev)
        rand_edges.append(edges)
        got = coverage_cuda.cov_all_cuda([edges], 8, 128)
        ref = cov_all_torch([edges], 8, 128)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        k1_err = max(k1_err, err)
        print(f"[3] K1 CH={ch:2d} NC={nc} ({coverage_cuda.k1_geometry(8, 128, ch)['form']} "
              f"form): max|K1 - plain| = {err:.3e} (bound {K1_BOUND:.0e})")
        if not err <= K1_BOUND:
            raise AssertionError(f"K1 disagrees with its plain twin at CH={ch}: {err}")
    # the random pools in one launch (the deepest first: the deep form), dead
    # row last
    got = coverage_cuda.cov_all_cuda(rand_edges, 8, 128)
    err = float((got - cov_all_torch(rand_edges, 8, 128)).abs().max())
    k1_err = max(k1_err, err)
    print(f"[3] K1 over the {len(rand_edges)} random pools in one launch: "
          f"max|K1 - plain| = {err:.3e}")
    if not err <= K1_BOUND:
        raise AssertionError(f"K1 disagrees over the random pools: {err}")
    cov = coverage_cuda.cov_all_cuda(d["chunk_edges"], 8, 128)
    cov_ref = cov_all_torch(d["chunk_edges"], 8, 128)
    err = float((cov - cov_ref).abs().max())
    k1_err = max(k1_err, err)
    print(f"[3] K1 on the 1080p pools {pools_nc}: max|K1 - plain| = {err:.3e}")
    if not err <= K1_BOUND:
        raise AssertionError(f"K1 disagrees on the 1080p pools: {err}")

    stamp("[3]")

    # ---- 3c. K4 vs plain ------------------------------------------------
    # K4 is K1's function in the pixel-major layout, with K1's arithmetic:
    # K1's bound, and its transpose should equal K1's rows too
    k4_err = 0.0
    for label, edges in [(f"CH={int(e.shape[1]):2d} NC={int(e.shape[0])}", e)
                         for e in rand_edges] + [
            (f"1080p pool {tuple(ce.shape[:2])}", ce) for ce in d["chunk_edges"]]:
        got = coverage_t_cuda.coverage_chunks_t_cuda(edges, 8, 128)
        ref = plain(edges, 8, 128, True)
        k1_rows = coverage_cuda.cov_all_cuda([edges], 8, 128)[:-1]
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        k4_err = max(k4_err, err)
        print(f"[3c] K4 {label}: max|K4 - plain| = {err:.3e} (bound {K1_BOUND:.0e}); "
              f"max|K4 - K1 transposed| = {float((got.t() - k1_rows).abs().max()):.3e}")
        if not err <= K1_BOUND:
            raise AssertionError(f"K4 disagrees with its plain twin on {label}: {err}")
    # every pool of the frame in one launch (the sharded paths' call)
    before = coverage_t_cuda.K4.launches
    got = coverage_t_cuda.coverage_pools_t_cuda(d["chunk_edges"], 8, 128)
    n4 = coverage_t_cuda.K4.launches - before
    err = max(float((g - plain(ce, 8, 128, True)).abs().max())
              for g, ce in zip(got, d["chunk_edges"]))
    k4_err = max(k4_err, err)
    geo4 = coverage_t_cuda.k4_geometry(8, 128, max(int(ce.shape[1])
                                                   for ce in d["chunk_edges"]))
    print(f"[3c] K4 over the {len(got)} 1080p pools in {n4} launch(es): "
          f"max|K4 - plain| = {err:.3e}; geometry {geo4}")
    if not err <= K1_BOUND or n4 != 1:
        raise AssertionError(f"K4 over the 1080p pools: {err}, {n4} launches")

    # ---- 3d. K6 vs plain and vs K1 ---------------------------------------
    # K6 is K1's function, layout and design for one pool, with K1's
    # arithmetic: K1's bound, and it should equal K1's rows too; random
    # chunks at every depth on 8x128 and 8x256 tiles, the 1080p pools (the
    # tall tiles' pools in [4g], the deep-chunk scene's in [4h])
    ch_56 = (2, 6, 24, 40, 64, 2048, 8192)
    rand_56 = [(f"CH={int(e.shape[1]):2d} NC={int(e.shape[0])} 8x128", e, 128)
               for e in rand_edges if int(e.shape[1]) in ch_56]
    for ch in ch_56:                   # phase 3e holds K5 to the same chunks
        nc = NC_DEEP.get(ch, 512)
        rand_56.append((f"CH={ch:2d} NC={nc} 8x256", torch.from_numpy(
            random_chunks(rng, nc, ch)).to(dev), 256))
    frame_pools = [(f"1080p pool {tuple(ce.shape[:2])}", ce, 128)
                   for ce in d["chunk_edges"]]

    def check_k6(label, edges, th, tw, tag="[3d]", ref=None):
        """K6 against coverage_chunks_torch (or `ref`, its result) and K1
        on one pool; returns the largest error against the twin."""
        ref = coverage_chunks_torch(edges, th, tw) if ref is None else ref
        k1_rows = coverage_cuda.cov_all_cuda([edges], th, tw)[:-1]
        got = coverage_slots_cuda.coverage_chunks_slots_cuda(edges, th, tw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        vs_k1 = float((got.reshape(k1_rows.shape) - k1_rows).abs().max())
        print(f"{tag} K6 {label} ({coverage_slots_cuda.k6_geometry(th, tw, int(edges.shape[1]))['form']} "
              f"form): max|K6 - plain| = {err:.3e} (bound "
              f"{K1_BOUND:.0e}); max|K6 - K1| = {vs_k1:.3e}")
        if not (err <= K1_BOUND and vs_k1 <= K1_BOUND):
            raise AssertionError(f"K6 disagrees with its plain twin or K1 on {label}: "
                                 f"{err}, {vs_k1}")
        return err

    def check_k5(label, edges, th, tw, tag="[3e]", ref=None):
        """K5 against coverage_chunks_t_torch (or `ref`, its result) and
        K4 on one pool; returns the largest error against the twin."""
        ref = coverage_chunks_t_torch(edges, th, tw) if ref is None else ref
        k4 = coverage_t_cuda.coverage_chunks_t_cuda(edges, th, tw)
        got = coverage_t_flat_cuda.coverage_chunks_t_flat_cuda(edges, th, tw)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        vs_k4 = float((got - k4).abs().max())
        print(f"{tag} K5 {label} ({coverage_t_flat_cuda.k5_geometry(th, tw, int(edges.shape[1]))['form']} "
              f"form): max|K5 - plain| = {err:.3e} (bound "
              f"{K1_BOUND:.0e}); max|K5 - K4| = {vs_k4:.3e}")
        if not (err <= K1_BOUND and vs_k4 <= K1_BOUND):
            raise AssertionError(f"K5 disagrees with its plain twin or K4 on {label}: "
                                 f"{err}, {vs_k4}")
        return err

    k6_err = 0.0
    for label, edges, tw in rand_56 + frame_pools:
        k6_err = max(k6_err, check_k6(label, edges, 8, tw, ref=plain(edges, 8, tw)))

    # ---- 3e. K5 vs plain and vs K4 ---------------------------------------
    # K5 is K4's function, layout and design for one pool, with K1's
    # arithmetic; also on the pools of the n = 1 partition (the sharded
    # frame's K4 input)
    part_pools = [(f"partitioned pool {tuple(ce.shape[:2])}",
                   torch.from_numpy(np.ascontiguousarray(ce)).to(dev), 128)
                  for ce, _cent in partition_plan_for_mesh(
                      plan_dense_arrays(plan), plan, 1)[0]["chunk_pools"]]
    k5_err = 0.0
    for label, edges, tw in rand_56 + frame_pools + part_pools:
        k5_err = max(k5_err, check_k5(label, edges, 8, tw,
                                      ref=plain(edges, 8, tw, True)))
    twins.clear()

    stamp("[3c]-[3e]")

    # ---- 3b. K3 vs plain ------------------------------------------------
    k3_err = 0.0
    for ss in (2, 4):
        th = 8 * ss
        for ch in (2, 4, 6, 12, 24, 40, 64, 2048, 8192):
            nc = NC_DEEP[ch] // ss if ch in NC_DEEP else 2048
            e = random_chunks(rng, nc, ch)
            e[..., 1::2] *= ss                  # y spans the TH sub-rows
            edges = torch.from_numpy(e).to(dev)
            rp = torch.from_numpy(random_rparams(rng, nc, th, 128)).to(dev)
            got = torch.empty((nc, 8 * 128), device=dev)
            coverage_resolve_cuda.coverage_chunks_res_cuda([edges], [rp], got, th,
                                                           128, ss)
            ref = coverage_chunks_res_torch(edges, rp, th, 128, ss)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            k3_err = max(k3_err, err)
            print(f"[3b] K3 ss={ss} CH={ch:2d} NC={nc} "
                  f"({coverage_resolve_cuda.k3_geometry(th, ss, ch)['form']} form): "
                  f"max|K3 - plain| = {err:.3e} (bound {K3_BOUND:.0e})")
            if not err <= K3_BOUND:
                raise AssertionError(f"K3 disagrees with its plain twin at "
                                     f"ss={ss} CH={ch}: {err}")
    _ctx2, plan2, d2 = record_plan(vg, draw_frame, 1920, 1080, dev, ss=2)
    if d2["res"] is None:
        raise AssertionError("the 1080p ss=2 plan has no resolve split")
    res2 = d2["res"]
    k = len(res2["rparams"])
    fin_k, sub_k = cov_split_resolved(d2["chunk_edges"], res2, 16, 128, 2)
    fin_p, sub_p = cov_split_resolved_torch(d2["chunk_edges"], res2, 16, 128, 2)
    torch.cuda.synchronize()
    nres = sum(int(ce.shape[0]) for ce in d2["chunk_edges"][:k])
    err = float((fin_k[:nres] - fin_p[:nres]).abs().max())
    k3_err = max(k3_err, err)
    print(f"[3b] K3 on the 1080p ss=2 RES pools "
          f"{[tuple(ce.shape[:2]) for ce in d2['chunk_edges'][:k]]}: "
          f"max|K3 - plain| = {err:.3e}")
    if not err <= K3_BOUND:
        raise AssertionError(f"K3 disagrees on the 1080p RES pools: {err}")
    raw = d2["chunk_edges"][k:]
    err = float((coverage_cuda.cov_all_cuda(raw, 16, 128)
                 - cov_all_torch(raw, 16, 128)).abs().max())
    k1_err = max(k1_err, err)
    print(f"[3b] K1 on the 1080p ss=2 RAW pools (16 sub-rows) "
          f"{[tuple(ce.shape[:2]) for ce in raw]}: max|K1 - plain| = {err:.3e}; "
          f"cov_sub after the extras fold (index_add_, atomics) "
          f"{float((sub_k - sub_p).abs().max()):.3e}")
    if not err <= K1_BOUND:
        raise AssertionError(f"K1 disagrees on the 1080p RAW pools: {err}")
    # vg_resolve_rows on the same folded sub-row coverage as its twin
    xe_ids, xe_rp = res2["xe_primary_raw"], res2["xe_rparams"]
    got = torch.empty((xe_ids.shape[0], 8 * 128), device=dev)
    coverage_resolve_cuda.resolve_rows_cuda(sub_p, xe_ids, xe_rp, got, 16, 128, 2)
    ref = resolve_cov_rows_torch(sub_p[xe_ids], xe_rp, tile_h=16, tile_w=128, ss=2)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    k3_err = max(k3_err, err)
    print(f"[3b] K3 vg_resolve_rows on the {xe_ids.shape[0]} XE rows: "
          f"max|K3 - plain| = {err:.3e}; whole cov_final "
          f"{float((fin_k - fin_p).abs().max()):.3e}")
    if not err <= K3_BOUND:
        raise AssertionError(f"vg_resolve_rows disagrees with its twin: {err}")

    stamp("[3b]")

    # ---- 4. K2 vs plain -------------------------------------------------
    scenes = [("1080p", plan, d)]
    for label, draw in (("small", draw_small_scene), ("feature", draw_feature_scene)):
        _c, p, dd = record_plan(vg, draw, WIDTH, HEIGHT, dev)
        scenes.append((label, p, dd))
    k2_err = 0.0
    covered = set()
    for label, p, dd in scenes:
        c = fold_extras(cov_all_torch(dd["chunk_edges"], 8, 128), dd["cov_map"])
        nt = p.ntx * p.nty
        for i, flags in enumerate(dd["bucket_flags"]):
            args_b = (c, dd["bucket_pteb"][i], dd["bucket_params"][i],
                      dd["ct_flat"], dd["bucket_ctile"][i], dd["bucket_ids"][i], BG)
            fb_k = torch.zeros((nt + 1, 8, 128, 4), device=dev)
            fb_p = fb_k.clone()
            composite_cuda.composite_bucket_cuda(fb_k, *args_b, tile_w=128, flags=flags)
            composite_bucket_into_torch(fb_p, *args_b, tile_w=128, flags=flags)
            torch.cuda.synchronize()
            err = float((fb_k[:nt] - fb_p[:nt]).abs().max())
            k2_err = max(k2_err, err)
            covered.add(tuple(int(f) for f in flags))
            if not err <= K2_BOUND:
                raise AssertionError(f"K2 disagrees on {label} bucket {i} "
                                     f"flags {flags}: {err}")
        print(f"[4] K2 on {len(dd['bucket_flags'])} {label} buckets: "
              f"max|K2 - plain| = {k2_err:.3e} (bound {K2_BOUND:.0e})")
    k2_form_err = {"a": k2_err, "b": 0.0, "c": 0.0, "d": 0.0, "e": 0.0}
    lanes = np.array(sorted(covered)).any(axis=0)
    print(f"[4] flag tuples (grad,tri,tex,clip,eo,noaa,scissor): {sorted(covered)}")
    print(f"[4] lanes covered: {lanes.astype(int).tolist()}")
    if not lanes.all():
        raise AssertionError(f"a lane of K2 was never exercised: {lanes}")

    # ---- 4b. K2 forms (d) and (e) vs plain at ss=2 -----------------------
    # form (e) reads the gradient, tri, texture and scissor lanes; (d) all 7
    e_lanes = (0, 1, 2, 6)
    covered_ss2 = {"d": set(), "e": set()}
    scenes2 = [("1080p", plan2, d2)]
    for label, draw in (("small", draw_small_scene), ("feature", draw_feature_scene),
                        ("resolve", draw_resolve_scene)):
        scenes2.append((label, *record_plan(vg, draw, WIDTH, HEIGHT, dev, ss=2)[1:]))
    for label, draw, w, h in (("1080p", draw_frame, 1920, 1080),
                              ("resolve", draw_resolve_scene, WIDTH, HEIGHT)):
        scenes2.append((f"{label} unsplit",
                        *record_plan(vg, draw, w, h, dev, ss=2, split=False)[1:]))
    for label, p, dd in scenes2:
        if dd["res"] is not None:
            cov_final, cov_sub = cov_split_resolved_torch(dd["chunk_edges"], dd["res"],
                                                          16, 128, 2)
        else:
            cov_final = None
            cov_sub = cov_all_resolved_torch(dd["chunk_edges"], dd["cov_map"], 16, 128)
        nt = p.ntx * p.nty
        forms = {"d": 0, "e": 0}
        for i, flags in enumerate(dd["bucket_flags"]):
            form = "e" if cov_final is not None and not flags[3] else "d"
            rbd = dd["bucket_rbd"][i] if form == "e" else None
            args_b = (cov_final if form == "e" else cov_sub, dd["bucket_pteb"][i],
                      dd["bucket_params"][i], dd["ct_flat"], dd["bucket_ctile"][i],
                      dd["bucket_ids"][i], BG)
            fb_k = torch.zeros((nt + 1, 8, 128, 4), device=dev)
            fb_p = fb_k.clone()
            composite_cuda.composite_bucket_cuda(fb_k, *args_b, tile_w=128, flags=flags,
                                                 ss=2, rbd=rbd)
            composite_bucket_into_torch(fb_p, *args_b, tile_w=128, flags=flags,
                                        ss=2, rbd=rbd)
            torch.cuda.synchronize()
            err = float((fb_k[:nt] - fb_p[:nt]).abs().max())
            k2_err = max(k2_err, err)
            k2_form_err[form] = max(k2_form_err[form], err)
            forms[form] += 1
            lanes_on = flags if form == "d" else [flags[j] for j in e_lanes]
            covered_ss2[form].add(tuple(int(f) for f in lanes_on))
            if not err <= K2_BOUND:
                raise AssertionError(f"K2 ({form}) disagrees on {label} ss=2 bucket "
                                     f"{i} flags {flags}: {err}")
        print(f"[4b] K2 on {label} ss=2: {forms['d']} form (d), {forms['e']} form (e) "
              f"buckets; max|K2 - plain| = {k2_err:.3e} (bound {K2_BOUND:.0e})")
    for form, names in (("d", "grad,tri,tex,clip,eo,noaa,scissor"),
                        ("e", "grad,tri,tex,scissor")):
        lanes = np.array(sorted(covered_ss2[form])).any(axis=0)
        print(f"[4b] form ({form}) lanes ({names}) covered: "
              f"{lanes.astype(int).tolist()}")
        if not lanes.all():
            raise AssertionError(f"a lane of K2 form ({form}) was never exercised: "
                                 f"{lanes}")

    # ---- 4c. K2 forms (b) and (c) vs plain -------------------------------
    covered_bc = {"b": set(), "c": set()}
    for label, p, dd in (("1080p ss=1", plan, d), ("1080p ss=2 split", plan2, d2)):
        ss, th = p.supersample, p.tile_h
        nt = p.ntx * p.nty
        if dd["res"] is not None:
            cov_final, cov_sub = cov_split_resolved_torch(dd["chunk_edges"], dd["res"],
                                                          th, 128, ss)
        else:
            cov_final = None
            cov_sub = cov_all_resolved_torch(dd["chunk_edges"], dd["cov_map"], th, 128)
        # (b): every bucket in its own form from a random plane per tile
        init = torch.from_numpy(
            rng.uniform(0, 1, (nt + 1, 8, 128, 4)).astype(np.float32)).to(dev)
        forms_b = {"a": 0, "d": 0, "e": 0}
        for i, flags in enumerate(dd["bucket_flags"]):
            form = "e" if cov_final is not None and not flags[3] else "ad"[ss > 1]
            rbd = dd["bucket_rbd"][i] if form == "e" else None
            args_b = (cov_final if form == "e" else cov_sub, dd["bucket_pteb"][i],
                      dd["bucket_params"][i], dd["ct_flat"], dd["bucket_ctile"][i],
                      dd["bucket_ids"][i], BG)
            fb_k, fb_p = init.clone(), init.clone()
            composite_cuda.composite_bucket_cuda(fb_k, *args_b, tile_w=128, flags=flags,
                                                 ss=ss, rbd=rbd, init=True)
            composite_bucket_into_torch(fb_p, *args_b, tile_w=128, flags=flags, ss=ss,
                                        rbd=rbd, init=True)
            torch.cuda.synchronize()
            err = float((fb_k[:nt] - fb_p[:nt]).abs().max())
            k2_form_err["b"] = max(k2_form_err["b"], err)
            forms_b[form] += 1
            covered_bc["b"].add(tuple(int(f) for f in flags))
            if not err <= K2_BOUND:
                raise AssertionError(f"K2 (b) with form ({form}) disagrees on {label} "
                                     f"bucket {i} flags {flags}: {err}")
        # (c): the batch's own tables (coverage rows over all pools, form (d)
        # at ss > 1) and K_REP random paint / colour-tile variants
        tb = _batch_tables(p, dd, K_REP)
        snaps = []
        for v in range(K_REP):
            ep = p.entry_paint.copy()
            ep[:, 10:18] *= rng.uniform(0.3, 1.0, (ep.shape[0], 8)).astype(np.float32)
            snaps.append({"entry_paint": ep, "ct_flat": dd["ct_flat"] * (0.5 ** v)})
        params_c, ct_c, ctile_c = _batch_values(dd, snaps)
        cov_c = cov_all_resolved_torch(dd["chunk_edges"], tb["cov_map"], th, 128)
        for i, flags in enumerate(dd["bucket_flags"]):
            args_c = (cov_c, tb["pteb"][i], params_c[i], ct_c, ctile_c[i], tb["ids"][i], BG)
            fb_k = torch.zeros((K_REP * nt + 1, 8, 128, 4), device=dev)
            fb_p = fb_k.clone()
            composite_cuda.composite_bucket_cuda(fb_k, *args_c, tile_w=128, flags=flags,
                                                 ss=ss, k_rep=K_REP)
            composite_bucket_into_torch(fb_p, *args_c, tile_w=128, flags=flags, ss=ss,
                                        k_rep=K_REP)
            torch.cuda.synchronize()
            err = float((fb_k[:K_REP * nt] - fb_p[:K_REP * nt]).abs().max())
            k2_form_err["c"] = max(k2_form_err["c"], err)
            covered_bc["c"].add(tuple(int(f) for f in flags))
            if not err <= K2_BOUND:
                raise AssertionError(f"K2 (c) disagrees on {label} bucket {i} flags "
                                     f"{flags}: {err}")
        print(f"[4c] K2 on {label}: (b) over {forms_b} buckets, max|K2 - plain| = "
              f"{k2_form_err['b']:.3e}; (c) k_rep={K_REP} over "
              f"{len(dd['bucket_flags'])} buckets, max|K2 - plain| = "
              f"{k2_form_err['c']:.3e} (bound {K2_BOUND:.0e})")
    for form in ("b", "c"):
        lanes = np.array(sorted(covered_bc[form])).any(axis=0)
        print(f"[4c] form ({form}) lanes (grad,tri,tex,clip,eo,noaa,scissor) covered: "
              f"{lanes.astype(int).tolist()}")

    # ---- 4d. K7 vs plain -------------------------------------------------
    # every bucket at ss=1 of phase 4's scenes in k7_settings' four
    # settings, then k7_sweep_buckets: each of the 16 template
    # instantiations in both block forms on those buckets' tiles
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k7_err, covered_k7, n128, k7_pool = 0.0, set(), 0, []
    tally = {"runs": {}, "forms": set()}
    for label, p, dd in scenes:
        ne = p.entry_backdrop.shape[0]
        cov_p = cov_all_resolved_torch(dd["chunk_edges"], dd["cov_map"], 8, 128)
        cents = [torch.from_numpy(np.asarray(c)).to(dev) for _ce, c in p.chunk_pools]
        entry_w = (entry_coverage_from_pools(dd["chunk_edges"], cents, ne, 8, 128)
                   + torch.from_numpy(p.entry_backdrop).to(dev)[:, :, None]).reshape(ne, -1)
        bg_col = torch.tensor(BG, device=dev).repeat_interleave(8 * 128)[:, None]
        for i, flags in enumerate(dd["bucket_flags"]):
            pteb, te, pp = dd["bucket_pteb"][i], dd["bucket_te"][i], dd["bucket_params"][i]
            ct_t = (dd["ct_flat"][dd["bucket_ctile"][i]].permute(1, 2, 0).contiguous()
                    if flags[2] else None)
            ew_cov = cov_p[pteb].permute(1, 2, 0).contiguous()
            ew_ent = entry_w[te].permute(1, 2, 0).contiguous()
            n128 += pp.shape[2] % 128 == 0
            k7_err = max(k7_err, check_k7(
                f"{label} bucket {i}", flags,
                k7_settings(rng, ew_cov, ew_ent, pp, ct_t, bg_col), sms, tally))
            k7_pool.append((ew_cov, ew_ent, pp, ct_t, flags))
            covered_k7.add(tuple(int(f) for f in flags))
        print(f"[4d] K7 on {len(dd['bucket_flags'])} {label} buckets: runs "
              f"{tally['runs']}; max|K7 - plain| = {k7_err:.3e} (bound {K2_BOUND:.0e})")
    lanes = np.array(sorted(covered_k7)).any(axis=0)
    print(f"[4d] K7 lanes (grad,tri,tex,clip,eo,noaa,scissor) covered: "
          f"{lanes.astype(int).tolist()}; k_rep={K_REP} on {n128} buckets with "
          f"Nb % 128 == 0 among them")
    if not lanes.all():
        raise AssertionError(f"a lane of K7 was never exercised: {lanes}")
    sweep = {"runs": {}, "forms": set()}
    sweep_err = 0.0
    for label, flags, ew_cov, ew_ent, pp, ct_t in k7_sweep_buckets(k7_pool, sms):
        sweep_err = max(sweep_err, check_k7(
            f"sweep {label}", flags,
            k7_settings(rng, ew_cov, ew_ent, pp, ct_t, bg_col), sms, sweep))
    k7_err = max(k7_err, sweep_err)
    every = {(g, pix) for g in range(1 << composite_flat_cuda.TEMPLATE_LANES)
             for pix in (composite_flat_cuda.PIX_NARROW, composite_flat_cuda.PIX_WIDE)}
    print(f"[4d] K7 sweep of every instantiation on {sms} SMs: runs {sweep['runs']}; "
          f"(G, pixels a thread) checked {sorted(sweep['forms'])}; max|K7 - plain| = "
          f"{sweep_err:.3e} (bound {K2_BOUND:.0e})")
    if every - sweep["forms"]:
        raise AssertionError(f"K7 instantiations never held to the twin: "
                             f"{sorted(every - sweep['forms'])}")

    stamp("[4]-[4d]")

    # ---- 5. the main path ----------------------------------------------
    zero_counts()
    ctx = vg.createContext(device="cuda")
    vg.begin(ctx, 0, 1920, 1080, 1.0)
    vg.scenes.demo_ui.draw_benchmark_frame(ctx, 0.0)
    img = vg.end(ctx)
    launches = read_counts()
    print(f"[5] main path launches: {launches}")
    if not (launches["K1"] > 0 and launches["K2"] > 0):
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if tuple(img.shape) != (1080, 1920, 4) or img.device.type != "cuda":
        raise AssertionError(f"end() returned {tuple(img.shape)} on {img.device}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("end() returned non-finite pixels")
    ref = execute_plan_torch(ctx.last_plan, ctx.background,
                             device_arrays=ctx.last_device_arrays)
    ferr = float((img - ref).abs().max())
    u8 = int(np.abs(image_to_u8(img).astype(np.int16)
                    - image_to_u8(ref).astype(np.int16)).max())
    st = ctx.last_plan.stats
    text = demo_ui._FONT_DATA[0] is not None if demo_ui._FONT_DATA else False
    print(f"[5] frame vs plain twins on the card: max|diff| = {ferr:.3e}, "
          f"u8 levels {u8} (bound {U8_BOUND})")
    print(f"[5] plan: entries {st.get('entries')} chunks {st.get('chunks')} "
          f"(live {st.get('chunks_live')}) tiles {st.get('tiles')} "
          f"max ops/tile {st.get('max_ops_per_tile')} binner {st.get('backend', 'numpy')} "
          f"buckets {len(ctx.last_device_arrays['bucket_flags'])} text drawn {text}")
    if u8 > U8_BOUND:
        raise AssertionError(f"main-path frame is {u8} u8 levels from the plain path")
    # a small input against the CPU path (held to vgtpu by the CPU tests)
    imgs = []
    for device in ("cuda", "cpu"):
        c2 = vg.createContext(device=device)
        vg.begin(c2, 0, WIDTH, HEIGHT, 1.0)
        draw_small_scene(c2)
        imgs.append(image_to_u8(vg.end(c2)).astype(np.int16))
    su8 = int(np.abs(imgs[0] - imgs[1]).max())
    print(f"[5] small scene CUDA vs CPU: u8 levels {su8} (bound {U8_BOUND})")
    if su8 > U8_BOUND:
        raise AssertionError(f"small scene CUDA vs CPU: {su8} u8 levels")

    # ---- 5b. the main path in parity mode (ss=2) --------------------------
    zero_counts()
    ctx2 = vg.createContext(vg.ContextConfig(coverage_supersample=2), device="cuda")
    vg.begin(ctx2, 0, 1920, 1080, 1.0)
    vg.scenes.demo_ui.draw_benchmark_frame(ctx2, 0.0)
    img2 = vg.end(ctx2)
    launches_ss2 = read_counts()
    print(f"[5b] main path (ss=2) launches: {launches_ss2}")
    if not all(launches_ss2[n] > 0 for n in ("K1", "K2", "K3", "K2 (d)", "K2 (e)")):
        raise AssertionError(f"ss=2 main path skipped a kernel: {launches_ss2}")
    if tuple(img2.shape) != (1080, 1920, 4) or img2.device.type != "cuda":
        raise AssertionError(f"ss=2 end() returned {tuple(img2.shape)} on {img2.device}")
    if not bool(torch.isfinite(img2).all()):
        raise AssertionError("ss=2 end() returned non-finite pixels")
    pl2, dv2 = ctx2.last_plan, ctx2.last_device_arrays
    ref2 = execute_plan_torch(pl2, ctx2.background, device_arrays=dv2)
    ferr2 = float((img2 - ref2).abs().max())
    u8_2 = int(np.abs(image_to_u8(img2).astype(np.int16)
                      - image_to_u8(ref2).astype(np.int16)).max())
    rh = pl2.resolve_host
    nraw = rh["nraw"]
    nxe = int((dv2["res"]["xe_primary_raw"] < nraw).sum())
    n_d = sum(1 for f in dv2["bucket_flags"] if f[3])
    n_e = len(dv2["bucket_flags"]) - n_d
    st2 = pl2.stats
    print(f"[5b] frame vs plain twins on the card: max|diff| = {ferr2:.3e}, "
          f"u8 levels {u8_2} (bound {U8_BOUND})")
    print(f"[5b] split: nres {rh['nres']} in {rh['npools_res']} pools, nraw {nraw}, "
          f"nxe {nxe} (padded {dv2['res']['xe_primary_raw'].shape[0]}); buckets: "
          f"{n_d} form (d), {n_e} form (e); plan: entries {st2.get('entries')} "
          f"chunks {st2.get('chunks')} (live {st2.get('chunks_live')}) tiles "
          f"{st2.get('tiles')}")
    if u8_2 > U8_BOUND:
        raise AssertionError(f"ss=2 main-path frame is {u8_2} u8 levels from the "
                             f"plain path")
    # the same code at ss=4 and 8 (K2's coverage ring and clip state then
    # take 37-123 KB of shared memory per block: composite_cuda.k2_geometry)
    for ss in (2, 4, 8):
        imgs = []
        for device in ("cuda", "cpu"):
            c2 = vg.createContext(vg.ContextConfig(coverage_supersample=ss),
                                  device=device)
            vg.begin(c2, 0, WIDTH, HEIGHT, 1.0)
            draw_small_scene(c2)
            imgs.append(image_to_u8(vg.end(c2)).astype(np.int16))
        su8 = int(np.abs(imgs[0] - imgs[1]).max())
        print(f"[5b] small scene ss={ss} CUDA vs CPU: u8 levels {su8} "
              f"(bound {U8_BOUND})")
        if su8 > U8_BOUND:
            raise AssertionError(f"small scene ss={ss} CUDA vs CPU: {su8} u8 levels")

    paths = {"main ss=1": launches, "main ss=2": launches_ss2}

    def check_path(name, counts, need, pairs, tag="[7]"):
        """A path's launch counts (each kernel in need launched), then its
        images against their references."""
        paths[name] = counts
        print(f"{tag} {name}: launches {counts}")
        missing = [k for k in need if counts[k] <= 0]
        if missing:
            raise AssertionError(f"{name} launched no {missing}: {counts}")
        for a, b in pairs:
            if tuple(a.shape) != tuple(b.shape):
                raise AssertionError(f"{name}: image {tuple(a.shape)}, reference "
                                     f"{tuple(b.shape)}")
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: non-finite pixels")
        worst = max(u8_levels(a, b) for a, b in pairs)
        diff = max(float((a - b).abs().max()) for a, b in pairs)
        print(f"{tag} {name}: {len(pairs)} images, worst {worst} u8 levels from the "
              f"reference (bound {U8_BOUND}), max|diff| {diff:.3e}")
        if worst > U8_BOUND:
            raise AssertionError(f"{name}: an image is {worst} u8 levels off")

    stamp("[5]-[5b]")

    # ---- 4e. tile shapes beyond 8x128 ------------------------------------
    # the small scene through end() at tile_w=256 and at tile_h=16, ss = 1,
    # 2, 8 (up to 128 sub-rows: K2's pixel groups, K3's launch-sized rparams
    # staging), held to the plain twins on the same plan, 0 u8 levels
    for cfg in ({"tile_w": 256}, {"tile_h": 16}):
        for ss in (1, 2, 8):
            name = f"tile {cfg} ss={ss}"
            c4 = vg.createContext(vg.ContextConfig(coverage_supersample=ss, **cfg),
                                  device="cuda")
            zero_counts()
            vg.begin(c4, 0, WIDTH, HEIGHT, 1.0)
            draw_small_scene(c4)
            img4 = vg.end(c4)
            counts = read_counts()
            paths[name] = counts
            need = ("K1", "K2") + (("K3", "K2 (e)") if ss > 1 else ("K2 (a)",))
            missing = [k for k in need if counts[k] <= 0]
            p4 = c4.last_plan
            geo = composite_cuda.k2_geometry(p4.tile_h // ss, p4.tile_w, ss,
                                             clip=True, tex=True)
            print(f"[4e] {name}: plan tiles {p4.tile_h}x{p4.tile_w} (sub-rows x "
                  f"width), {len(c4.last_device_arrays['bucket_flags'])} buckets; "
                  f"K2 {geo['threads']} threads x {geo['groups']} pixel groups per "
                  f"tile, <= {geo['smem_bytes']} shared bytes; launches {counts}")
            if missing:
                raise AssertionError(f"[4e] {name} launched no {missing}: {counts}")
            ref4 = execute_plan_torch(p4, c4.background,
                                      device_arrays=c4.last_device_arrays)
            if tuple(img4.shape) != (HEIGHT, WIDTH, 4) or not bool(
                    torch.isfinite(img4).all()):
                raise AssertionError(f"[4e] {name}: {tuple(img4.shape)} image or "
                                     f"non-finite pixels")
            lv = u8_levels(img4, ref4)
            print(f"[4e] {name}: vs the plain twins on the card: max|diff| "
                  f"{float((img4 - ref4).abs().max()):.3e}, {lv} u8 levels (bound 0)")
            if lv:
                raise AssertionError(f"[4e] {name}: {lv} u8 levels from the twins")

    # ---- 4f. chunks over 32 edges ---------------------------------------
    # ContextConfig(chunk_pools=(2, 8, 48)) through end(): the deep-chunk
    # scene (48-edge chunks in RES and RAW pools at ss=2) held to the plain
    # twins on the same plan at 0 u8 levels, and the 1080p frame (its fold
    # is atomic: within 1 u8 level, as [5])
    for label, draw, w, h, lv_bound in (
            ("deep-chunk scene", draw_deep_chunk_scene, WIDTH, HEIGHT, 0),
            ("1080p frame", draw_frame, 1920, 1080, U8_BOUND)):
        for ss in (1, 2):
            name = f"chunk_pools (2, 8, 48) {label} ss={ss}"
            c6 = vg.createContext(vg.ContextConfig(coverage_supersample=ss,
                                                   chunk_pools=(2, 8, 48)),
                                  device="cuda")
            zero_counts()
            vg.begin(c6, 0, w, h, 1.0)
            draw(c6)
            img6 = vg.end(c6)
            counts = read_counts()
            paths[name] = counts
            d6 = c6.last_device_arrays
            k6 = len(d6["res"]["rparams"]) if ss > 1 else 0
            shapes = [tuple(int(x) for x in ce.shape[:2]) for ce in d6["chunk_edges"]]
            live48 = [int((ce.abs().sum(dim=(1, 2)) > 0).sum())
                      for ce in d6["chunk_edges"] if ce.shape[1] == 48]
            need = ("K1", "K2") + (("K3",) if ss > 1 else ())
            missing = [k for k in need if counts[k] <= 0]
            print(f"[4f] {name}: pools {shapes} ({k6} RES first), live 48-edge "
                  f"chunks {live48}; launches {counts}")
            if missing or not any(live48):
                raise AssertionError(f"[4f] {name}: launched no {missing} or no live "
                                     f"48-edge chunk: {counts}, {live48}")
            ref6 = execute_plan_torch(c6.last_plan, c6.background, device_arrays=d6)
            if tuple(img6.shape) != (c6.fb_height, c6.fb_width, 4) or not bool(
                    torch.isfinite(img6).all()):
                raise AssertionError(f"[4f] {name}: {tuple(img6.shape)} image or "
                                     f"non-finite pixels")
            lv = u8_levels(img6, ref6)
            print(f"[4f] {name}: vs the plain twins on the card: max|diff| "
                  f"{float((img6 - ref6).abs().max()):.3e}, {lv} u8 levels "
                  f"(bound {lv_bound})")
            if lv > lv_bound:
                raise AssertionError(f"[4f] {name}: {lv} u8 levels from the twins")
            del c6, img6, ref6, d6

    # ---- 4g. tiles taller than one staging window -------------------------
    # the 512x256 scenes with chunk_pools=(2, 8, 48) through end(): the
    # small scene at ss=1 with tile_h=16384 (over the 14,512 rows K1's masks
    # once held at CH = 2) and the resolve scene at ss=2 with tile_h=8192
    # (16,384 sub-rows, over K3's 7,248; at that height every entry of the
    # small scene takes several chunks, so its plan has no RES pool and
    # K3 would not run), held to the plain twins on the same plan at 0 u8
    # levels; K4, K5 and K6 over the plan's pools against their twins
    for ss, th, draw in ((1, 16384, draw_small_scene), (2, 8192, draw_resolve_scene)):
        name = f"tall tiles tile_h={th} ss={ss} ({draw.__name__})"
        c7 = vg.createContext(vg.ContextConfig(coverage_supersample=ss, tile_h=th,
                                               chunk_pools=(2, 8, 48)),
                              device="cuda")
        zero_counts()
        vg.begin(c7, 0, WIDTH, HEIGHT, 1.0)
        draw(c7)
        img7 = vg.end(c7)
        counts = read_counts()
        paths[name] = counts
        d7, p7 = c7.last_device_arrays, c7.last_plan
        shapes = [tuple(int(x) for x in ce.shape[:2]) for ce in d7["chunk_edges"]]
        max_ch = max(c for _n, c in shapes)
        k_res = len(d7["res"]["rparams"]) if d7["res"] is not None else 0
        k1g = coverage_cuda.k1_geometry(p7.tile_h, 128, max(c for _n, c in shapes[k_res:]))
        k3g = (coverage_resolve_cuda.k3_geometry(p7.tile_h, ss, max(
            c for _n, c in shapes[:k_res])) if k_res else {})
        need = ("K1", "K2") + (("K3",) if ss > 1 else ())
        missing = [k for k in need if counts[k] <= 0]
        print(f"[4g] {name}: plan tiles {p7.tile_h}x{p7.tile_w} (sub-rows x width), "
              f"pools {shapes} ({k_res} RES first); K1 windows of "
              f"{k1g['window_rows']} rows ({k1g['windows']} a tile), K3 "
              f"{k3g.get('window_rows')} sub-rows ({k3g.get('windows')}); "
              f"launches {counts}")
        if missing or k1g["windows"] < 2 or (ss > 1 and k3g.get("windows", 0) < 2):
            raise AssertionError(f"[4g] {name}: launched no {missing}, or the tile "
                                 f"fits one window: {k1g}, {k3g}")
        ref7 = execute_plan_torch(p7, c7.background, device_arrays=d7)
        if tuple(img7.shape) != (HEIGHT, WIDTH, 4) or not bool(torch.isfinite(img7).all()):
            raise AssertionError(f"[4g] {name}: {tuple(img7.shape)} image or "
                                 f"non-finite pixels")
        lv = u8_levels(img7, ref7)
        print(f"[4g] {name}: vs the plain twins on the card: max|diff| "
              f"{float((img7 - ref7).abs().max()):.3e}, {lv} u8 levels (bound 0)")
        if lv:
            raise AssertionError(f"[4g] {name}: {lv} u8 levels from the twins")
        del img7, ref7
        got = coverage_t_cuda.coverage_pools_t_cuda(d7["chunk_edges"], p7.tile_h, 128)
        err = 0.0
        for g, ce in zip(got, d7["chunk_edges"]):
            ref = coverage_chunks_t_torch(ce, p7.tile_h, 128)
            err = max(err, float((g - ref).abs().max()))
            label = f"tall-tile pool {tuple(ce.shape[:2])} at tile_h={p7.tile_h}"
            k5_err = max(k5_err, check_k5(label, ce, p7.tile_h, 128, "[4g]", ref))
            del ref
            k6_err = max(k6_err, check_k6(label, ce, p7.tile_h, 128, "[4g]"))
        k4_err = max(k4_err, err)
        print(f"[4g] K4 over the plan's pools at tile_h={p7.tile_h}: max|K4 - plain| "
              f"= {err:.3e} (bound {K1_BOUND:.0e}); geometry "
              f"{coverage_t_cuda.k4_geometry(p7.tile_h, 128, max_ch)}")
        if not err <= K1_BOUND:
            raise AssertionError(f"[4g] K4 disagrees at tile_h={p7.tile_h}: {err}")
        del got, c7, d7
        torch.cuda.empty_cache()

    stamp("[4e]-[4g]")

    # ---- 4h. chunks deeper than one edge window ---------------------------
    # the deep-tile scene (a comb of 2,001 edges in one tile) with
    # chunk_pools=(2, 8, CH_DEEP) through end() at ss = 1 and 2: its chunk
    # is deeper than the 1,808 edges a shallow K1 block held, so K1 (and at
    # ss=2 K3, whose RES pool the chunk's entry reaches) launch in their
    # deep form; held to the plain twins on the same plan at 0 u8 levels;
    # K4, K5 and K6 over the plan's pools against their twins
    for ss in (1, 2):
        name = f"deep chunks chunk_pools (2, 8, {CH_DEEP}) ss={ss}"
        c8 = vg.createContext(vg.ContextConfig(coverage_supersample=ss,
                                               chunk_pools=(2, 8, CH_DEEP)),
                              device="cuda")
        zero_counts()
        vg.begin(c8, 0, WIDTH, HEIGHT, 1.0)
        draw_deep_tile_scene(c8)
        img8 = vg.end(c8)
        counts = read_counts()
        paths[name] = counts
        d8, p8 = c8.last_device_arrays, c8.last_plan
        pools8 = d8["chunk_edges"]
        shapes = [tuple(int(x) for x in ce.shape[:2]) for ce in pools8]
        live = [int((ce.abs().sum(dim=2) > 0).sum(dim=1).max()) for ce in pools8]
        k_res = len(d8["res"]["rparams"]) if d8["res"] is not None else 0
        k1g = coverage_cuda.k1_geometry(p8.tile_h, 128, max(c for _n, c in shapes[k_res:]))
        k3g = (coverage_resolve_cuda.k3_geometry(p8.tile_h, ss, max(
            c for _n, c in shapes[:k_res])) if k_res else {})
        need = ("K1", "K2") + (("K3",) if ss > 1 else ())
        missing = [k for k in need if counts[k] <= 0]
        print(f"[4h] {name}: pools {shapes} ({k_res} RES first), the deepest live "
              f"chunk per pool {live} edges; K1 {k1g['form']} form, K3 "
              f"{k3g.get('form', 'no RES pool, no')} form (edge windows of "
              f"{k1g['edge_window']}); launches {counts}")
        if (missing or k1g["form"] != "deep" or max(live) <= 1808
                or (ss > 1 and (k3g.get("form") != "deep" or max(live[:k_res]) <= 1808))):
            raise AssertionError(f"[4h] {name}: launched no {missing}, or K1 or K3 "
                                 f"took no deep form, or no chunk over 1,808 edges: "
                                 f"{k1g}, {k3g}, {live}")
        ref8 = execute_plan_torch(p8, c8.background, device_arrays=d8)
        if tuple(img8.shape) != (HEIGHT, WIDTH, 4) or not bool(torch.isfinite(img8).all()):
            raise AssertionError(f"[4h] {name}: {tuple(img8.shape)} image or "
                                 f"non-finite pixels")
        lv = u8_levels(img8, ref8)
        print(f"[4h] {name}: vs the plain twins on the card: max|diff| "
              f"{float((img8 - ref8).abs().max()):.3e}, {lv} u8 levels (bound 0)")
        if lv:
            raise AssertionError(f"[4h] {name}: {lv} u8 levels from the twins")
        got = coverage_t_cuda.coverage_pools_t_cuda(pools8, p8.tile_h, 128)
        err = 0.0
        for g, ce in zip(got, pools8):
            ref = coverage_chunks_t_torch(ce, p8.tile_h, 128)
            err = max(err, float((g - ref).abs().max()))
            label = f"deep-tile pool {tuple(ce.shape[:2])} at tile_h={p8.tile_h}"
            k5_err = max(k5_err, check_k5(label, ce, p8.tile_h, 128, "[4h]", ref))
            k6_err = max(k6_err, check_k6(label, ce, p8.tile_h, 128, "[4h]"))
        k4_err = max(k4_err, err)
        print(f"[4h] K4 over the plan's pools ({coverage_t_cuda.k4_geometry(p8.tile_h, 128, CH_DEEP)['form']} "
              f"form): max|K4 - plain| = {err:.3e} (bound {K1_BOUND:.0e})")
        if not err <= K1_BOUND:
            raise AssertionError(f"[4h] K4 disagrees on the deep-tile pools: {err}")
        del got, c8, d8, img8, ref8

    stamp("[4h]")

    # ---- 5c. the 1080p frame through K5 or K6 and K7 ----------------------
    # chunk coverage per pool (K5 pixel-major, or K6 chunk-major), the
    # chunk -> entry index_add_, + backdrop -> entry_w; per bucket ew_t
    # gathered by its entry table, K7 (add_backdrop=False); held to phase 5
    pl5, dv5 = ctx.last_plan, ctx.last_device_arrays
    cents5 = [torch.from_numpy(np.asarray(c)).to(dev) for _ce, c in pl5.chunk_pools]
    for cov_k in ("K5", "K6"):
        zero_counts()
        fimg = execute_plan_flat(pl5, dv5, cents5, ctx.background, cov_k)
        counts = read_counts()
        check_path(f"flat frame via {cov_k}", counts, (cov_k, "K7"), [(fimg, img)],
                   tag="[5c]")

    stamp("[5c]")

    # ---- 7. the serving paths -------------------------------------------
    def app_frame(c, draw, dispatch=True):
        vg.begin(c, 0, 1920, 1080, 1.0)
        draw(c)
        return vg.end(c, background=BG_APP, dispatch=dispatch)

    def overlay(k):
        """bench.py's anim / batch_diag frame: the north-star frame plus a
        rect whose colour is the only delta."""
        def f(c):
            demo_ui.draw_benchmark_frame(c, 0.0)
            vg.beginPath(c)
            vg.rect(c, 1800, 1000, 60, 40)
            vg.fillPath(c, vg.color4ub(50 + 17 * k, 120, 200, 180),
                        vg.FillFlags.ConvexAA)
        return f

    def layer_frame(k):
        return lambda c: demo_ui.draw_benchmark_frame(c, 0.3 + 0.05 * k)

    def bench_frame(c):
        demo_ui.draw_benchmark_frame(c, 0.0)

    # redraw: identical re-records re-render the resident plan
    ctx_r = vg.createContext(device="cuda")
    zero_counts()
    imgs = [app_frame(ctx_r, bench_frame) for _ in range(5)]
    counts = read_counts()
    hits = ctx_r.profiler.counters.get("memo_hits", 0)
    print(f"[7] redraw: memo_hits {hits} of 5 frames")
    if hits != 4:
        raise AssertionError(f"redraw took {hits} frame-memo hits, not 4")
    check_path("redraw", counts, ("K1", "K2", "K2 (a)"),
               [(im, imgs[0]) for im in imgs[1:]])

    # anim: the overlay's colour changes, the resident paint rows are patched
    ref_a = vg.createContext(vg.ContextConfig(frame_memo=False), device="cuda")
    refs = [app_frame(ref_a, overlay(k)) for k in range(6)]
    ctx_a = vg.createContext(device="cuda")
    zero_counts()
    imgs, up = [], []
    for k in range(6):
        u0 = ctx_a.profiler.counters.get("upload_bytes", 0)
        imgs.append(app_frame(ctx_a, overlay(k)))
        up.append(ctx_a.profiler.counters.get("upload_bytes", 0) - u0)
    counts = read_counts()
    hits = ctx_a.profiler.counters.get("memo_paint_hits", 0)
    print(f"[7] anim: memo_paint_hits {hits} of 5 recolours; upload_bytes "
          f"{up[0]} for the full frame, {up[1]} for a patch frame")
    if hits != 5:
        raise AssertionError(f"anim took {hits} paint patches, not 5")
    check_path("anim", counts, ("K1", "K2", "K2 (a)"), list(zip(imgs, refs)))

    # layer: the tiger and the UI's static part bake once, the moving UI
    # composites over the resident tiles (K2 (b))
    layer_ctx = {}
    for ss in (1, 2):
        ref_l = vg.createContext(vg.ContextConfig(coverage_supersample=ss,
                                                  layer_memo=False), device="cuda")
        refs = [app_frame(ref_l, layer_frame(k)) for k in range(6)]
        ctx_l = vg.createContext(vg.ContextConfig(coverage_supersample=ss), device="cuda")
        zero_counts()
        imgs = [app_frame(ctx_l, layer_frame(k)) for k in range(6)]
        counts = read_counts()
        n = ctx_l.profiler.counters
        print(f"[7] layer ss={ss}: layer_bakes {n.get('layer_bakes', 0)} layer_hits "
              f"{n.get('layer_hits', 0)} of 6 frames; prefix {ctx_l._layer_used} of "
              f"{len(ctx_l.ops)} ops; suffix plan {ctx_l.last_plan.stats.get('entries')} "
              f"entries in {len(ctx_l.last_device_arrays['bucket_flags'])} buckets")
        if n.get("layer_bakes", 0) != 1 or n.get("layer_hits", 0) < 3:
            raise AssertionError(f"layer ss={ss}: {dict(n)}")
        need = ("K1", "K2", "K2 (b)") + (("K3", "K2 (d)", "K2 (e)") if ss > 1
                                         else ("K2 (a)",))
        check_path(f"layer ss={ss}", counts, need, list(zip(imgs, refs)))
        layer_ctx[ss] = ctx_l

    # renderFrames: three different canvases, each ended with
    # end(dispatch=False), rendered back to back
    rf_cases = [(1, 1920, 1080, bench_frame), (2, 1920, 1080, bench_frame),
                (1, WIDTH, HEIGHT, draw_small_scene)]

    def rf_context(ss):
        return vg.createContext(vg.ContextConfig(coverage_supersample=ss), device="cuda")

    def rf_record(c, case, dispatch):
        _ss, w, h, draw = case
        vg.begin(c, 0, w, h, 1.0)
        draw(c)
        return vg.end(c, background=BG_APP, dispatch=dispatch)

    refs = [rf_record(rf_context(case[0]), case, True) for case in rf_cases]
    rf_ctxs = [rf_context(case[0]) for case in rf_cases]
    for c, case in zip(rf_ctxs, rf_cases):
        if rf_record(c, case, False) is not None or c.frame_image is not None:
            raise AssertionError("end(dispatch=False) rendered a frame")
    zero_counts()
    rf_imgs = vg.renderFrames(rf_ctxs)
    counts = read_counts()
    check_path("renderFrames", counts,
               ("K1", "K2", "K3", "K2 (a)", "K2 (d)", "K2 (e)"), list(zip(rf_imgs, refs)))

    # batch: bench.py's K=6 overlay variants, coverage once, K2 (c) per bucket
    ctx_b = vg.createContext(device="cuda")
    zero_counts()
    vb = VariantBatch.bake(ctx_b, [overlay(k) for k in range(K_BATCH)], 1920, 1080,
                           background=BG_APP)
    bimgs = vb.render(background=BG_APP)
    counts = read_counts()
    if tuple(bimgs.shape) != (K_BATCH, 1080, 1920, 4):
        raise AssertionError(f"VariantBatch.render returned {tuple(bimgs.shape)}")
    ref_b = vg.createContext(vg.ContextConfig(frame_memo=False), device="cuda")
    refs = [app_frame(ref_b, overlay(k)) for k in range(K_BATCH)]
    check_path("batch", counts, ("K1", "K2", "K2 (c)"),
               [(bimgs[k], refs[k]) for k in range(K_BATCH)])
    refs_batch = refs

    stamp("[7]")

    # ---- 8. the multi-GPU paths -----------------------------------------
    n_cards = torch.cuda.device_count()

    def mesh_of(n):
        """n shards, one per card while cards last, then repeating them."""
        return Mesh(tuple(torch.device("cuda", k % n_cards) for k in range(n)))

    def mesh_note(mesh):
        devs = [str(x) for x in mesh.devices]
        if len(set(devs)) == len(devs):
            return f"devices {devs}: one shard per card"
        return (f"devices {devs}: {len(devs)} shards on {len(set(devs))} card(s), "
                f"repeated (no cross-card copy for the repeats)")

    def meta_note(m):
        return (f"chunk_balance {m['chunk_balance']:.4f} entry_balance "
                f"{m['entry_balance']:.4f} ici_bytes_per_frame "
                f"{m['ici_bytes_per_frame']}; ne_dev {m['ne_dev']} t_pad {m['t_pad']} "
                f"chunk slots live {m['chunk_slots_live']} of {m['chunk_slots_padded']}")

    # the tile-sharded frame: K4 + the oracle composite, held to phase 5
    sharded = {}
    for n in (1, 2, 4):
        mesh = mesh_of(n)
        zero_counts()
        simg, meta = render_frame_sharded(ctx.last_plan, mesh, ctx.background,
                                          return_meta=True)
        counts = read_counts()
        print(f"[8] sharded n={n}: {mesh_note(mesh)}; {meta_note(meta)}; tile table "
              f"{meta['t_pad'] // n} x {ctx.last_plan.tile_entries.shape[1]} per shard")
        check_path(f"sharded n={n}", counts, ("K4",), [(simg, ctx.frame_image)],
                   tag="[8]")
        sharded[n] = mesh
    # the sharded fused frame: K1, the fold, K2 per shard (the RAW
    # formulation at ss=2), held to phases 5 and 5b
    sharded_fused = {}
    for ss, c in ((1, ctx), (2, ctx2)):
        for n in (2, 4):
            mesh = mesh_of(n)
            zero_counts()
            fimg, meta = render_frame_sharded_fused(c.last_plan, mesh, c.background,
                                                    return_meta=True)
            counts = read_counts()
            print(f"[8] sharded fused ss={ss} n={n}: {mesh_note(mesh)}; "
                  f"{meta_note(meta)}")
            check_path(f"sharded fused ss={ss} n={n}", counts,
                       ("K1", "K2", "K2 (a)" if ss == 1 else "K2 (d)"),
                       [(fimg, c.frame_image)], tag="[8]")
            sharded_fused[(ss, n)] = mesh
    # the variant-sharded batch: phase 7's K=6 batch over 4 shards (8 frames)
    mesh4 = mesh_of(4)
    zero_counts()
    simgs = vb.render_sharded(mesh4, BG_APP)
    counts = read_counts()
    if tuple(simgs.shape) != (K_BATCH, 1080, 1920, 4) or simgs.device != ctx.frame_image.device:
        raise AssertionError(f"render_sharded returned {tuple(simgs.shape)} on "
                             f"{simgs.device}")
    print(f"[8] render_sharded: K={K_BATCH} over {mesh_note(mesh4)}, padded to "
          f"{-(-K_BATCH // 4) * 4} frames")
    check_path("render_sharded n=4", counts, ("K4",),
               [(simgs[k], refs_batch[k]) for k in range(K_BATCH)], tag="[8]")
    del refs, refs_batch, imgs, bimgs, rf_imgs, simgs

    stamp("[8]")

    # ---- 10a. device texture sampling; 10b. the retained pan -------------
    samp = phase_10a(vg, card, zero_counts, read_counts, check_path)
    stamp("[10a]")
    pan = phase_10b(vg, card, zero_counts, read_counts, check_path)
    stamp("[10b]")

    # ---- 11. the cached-list app; 11b. render_edges ------------------------
    phase_11(vg, card, zero_counts, read_counts, check_path)
    stamp("[11]")
    phase_11b(card)
    stamp("[11b]")

    # ---- 6. times -------------------------------------------------------
    pl, dv = ctx.last_plan, ctx.last_device_arrays
    nt = pl.ntx * pl.nty
    cov_res = fold_extras(coverage_cuda.cov_all_cuda(dv["chunk_edges"], 8, 128),
                          dv["cov_map"])

    def composite_all(bucket_fn):
        return frame_fb(cov_res, dv["bucket_ids"], dv["bucket_pteb"],
                        dv["bucket_params"], dv["bucket_ctile"], dv["ct_flat"],
                        BG, tile_h=8, tile_w=128, num_tiles=nt,
                        bucket_flags=dv["bucket_flags"], bucket_fn=bucket_fn)

    # ss=2: K3 is every vg_coverage_chunks_res + vg_resolve_rows launch of
    # a frame (RES pools, then XE rows over the folded cov_sub); K1 the RAW
    # pools at 16 sub-rows; K2 every bucket, forms (d) and (e)
    res2, nt2 = dv2["res"], pl2.ntx * pl2.nty
    k = len(res2["rparams"])
    fin2, sub2 = cov_split_resolved(dv2["chunk_edges"], res2, 16, 128, 2)
    nres2 = fin2.shape[0] - 1 - res2["xe_primary_raw"].shape[0]

    def k3_all(cuda):
        if cuda:
            coverage_resolve_cuda.coverage_chunks_res_cuda(
                dv2["chunk_edges"][:k], res2["rparams"], fin2[:nres2], 16, 128, 2)
        else:
            fin2[:nres2] = torch.cat([coverage_chunks_res_torch(ce, rp, 16, 128, 2)
                                      for ce, rp in zip(dv2["chunk_edges"][:k],
                                                        res2["rparams"])])
        out = fin2[nres2:nres2 + res2["xe_primary_raw"].shape[0]]
        if cuda:
            coverage_resolve_cuda.resolve_rows_cuda(
                sub2, res2["xe_primary_raw"], res2["xe_rparams"], out, 16, 128, 2)
        else:
            out.copy_(resolve_cov_rows_torch(sub2[res2["xe_primary_raw"]],
                                             res2["xe_rparams"], tile_h=16,
                                             tile_w=128, ss=2))

    def composite_all_ss2(bucket_fn):
        return frame_fb(sub2, dv2["bucket_ids"], dv2["bucket_pteb"],
                        dv2["bucket_params"], dv2["bucket_ctile"], dv2["ct_flat"],
                        BG, tile_h=16, tile_w=128, num_tiles=nt2,
                        bucket_flags=dv2["bucket_flags"], bucket_fn=bucket_fn,
                        ss=2, cov_final_arr=fin2, bucket_rbd=dv2["bucket_rbd"])

    ms = {
        "frame": time_ms(lambda: execute_plan(pl, BG, device_arrays=dv)),
        "frame_plain": time_ms(lambda: execute_plan_torch(pl, BG, device_arrays=dv)),
        "K1": time_ms(lambda: coverage_cuda.cov_all_cuda(dv["chunk_edges"], 8, 128)),
        "K1_plain": time_ms(lambda: cov_all_torch(dv["chunk_edges"], 8, 128)),
        "K2": time_ms(lambda: composite_all(composite_cuda.composite_bucket_cuda)),
        "K2_plain": time_ms(lambda: composite_all(composite_bucket_into_torch)),
        "frame_ss2": time_ms(lambda: execute_plan(pl2, BG, device_arrays=dv2)),
        "frame_ss2_plain": time_ms(lambda: execute_plan_torch(pl2, BG,
                                                              device_arrays=dv2)),
        "K1_ss2": time_ms(lambda: coverage_cuda.cov_all_cuda(
            dv2["chunk_edges"][k:], 16, 128)),
        "K1_ss2_plain": time_ms(lambda: cov_all_torch(dv2["chunk_edges"][k:], 16, 128)),
        "K3_ss2": time_ms(lambda: k3_all(True)),
        "K3_ss2_plain": time_ms(lambda: k3_all(False)),
        "K2_ss2": time_ms(lambda: composite_all_ss2(composite_cuda.composite_bucket_cuda)),
        "K2_ss2_plain": time_ms(lambda: composite_all_ss2(composite_bucket_into_torch)),
    }
    for name, v in ms.items():
        print(f"[6] {name:15s} {v:9.3f} ms  (median of 12, CUDA events; {card})")
    # K2's forms one at a time: (d) and (e) split the ss=2 frame's buckets;
    # (b) every bucket of the ss=1 layer frame's suffix plan over its
    # resident tiles; (c) every bucket of the K=6 batch
    def only(form, fn):
        def run(*args, rbd=None, **kw):
            if (rbd is not None) == (form == "e"):
                fn(*args, rbd=rbd, **kw)
        return run

    cl = layer_ctx[1]
    pb, db, tiles_b = cl.last_plan, cl.last_device_arrays, cl._layer_render
    cov_b = fold_extras(coverage_cuda.cov_all_cuda(db["chunk_edges"], 8, 128),
                        db["cov_map"])

    def composite_layer(bucket_fn):
        return frame_fb(cov_b, db["bucket_ids"], db["bucket_pteb"],
                        db["bucket_params"], db["bucket_ctile"], db["ct_flat"],
                        BG_APP, tile_h=8, tile_w=128, num_tiles=pb.ntx * pb.nty,
                        bucket_flags=db["bucket_flags"], bucket_fn=bucket_fn,
                        init_tiles=tiles_b)

    tbv, nt_v = vb._tables, vb._plan.ntx * vb._plan.nty
    cov_v = cov_all_resolved(vb._d["chunk_edges"], tbv["cov_map"], 8, 128)

    def composite_batch(bucket_fn):
        return frame_fb(cov_v, tbv["ids"], tbv["pteb"], vb._params, vb._ctile,
                        vb._ct_flat, BG_APP, tile_h=8, tile_w=128,
                        num_tiles=K_BATCH * nt_v, bucket_flags=vb._d["bucket_flags"],
                        bucket_fn=bucket_fn, k_rep=K_BATCH)

    k2cuda, k2plain = composite_cuda.composite_bucket_cuda, composite_bucket_into_torch
    ms.update({
        "K2d_ss2": time_ms(lambda: composite_all_ss2(only("d", k2cuda))),
        "K2d_ss2_plain": time_ms(lambda: composite_all_ss2(only("d", k2plain))),
        "K2e_ss2": time_ms(lambda: composite_all_ss2(only("e", k2cuda))),
        "K2e_ss2_plain": time_ms(lambda: composite_all_ss2(only("e", k2plain))),
        "K2b_layer": time_ms(lambda: composite_layer(k2cuda)),
        "K2b_layer_plain": time_ms(lambda: composite_layer(k2plain)),
        "K2c_batch": time_ms(lambda: composite_batch(k2cuda)),
        "K2c_batch_plain": time_ms(lambda: composite_batch(k2plain), runs=3, warmup=1),
        "layer_frame": time_ms(lambda: execute_plan(pb, BG_APP, device_arrays=db,
                                                    init_tiles=tiles_b)),
        "batch_render": time_ms(lambda: vb.render(BG_APP)),
    })
    for name in ("K2d_ss2", "K2e_ss2", "K2b_layer", "K2c_batch", "layer_frame",
                 "batch_render"):
        for key in (name, f"{name}_plain"):
            if key in ms:
                print(f"[6] {key:15s} {ms[key]:9.3f} ms  (CUDA events; {card})")
    # device time alone: the event times above include the host's launch
    # gaps (one Python wrapper call per pool and bucket)
    # torch.profiler can drop device events (a run of 12 K4 launches once
    # recorded 8), so each kernel's launches per call come from its
    # wrapper's count over the same profiled calls
    dev_ms, dev_calls, dev_launched = {}, {}, {}

    def profiled(tag, run, frames=10):
        by, calls, busy, window = device_breakdown(run, frames, zero=zero_counts)
        dev_ms[tag], dev_calls[tag] = by, calls
        dev_launched[tag] = {k: n / frames for k, n in read_counts().items()}
        return by, busy, window

    for tag, run in (("ss1", lambda: execute_plan(pl, BG, device_arrays=dv)),
                     ("ss2", lambda: execute_plan(pl2, BG, device_arrays=dv2)),
                     ("layer", lambda: execute_plan(pb, BG_APP, device_arrays=db,
                                                    init_tiles=tiles_b)),
                     ("batch", lambda: vb.render(BG_APP))):
        by, busy, window = profiled(tag, run)
        print(f"[6] steady {tag}: device busy {busy:.4f} of {window:.4f} ms per "
              f"call ({100 * busy / window:.1f}% busy; torch.profiler, 10 calls; {card})")
        for key, v in sorted(by.items(), key=lambda kv: -kv[1]):
            print(f"[6]    {key:48s} {v:.4f} ms/call")
    for tag in ("ss1", "ss2"):
        print(f"[6] steady {tag} coverage: " + ", ".join(
            f"{key} {dev_ms[tag].get(key, 0.0):.4f} ms in "
            f"{dev_calls[tag].get(key, 0.0):g} recorded launches"
            for key in ("K1", "K3", "K3 rows")) + f"; wrapper launches per frame "
            f"K1 {dev_launched[tag]['K1']:g}, K3 (both entry points) "
            f"{dev_launched[tag]['K3']:g} "
            f"(torch.profiler, 10 frames; {card})")

    # the serving paths' host time: end() (or renderFrames) to
    # torch.cuda.synchronize(), recording excluded, median of 5
    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def end_ms(c, draw) -> float:
        vg.begin(c, 0, 1920, 1080, 1.0)
        draw(c)
        return timed(lambda: vg.end(c, background=BG_APP))

    ctx_f = vg.createContext(vg.ContextConfig(frame_memo=False), device="cuda")
    end_ms(ctx_f, bench_frame)
    c_a = dict(ctx_a.profiler.counters)
    c_l = dict(layer_ctx[1].profiler.counters)
    host = {
        "end() full path": [end_ms(ctx_f, bench_frame) for _ in range(5)],
        "end() redraw": [end_ms(ctx_r, bench_frame) for _ in range(5)],
        "end() anim": [end_ms(ctx_a, overlay(6 + i)) for i in range(5)],
        "end() layer": [end_ms(layer_ctx[1], layer_frame(6 + i)) for i in range(5)],
    }
    n_a, n_l = ctx_a.profiler.counters, layer_ctx[1].profiler.counters
    if (n_a["memo_paint_hits"] - c_a["memo_paint_hits"] != 5
            or n_l["layer_hits"] - c_l["layer_hits"] != 5):
        raise AssertionError("[6] an anim or layer frame left its short path")

    def rf_ms() -> float:
        for c, case in zip(rf_ctxs, rf_cases):
            rf_record(c, case, False)
        return timed(lambda: vg.renderFrames(rf_ctxs))

    host["renderFrames (3 contexts)"] = [rf_ms() for _ in range(5)]
    for name, ts in host.items():
        print(f"[6] {name:26s} {statistics.median(ts):9.3f} ms host  (median of 5, "
              f"to torch.cuda.synchronize(); {[round(t, 3) for t in ts]}; {card})")
    batch_ms = measure_batch_ms_per_frame(vb, BG_APP, reps_hi=8, reps_lo=2)
    print(f"[6] measure_batch_ms_per_frame K={K_BATCH}: {batch_ms:.4f} ms per variant "
          f"frame (CUDA events, 8 - 2 renders) beside the steady single frame "
          f"{ms['frame']:.4f} ms ({card})")

    # the multi-GPU paths from resident shards (partitioned and uploaded
    # once): CUDA events on cuda:0, where every shard's framebuffer lands
    sharded = {n: shard_frame(ctx.last_plan, mesh) for n, mesh in sharded.items()}
    sharded_fused = {(ss, n): shard_frame_fused((ctx if ss == 1 else ctx2).last_plan, mesh)
                     for (ss, n), mesh in sharded_fused.items()}
    for n, sf in sharded.items():
        ms[f"sharded n={n}"] = time_ms(lambda sf=sf: sf.render(ctx.background))
    for (ss, n), sf in sharded_fused.items():
        c = ctx if ss == 1 else ctx2
        ms[f"sharded fused ss={ss} n={n}"] = time_ms(
            lambda sf=sf, c=c: sf.render(c.background))
    for name, sf in [(f"sharded n={n}", sf) for n, sf in sharded.items()] + [
            (f"sharded fused ss={ss} n={n}", sf)
            for (ss, n), sf in sharded_fused.items()]:
        print(f"[6] {name:26s} {ms[name]:9.3f} ms  (median of 12, CUDA events; "
              f"{mesh_note(sf.mesh)}; {card})")
    # K4 over the n = 1 shard's pools (every live chunk of the frame)
    k4_pools = sharded[1].shards[0]["chunk_edges"]
    ms["K4"] = time_ms(lambda: coverage_t_cuda.coverage_pools_t_cuda(k4_pools, 8, 128))
    ms["K4_plain"] = time_ms(lambda: [coverage_chunks_t_torch(ce, 8, 128)
                                      for ce in k4_pools])
    for key in ("K4", "K4_plain"):
        print(f"[6] {key:15s} {ms[key]:9.3f} ms  (median of 12, CUDA events; pools "
              f"{[tuple(ce.shape[:2]) for ce in k4_pools]}; {card})")
    by, busy, window = profiled("sharded", lambda: sharded[1].render(ctx.background),
                                frames=3)
    print(f"[6] sharded n=1: device busy {busy:.4f} of {window:.4f} ms per frame "
          f"({100 * busy / window:.1f}% busy; torch.profiler, 3 frames; {card})")
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    for key, v in top + ([] if "K4" in dict(top) else [("K4", by.get("K4", 0.0))]):
        print(f"[6]    {key:48s} {v:.4f} ms/frame")
    print("[6] K4 launches per shard (one launch over a shard's pools): " + ", ".join(
        f"{name} {paths[name]['K4'] / n:g} ({paths[name]['K4']} over {n} shard(s))"
        for name, n in (("sharded n=1", 1), ("sharded n=2", 2), ("sharded n=4", 4),
                        ("render_sharded n=4", 4))) + f"; profiled n = 1 frame "
        f"{dev_launched['sharded']['K4']:g} launches")
    ms["render_sharded"] = time_ms(lambda: vb.render_sharded(mesh4, BG_APP), runs=5,
                                   warmup=1)
    print(f"[6] render_sharded K={K_BATCH} over {mesh_note(mesh4)}: "
          f"{ms['render_sharded']:.3f} ms, {ms['render_sharded'] / K_BATCH:.3f} ms per "
          f"variant (median of 5, CUDA events; {card})")

    # K5-K8 beside their twins at the shapes of the paths that run them: K5
    # and K6 over the frame's pools (with K4 there too; K1 is timed on them
    # above), K7 over the [5c] frame's buckets with ew_t and the colour tiles
    # gathered beforehand, K8 on the cold probe's (256, 128), beside
    # torch.add(1, x, alpha=2), one PyTorch call of the same function
    npx = 8 * 128
    ne5 = pl.entry_backdrop.shape[0]
    entry_w5 = (entry_coverage_from_pools(dv["chunk_edges"], cents5, ne5, 8, 128)
                + torch.from_numpy(pl.entry_backdrop).to(dev)[:, :, None]).reshape(ne5, -1)
    bg_col = torch.tensor(BG, device=dev).repeat_interleave(npx)[:, None]
    k7_in = [(entry_w5[te].permute(1, 2, 0).contiguous(), pp,
              dv["ct_flat"][ct].permute(1, 2, 0).contiguous() if fl[2] else None, fl)
             for te, pp, ct, fl in zip(dv["bucket_te"], dv["bucket_params"],
                                       dv["bucket_ctile"], dv["bucket_flags"])]

    def k7_all(fn):
        for ew, pp, ct, fl in k7_in:
            fn(ew, pp, ct, bg_col, tile_w=128, flags=fl, add_backdrop=False)

    # K7 against its twin on every [5c] bucket in k7_settings' four settings
    # (the [5c] frame's own is entry_w), both block forms among them
    tally5 = {"runs": {}, "forms": set()}
    err5 = 0.0
    for i, ((ew, pp, ct, fl), pteb) in enumerate(zip(k7_in, dv["bucket_pteb"])):
        ew_cov = cov_res[pteb].permute(1, 2, 0).contiguous()
        err5 = max(err5, check_k7(f"[5c] bucket {i}", fl,
                                  k7_settings(rng, ew_cov, ew, pp, ct, bg_col), sms,
                                  tally5))
    k7_err = max(k7_err, err5)
    pix5 = sorted({pix for _g, pix in tally5["forms"]})
    print(f"[6] K7 on the {len(k7_in)} [5c] buckets: runs {tally5['runs']}; (G, pixels "
          f"a thread) {sorted(tally5['forms'])}; max|K7 - plain| = {err5:.3e} (bound "
          f"{K2_BOUND:.0e})")
    if pix5 != sorted((composite_flat_cuda.PIX_NARROW, composite_flat_cuda.PIX_WIDE)):
        raise AssertionError(f"[6] the [5c] buckets held only K7's {pix5}-pixel form "
                             f"to the twin")

    # K7's live slots on the [5c] buckets: the (tile, slot) pairs valid; the
    # (warp, slot) pairs a warp of 32 tiles skips (no tile valid); and the
    # invalid (tile, slot) pairs of real tiles it still walks (a tile whose
    # slot is invalid in a slot its warp walks keeps c = 0)
    from vgtpu_torch.ops.composite import _P_VALID

    n_pairs = n_valid = n_wslots = n_wskip = n_walked_invalid = 0
    tiles = composite_flat_cuda.TILES
    for (_ew, pp, _ct, _fl), ids in zip(k7_in, dv["bucket_ids"]):
        valid = pp[:, _P_VALID, :] > 0                        # (MO, Nb)
        real = ids < nt
        n_pairs += int(valid[:, real].numel())
        n_valid += int(valid[:, real].sum())
        mo_b, nbo_b = valid.shape
        groups = -(-nbo_b // tiles)
        padded = torch.zeros((mo_b, groups * tiles), dtype=torch.bool,
                             device=valid.device)
        padded[:, :nbo_b] = valid
        real_p = torch.zeros(groups * tiles, dtype=torch.bool, device=valid.device)
        real_p[:nbo_b] = real
        per_warp = padded.reshape(mo_b, groups, tiles)
        live = per_warp.any(dim=2)                            # (MO, groups)
        n_wslots += int(live.numel())
        n_wskip += int((~live).sum())
        n_walked_invalid += int((live[:, :, None] & ~per_warp
                                 & real_p.reshape(1, groups, -1)).sum())
    k7_regs = {}
    for mangled, (regs, spill) in ptxas_by_kernel(composite_flat_cuda.K7.build_log).items():
        m = re.search(r"ILi(\d+)ELi(\d+)EE", mangled)
        if m:
            k7_regs[(int(m.group(1)), int(m.group(2)))] = (regs, spill)
    used = sorted({(composite_flat_cuda.k7_instantiation(fl)[0],
                    composite_flat_cuda.k7_geometry(
                        int(pp.shape[0]), npx, 128, int(pp.shape[2]), False,
                        composite_flat_cuda.k7_instantiation(fl)[0],
                        sms)["pixels_per_thread"])
                   for (_ew, pp, _ct, fl) in k7_in})
    print(f"[6] K7 on the [5c] buckets: (tile, slot) pairs valid {n_valid} of {n_pairs} "
          f"({100 * n_valid / max(n_pairs, 1):.1f}%, real tiles); (warp, slot) pairs "
          f"skipped {n_wskip} of {n_wslots} ({100 * n_wskip / max(n_wslots, 1):.1f}%); "
          f"invalid (tile, slot) pairs of real tiles still walked {n_walked_invalid} "
          f"of {n_pairs - n_valid} "
          f"({100 * n_walked_invalid / max(n_pairs - n_valid, 1):.1f}%)")
    print(f"[6] ptxas K7 per instantiation (G: grad 1, tri 2, tex 4, clip 8; pixels a "
          f"thread): { {k: k7_regs[k] for k in sorted(k7_regs)} } (registers, spill "
          f"bytes); the [5c] buckets take (G, pixels) in {used} on {sms} SMs: "
          f"{ {k: k7_regs.get(k) for k in used} }")

    x8 = torch.from_numpy(np.random.default_rng(SEED).normal(
        0, 1e3, cold_probe.SHAPE).astype(np.float32)).to(dev)
    one8 = torch.ones_like(x8)
    y8 = probe_cuda.probe_affine_cuda(x8)
    k8_err = float((y8 - cold_probe.probe_affine_torch(x8)).abs().max())
    lib_err = float((y8 - torch.add(one8, x8, alpha=2.0)).abs().max())
    print(f"[6] K8 on {tuple(x8.shape)}: max|K8 - plain| = {k8_err:.3e}, "
          f"max|K8 - torch.add| = {lib_err:.3e} (exact)")
    if k8_err != 0.0:
        raise AssertionError(f"K8 disagrees with its plain twin: {k8_err}")
    fpools = dv["chunk_edges"]
    ms.update({
        "K5": time_ms(lambda: [coverage_t_flat_cuda.coverage_chunks_t_flat_cuda(
            ce, 8, 128) for ce in fpools]),
        "K5_plain": time_ms(lambda: [coverage_chunks_t_torch(ce, 8, 128) for ce in fpools]),
        "K4 frame pools": time_ms(lambda: coverage_t_cuda.coverage_pools_t_cuda(
            fpools, 8, 128)),
        "K6": time_ms(lambda: [coverage_slots_cuda.coverage_chunks_slots_cuda(
            ce, 8, 128) for ce in fpools]),
        "K6_plain": time_ms(lambda: [coverage_chunks_torch(ce, 8, 128) for ce in fpools]),
        "K7": time_ms(lambda: k7_all(composite_flat_cuda.composite_bucket_flat_cuda)),
        "K7_plain": time_ms(lambda: k7_all(composite_bucket_torch)),
        "K8": time_ms(lambda: probe_cuda.probe_affine_cuda(x8)),
        "K8_plain": time_ms(lambda: cold_probe.probe_affine_torch(x8)),
        "K8_library": time_ms(lambda: torch.add(one8, x8, alpha=2.0)),
        "flat_frame_K5": time_ms(lambda: execute_plan_flat(pl, dv, cents5, BG, "K5")),
        "flat_frame_K6": time_ms(lambda: execute_plan_flat(pl, dv, cents5, BG, "K6")),
    })
    for key in ("K5", "K5_plain", "K4 frame pools", "K6", "K6_plain", "K1", "K7",
                "K7_plain", "K8", "K8_plain", "K8_library", "flat_frame_K5",
                "flat_frame_K6", "frame"):
        print(f"[6] {key:15s} {ms[key]:9.3f} ms  (median of 12, CUDA events; {card})")
    for tag, run in (("flat K5", lambda: execute_plan_flat(pl, dv, cents5, BG, "K5")),
                     ("flat K6", lambda: execute_plan_flat(pl, dv, cents5, BG, "K6")),
                     ("K8", lambda: probe_cuda.probe_affine_cuda(x8)),
                     ("K8 library", lambda: torch.add(one8, x8, alpha=2.0))):
        by, busy, window = profiled(tag, run)
        print(f"[6] {tag}: device busy {busy:.4f} of {window:.4f} ms per call "
              f"({100 * busy / window:.1f}% busy; torch.profiler, 10 calls; {card})")
        for key, v in sorted(by.items(), key=lambda kv: -kv[1])[:8]:
            print(f"[6]    {key:48s} {v:.4f} ms/call")
    for key in ("K5", "K6"):
        print(f"[6] {key} device ms per [5c] frame: {dev_ms[f'flat {key}'][key]:.4f} in "
              f"{dev_launched[f'flat {key}'][key]:g} launches ({len(fpools)} pools; "
              f"torch.profiler, 10 frames; {card})")

    # the launch route: host us per call of K8's wrapper and of torch.add,
    # and of each step of the route (utils/launch_route.py); the steady
    # ss=1 frame's host ms from call to return; and its CPU trace, which must
    # hold no host-side wait
    route = launch_route.measure(x8)
    print(f"[6] launch route: probe_affine_cuda {route['wrapper']:.3f} us/call, "
          f"torch.add {route['torch_add']:.3f} us/call "
          f"({route['wrapper_over_torch_add']:.3f}x; host clock, mean of "
          f"{route['calls']} back-to-back calls, median of {route['repeats']}; "
          f"{card})")
    print(f"[6] launch route steps (host us/call): " + json.dumps(
        {k: round(v, 4) for k, v in route.items() if isinstance(v, float)}))
    host_ret = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        execute_plan(pl, BG, device_arrays=dv)
        host_ret.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    ms["frame_host_return"] = statistics.median(host_ret[5:])
    print(f"[6] steady ss=1 frame: {ms['frame_host_return']:.3f} ms host from call "
          f"to return, before the synchronise (median of 20; {card})")
    for tag, run in (("ss=1", lambda: execute_plan(pl, BG, device_arrays=dv)),
                     ("ss=2", lambda: execute_plan(pl2, BG, device_arrays=dv2)),
                     ("layer", lambda: execute_plan(pb, BG_APP, device_arrays=db,
                                                    init_tiles=tiles_b))):
        waits = host_waits(run)
        print(f"[6] steady {tag} frame, CPU trace of 5 frames: host-side waits "
              f"{waits['waits']}, runtime calls {waits['runtime']}; "
              f"{waits['launch_events'] / 5:g} kernel launches per frame")
        if waits["waits"]:
            raise AssertionError(f"[6] the steady {tag} frame waits on the host: "
                                 f"{waits}")
    # the retained pan: ms per frame over vgtpu's scrolling sequence, the
    # device's busy share and launches per pan frame, K1's and K2's device
    # ms in it, one render's host ms from call to return, and its CPU trace
    for label, sc in pan["scenes"].items():
        pan_ms = measure_pan_ms_per_frame(sc, reps_hi=32, reps_lo=2)
        tag = f"pan {label}"
        by, busy, window = profiled(tag, lambda sc=sc: sc.render(37, 5))
        rets = []
        for _ in range(25):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc.render(37, 5)
            rets.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        waits = host_waits(lambda sc=sc: sc.render(37, 5))
        ms[tag] = pan_ms
        print(f"[6] {tag}: measure_pan_ms_per_frame {pan_ms:.4f} ms per frame (CUDA "
              f"events, 32 - 2 frames); device busy {busy:.4f} of {window:.4f} ms per "
              f"frame ({100 * busy / window:.1f}% busy; torch.profiler, 10 frames); "
              f"{sum(dev_calls[tag].values()):g} device events and "
              f"{waits['launch_events'] / 5:g} kernel launches per frame (K1 "
              f"{dev_launched[tag]['K1']:g}, K2 {dev_launched[tag]['K2']:g}); host "
              f"{statistics.median(rets[5:]):.3f} ms from call to return (median of "
              f"20); bake {pan['bake_ms'][label]:.1f} ms host; {card}")
        print(f"[6]    device ms per pan frame: " + ", ".join(
            f"{key} {by.get(key, 0.0):.4f}" for key in ("K1", "K2 (a)/(d)"))
            + "; the rest: " + ", ".join(
                f"{key} {v:.4f}" for key, v in sorted(by.items(), key=lambda kv: -kv[1])
                if key not in ("K1", "K2 (a)/(d)"))[:600])
        if waits["waits"]:
            raise AssertionError(f"[6] the {tag} frame waits on the host: {waits}")
    print(f"[6] textures stage (host ms, first frame / same frame again / panels "
          f"moved): numpy sampler "
          f"{' / '.join(f'{t:.3f}' for t in samp['stage_ms'][False])}, device sampler "
          f"{' / '.join(f'{t:.3f}' for t in samp['stage_ms'][True])}; the device "
          f"sampler alone {samp['sampler_ms']:.4f} ms ({card})")
    if ms["K8"] > 1.1 * ms["K8_library"]:
        print(f"[6] note: K8 {ms['K8']:.4f} ms is over 1.1x torch.add's "
              f"{ms['K8_library']:.4f} ms (CUDA events)")

    stamp("[6]")

    # ---- 9. cold start ----------------------------------------------------
    # each phase a fresh process with jax blocked; phase 2's builds left the
    # kernel cache warm, as the TPU probe ran with its compile cache warm
    cold = {name: cold_probe.run_phase(name) for name in cold_probe.PHASES}
    for name, r in cold.items():
        print(f"[9] cold {name}: {json.dumps(r)} ({card})")
    if cold["K8"]["max_abs_err"] != 0.0 or cold["K8"]["launches"] < 1:
        raise AssertionError(f"[9] the cold K8 phase: {cold['K8']}")
    fr9 = cold["frame"]
    if fr9["shape"] != [1080, 1920, 4] or not fr9["finite"] or min(
            fr9["launches"].values()) < 1:
        raise AssertionError(f"[9] the cold frame: {fr9}")
    # the K8 phase's process started with every count at 0
    paths["cold probe K8"] = {**dict.fromkeys(read_counts(), 0),
                              "K8": cold["K8"]["launches"]}

    # achieved rates and each kernel's bound from this run's shapes
    k1_flop = sum(int(ce.shape[0]) * int(ce.shape[1]) for ce in dv["chunk_edges"]) \
        * npx * 25                       # ~25 float ops per edge and pixel
    k1_bytes = sum(ce.numel() * 4 + int(ce.shape[0]) * npx * 4
                   for ce in dv["chunk_edges"])
    # K3: 2*npx sub-pixels per chunk, ~25 ops per edge + ~15 of epilogue
    k3_flop = sum(int(ce.shape[0]) * 2 * npx * (25 * int(ce.shape[1]) + 15)
                  for ce in dv2["chunk_edges"][:k])
    nxe2 = res2["xe_primary_raw"].shape[0]
    k3_bytes = (sum(ce.numel() * 4 + int(ce.shape[0]) * npx * 4
                    for ce in dv2["chunk_edges"][:k])
                + sum(rp.numel() * 4 for rp in res2["rparams"])
                + nxe2 * (2 * npx * 4 + npx * 4) + res2["xe_rparams"].numel() * 4)
    split2 = [(fin2 if rbd is not None else sub2, pteb, pp, dv2["ct_flat"], ct, ids, rbd)
              for pteb, pp, ct, ids, rbd in zip(
                  dv2["bucket_pteb"], dv2["bucket_params"], dv2["bucket_ctile"],
                  dv2["bucket_ids"], dv2["bucket_rbd"])]
    work = {
        "K1": (k1_bytes, k1_flop),
        "a": k2_work([(cov_res, *b, None) for b in zip(
            dv["bucket_pteb"], dv["bucket_params"], [dv["ct_flat"]] * 99,
            dv["bucket_ctile"], dv["bucket_ids"])], npx, 1, nt),
        "b": k2_work([(cov_b, *b, None) for b in zip(
            db["bucket_pteb"], db["bucket_params"], [db["ct_flat"]] * 99,
            db["bucket_ctile"], db["bucket_ids"])], npx, 1, pb.ntx * pb.nty,
            init=True),
        "c": k2_work([(cov_v, *b, None) for b in zip(
            tbv["pteb"], vb._params, [vb._ct_flat] * 99, vb._ctile, tbv["ids"])],
            npx, 1, K_BATCH * nt_v),
        "d": k2_work([b for b in split2 if b[6] is None], npx, 2, nt2),
        "e": k2_work([b for b in split2 if b[6] is not None], npx, 2, nt2),
        "K3": (k3_bytes, k3_flop),
        # K4 over the live chunk slots of the n = 1 partition, counted as K1's
        "K4": (sum(live * (int(ce.shape[1]) * 16 + npx * 4)
                   for live, ce in zip(sharded[1].meta["chunk_slots_live"], k4_pools)),
               sum(live * int(ce.shape[1]) * npx * 25
                   for live, ce in zip(sharded[1].meta["chunk_slots_live"], k4_pools))),
        # K5 and K6: K1's function over the same pools
        "K5": (k1_bytes, k1_flop),
        "K6": (k1_bytes, k1_flop),
        "K7": k7_work([(*b[:3], ids) for b, ids in zip(k7_in, dv["bucket_ids"])],
                      npx, nt),
        # K8: x read, out written, a multiply and an add per element
        "K8": (2 * x8.numel() * 4, 2 * x8.numel()),
    }
    # the coverage kernels' live count: K1 and K3 add an edge to a row only
    # where h > 0 (edge_row_live, their masks' test), so the dense count
    # above is no bound for them; per live (edge, row) pair ~12 operations
    # per pixel of the row and ~6 for the row part, and K3's epilogue per
    # sub-pixel.  K4-K6 compute the same function, so the same least work
    # bounds them.
    per_pair = 128 * 12 + 6

    def live_pairs(pools, th):
        live = [edge_row_live(ce, th) for ce in pools]
        return (sum(int(m.sum()) for m in live), sum(m.numel() for m in live),
                sum(int((~m.any(dim=(1, 2))).sum()) for m in live),
                [round(float(m.float().mean()), 4) if m.numel() else None
                 for m in live])

    lp = {"ss=1 frame": live_pairs(dv["chunk_edges"], 8),
          "ss=2 RAW pools": live_pairs(dv2["chunk_edges"][k:], 16),
          "ss=2 RES pools": live_pairs(dv2["chunk_edges"][:k], 16),
          "n = 1 shard (K4)": live_pairs(k4_pools, 8)}
    for name, (n_live, n_all, dead, shares) in lp.items():
        print(f"[6] live (edge, row) pairs, {name}: {n_live} of {n_all} "
              f"({100 * n_live / n_all:.1f}%), per pool {shares}; {dead} chunks "
              f"with no live pair (h > 0, edge_row_live)")
    nres_chunks = sum(int(ce.shape[0]) for ce in dv2["chunk_edges"][:k])
    dense_work = {key: work[key] for key in ("K1", "K3", "K4", "K5", "K6")}
    k1_live = lp["ss=1 frame"][0] * per_pair
    work.update({
        "K1": (k1_bytes, k1_live),
        "K3": (k3_bytes, lp["ss=2 RES pools"][0] * per_pair + nres_chunks * 2 * npx * 15),
        "K4": (work["K4"][0], lp["n = 1 shard (K4)"][0] * per_pair),
        "K5": (k1_bytes, k1_live),
        "K6": (k1_bytes, k1_live),
    })
    for key, (nb, ops) in work.items():
        bms, by_ = bound(nb, ops)
        dense = ""
        if key in dense_work:
            dms, dby = bound(*dense_work[key])
            dense = (f"; dense count {dense_work[key][1] / 1e9:.2f} G operations -> "
                     f"{dms:.4f} ms by {dby}")
        print(f"[6] work {key}: {nb / 1e6:.1f} MB, {ops / 1e9:.2f} G operations -> "
              f"bound {bms:.4f} ms by {by_}{dense} (67 TFLOP/s FP32, 3.35 TB/s HBM)")
    for key in ("K1", "K3", "K4", "K5", "K6", "K7"):
        print(f"[6] ptxas {key} ({kernels[key].name}.cu): "
              f"{ptxas_summary(kernels[key].build_log)}")
    for key in ("K5", "K6"):
        print(f"[6] ptxas {key} per kernel (registers, spill bytes): "
              f"{ptxas_by_kernel(kernels[key].build_log)}")
    print(f"[6] K5 and K6 on the [5c] frame's pools: live (edge, row) pairs "
          f"{lp['ss=1 frame'][0]} of {lp['ss=1 frame'][1]} "
          f"({100 * lp['ss=1 frame'][0] / lp['ss=1 frame'][1]:.1f}%); bound "
          f"{bound(*work['K5'])[0]:.4f} ms live, {bound(*dense_work['K5'])[0]:.4f} "
          f"dense; device {dev_ms['flat K5']['K5']:.4f} (K5), "
          f"{dev_ms['flat K6']['K6']:.4f} (K6) ms per frame ({card})")
    k1_rate = k1_flop / (ms["K1"] * 1e-3) / 1e12
    k2_rate = work["a"][0] / (ms["K2"] * 1e-3) / 1e12
    k3_rate = k3_flop / (ms["K3_ss2"] * 1e-3) / 1e12
    print(f"[6] K1 ~{k1_flop / 1e9:.2f} GFLOP -> {k1_rate:.1f} TFLOP/s "
          f"({100 * k1_rate / 67:.0f}% of 67 FP32 peak; {card})")
    print(f"[6] K2 (a) ~{work['a'][0] / 1e6:.1f} MB read+written -> {k2_rate:.3f} TB/s "
          f"({100 * k2_rate / 3.35:.0f}% of 3.35 HBM peak; {card})")
    print(f"[6] K3 (ss=2, RES pools) ~{k3_flop / 1e9:.2f} GFLOP -> {k3_rate:.1f} "
          f"TFLOP/s ({100 * k3_rate / 67:.0f}% of 67 FP32 peak; {card})")

    elapsed = time.perf_counter() - t_start
    print(f"[6] chip_smoke wall time {elapsed:.1f} s")
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "vgtpu.")) or m == "vgtpu")
    if leaked:
        raise AssertionError(f"chip_smoke imported {leaked}")

    def entry(name, key, source, replaces, err, t, t_plain, tag, dev_keys,
              **extra):
        """One kernel's record: launches summed over the main paths' runs
        (phases 4e, 4f, 5, 5b, 5c, 7, 8, 9, 10a, 10b and 11), the bound from this run's
        shapes (for the coverage kernels the live count; [6] prints the
        dense one beside it), its launches per call of the run `tag` that times
        it (the wrapper's count), its device ms per call (torch.profiler's ms per recorded
        event under dev_keys x those launches), and the main paths' excess
        over the bound: launches x (device ms - bound ms) per launch."""
        by_path = {p: c[key] for p, c in paths.items() if c[key]}
        wkey = key.split()[-1].strip("()")
        bms, by_ = bound(*work[wkey])
        n = sum(by_path.values())
        dev_t, per_call, events = dev_per_call(tag, key, dev_keys)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "launches_by_path": by_path, "max_abs_err": err, "ms": t,
                "plain_ms": t_plain, "bound_ms": bms, "bound_by": by_,
                "library_ms": None, "device_ms": dev_t, "per_call": per_call,
                "events_per_call": events, "excess_ms": n * (dev_t - bms) / per_call,
                **extra}

    def dev_per_call(tag, key, dev_keys):
        """(device ms per call, launches per call, recorded events per call)
        of kernel `key` in the profiled run `tag`."""
        events = sum(dev_calls[tag].get(k, 0.0) for k in dev_keys)
        per_call = dev_launched[tag][key]
        if not events or not per_call:
            raise AssertionError(f"[6] {key} in the {tag} run: {per_call} launches, "
                                 f"{events} recorded events per call")
        dev_t = sum(dev_ms[tag].get(k, 0.0) for k in dev_keys) / events * per_call
        return dev_t, per_call, events

    k2src = "vgtpu_torch/csrc/composite.cu"
    k2rep = "vgtpu/ops/composite_pallas.py:181"
    k2 = ("K2 (a)/(d)",)

    def k2_shared(flags_list, ss, final=False, clip_only=None):
        """K2's pipeline depth, threads and the dynamic shared bytes of each
        launch of a form over the buckets with these lane flags (clip_only:
        only the clip (True) or non-clip (False) buckets)."""
        geos = [composite_cuda.k2_geometry(8, 128, ss, final=final, clip=bool(f[3]),
                                           tex=bool(f[2]))
                for f in flags_list if clip_only is None or bool(f[3]) == clip_only]
        return {"stages": composite_cuda.STAGES,
                "threads": sorted({g["threads"] for g in geos}),
                "smem_bytes": sorted({g["smem_bytes"] for g in geos})}

    records = [
        entry("K1 chunk coverage", "K1", "vgtpu_torch/csrc/coverage.cu",
              "vgtpu/ops/coverage_pallas.py:254", k1_err, ms["K1"], ms["K1_plain"],
              "ss1", ("K1",), ms_ss2=ms["K1_ss2"], plain_ms_ss2=ms["K1_ss2_plain"],
              device_ms_ss2=dev_per_call("ss2", "K1", ("K1",))[0]),
        entry("K2 (a) painter composite, ss=1", "K2 (a)", k2src, k2rep,
              k2_form_err["a"], ms["K2"], ms["K2_plain"], "ss1", k2,
              **k2_shared(dv["bucket_flags"], 1)),
        entry("K2 (b) per-tile init planes (layer memo)", "K2 (b)", k2src,
              f"{k2rep} (form :577)", k2_form_err["b"], ms["K2b_layer"],
              ms["K2b_layer_plain"], "layer", k2, **k2_shared(db["bucket_flags"], 1)),
        entry("K2 (c) k_rep variant blocks (VariantBatch)", "K2 (c)", k2src,
              f"{k2rep} (form :550)", k2_form_err["c"], ms["K2c_batch"],
              ms["K2c_batch_plain"], "batch", k2,
              **k2_shared(vb._d["bucket_flags"], 1)),
        entry("K2 (d) sub-row coverage, ss>1", "K2 (d)", k2src, k2rep,
              k2_form_err["d"], ms["K2d_ss2"], ms["K2d_ss2_plain"], "ss2", k2,
              **k2_shared(dv2["bucket_flags"], 2, clip_only=True)),
        entry("K2 (e) final coverage + rbd, ss>1", "K2 (e)", k2src, k2rep,
              k2_form_err["e"], ms["K2e_ss2"], ms["K2e_ss2_plain"], "ss2", ("K2 (e)",),
              **k2_shared(dv2["bucket_flags"], 2, final=True, clip_only=False)),
        entry("K3 resolved chunk coverage", "K3", "vgtpu_torch/csrc/coverage_resolve.cu",
              "vgtpu/ops/coverage_resolve.py:204", k3_err, ms["K3_ss2"],
              ms["K3_ss2_plain"], "ss2", ("K3", "K3 rows")),
        entry("K4 pixel-major chunk coverage", "K4", "vgtpu_torch/csrc/coverage_t.cu",
              "vgtpu/ops/coverage_pallas.py:158", k4_err, ms["K4"], ms["K4_plain"],
              "sharded", ("K4",)),
        entry("K5 pixel-major chunk coverage, flat form", "K5",
              "vgtpu_torch/csrc/coverage_t_flat.cu", "vgtpu/ops/coverage_pallas.py:132",
              k5_err, ms["K5"], ms["K5_plain"], "flat K5", ("K5",),
              k4_ms_same_pools=ms["K4 frame pools"]),
        entry("K6 chunk coverage, edge slot by slot", "K6",
              "vgtpu_torch/csrc/coverage_slots.cu", "vgtpu/ops/coverage_pallas.py:25",
              k6_err, ms["K6"], ms["K6_plain"], "flat K6", ("K6",)),
        entry("K7 flat painter composite, ss=1", "K7", "vgtpu_torch/csrc/composite_flat.cu",
              "vgtpu/ops/composite_pallas.py:384", k7_err, ms["K7"], ms["K7_plain"],
              "flat K5", ("K7",)),
        entry("K8 cold-dispatch probe x*2+1", "K8", "vgtpu_torch/csrc/probe.cu",
              "tools/probe_cold_tax.py:58", k8_err, ms["K8"], ms["K8_plain"],
              "K8", ("K8",), library_ms=ms["K8_library"],
              library_device_ms=sum(dev_ms["K8 library"].values())),
    ]
    # the order for the kernels' speed work: first a kernel slower than one
    # PyTorch call of its function (CUDA events), then by the main paths'
    # excess over the bound; one within 2x its bound is left alone
    for r in sorted(records, key=lambda r: (r["library_ms"] is None
                                            or r["ms"] <= r["library_ms"],
                                            -r["excess_ms"])):
        note = ("within 2x its bound" if r["device_ms"] <= 2 * r["bound_ms"] else
                f"{r['device_ms'] / r['bound_ms']:.1f}x its bound")
        if r["library_ms"] is not None:
            note += (f"; {r['ms']:.4f} ms against one PyTorch call's "
                     f"{r['library_ms']:.4f} (CUDA events)")
        print(f"[6] speed order: {r['name']}: {r['launches']} launches x "
              f"({r['device_ms']:.4f} - {r['bound_ms']:.4f}) ms / {r['per_call']:g} "
              f"launches per call ({r['events_per_call']:g} recorded by torch.profiler) "
              f"= {r['excess_ms']:.3f} ms; {note} ({card})")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
