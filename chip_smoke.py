#!/usr/bin/env python3
"""Smoke test of vgtpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):
  1. CUDA present; print the card's name and power limit (nvidia-smi).
  2. Build kernels K1 (csrc/coverage.cu), K2 (csrc/composite.cu) and K3
     (csrc/coverage_resolve.cu) with nvcc from the checkout, one nvcc each,
     all started together; print the build seconds and ptxas's register and
     spill report.
  3. K1 against its plain twin coverage_chunks_torch on the card: random
     chunks (horizontal, near-vertical, tiny-dy, zero-length, out-of-tile
     edges) at CH = 2, 4, 8, 24 and the 1080p frame's pool sizes.
  3b. K3 against coverage_chunks_res_torch: random chunks at ss = 2, 4 and
     CH = 2, 4, 6, 12, 24 with random resolve params (even-odd, non-AA,
     texture, scissor, backdrop), and the RES pools of the 1080p ss=2 plan;
     K3's vg_resolve_rows against resolve_cov_rows_torch on its XE rows.
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
  5. The main path: createContext(device="cuda"), begin 1920x1080,
     scenes.demo_ui.draw_benchmark_frame, end().  Both kernels' launch
     counts must be > 0; the image must match the same plan through the
     plain twins on the card within 1 u8 level, and the small scene must
     match the CPU path within 1 u8 level.
  5b. The main path in parity mode: createContext(ContextConfig(
     coverage_supersample=2), device="cuda"), the same frame; K1, K2 and K3
     launch counts > 0; the image within 1 u8 level of the plain twins on
     the same plan; the small scene at ss = 2, 4 and 8 within 1 u8 level of
     the CPU path.
  6. Times (CUDA events, median of 12 runs after warm-up): the steady frame
     from resident arrays at ss=1 and ss=2, K1, K2 and K3 beside their plain
     twins; then each kernel's device time per steady frame and the device's
     busy share (torch.profiler over 10 frames).

The last two lines are the kernels' JSON record and the contract line
{"ok": true, "device": {...}}.  Imports neither jax nor vgtpu.
"""

from __future__ import annotations

import concurrent.futures
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


def device_breakdown(run, frames: int = 10):
    """torch.profiler over `frames` calls of run(): device ms per frame by
    kernel (K1, K2 forms, K3 entry points, the rest by name), device-busy ms
    per frame, and the window from the first device op to the last."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            run()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        raise AssertionError("torch.profiler recorded no device time")
    names = (("coverage_chunks_kernel", "K1"), ("coverage_res_kernel", "K3"),
             ("resolve_rows_kernel", "K3 rows"), ("composite_final_kernel", "K2 (e)"),
             ("composite_bucket_kernel", "K2 (a)/(d)"))
    by = {}
    for e in ev:
        key = next((k for n, k in names if n in e.name), e.name[:48])
        by[key] = by.get(key, 0.0) + e.device_time / 1e3 / frames
    busy = sum(e.device_time for e in ev) / 1e3 / frames
    window = (max(e.time_range.end for e in ev)
              - min(e.time_range.start for e in ev)) / 1e3 / frames
    return by, busy, window


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
    from vgtpu_torch.ops import composite_cuda, coverage_cuda, coverage_resolve_cuda
    from vgtpu_torch.ops.composite import composite_bucket_into_torch, frame_fb
    from vgtpu_torch.ops.coverage import (
        cov_all_resolved_torch,
        cov_all_torch,
        fold_extras,
    )
    from vgtpu_torch.ops.coverage_resolve import (
        cov_split_resolved,
        cov_split_resolved_torch,
        coverage_chunks_res_torch,
        resolve_cov_rows_torch,
    )
    from vgtpu_torch.raster.frame import execute_plan, execute_plan_torch, image_to_u8
    from vgtpu_torch.scenes import demo_ui
    from vgtpu_torch.scenes.small import (
        HEIGHT,
        WIDTH,
        draw_feature_scene,
        draw_resolve_scene,
        draw_small_scene,
    )

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
    kernels = {"K1": K1, "K2": K2, "K3": K3}
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
    pools_nc = [int(ce.shape[0]) for ce in d["chunk_edges"]]
    for ch in (2, 4, 8, 24):
        nc = next((n for n, ce in zip(pools_nc, d["chunk_edges"])
                   if ce.shape[1] == ch), 2048)
        nc = min(max(nc, 2048), 8192)
        edges = torch.from_numpy(random_chunks(rng, nc, ch)).to(dev)
        got = coverage_cuda.cov_all_cuda([edges], 8, 128)
        ref = cov_all_torch([edges], 8, 128)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        k1_err = max(k1_err, err)
        print(f"[3] K1 CH={ch:2d} NC={nc}: max|K1 - plain| = {err:.3e} "
              f"(bound {K1_BOUND:.0e})")
        if not err <= K1_BOUND:
            raise AssertionError(f"K1 disagrees with its plain twin at CH={ch}: {err}")
    cov = coverage_cuda.cov_all_cuda(d["chunk_edges"], 8, 128)
    cov_ref = cov_all_torch(d["chunk_edges"], 8, 128)
    err = float((cov - cov_ref).abs().max())
    k1_err = max(k1_err, err)
    print(f"[3] K1 on the 1080p pools {pools_nc}: max|K1 - plain| = {err:.3e}")
    if not err <= K1_BOUND:
        raise AssertionError(f"K1 disagrees on the 1080p pools: {err}")

    # ---- 3b. K3 vs plain ------------------------------------------------
    k3_err = 0.0
    for ss in (2, 4):
        th = 8 * ss
        for ch in (2, 4, 6, 12, 24):
            nc = 2048
            e = random_chunks(rng, nc, ch)
            e[..., 1::2] *= ss                  # y spans the TH sub-rows
            edges = torch.from_numpy(e).to(dev)
            rp = torch.from_numpy(random_rparams(rng, nc, th, 128)).to(dev)
            got = torch.empty((nc, 8 * 128), device=dev)
            coverage_resolve_cuda.coverage_chunks_res_cuda(edges, rp, got, th, 128, ss)
            ref = coverage_chunks_res_torch(edges, rp, th, 128, ss)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            k3_err = max(k3_err, err)
            print(f"[3b] K3 ss={ss} CH={ch:2d} NC={nc}: max|K3 - plain| = "
                  f"{err:.3e} (bound {K3_BOUND:.0e})")
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

    # ---- 5. the main path ----------------------------------------------
    for k in kernels.values():
        k.launches = 0
    ctx = vg.createContext(device="cuda")
    vg.begin(ctx, 0, 1920, 1080, 1.0)
    vg.scenes.demo_ui.draw_benchmark_frame(ctx, 0.0)
    img = vg.end(ctx)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
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
    for k in kernels.values():
        k.launches = 0
    ctx2 = vg.createContext(vg.ContextConfig(coverage_supersample=2), device="cuda")
    vg.begin(ctx2, 0, 1920, 1080, 1.0)
    vg.scenes.demo_ui.draw_benchmark_frame(ctx2, 0.0)
    img2 = vg.end(ctx2)
    torch.cuda.synchronize()
    launches_ss2 = {name: k.launches for name, k in kernels.items()}
    print(f"[5b] main path (ss=2) launches: {launches_ss2}")
    if not all(n > 0 for n in launches_ss2.values()):
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
    # the same code at ss=4 and 8 (K2's clip state then needs 32 and 64 KB
    # of shared memory per block)
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
        row = 0
        for ce, rp in zip(dv2["chunk_edges"][:k], res2["rparams"]):
            n = int(ce.shape[0])
            if cuda:
                coverage_resolve_cuda.coverage_chunks_res_cuda(
                    ce, rp, fin2[row:row + n], 16, 128, 2)
            else:
                fin2[row:row + n] = coverage_chunks_res_torch(ce, rp, 16, 128, 2)
            row += n
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
    # device time alone: the event times above include the host's launch
    # gaps (one Python wrapper call per pool and bucket)
    dev_ms = {}
    for tag, p_, d_ in (("ss1", pl, dv), ("ss2", pl2, dv2)):
        by, busy, window = device_breakdown(
            lambda p_=p_, d_=d_: execute_plan(p_, BG, device_arrays=d_))
        dev_ms[tag] = by
        print(f"[6] steady frame {tag}: device busy {busy:.4f} of {window:.4f} ms per "
              f"frame ({100 * busy / window:.1f}% busy; torch.profiler, 10 frames; {card})")
        for key, v in sorted(by.items(), key=lambda kv: -kv[1]):
            print(f"[6]    {key:48s} {v:.4f} ms/frame")
    # achieved rates from the shapes (H100 SXM peaks at 700 W: 67 TFLOP/s
    # FP32 outside the tensor cores, 3.35 TB/s HBM)
    npx = 8 * 128
    k1_flop = sum(int(ce.shape[0]) * int(ce.shape[1]) for ce in dv["chunk_edges"]) \
        * npx * 25                       # ~25 float ops per edge and pixel
    k2_bytes = npx * 16 * sum(int(i.shape[0]) for i in dv["bucket_ids"])  # fb out
    for pteb, pp, ctile in zip(dv["bucket_pteb"], dv["bucket_params"],
                               dv["bucket_ctile"]):
        slots = pteb.numel()             # one coverage row + params per slot
        k2_bytes += slots * (npx * 4 + pp.shape[1] * 4)
        if ctile is not None:
            k2_bytes += slots * npx * 16  # colour tile per slot
    k1_rate = k1_flop / (ms["K1"] * 1e-3) / 1e12
    k2_rate = k2_bytes / (ms["K2"] * 1e-3) / 1e12
    # K3: 2*npx sub-pixels per chunk, ~25 ops per edge + ~15 of epilogue
    k3_flop = sum(int(ce.shape[0]) * 2 * npx * (25 * int(ce.shape[1]) + 15)
                  for ce in dv2["chunk_edges"][:k])
    k3_rate = k3_flop / (ms["K3_ss2"] * 1e-3) / 1e12
    print(f"[6] K1 ~{k1_flop / 1e9:.2f} GFLOP -> {k1_rate:.1f} TFLOP/s "
          f"({100 * k1_rate / 67:.0f}% of 67 FP32 peak; {card})")
    print(f"[6] K2 ~{k2_bytes / 1e6:.1f} MB read+written -> {k2_rate:.3f} TB/s "
          f"({100 * k2_rate / 3.35:.0f}% of 3.35 HBM peak; {card})")
    print(f"[6] K3 (ss=2, RES pools) ~{k3_flop / 1e9:.2f} GFLOP -> {k3_rate:.1f} "
          f"TFLOP/s ({100 * k3_rate / 67:.0f}% of 67 FP32 peak; {card})")

    elapsed = time.perf_counter() - t_start
    print(f"[6] chip_smoke wall time {elapsed:.1f} s")
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "vgtpu.")) or m == "vgtpu")
    if leaked:
        raise AssertionError(f"chip_smoke imported {leaked}")
    def launch_counts(name):
        by_path = {"ss1": launches[name], "ss2": launches_ss2[name]}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    def device_ms(*keys):
        return {f"device_ms_{tag}": sum(dev_ms[tag].get(k, 0.0) for k in keys)
                for tag in ("ss1", "ss2")}

    print(json.dumps({"kernels": [
        {"name": "K1 chunk coverage", "route": "cuda",
         "source": "vgtpu_torch/csrc/coverage.cu",
         "replaces": "vgtpu/ops/coverage_pallas.py:254",
         **launch_counts("K1"), "max_abs_err": k1_err,
         "ms": ms["K1"], "plain_ms": ms["K1_plain"],
         "ms_ss2": ms["K1_ss2"], "plain_ms_ss2": ms["K1_ss2_plain"],
         **device_ms("K1")},
        {"name": "K2 fused painter composite", "route": "cuda",
         "source": "vgtpu_torch/csrc/composite.cu",
         "replaces": "vgtpu/ops/composite_pallas.py:181",
         **launch_counts("K2"), "max_abs_err": k2_err,
         "ms": ms["K2"], "plain_ms": ms["K2_plain"],
         "ms_ss2": ms["K2_ss2"], "plain_ms_ss2": ms["K2_ss2_plain"],
         **device_ms("K2 (a)/(d)", "K2 (e)")},
        {"name": "K3 resolved chunk coverage", "route": "cuda",
         "source": "vgtpu_torch/csrc/coverage_resolve.cu",
         "replaces": "vgtpu/ops/coverage_resolve.py:204",
         **launch_counts("K3"), "max_abs_err": k3_err,
         "ms": ms["K3_ss2"], "plain_ms": ms["K3_ss2_plain"],
         **device_ms("K3", "K3 rows")},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
