#!/usr/bin/env python3
"""Smoke test of vgtpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):
  1. CUDA present; print the card's name and power limit (nvidia-smi).
  2. Build kernels K1 (csrc/coverage.cu) and K2 (csrc/composite.cu) with
     nvcc from the checkout; print the build seconds and ptxas's register
     and spill report.
  3. K1 against its plain twin coverage_chunks_torch on the card: random
     chunks (horizontal, near-vertical, tiny-dy, zero-length, out-of-tile
     edges) at CH = 2, 4, 8, 24 and the 1080p frame's pool sizes.
  4. K2 against its plain twin composite_bucket_into_torch on every bucket of
     the 1080p tiger + demo-UI plan and of the two 512x256 scenes of
     vgtpu_torch.scenes.small (an image pattern covers the texture lane,
     the feature scene the scissor, even-odd, non-AA, clip, gradient and
     triangle lanes).
  5. The main path: createContext(device="cuda"), begin 1920x1080,
     scenes.demo_ui.draw_benchmark_frame, end().  Both kernels' launch
     counts must be > 0; the image must match the same plan through the
     plain twins on the card within 1 u8 level, and the small scene must
     match the CPU path within 1 u8 level.
  6. Times (CUDA events, median of 12 runs after warm-up): the steady frame
     from resident arrays, K1 and K2 beside their plain twins.

The last two lines are the kernels' JSON record and the contract line
{"ok": true, "device": {...}}.  Imports neither jax nor vgtpu.
"""

from __future__ import annotations

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


def record_plan(vg, draw, w, h, device):
    """Record a scene through the port's vg:: surface and upload its plan."""
    from vgtpu_torch.raster.frame import plan_to_device

    ctx = vg.createContext(device=device)
    vg.begin(ctx, 0, w, h, 1.0)
    draw(ctx)
    ctx._finalize_ops()
    from vgtpu_torch.raster.binning import bin_frame

    cfg = ctx.cfg
    plan = bin_frame(ctx.ops, ctx.fb_width, ctx.fb_height, tile_h=cfg.tile_h,
                     tile_w=cfg.tile_w, chunk=cfg.edges_per_chunk,
                     pools=cfg.chunk_pools, depth_cap=cfg.max_ops_per_tile_cap)
    ctx._fill_textures(plan)
    return ctx, plan, plan_to_device(plan, device)


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
    from vgtpu_torch.ops import composite_cuda, coverage_cuda
    from vgtpu_torch.ops.composite import composite_bucket_into_torch, frame_fb
    from vgtpu_torch.ops.coverage import cov_all_torch, fold_extras
    from vgtpu_torch.raster.frame import execute_plan, execute_plan_torch, image_to_u8
    from vgtpu_torch.scenes import demo_ui
    from vgtpu_torch.scenes.small import (
        HEIGHT,
        WIDTH,
        draw_feature_scene,
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
    K1, K2 = coverage_cuda.K1, composite_cuda.K2
    for name, k in (("K1", K1), ("K2", K2)):
        secs = k.build()
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

    # ---- 5. the main path ----------------------------------------------
    K1.launches = 0
    K2.launches = 0
    ctx = vg.createContext(device="cuda")
    vg.begin(ctx, 0, 1920, 1080, 1.0)
    vg.scenes.demo_ui.draw_benchmark_frame(ctx, 0.0)
    img = vg.end(ctx)
    torch.cuda.synchronize()
    launches = {"K1": K1.launches, "K2": K2.launches}
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

    ms = {
        "frame": time_ms(lambda: execute_plan(pl, BG, device_arrays=dv)),
        "frame_plain": time_ms(lambda: execute_plan_torch(pl, BG, device_arrays=dv)),
        "K1": time_ms(lambda: coverage_cuda.cov_all_cuda(dv["chunk_edges"], 8, 128)),
        "K1_plain": time_ms(lambda: cov_all_torch(dv["chunk_edges"], 8, 128)),
        "K2": time_ms(lambda: composite_all(composite_cuda.composite_bucket_cuda)),
        "K2_plain": time_ms(lambda: composite_all(composite_bucket_into_torch)),
    }
    for k, v in ms.items():
        print(f"[6] {k:12s} {v:9.3f} ms  (median of 12, CUDA events; {card})")
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
    print(f"[6] K1 ~{k1_flop / 1e9:.2f} GFLOP -> {k1_rate:.1f} TFLOP/s "
          f"({100 * k1_rate / 67:.0f}% of 67 FP32 peak; {card})")
    print(f"[6] K2 ~{k2_bytes / 1e6:.1f} MB read+written -> {k2_rate:.3f} TB/s "
          f"({100 * k2_rate / 3.35:.0f}% of 3.35 HBM peak; {card})")

    elapsed = time.perf_counter() - t_start
    print(f"[6] chip_smoke wall time {elapsed:.1f} s")
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "vgtpu.")) or m == "vgtpu")
    if leaked:
        raise AssertionError(f"chip_smoke imported {leaked}")
    print(json.dumps({"kernels": [
        {"name": "K1 chunk coverage", "route": "cuda",
         "source": "vgtpu_torch/csrc/coverage.cu",
         "replaces": "vgtpu/ops/coverage_pallas.py:254",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": ms["K1"], "plain_ms": ms["K1_plain"]},
        {"name": "K2 fused painter composite", "route": "cuda",
         "source": "vgtpu_torch/csrc/composite.cu",
         "replaces": "vgtpu/ops/composite_pallas.py:181",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": ms["K2"], "plain_ms": ms["K2_plain"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
