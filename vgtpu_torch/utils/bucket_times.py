"""Per-launch device times of the flat composite (K7) and the pixel-major
coverage (K4) on the 1080p tiger + demo-UI frame, beside the kernels that
compute the same function in the main path's layout (K2 form (a) per
bucket, K1 over the same pools).

    python3 -m vgtpu_torch.utils.bucket_times [--reps N]

Run from the root of a checkout on a machine with a card: it builds the
kernels it times (K1, K2, K4, K7) from that checkout's sources, records
and bins the frame, and prints one JSON line per bucket (its lanes, K7's
instantiation, MO, tiles, the valid share of its (tile, slot) pairs, K7's
and K2's ms per launch) and one for the coverage pools (K4 and K1 ms per
call over the frame's pools and over the pools of its n = 1 partition),
then a total line.  Times are device times per launch: torch.profiler's
CUDA records of `reps` back-to-back launches after a warm-up, the kernel's
own records summed and divided by their count (a launch shorter than the
host's launch gap would make CUDA events time the host).
Each K7 and K4 output is held to its plain twin first: any difference
from it raises.  Two checkouts timed in one call compare two versions of a
kernel on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np


def _device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device ms of the records whose name holds `kernel` over `reps`
    calls of fn() (torch.profiler, CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if ev:
            return sum(e.device_time for e in ev) / 1e3 / len(ev)
    raise RuntimeError(f"torch.profiler recorded no {kernel} launch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bucket_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    import vgtpu_torch as vg
    from vgtpu_torch.ops import composite_cuda, composite_flat_cuda, coverage_cuda
    from vgtpu_torch.ops import coverage_t_cuda
    from vgtpu_torch.ops.composite import _P_VALID, composite_bucket_torch
    from vgtpu_torch.ops.coverage import (
        cov_all_torch,
        coverage_chunks_t_torch,
        entry_coverage_from_pools,
        fold_extras,
    )
    from vgtpu_torch.parallel.sharding import partition_plan_for_mesh, plan_dense_arrays
    from vgtpu_torch.raster.binning import bin_frame
    from vgtpu_torch.raster.frame import plan_to_device
    from vgtpu_torch.scenes import demo_ui

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    for k in (coverage_cuda.K1, composite_cuda.K2, coverage_t_cuda.K4,
              composite_flat_cuda.K7):
        k.build()
    dev = torch.device("cuda", 0)
    ctx = vg.createContext(device="cuda")
    vg.begin(ctx, 0, 1920, 1080, 1.0)
    demo_ui.draw_benchmark_frame(ctx, 0.0)
    ctx._finalize_ops()
    cfg = ctx.cfg
    plan = bin_frame(ctx.ops, ctx.fb_width, ctx.fb_height, tile_h=cfg.tile_h,
                     tile_w=cfg.tile_w, chunk=cfg.edges_per_chunk,
                     pools=cfg.chunk_pools, supersample=1,
                     depth_cap=cfg.max_ops_per_tile_cap)
    ctx._fill_textures(plan)
    d = plan_to_device(plan, dev)
    th, tw = plan.tile_h, plan.tile_w
    npx = th * tw
    nt = plan.ntx * plan.nty
    bg = (1.0, 1.0, 1.0, 1.0)
    bg_col = torch.tensor(bg, device=dev).repeat_interleave(npx)[:, None]

    # K7's inputs as the [5c] frame gathers them (chip_smoke.py phase 6)
    cents = [torch.from_numpy(np.asarray(c)).to(dev) for _ce, c in plan.chunk_pools]
    ne = plan.entry_backdrop.shape[0]
    entry_w = (entry_coverage_from_pools(d["chunk_edges"], cents, ne, th, tw)
               + torch.from_numpy(plan.entry_backdrop).to(dev)[:, :, None]).reshape(ne, -1)
    cov_res = fold_extras(cov_all_torch(d["chunk_edges"], th, tw), d["cov_map"])
    tot = {"K7": 0.0, "K2 (a)": 0.0}
    for i, (te, pp, ct, fl, pteb, ctile, ids) in enumerate(zip(
            d["bucket_te"], d["bucket_params"], d["bucket_ctile"], d["bucket_flags"],
            d["bucket_pteb"], d["bucket_ctile"], d["bucket_ids"])):
        ew = entry_w[te].permute(1, 2, 0).contiguous()
        ct_t = d["ct_flat"][ct].permute(1, 2, 0).contiguous() if fl[2] else None
        got = composite_flat_cuda.composite_bucket_flat_cuda(
            ew, pp, ct_t, bg_col, tile_w=tw, flags=fl)
        ref = composite_bucket_torch(ew, pp, ct_t, bg_col, tile_w=tw, flags=fl,
                                     add_backdrop=False)
        err7 = float((got - ref).abs().max())
        if err7 != 0.0:
            raise AssertionError(f"bucket_times: K7 differs from its twin by {err7} "
                                 f"on bucket {i} (flags {fl})")
        ms7 = _device_ms(lambda: composite_flat_cuda.composite_bucket_flat_cuda(
            ew, pp, ct_t, bg_col, tile_w=tw, flags=fl), args.reps,
            "composite_flat_kernel")
        fb = torch.zeros((nt + 1, th, tw, 4), device=dev)
        ms2 = _device_ms(lambda: composite_cuda.composite_bucket_cuda(
            fb, cov_res, pteb, pp, d["ct_flat"], ctile, ids, bg, tile_w=tw,
            flags=fl), args.reps, "composite_bucket_kernel")
        valid = pp[:, _P_VALID, :] > 0
        real = ids < nt
        mo, _npp, nbo = pp.shape
        tot["K7"] += ms7
        tot["K2 (a)"] += ms2
        print(json.dumps({
            "bucket": i, "flags": [int(f) for f in fl],
            "k7_instantiation": composite_flat_cuda.k7_instantiation(fl)[0],
            "mo": int(mo), "tiles": int(nbo), "real_tiles": int(real.sum()),
            "valid_share": round(float(valid[:, real].float().mean()), 4),
            "k7_ms": ms7, "k7_err": err7, "k2a_ms": ms2, "card": card}))

    # K4 beside K1 over the frame's pools and the n = 1 partition's
    part = [torch.from_numpy(np.ascontiguousarray(ce)).to(dev)
            for ce, _c in partition_plan_for_mesh(plan_dense_arrays(plan), plan, 1)[0]["chunk_pools"]]
    for name, pools in (("frame pools", d["chunk_edges"]), ("n = 1 shard pools", part)):
        outs = coverage_t_cuda.coverage_pools_t_cuda(pools, th, tw)
        err4 = max(float((o - coverage_chunks_t_torch(ce, th, tw)).abs().max())
                   for o, ce in zip(outs, pools))
        if err4 != 0.0:
            raise AssertionError(f"bucket_times: K4 differs from its twin by {err4} "
                                 f"on the {name}")
        ms4 = _device_ms(lambda: coverage_t_cuda.coverage_pools_t_cuda(pools, th, tw),
                         args.reps, "coverage_chunks_t_kernel")
        ms1 = _device_ms(lambda: coverage_cuda.cov_all_cuda(pools, th, tw), args.reps,
                         "coverage_chunks_kernel")
        tot[f"K4 {name}"] = ms4
        print(json.dumps({"pools": name, "shapes": [list(ce.shape[:2]) for ce in pools],
                          "k4_ms": ms4, "k4_err": err4, "k1_ms": ms1, "card": card}))
    print(json.dumps({"total_ms": tot, "reps": args.reps, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
