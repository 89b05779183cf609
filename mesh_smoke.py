#!/usr/bin/env python3
"""The multi-GPU paths of vgtpu_torch with one shard on each card.

Run from the root of a checkout on a machine with two or more GPUs:
    python3 mesh_smoke.py

chip_smoke.py drives the same paths (its phase 8) on whatever the machine
has, repeating cuda:0 on a one-card machine, where no shard's tensors or
launches leave that card.  This script needs several cards and makes each
mesh with make_mesh(n), one shard per card, so every shard's uploads, kernel
launches and the copy of its framebuffer to cuda:0 cross cards.  K1, K2 and
K4 take their card's index at the entry point, which switches the calling
thread's device for the launch and restores it (csrc/common.cuh::
DeviceScope), on that card's current stream: a launch that landed on another
card would fail on the stream, and the thread's device must still be cuda:0
after every path.  For n = 1, 2, 4 (as far as the cards go), with the launch
counts zeroed before each run and read after:

  - render_frame_sharded (K4 + the oracle composite) against the 1080p
    tiger + demo-UI frame's end() image on cuda:0;
  - render_frame_sharded_fused (K1, the fold, K2) at ss = 1 and 2 against
    the end() images at ss = 1 and 2;
  - VariantBatch.render_sharded of bench.py's K=6 overlay variants against
    each variant's full-path render;

every image within 1 u8 level, each shard's tensors on its own card, the
thread's current device cuda:0; then
each path's time per n (CUDA events on cuda:0, where the shards' images
land; median of 12, of 5 for render_sharded) beside the same shards
repeated on cuda:0, and the copy of one frame's framebuffer from each other
card to cuda:0 alone.  The last line is
{"ok": true, "device": {...}}.  Imports neither jax nor vgtpu.
"""

from __future__ import annotations

import concurrent.futures
import json
import sys
import time

from chip_smoke import BG_APP, K_BATCH, U8_BOUND, card_line, time_ms, u8_levels


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("mesh_smoke: needs two or more CUDA devices", file=sys.stderr)
        return 1
    import vgtpu_torch as vg
    from vgtpu_torch.ops import (
        composite_cuda,
        coverage_cuda,
        coverage_resolve_cuda,
        coverage_t_cuda,
    )
    from vgtpu_torch.parallel.sharded_fused import shard_frame_fused
    from vgtpu_torch.parallel.sharding import Mesh, make_mesh, shard_frame
    from vgtpu_torch.raster.batch import VariantBatch
    from vgtpu_torch.scenes import demo_ui

    cards = torch.cuda.device_count()
    card = card_line()
    print(card)
    print(f"[1] torch {torch.__version__}: {cards} cards "
          f"{[torch.cuda.get_device_name(k) for k in range(cards)]}")
    kernels = {"K1": coverage_cuda.K1, "K2": composite_cuda.K2,
               "K3": coverage_resolve_cuda.K3, "K4": coverage_t_cuda.K4}
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        for name, secs in zip(kernels, pool.map(lambda k: k.build(), kernels.values())):
            print(f"[2] built {name} in {secs:.1f} s")

    def counts() -> dict:
        for k in range(cards):
            torch.cuda.synchronize(k)
        return {name: k.launches for name, k in kernels.items()}

    def zero():
        for k in kernels.values():
            k.launches = 0

    def overlay(k):
        """bench.py's batch_diag frame: the north-star frame plus a rect
        whose colour is the only delta."""
        def f(c):
            demo_ui.draw_benchmark_frame(c, 0.0)
            vg.beginPath(c)
            vg.rect(c, 1800, 1000, 60, 40)
            vg.fillPath(c, vg.color4ub(50 + 17 * k, 120, 200, 180),
                        vg.FillFlags.ConvexAA)
        return f

    # the single-device references, on cuda:0
    refs = {}
    for ss in (1, 2):
        c = vg.createContext(vg.ContextConfig(coverage_supersample=ss), device="cuda")
        vg.begin(c, 0, 1920, 1080, 1.0)
        demo_ui.draw_benchmark_frame(c, 0.0)
        vg.end(c, background=BG_APP)
        refs[ss] = c
    vb = VariantBatch.bake(vg.createContext(device="cuda"),
                           [overlay(k) for k in range(K_BATCH)], 1920, 1080,
                           background=BG_APP)
    ref_b = vg.createContext(vg.ContextConfig(frame_memo=False), device="cuda")
    batch_refs = []
    for k in range(K_BATCH):
        vg.begin(ref_b, 0, 1920, 1080, 1.0)
        overlay(k)(ref_b)
        batch_refs.append(vg.end(ref_b, background=BG_APP))

    def tensors(x):
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in tensors(v)]
        return [x] if isinstance(x, torch.Tensor) else []

    def check(name, need, got, pairs, sf=None):
        print(f"[8] {name}: launches {got}")
        if any(got[k] <= 0 for k in need):
            raise AssertionError(f"{name} launched no {need}: {got}")
        if torch.cuda.current_device() != 0:
            raise AssertionError(f"{name} left the thread on cuda:"
                                 f"{torch.cuda.current_device()}")
        if sf is not None:
            for s, dev in zip(sf.shards, sf.mesh.devices):
                placed = {t.device for t in tensors(s)}
                if placed != {dev}:
                    raise AssertionError(f"{name}: a shard for {dev} holds {placed}")
        for a, b in pairs:
            if tuple(a.shape) != tuple(b.shape) or not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{name}: image {tuple(a.shape)} on {a.device}")
        worst = max(u8_levels(a, b) for a, b in pairs)
        diff = max(float((a.to(b.device) - b).abs().max()) for a, b in pairs)
        print(f"[8] {name}: {len(pairs)} images, worst {worst} u8 levels (bound "
              f"{U8_BOUND}), max|diff| {diff:.3e}")
        if worst > U8_BOUND:
            raise AssertionError(f"{name}: an image is {worst} u8 levels off")

    times = {}
    for n in [n for n in (1, 2, 4) if n <= cards]:
        mesh = make_mesh(n)
        print(f"[8] n={n}: devices {[str(d) for d in mesh.devices]}")
        zero()
        sf = shard_frame(refs[1].last_plan, mesh)
        img = sf.render(BG_APP)
        check(f"sharded n={n}", ("K4",), counts(), [(img, refs[1].frame_image)], sf)
        m = sf.meta
        print(f"[8] sharded n={n}: chunk_balance {m['chunk_balance']:.4f} entry_balance "
              f"{m['entry_balance']:.4f} ici_bytes_per_frame {m['ici_bytes_per_frame']}")
        times[f"sharded n={n}"] = time_ms(lambda sf=sf: sf.render(BG_APP))
        for ss in (1, 2):
            zero()
            sff = shard_frame_fused(refs[ss].last_plan, mesh)
            img = sff.render(BG_APP)
            check(f"sharded fused ss={ss} n={n}", ("K1", "K2"), counts(),
                  [(img, refs[ss].frame_image)], sff)
            times[f"sharded fused ss={ss} n={n}"] = time_ms(
                lambda sff=sff: sff.render(BG_APP))
        if n > 1:
            # the same shards repeated on cuda:0, timed in the same run: what
            # one shard per card changes
            rep = Mesh((torch.device("cuda", 0),) * n)
            times[f"sharded n={n} on cuda:0"] = time_ms(
                lambda sf=shard_frame(refs[1].last_plan, rep): sf.render(BG_APP))
            for ss in (1, 2):
                times[f"sharded fused ss={ss} n={n} on cuda:0"] = time_ms(
                    lambda sf=shard_frame_fused(refs[ss].last_plan, rep): sf.render(BG_APP))
        zero()
        imgs = vb.render_sharded(mesh, BG_APP)
        check(f"render_sharded n={n}", ("K4",), counts(),
              [(imgs[k], batch_refs[k]) for k in range(K_BATCH)])
        times[f"render_sharded n={n}"] = time_ms(
            lambda mesh=mesh: vb.render_sharded(mesh, BG_APP), runs=5, warmup=1)
    for name, t in times.items():
        per = f", {t / K_BATCH:.3f} ms per variant" if name.startswith("render") else ""
        where = "repeated" if name.endswith("on cuda:0") else "one shard per card"
        print(f"[6] {name:38s} {t:9.3f} ms{per}  (CUDA events on cuda:0, median of "
              f"{5 if per else 12}; {where}; {card})")
    # the gather alone: one frame's framebuffer (T x 8 x 128 x 4 f32) from
    # each other card to cuda:0, the copy every sharded render ends with
    pl = refs[1].last_plan
    fb = refs[1].frame_image.new_empty((pl.ntx * pl.nty, pl.tile_h, pl.tile_w, 4))
    for k in range(1, cards):
        src = fb.to(torch.device("cuda", k))
        t = time_ms(lambda src=src: src.to(fb.device))
        times[f"copy cuda:{k} -> cuda:0"] = t
        print(f"[6] copy cuda:{k} -> cuda:0 {fb.nbytes / 1e6:.1f} MB: {t:.3f} ms "
              f"({fb.nbytes / t / 1e6:.1f} GB/s; peer access "
              f"{torch.cuda.can_device_access_peer(0, k)}; CUDA events, median of 12; "
              f"{card})")
    print(f"[6] mesh_smoke wall time {time.perf_counter() - t_start:.1f} s")
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "vgtpu.")) or m == "vgtpu")
    if leaked:
        raise AssertionError(f"mesh_smoke imported {leaked}")
    print(json.dumps({"times_ms": times}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
