"""The readings that the limit of `correct` is set from, in one process:

    python3 vgbench/readings.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds 2]

For each seed, the cell's set-up and a short window of the program, then
the check of its kept frames; for each control seed, the same window with
the control (control.py) in the program's place.  One JSON line per seed:
{"side", "seed", "frames", "level_gap" (widest), "gaps"}.  The limit sits
above the program's largest reading and below the control's smallest
(PERF.md gives the readings)."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seeds, control_seeds, seconds: float, device="cuda:0",
             cpu: bool = False, config=None, params=None, out=sys.stdout) -> list:
    import torch

    from vgbench import check, harness
    from vgbench.control import Control

    wl = harness.load_json(ROOT, "vgbench", "workloads", f"{workload}.json")
    if params:
        wl["params"].update(params)
    cfg = config or harness.load_json(ROOT, "vgbench", "configs", f"{wl['config']}.json")
    sync = harness.make_sync(cpu)
    rows = []
    for side, seed in [("program", s) for s in seeds] + [("control", s) for s in control_seeds]:
        t0 = time.perf_counter()
        env, driver = harness.make_driver(wl, cfg, ROOT, seed, device)
        if side == "control":
            driver = Control(driver, env)
        harness.run_frames(driver, driver.warmup_frames(), harness.Spans(), sync)
        keep = harness.keeper(driver, wl["params"], seed)
        lat, _w = harness.window(driver, seconds, harness.Spans(), sync, keep.offer)
        driver.close()
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
        res = check.compare(keep.kept, driver, device, ss=env.ss, background=env.background)
        row = {"side": side, "seed": seed, "frames": len(lat),
               "level_gap": max(g for _k, g, _t in res),
               "gaps": [[k, g, t] for k, g, t in res],
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
        del keep, driver
    return rows


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args()

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    readings(a.workload, ints(a.seeds), ints(a.control_seeds), a.seconds)
