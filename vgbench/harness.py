"""One run of one cell: set-up, the measured window, the check, the result.

    python3 vgbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in BENCHMARK.json; its file under workloads/
names the configuration (configs/<config>.json), the traffic driver
(traffic/<driver>.py) and the driver's parameters.  The program is
vgtpu_torch on one card; nothing here imports jax or vgtpu.

The window is a closed loop of frames: a frame starts with its host work
(the driver's record or render call) and ends when its image is complete
on the card (an event recorded after it and waited on) before the next
starts.  `--trace 0` prints the end-to-end metrics: frame_ms (the window
over the frames completed in it), frame_p95_ms (the 95th percentile of
every frame's latency) and setup_s (process start to the first timed
frame).  `--trace 1` runs the same window for the host spans and the
program's stage times, then a traced window of the cell's trace_frames
frames under torch.profiler, and prints the per-layer metrics that
BENCHMARK.json lists for the cell, each read by metrics/<name>.py.

Once the window has closed, the frames kept from it (a sample drawn from
the seed) are held to the reference (check.py), and the last stderr lines
and the result's last key give each number compared beside its limit."""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import numpy as np

from vgbench.trace import SPAN_PREFIX

FORBIDDEN = ("jax", "jaxlib", "flax", "vgtpu")


class Spans:
    """Host-clock totals by span name; with `trace`, each span is also a
    torch.profiler range (vgbench.<name>)."""

    def __init__(self, trace: bool = False) -> None:
        self.total = defaultdict(float)
        self.trace = trace

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.trace:
            import torch

            rf = torch.profiler.record_function(SPAN_PREFIX + name)
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.total[name] += time.perf_counter() - t0


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, inclusive)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


class Reservoir:
    """The window's frames the check holds to the reference: every frame
    in `always`, and a uniform sample of `n` of the others from a window of
    unknown length, drawn from its own generator (Algorithm R)."""

    def __init__(self, n: int, rng: np.random.Generator, always=()) -> None:
        self.n, self.rng, self.always = n, rng, set(always)
        self.fixed, self.sampled, self.seen = [], [], 0

    @property
    def kept(self) -> list:
        return self.fixed + self.sampled

    def offer(self, k: int, image) -> None:
        if k in self.always:
            self.fixed.append((k, image.clone()))
            return
        self.seen += 1
        if len(self.sampled) < self.n:
            self.sampled.append((k, image.clone()))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.n:
            self.sampled[j] = (k, image.clone())


def keeper(driver, params: dict, seed: int) -> Reservoir:
    """The check's sample of a window: the window's first frame and the
    frames the driver always has checked (its edge cases), and
    params["check_frames"] more drawn from the seed."""
    return Reservoir(int(params["check_frames"]), np.random.default_rng([seed, 1]),
                     always={0, *driver.check_always()})


def run_frames(driver, ks, spans: Spans, sync, on_frame=None):
    """Run frames ks in a closed loop; returns their latencies (s)."""
    lat = []
    for k in ks:
        with spans("frame") if spans.trace else contextlib.nullcontext():
            t0 = time.perf_counter()
            img = driver.frame(k, spans)
            with spans("frame_wait"):
                sync()
            lat.append(time.perf_counter() - t0)
        if on_frame is not None:
            on_frame(k, img)
    return lat


def window(driver, seconds: float, spans: Spans, sync, on_frame):
    """Frames k = 0, 1, ... until `seconds` have passed; returns the
    latencies and the window's length (s), start to the last frame's end."""
    lat, k = [], 0
    t0 = time.perf_counter()
    while True:
        lat += run_frames(driver, (k,), spans, sync, on_frame)
        k += 1
        if time.perf_counter() - t0 >= seconds:
            return lat, time.perf_counter() - t0


class Observation:
    """What a per-layer metric reads: the untraced window's frames, host
    spans (s), the program's stage totals (ms) and counters, and the traced
    window (trace.Trace) with the frozen work of its frames."""

    def __init__(self, cell, frames, spans, stages, counters, trace, work_of):
        self.cell, self.frames, self.spans = cell, frames, spans
        self.stages, self.counters, self.trace = stages, counters, trace
        self._work_of, self._work = work_of, None

    def span_ms(self, name: str) -> float | None:
        return self.spans[name] * 1e3 / self.frames if name in self.spans else None

    def stage_ms(self, name: str) -> float | None:
        return self.stages[name] / self.frames if name in self.stages else None

    def work(self) -> list:
        """roofline.frame_work of every traced frame."""
        if self._work is None:
            self._work = self._work_of()
        return self._work


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def metric_module(root: str, name: str):
    path = os.path.join(root, "vgbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"vgbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str) -> list:
    """The per-layer metrics whose `workloads` in BENCHMARK.json name this
    cell."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float, root: str) -> int:
    args = parse(argv)
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"vgbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    wl = load_json(root, "vgbench", "workloads", f"{args.workload}.json")
    config = load_json(root, "vgbench", "configs", f"{wl['config']}.json")
    chips = int(cells[args.workload]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vgbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    return run(args, bench, wl, config, root, t_start, device="cuda:0")


def make_driver(wl, config, root, seed, device):
    """(env, driver) of a cell: the driver module traffic/<driver>.py found
    by the name in the workload file."""
    import vgtpu_torch as vg
    from vgbench.scene import Env, read_font

    env = Env(root=root, vg=vg, config=config, params=wl["params"], seed=seed,
              device=device, font_data=read_font(root, config))
    return env, importlib.import_module(f"vgbench.traffic.{wl['driver']}").make(env)


def make_sync(cpu: bool):
    """The end-of-frame wait: an event recorded after the frame's work on
    the current stream, waited on (nothing to wait for on the CPU)."""
    if cpu:
        return lambda: None
    import torch

    def sync():
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
    return sync


def run(args, bench, wl, config, root, t_start, device, cpu_sync=False,
        wrap=None) -> int:
    """The run after the harness's look for a card (tests call it on the
    CPU with cpu_sync=True, and wrap the driver to break the timed path)."""
    import torch

    from vgbench import check

    params = wl["params"]
    env, driver = make_driver(wl, config, root, args.seed, device)
    if wrap is not None:
        driver = wrap(driver)
    sync = make_sync(cpu_sync)

    # set-up: every frame shape the window uses, on the same path
    run_frames(driver, driver.warmup_frames(), Spans(), sync)
    setup_s = time.perf_counter() - t_start

    keep = keeper(driver, params, args.seed)
    spans = Spans()
    if driver.profiler is not None:
        driver.profiler.reset()
    lat, window_s = window(driver, args.seconds, spans, sync, keep.offer)
    frames = len(lat)
    stages = dict(driver.profiler.times_ms) if driver.profiler is not None else {}
    counters = dict(driver.profiler.counters) if driver.profiler is not None else {}
    hits = {k: counters.get(k, 0) for k in ("memo_hits", "layer_hits", "layer_cl_hits")}
    print(f"vgbench: {args.workload} seed {args.seed}: {frames} frames in "
          f"{window_s:.3f} s; " + " ".join(f"{k} {v}" for k, v in hits.items())
          + f"; program counters {json.dumps(counters, sort_keys=True)}", flush=True)

    trace = None
    if args.trace:
        from vgbench.trace import Trace

        acts = [torch.profiler.ProfilerActivity.CPU]
        if not cpu_sync:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        n_tr = int(params["trace_frames"])
        tr_ks = range(frames, frames + n_tr)
        with torch.profiler.profile(activities=acts) as prof:
            run_frames(driver, tr_ks, Spans(trace=True), sync)
        trace = Trace.from_profiler(prof, n_tr)

    peak = int(torch.cuda.max_memory_allocated(0)) if not cpu_sync else 0

    metrics = {}
    breakdown = None
    if args.trace:
        def work_of():
            from vgbench.roofline import frame_work

            cc = config["context_config"]
            out, prev = [], driver.reference(tr_ks[0] - 1)[0]
            for k in tr_ks:
                ops, w, h, _images = driver.reference(k)
                out.append(frame_work(ops, w, h, env.ss, cc["tile_w"], cc["tile_h"],
                                      prev_ops=prev))
                prev = ops
            return out

        obs = Observation(args.workload, frames, dict(spans.total), stages,
                          counters, trace, work_of)
        for m in cell_metrics(bench, args.workload):
            v = metric_module(root, m["name"]).read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": trace.top_device_ops(), "idle_gaps": trace.idle_gaps()}
    else:
        metrics = {
            "frame_ms": {"value": window_s * 1e3 / frames, "unit": "ms"},
            "frame_p95_ms": {"value": p95(lat) * 1e3, "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }

    # the check, once the window has closed and the program's state is freed
    kept = keep.kept
    driver.close()
    gc.collect()
    if not cpu_sync:
        torch.cuda.empty_cache()
    limit = float(wl["limits"]["level_gap"])
    try:
        results = check.compare(kept, driver, device, ss=env.ss,
                                background=env.background)
        gap = max(g for _k, g, _t in results)
        failed = sum(g > limit for _k, g, _t in results)
        ties = sum(t for _k, _g, t in results)
        note = f"{len(results)} frames {[k for k, _g, _t in results]}, {ties} tie pixels"
    except Exception as e:          # the run reports an incorrect result, not a crash
        import traceback

        traceback.print_exc()
        gap, failed, note = float("inf"), len(kept), f"the check raised {e!r}"
    correct = bool(kept) and failed == 0 and gap <= limit
    device_rec = {"platform": "gpu" if not cpu_sync else "cpu",
                  "kind": torch.cuda.get_device_name(0) if not cpu_sync else "cpu",
                  "count": int(wl["chips"]), "memory_peak_bytes": peak}
    if trace is not None:
        device_rec.update(busy_s=trace.busy_s, window_s=trace.window_s)
    result = {"correct": correct, "attempted": frames, "failed": int(failed),
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {"level_gap": {"value": gap if np.isfinite(gap) else None,
                                      "limit": limit}}
    print(f"vgbench: checked {note}", file=sys.stderr)
    # last, once the metrics' readers and the reference have run too
    bad = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if bad:
        print(f"vgbench: the process loaded {bad} (jax or the JAX package); no result",
              file=sys.stderr)
        return 3
    print(f"check level_gap {gap!r} limit {limit!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
