# Copied from vgtpu/utils/profiler.py: the jax-free host half of the PyTorch port.
"""Per-stage frame profiling + counters (SURVEY.md §5: the reference ships
only debug printf macros, vg.h:47-73, and command-list memory Stats,
vg.h:339-343 — a production TPU engine needs real observability).

Usage:
    prof = FrameProfiler()
    with prof.stage("bake"):
        ...
    prof.report()   # dict of stage -> ms

Context integrates one automatically; `vg.getStats(ctx)` surfaces the
counters.  For device-side tracing use torch.profiler (see `trace_frame`).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class FrameProfiler:
    times_ms: dict = field(default_factory=lambda: defaultdict(float))
    counters: dict = field(default_factory=lambda: defaultdict(int))
    _frames: int = 0

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times_ms[name] += (time.perf_counter() - t0) * 1e3

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def frame_done(self) -> None:
        self._frames += 1

    def report(self) -> dict:
        f = max(self._frames, 1)
        return {
            "frames": self._frames,
            "ms_per_frame": {k: v / f for k, v in self.times_ms.items()},
            "counters": dict(self.counters),
        }

    def reset(self) -> None:
        self.times_ms.clear()
        self.counters.clear()
        self._frames = 0



@contextlib.contextmanager
def trace_frame(logdir: str):
    """torch.profiler trace around a frame (vgtpu's trace_frame runs
    jax.profiler): CPU activity and, when torch sees a CUDA device, the
    card's kernels.  On exit the trace is written under `logdir` as a
    Chrome trace (trace.json; open it in chrome://tracing or Perfetto).
    Yields the profiler, whose key_averages() summarises the frame."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
