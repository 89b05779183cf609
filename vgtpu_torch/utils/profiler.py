# Copied from vgtpu/utils/profiler.py: the jax-free host half of the PyTorch port.
"""Per-stage frame profiling + counters (SURVEY.md §5: the reference ships
only debug printf macros, vg.h:47-73, and command-list memory Stats,
vg.h:339-343 — a production TPU engine needs real observability).

Usage:
    prof = FrameProfiler()
    with prof.stage("bake"):
        ...
    prof.report()   # dict of stage -> ms

Context integrates one automatically (`ctx.profiler`); `vg.getStats(ctx)`
surfaces the counters.  A RetainedScene reports to the profiler of the
context it was baked from: its renders add the pan's stages (`pan`,
`pan.shift`, `pan.coverage`, `pan.patch`, `pan.resample`,
`pan.composite`, `pan.window`) to `times_ms`, which report() divides by
the frames ended through `end()` only; its bake adds `bake.textures` (the
sampling plan and the texture uploads) and sets the `texture_bytes`
counter.

The stages are the port's one tracer.  Each keeps a host-clock total in
`times_ms`; while a torch profiler records (`trace_frame`, or any
`torch.profiler.profile`), it is also a CPU range named `vg.<stage>` on
the profiler's clock, nested as the code nests: `vg.bin` holds
`vg.bin.native`, `vg.pan` holds the six `vg.pan.*` phases.  The ranges
are CPU-scoped (not user annotations), so the CUDA trace does not mirror
them as device events; in `trace_frame`'s Chrome trace they sit on the
host thread above the aten ops and runtime calls they issue.  With no
profiler recording a stage costs one flag check more than its clock:
0.7-1.1 us a stage, 1.8-1.9 us with a profiler recording (torch 2.11 on
the host of an H100 80GB HBM3 machine), ~0.02 ms on a 17-stage frame.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

RANGE_PREFIX = "vg."


class _Stage:
    """FrameProfiler.stage's context: the host-clock total, and the
    vg.<name> range while a torch profiler records."""

    __slots__ = ("_times", "_name", "_range", "_t0")

    def __init__(self, times: dict, name: str) -> None:
        self._times, self._name, self._range = times, name, None

    def __enter__(self) -> None:
        if _autograd_profiler._is_profiler_enabled:
            self._range = _RecordFunctionFast(RANGE_PREFIX + self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        self._times[self._name] += (time.perf_counter() - self._t0) * 1e3
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


@dataclass
class FrameProfiler:
    times_ms: dict = field(default_factory=lambda: defaultdict(float))
    counters: dict = field(default_factory=lambda: defaultdict(int))
    _frames: int = 0

    def stage(self, name: str) -> _Stage:
        return _Stage(self.times_ms, name)

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


def stage_of(profiler):
    """profiler.stage, or a stage that records nothing for profiler None."""
    if profiler is not None:
        return profiler.stage
    return lambda _name: contextlib.nullcontext()


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
