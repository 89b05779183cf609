"""Readers of the program's own spans in a traced window: the CPU ranges
vg.<stage> that vgtpu_torch's FrameProfiler opens while torch.profiler
records (one per stage call, on the profiler's clock).  A program without
such ranges gives no intervals, and the metrics that read them nothing."""

from __future__ import annotations

import bisect

# host runtime calls that put work on the card's stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchKernelExC", "cudaMemcpyAsync", "cudaMemsetAsync")


def intervals(trace, name: str) -> list:
    """The union of the host ranges called `name`, clipped to the traced
    window, as sorted disjoint [start_us, end_us] pairs."""
    out = []
    for a, b in sorted((max(a, trace.t0), min(b, trace.t1))
                       for n, a, b in trace.host if n == name):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def starts_inside(trace, names, spans: list) -> int:
    """How many host events named in `names` start inside one of `spans`
    (sorted disjoint intervals)."""
    names, lo = set(names), [s[0] for s in spans]
    count = 0
    for n, a, _b in trace.host:
        if n in names:
            i = bisect.bisect_right(lo, a) - 1
            count += i >= 0 and a < spans[i][1]
    return count


def idle_inside(trace, spans: list) -> float:
    """The card's idle time (the window less trace.busy_intervals()) that
    falls inside `spans` (sorted disjoint intervals), in us."""
    idle, prev = [], trace.t0
    for a, b in trace.busy_intervals():
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    if trace.t1 > prev:
        idle.append((prev, trace.t1))
    total, i, j = 0.0, 0, 0
    while i < len(idle) and j < len(spans):
        a, b = max(idle[i][0], spans[j][0]), min(idle[i][1], spans[j][1])
        total += max(0.0, b - a)
        if idle[i][1] < spans[j][1]:
            i += 1
        else:
            j += 1
    return total
