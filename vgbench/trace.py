"""Readers of a torch.profiler window: the device's operations by kernel,
its busy time, host-side waits and what the host did while the card sat
idle.  Frozen copies of chip_smoke.device_breakdown and host_waits,
rewritten over the events of one traced window of frames."""

from __future__ import annotations

from dataclasses import dataclass, field

# the port's kernels by their CUDA symbols (vgtpu_torch/csrc): K1 and K3
# the coverage kernels, K2 the painter composite (form (a)-(d) in
# composite_bucket_kernel, (e) in composite_final_kernel)
KERNELS = (
    ("coverage_chunks_deep_kernel", "K1"), ("coverage_chunks_kernel", "K1"),
    ("coverage_res_windowed_kernel", "K3"), ("coverage_res_deep_kernel", "K3"),
    ("coverage_res_kernel", "K3"), ("resolve_rows_kernel", "K3 rows"),
    ("composite_final_kernel", "K2 (e)"), ("composite_bucket_kernel", "K2 (a)-(d)"),
    ("coverage_chunks_t_deep_kernel", "K4"), ("coverage_chunks_t_kernel", "K4"),
    ("coverage_t_flat_deep_kernel", "K5"), ("coverage_t_flat_kernel", "K5"),
    ("coverage_slots_deep_kernel", "K6"), ("coverage_slots_kernel", "K6"),
    ("composite_flat_kernel", "K7"), ("probe_affine_kernel", "K8"),
)

# runtime calls and ops on which the host waits for the card
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "aten::_local_scalar_dense", "aten::item")

SPAN_PREFIX = "vgbench."


def kernel_label(name: str) -> str | None:
    """The port kernel a device op belongs to, None for any other op."""
    for sym, label in KERNELS:
        if sym in name:
            return label
    return None


@dataclass
class Trace:
    """One traced window of `frames` frames: device ops and host events as
    (name, start_us, end_us), the harness's own spans among the host ones."""

    frames: int
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0

    @classmethod
    def from_profiler(cls, prof, frames: int) -> "Trace":
        import torch

        dev, host = [], []
        for e in prof.events():
            rec = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the harness's ranges also appear on the device timeline
                # as annotations spanning the frame's work: not operations
                if not e.name.startswith(SPAN_PREFIX):
                    dev.append(rec)
            else:
                host.append(rec)
        spans = [h for h in host if h[0] == SPAN_PREFIX + "frame"]
        t0 = min(s[1] for s in spans) if spans else min(d[1] for d in dev)
        t1 = max(s[2] for s in spans) if spans else max(d[2] for d in dev)
        dev = [d for d in dev if d[2] > t0 and d[1] < t1]
        return cls(frames, sorted(dev, key=lambda d: d[1]), host, t0, t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device ops' intervals, clipped to the window."""
        out = []
        for _n, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_ms_by(self, keep) -> float:
        """Device ms per frame of the ops whose name passes keep(name)."""
        return sum(b - a for n, a, b in self.device if keep(n)) * 1e-3 / self.frames

    def kernel_ms(self, labels) -> float:
        """Device ms per frame of the port kernels with these labels."""
        return self.device_ms_by(lambda n: kernel_label(n) in labels)

    def host_waits(self) -> int:
        """Host-side waits (HOST_WAITS) in the window, leaving out those
        inside the harness's own end-of-frame wait."""
        own = [(a, b) for n, a, b in self.host if n == SPAN_PREFIX + "frame_wait"]
        count = 0
        for n, a, b in self.host:
            if n in HOST_WAITS and self.t0 <= a < self.t1 and not any(
                    oa <= a and b <= ob for oa, ob in own):
                count += 1
        return count

    def top_device_ops(self, n: int = 10) -> list:
        """[name, seconds] of the device ops that took most time, by the
        port kernel's label or the op's name."""
        by: dict = {}
        for name, a, b in self.device:
            key = kernel_label(name) or name[:64]
            by[key] = by.get(key, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[label, seconds]: the card's idle time in the window summed by
        what the host was doing at each gap's middle: the innermost
        harness span and the host op under it, if any."""
        import numpy as np

        def table(recs):
            return (np.array([r[1] for r in recs], np.float64).reshape(-1),
                    np.array([r[2] for r in recs], np.float64).reshape(-1),
                    [r[0] for r in recs])

        spans = table([(nm[len(SPAN_PREFIX):], a, b) for nm, a, b in self.host
                       if nm.startswith(SPAN_PREFIX) and nm != SPAN_PREFIX + "frame"])
        ops = table([r for r in self.host if not r[0].startswith(SPAN_PREFIX)])
        gaps, prev = [], self.t0
        for a, b in self.busy_intervals():
            if a > prev:
                gaps.append((prev, a))
            prev = b
        if self.t1 > prev:
            gaps.append((prev, self.t1))

        def innermost(tab, mid):
            starts, ends, names = tab
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if not len(hit):
                return None
            return names[hit[np.argmin(ends[hit] - starts[hit])]]

        by: dict = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            label = innermost(spans, mid) or "between frames"
            under = innermost(ops, mid)
            if under:
                label += ": " + under[:48]
            by[label] = by.get(label, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
