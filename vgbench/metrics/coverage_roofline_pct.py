"""coverage_roofline_pct: The coverage kernels' share of their roofline: the frozen bound of the
traced frames' coverage work (roofline.frame_work, from the frames' own
edges and the tile shape) over the device ms of K1 and K3 in the trace."""

LAYER = "coverage kernels K1, K3: ops.coverage, csrc/coverage.cu, csrc/coverage_resolve.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate",
             "tiger_ui_1080p.scroll",
             "tiger_ui_1080p_ss2.scroll"]


def read(obs):
    from vgbench.roofline import bound_ms

    t = obs.trace
    dev = None if t is None else t.kernel_ms(("K1", "K3", "K3 rows"))
    if not dev:
        return None
    bound = sum(bound_ms(*w["coverage"]) for w in obs.work()) / t.frames
    return 100.0 * bound / dev
