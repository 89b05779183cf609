"""composite_roofline_pct: The composite kernel's share of its roofline: the frozen bound of the
traced frames' composite work over the device ms of K2, all forms."""

LAYER = "composite kernel K2: ops.composite.frame_fb, csrc/composite.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate",
             "tiger_ui_1080p.scroll",
             "tiger_ui_1080p_ss2.scroll"]


def read(obs):
    from vgbench.roofline import bound_ms

    t = obs.trace
    dev = None if t is None else t.kernel_ms(("K2 (a)-(d)", "K2 (e)"))
    if not dev:
        return None
    bound = sum(bound_ms(*w["composite"]) for w in obs.work()) / t.frames
    return 100.0 * bound / dev
