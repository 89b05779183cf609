"""device_idle_pct: The share of the traced window in which no kernel, copy or fill ran on
the card."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate",
             "tiger_ui_1080p.scroll",
             "tiger_ui_1080p_ss2.scroll"]


def read(obs):
    t = obs.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
