"""pan_resample_idle_ms: the card's idle time (the traced window less the
device ops' busy intervals) that falls inside the program's
vg.pan.resample ranges (the pan's glyph resample), ms per traced frame."""

LAYER = "retained pan: raster.retained.RetainedScene.render"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.scroll",
             "tiger_ui_1080p_ss2.scroll"]


def read(obs):
    from vgbench.program_spans import idle_inside, intervals

    t = obs.trace
    spans = [] if t is None else intervals(t, "vg.pan.resample")
    if not spans:
        return None
    return idle_inside(t, spans) * 1e-3 / t.frames
