"""pan_resample_launches_per_frame: host runtime calls that put work on
the card (program_spans.LAUNCH_CALLS) starting inside the program's
vg.pan.resample ranges (the pan's glyph resample: sample_groups and the
colour tiles' layout), per traced frame."""

LAYER = "retained pan: raster.retained.RetainedScene.render"
UNIT = "launches/frame"
SOURCE = "program_span"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.scroll",
             "tiger_ui_1080p_ss2.scroll"]


def read(obs):
    from vgbench.program_spans import LAUNCH_CALLS, intervals, starts_inside

    t = obs.trace
    spans = [] if t is None else intervals(t, "vg.pan.resample")
    if not spans:
        return None
    return starts_inside(t, LAUNCH_CALLS, spans) / t.frames
