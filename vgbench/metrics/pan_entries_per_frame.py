"""pan_entries_per_frame: ctx.profiler's `pan_entries` counter: the (op, tile)
entries kernel K2 composites a view over those tiles, per frame.
RetainedScene.render adds the bake's constant each view; no cell but the
map's hands the harness the scene's profiler, so it reads nothing
elsewhere."""

LAYER = "retained pan: raster.retained.RetainedScene.render"
UNIT = "entries/frame"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["citymap_z17.pan"]


def read(obs):
    n = obs.counters.get("pan_entries")
    return None if n is None else n / obs.frames
