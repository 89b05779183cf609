"""pan_edges_per_frame: ctx.profiler's `pan_edges` counter: the edge rows
kernel K1 walks a view, per frame.  K1 walks every slot of the baked chunk
pools, padding included, so the unit is pool slots: it moves in the pools'
bucket steps, not edge by edge.  RetainedScene.render adds the bake's constant each view; no
cell but the map's hands the harness the scene's profiler, so it reads
nothing elsewhere."""

LAYER = "retained pan: raster.retained.RetainedScene.render"
UNIT = "slots/frame"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["citymap_z17.pan"]


def read(obs):
    n = obs.counters.get("pan_edges")
    return None if n is None else n / obs.frames
