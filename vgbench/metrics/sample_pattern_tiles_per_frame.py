"""sample_pattern_tiles_per_frame: ctx.profiler's `sample_pattern_tiles`
counter: the pattern-fill (image pattern) colour tiles that the resample
writes, per frame.  Each view's resample
(ops/sampling_device.sample_tiles_flat) adds the count taken from the tile
index built at bake; a program without the counter reads nothing."""

LAYER = "textures: Context._fill_textures, ops.sampling_device"
UNIT = "tiles/frame"
SOURCE = "program_counter"
MOVES = "frame_ms"
WORKLOADS = ["citymap_z17_hybrid2x.pan"]


def read(obs):
    n = obs.counters.get("sample_pattern_tiles")
    return None if n is None else n / obs.frames
