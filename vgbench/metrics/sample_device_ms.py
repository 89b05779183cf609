"""sample_device_ms: device ms per traced frame of kernel S1, the
texture sampler (csrc/sample_tiles.cu), found in the trace by its CUDA
symbol sample_tiles_kernel; nothing where no device op carries it."""

LAYER = "textures: Context._fill_textures, ops.sampling_device"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["citymap_z17_hybrid2x.pan"]

SYMBOL = "sample_tiles_kernel"


def read(obs):
    t = obs.trace
    if t is None or not any(SYMBOL in n for n, _a, _b in t.device):
        return None
    return t.device_ms_by(lambda name: SYMBOL in name)
