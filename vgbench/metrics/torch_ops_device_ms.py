"""torch_ops_device_ms: Device ms per frame of every device operation that is not one of the
port's csrc kernels (trace.KERNELS): the sampler, the pan's shift, patch,
fill and copy, the fold, the image copies."""

LAYER = "plain torch device work: ops.sampling_device, the pan's shift, patch, fill and copy, the fold"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frame_ms"
WORKLOADS = ["tiger_ui_1080p.animate",
             "tiger_ui_1080p.scroll",
             "tiger_ui_1080p_ss2.scroll"]


def read(obs):
    from vgbench.trace import kernel_label

    t = obs.trace
    if t is None or not t.device:
        return None
    return t.device_ms_by(lambda name: kernel_label(name) is None)
