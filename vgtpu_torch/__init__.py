"""vgtpu_torch: the PyTorch + CUDA port of vgtpu, the 2D vector-graphics engine.

The same vg:: free functions over a Context as `vgtpu` (include/vg/vg.h
parity), with the device half in PyTorch and hand-written CUDA kernels for
NVIDIA Hopper (vgtpu_torch/csrc).  The host half (recorder, geometry, native
C++ binner, fonts, numpy sampler, scenes) is a jax-free copy of vgtpu's, so
the package imports torch and numpy only.

    import vgtpu_torch as vg
    ctx = vg.createContext(device="cuda")      # or device="cpu"
    vg.begin(ctx, 0, 1920, 1080, 1.0)
    ...                                        # path verbs, fills, text
    img = vg.end(ctx)                          # (H, W, 4) premultiplied f32
"""

from vgtpu_torch.core import (  # noqa: F401
    Color,
    Colors,
    LineCap,
    LineJoin,
    PathType,
    FillRule,
    Winding,
    ClipRule,
    TransformOrder,
    StrokeFlags,
    FillFlags,
    ImageFlags,
    TextAlign,
    TextBoxFlags,
    CommandListFlags,
    FontFlags,
    color4f,
    color4ub,
    colorHSB,
    colorHSL,
    colorSetAlpha,
    colorGetRed,
    colorGetGreen,
    colorGetBlue,
    colorGetAlpha,
    stroke_flags,
    fill_flags,
)
from vgtpu_torch.api.config import ContextConfig  # noqa: F401

from vgtpu_torch.api.context import *  # noqa: F401,F403
from vgtpu_torch.api.context import (  # noqa: F401 (explicit for IDEs)
    Context,
    GradientHandle,
    ImagePatternHandle,
    ImageHandle,
    FontHandle,
    CommandListHandle,
    TextConfig,
    TextRow,
    GlyphPosition,
    isValid,
)
from vgtpu_torch.raster.batch import (  # noqa: F401
    VariantBatch,
    measure_batch_ms_per_frame,
)


def debugPrintf(fmt: str, *args) -> None:
    """vg.h VG_TRACE analogue (vg.h:50-56): formatted diagnostic print,
    gated by the VGTPU_DEBUG environment variable."""
    import os as _os
    import sys as _sys

    if _os.environ.get("VGTPU_DEBUG"):
        print("vg " + (fmt % args if args else fmt), file=_sys.stderr)


def debugBreak() -> None:
    """vg.h VG_CHECK's bx::debugBreak analogue (vg.h:62-68): drop into the
    debugger when VGTPU_DEBUG is set, else no-op."""
    import os as _os

    if _os.environ.get("VGTPU_DEBUG"):
        import pdb

        pdb.set_trace()


__version__ = "0.1.0"

# last: the scene modules import this package (vg.scenes.demo_ui, ...)
from vgtpu_torch import scenes  # noqa: E402,F401
