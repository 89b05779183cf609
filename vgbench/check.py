"""How `correct` is decided: the frames the window produced, held to the
plain reference (reference/) rendered from the same draw commands.

The number compared is `level_gap`: the widest gap, in u8 levels (x 255),
between the program's premultiplied frame and the reference's, over every
channel of every pixel of every checked frame, leaving out the pixels a
threshold decides by rounding alone (reference.raster.TIE).  The limit is
the cell's, in its workload file (`limits`), set from the readings in
PERF.md."""

from __future__ import annotations

import torch


def level_gap(image: torch.Tensor, reference: torch.Tensor, ties: torch.Tensor) -> float:
    """Widest |image - reference| x 255 outside the tie pixels; inf when
    the image has the wrong shape or a value that is not finite."""
    if tuple(image.shape) != tuple(reference.shape) or not bool(torch.isfinite(image).all()):
        return float("inf")
    gap = (image.to(reference.dtype) - reference).abs().amax(dim=-1)
    gap = gap.masked_fill(ties, 0.0)
    return float(gap.max()) * 255.0


def reference_image(frame, device, *, ss: int, background,
                    geom_dtype=torch.float64, comp_dtype=torch.float64):
    """(image, ties) of the reference for a driver's frame record
    (ops, width, height, images)."""
    from vgbench.reference.raster import render

    ops, width, height, images = frame
    return render(ops, width, height, images, background=background, ss=ss,
                  device=device, geom_dtype=geom_dtype, comp_dtype=comp_dtype)


def compare(kept: list, driver, device, *, ss: int, background) -> list:
    """[(frame index, level_gap, tie pixels)] of the kept (k, image) pairs."""
    out = []
    for k, img in kept:
        ref, ties = reference_image(driver.reference(k), device, ss=ss,
                                    background=background)
        out.append((k, level_gap(img, ref, ties), int(ties.sum())))
        del ref, ties
    return out
