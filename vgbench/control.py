"""The control of `correct`: the reference itself put in the program's
place, computed a step below the configuration's float32: every position
in float32 (edges, winding, pixel centres, texture and paint
coordinates), the composite in bfloat16 (coverage, texels, colours and
the blend), the step that would tempt a later change.  The check has to find it not
correct (readings.py reads it on the card; tests/test_vgbench_control.py
keeps it)."""

from __future__ import annotations

import torch

from vgbench import check


class Control:
    """A driver whose frame k is the low-precision reference of the wrapped
    driver's frame k."""

    def __init__(self, driver, env) -> None:
        self.driver, self.env = driver, env
        self.profiler = None

    def warmup_frames(self):
        return range(0)

    def check_always(self):
        return self.driver.check_always()

    def frame(self, k: int, span):
        with span("control"):
            img, _ties = check.reference_image(
                self.driver.reference(k), self.env.device, ss=self.env.ss,
                background=self.env.background, geom_dtype=torch.float32,
                comp_dtype=torch.bfloat16)
            return img.float()

    def reference(self, k: int):
        return self.driver.reference(k)

    def close(self) -> None:
        self.driver.close()
