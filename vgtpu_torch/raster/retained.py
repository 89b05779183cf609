"""Retained-scene panning (vgtpu/raster/retained.py): not ported yet.

The names exist so that code written against vgtpu reaches a clear
NotImplementedError naming the ROADMAP.md item."""

from __future__ import annotations

from vgtpu_torch.api.context import _unported


class RetainedScene:
    """Device-resident pannable scene: not ported."""

    def __init__(self, *_args, **_kwargs):
        raise _unported("RetainedScene", "retained pan")

    @classmethod
    def bake(cls, *_args, **_kwargs):
        raise _unported("RetainedScene.bake", "retained pan")


def measure_pan_ms_per_frame(*_args, **_kwargs):
    raise _unported("measure_pan_ms_per_frame", "retained pan")
