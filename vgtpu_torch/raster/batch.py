"""Batched paint-variant rendering (vgtpu/raster/batch.py): not ported yet.

The names exist so that code written against vgtpu reaches a clear
NotImplementedError naming the ROADMAP.md item."""

from __future__ import annotations

from vgtpu_torch.api.context import _unported


class VariantBatch:
    """K paint variants of one scene in one dispatch: not ported."""

    def __init__(self, *_args, **_kwargs):
        raise _unported("VariantBatch", "batch with K2 (c)")

    @classmethod
    def bake(cls, *_args, **_kwargs):
        raise _unported("VariantBatch.bake", "batch with K2 (c)")


def measure_batch_ms_per_frame(*_args, **_kwargs):
    raise _unported("measure_batch_ms_per_frame", "batch with K2 (c)")
