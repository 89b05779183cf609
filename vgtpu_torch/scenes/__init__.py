"""Scenes: the SVG loader, the procedural tiger, the demo UI and the small
feature scene."""

from vgtpu_torch.scenes import demo_ui, small, svg, tiger  # noqa: F401
