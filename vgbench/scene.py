"""The frame both sides draw: the configuration's tiger and demo UI through
the program's scene module on one side and the reference's frozen copy on
the other, with the same parameters.

`Env` is what a traffic driver gets: the program's `vg` module, the
configuration and the cell's parameters, the seed's generator, the card,
and the font bytes the configuration names (read once, checked against
its SHA-256, handed to both sides)."""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class Env:
    root: str            # the checkout
    vg: object           # the program's vg:: module (vgtpu_torch)
    config: dict
    params: dict
    seed: int
    device: str
    font_data: bytes

    @property
    def rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seed)

    @property
    def ss(self) -> int:
        return int(self.config["context_config"]["coverage_supersample"])

    @property
    def background(self) -> tuple:
        return tuple(float(v) for v in self.config["background"])

    def create_context(self):
        """A program context on the card with the configuration's
        ContextConfig fields (the rest default)."""
        vg = self.vg
        return vg.createContext(vg.ContextConfig(**self.config["context_config"]),
                                device=self.device)


def read_font(root: str, config: dict) -> bytes:
    font = config["font"]
    with open(os.path.join(root, font["file"]), "rb") as f:
        data = f.read()
    digest = hashlib.sha256(data).hexdigest()
    if digest != font["sha256"]:
        raise RuntimeError(f"{font['file']}: SHA-256 {digest}, the configuration "
                           f"states {font['sha256']}")
    return data


def tiger_at(config: dict, scale_factor: float = 1.0, dx: float = 0.0, dy: float = 0.0):
    """(x, y, scale) of draw_tiger for the configuration's tiger scaled by
    scale_factor about its centre and moved by (dx, dy).  The artwork is
    900 x 900 units (scenes/tiger.tiger_svg_text)."""
    t = config["tiger"]
    s0 = t["scale"]
    s = s0 * scale_factor
    cx, cy = t["x"] + 450.0 * s0, t["y"] + 450.0 * s0
    return cx - 450.0 * s + dx, cy - 450.0 * s + dy, s


def draw_program(env: Env, ctx, tiger, t: float, tiger_drawn: bool = True) -> None:
    """The frame's draw calls on the program: draw_tiger at `tiger` (x, y,
    scale), unless the caller submitted it from a command list, then the
    demo UI at time t."""
    from vgtpu_torch.scenes.demo_ui import draw_demo_ui
    from vgtpu_torch.scenes.tiger import draw_tiger

    if tiger_drawn:
        draw_tiger(ctx, *tiger)
    ui = env.config["ui"]
    draw_demo_ui(ctx, t, ui["x0"], ui["y0"])


def record_reference(env: Env, tiger, t: float, from_list: bool = False):
    """The same frame's draw calls on the reference recorder; returns its
    context (ops, images).  from_list: the tiger comes from a Cacheable
    command list, whose replay merges no draws."""
    from vgbench.reference import vg as rv
    from vgbench.reference.demo_ui import draw_demo_ui
    from vgbench.reference.tiger import draw_tiger

    cfg = env.config
    r = rv.createContext(env.font_data)
    rv.begin(r, 0, cfg["width"], cfg["height"], cfg["dpr"])
    tg = cfg["tiger"]
    r.merge = not from_list
    draw_tiger(r, *tiger, seed=tg["seed"], n_paths=tg["n_paths"])
    r.merge = True
    draw_demo_ui(r, t, cfg["ui"]["x0"], cfg["ui"]["y0"])
    return r
