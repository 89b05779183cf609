"""The port's VariantBatch and renderFrames on the CPU, against vgtpu.

Each variant of the port's batch (coverage once, then every bucket through
K2 form (c)'s twin: K variant blocks sharing one block of coverage rows) is
held to vgtpu's per-frame end() of that variant, and each renderFrames image
(contexts ended with end(dispatch=False)) to vgtpu's own end() of the same
scene: atol=1e-5 and 1 u8 level after image_to_u8.  The cases mirror
tests/test_batch.py's; render_sharded runs on CPU meshes of repeated
devices against vgtpu's render_sharded on its virtual mesh (3e-6)."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

import vgtpu as vgj  # noqa: E402
import vgtpu_torch as vgt  # noqa: E402
from tests.fontdata import FONT_DATA  # noqa: E402
from tests.test_torch_memo import BG, H, W, draw_scene  # noqa: E402
from vgtpu.raster.frame import image_to_u8 as image_to_u8_j  # noqa: E402
from vgtpu_torch.raster.batch import VariantBatch, measure_batch_ms_per_frame  # noqa: E402
from vgtpu_torch.raster.frame import image_to_u8  # noqa: E402

ATOL = 1e-5

VARIANTS = [
    dict(rect_col=(90, 140, 220, 160), circ_col=(250, 210, 60, 255)),
    dict(rect_col=(220, 90, 140, 160), circ_col=(60, 250, 210, 255),
         grad=((40, 250, 60, 255), (250, 40, 60, 255)),
         text_col=(255, 220, 40, 255)),
    dict(rect_col=(140, 220, 90, 160), circ_col=(210, 60, 250, 255),
         grad_geo=(40.0, 10.0, 160.0, 110.0),
         stroke_col=(220, 20, 120, 255)),
]
VARIANTS2 = [
    dict(rect_col=(30, 30, 200, 160), circ_col=(10, 250, 110, 255)),
    dict(rect_col=(180, 180, 40, 160), circ_col=(250, 10, 110, 255),
         grad=((250, 250, 60, 255), (60, 250, 250, 255))),
    dict(rect_col=(90, 90, 90, 160), circ_col=(250, 250, 250, 255),
         stroke_col=(40, 40, 220, 255)),
]


def _close(got, ref, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=what)
    u8 = np.abs(image_to_u8(got).astype(np.int16)
                - image_to_u8_j(ref).astype(np.int16)).max()
    assert u8 <= 1, f"{what}: {u8} u8 levels"


def _font(ctx, vg):
    return (vg.createFont(ctx, "sans", FONT_DATA, len(FONT_DATA), 0)
            if FONT_DATA is not None else None)


def _draw_variant(c, vg, font, p):
    draw_scene(c, vg, font, **p)
    # corner probes: content in flat tile 0 AND the last tile, so the
    # batch's pad-row scratch ids and k*T offsets are held to the oracle
    col = p["circ_col"]
    vg.beginPath(c)
    vg.rect(c, 1, 1, 40, 5)
    vg.fillPath(c, vg.color4ub(col[0], col[1], col[2], 200), vg.FillFlags.ConvexAA)
    vg.beginPath(c)
    vg.rect(c, W - 30, H - 6, 26, 5)
    vg.fillPath(c, vg.color4ub(col[2], col[0], col[1], 200), vg.FillFlags.ConvexAA)


def _oracle(draw, w=W, h=H, dpr=1.0, setup=None, **cfg):
    """vgtpu's end() of one frame: draw(ctx, vg, state)."""
    ctx = vgj.createContext(vgj.ContextConfig(**cfg))
    st = setup(ctx, vgj) if setup else None
    vgj.begin(ctx, 0, w, h, dpr)
    draw(ctx, vgj, st)
    return np.asarray(vgj.end(ctx, background=BG))


def _variant_fns(variants):
    return [lambda c, vg, font, p=p: _draw_variant(c, vg, font, p)
            for p in variants]


def _bake(draws, w=W, h=H, dpr=1.0, setup=None, **cfg):
    ctx = vgt.createContext(vgt.ContextConfig(**cfg), device="cpu")
    st = setup(ctx, vgt) if setup else None
    vb = VariantBatch.bake(ctx, [lambda c, f=f: f(c, vgt, st) for f in draws],
                           w, h, dpr=dpr, background=BG)
    return vb, ctx, st


def _check_batch(vb, draws, w=W, h=H, dpr=1.0, setup=None, **cfg):
    imgs = vb.render(background=BG)
    assert imgs.shape == (len(draws), round(h * dpr), round(w * dpr), 4)
    assert imgs.device.type == "cpu"
    for k, f in enumerate(draws):
        _close(imgs[k], _oracle(f, w, h, dpr, setup, **cfg), f"variant {k}")


def test_batch_matches_per_frame():
    draws = _variant_fns(VARIANTS)
    vb, _ctx, _ = _bake(draws, setup=_font)
    # form (c): every bucket's params hold K lane blocks over one block of
    # coverage rows
    for pteb, pp in zip(vb._tables["pteb"], vb._params):
        assert pp.shape[2] == len(VARIANTS) * pteb.shape[0]
    _check_batch(vb, draws, setup=_font)


def test_structural_variant_raises():
    def base(c, vg, font):
        draw_scene(c, vg, font, **VARIANTS[0])

    def extra(c, vg, font):
        base(c, vg, font)
        vg.beginPath(c)
        vg.circle(c, 60, 60, 10)
        vg.fillPath(c, vg.Colors.Red, vg.FillFlags.ConvexAA)

    with pytest.raises(ValueError, match="structure"):
        _bake([base, extra], setup=_font)


def test_opacity_class_flip_raises():
    a = dict(VARIANTS[0])
    b = dict(VARIANTS[0], circ_col=(250, 210, 60, 120))   # opaque -> translucent
    with pytest.raises(ValueError, match="structure"):
        _bake([lambda c, vg, f: draw_scene(c, vg, f, **a),
               lambda c, vg, f: draw_scene(c, vg, f, **b)], setup=_font)


def test_bake_requires_the_memos():
    ctx = vgt.createContext(vgt.ContextConfig(paint_memo=False), device="cpu")
    with pytest.raises(ValueError, match="paint_memo"):
        VariantBatch.bake(ctx, [lambda c: None], W, H)


def test_batch_dpr2_matches_per_frame():
    draws = _variant_fns(VARIANTS[:2])
    vb, _ctx, _ = _bake(draws, dpr=2.0, setup=_font)
    _check_batch(vb, draws, dpr=2.0, setup=_font)


def test_batch_supersample_matches_per_frame():
    """ss=2: the resident plan is split, the batch builds its own coverage
    rows over all pools and every bucket takes form (d) with k_rep."""
    draws = _variant_fns(VARIANTS)
    vb, ctx, _ = _bake(draws, coverage_supersample=2)
    assert ctx.last_device_arrays["res"] is not None
    _check_batch(vb, draws, coverage_supersample=2)


def test_batch_clip_scissor_pattern_matches_per_frame():
    """Clip + scissor + an image pattern whose tint varies per variant: the
    K colour-tile tables stack and each block's ctile ids are offset."""
    rng = np.random.default_rng(5)
    img_data = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    img_data[..., 3] = 255
    tints = [(255, 255, 255, 255), (255, 160, 80, 255), (90, 200, 255, 200)]

    def setup(ctx, vg):
        return vg.createImage(ctx, 16, 16, 0, img_data)

    def draw(tint):
        def f(c, vg, img):
            vg.beginClip(c, vg.ClipRule.In)
            vg.beginPath(c)
            vg.circle(c, 120, 80, 70)
            vg.fillPath(c, vg.Colors.Black, vg.FillFlags.Convex)
            vg.endClip(c)
            p = vg.createImagePattern(c, 40, 20, 160, 120, 0.0, img)
            vg.beginPath(c)
            vg.rect(c, 40, 20, 160, 120)
            vg.fillPath(c, p, vg.color4ub(*tint), vg.FillFlags.ConvexAA)
            vg.resetClip(c)
            vg.setScissor(c, 180, 40, 120, 100)
            vg.beginPath(c)
            vg.rect(c, 160, 30, 150, 120)
            vg.fillPath(c, vg.color4ub(tint[0], tint[2], tint[1], 220),
                        vg.FillFlags.ConvexAA)
            vg.resetScissor(c)
        return f

    draws = [draw(t) for t in tints]
    vb, _ctx, _ = _bake(draws, setup=setup)
    assert vb._ct_flat.shape[0] == 3 * vb._d["ct_flat"].shape[0]
    _check_batch(vb, draws, setup=setup)


def test_batch_one_wide_bucket_shares_coverage():
    """A 1024x128 canvas fully covered by one rect: one bucket of 128 tiles,
    K=3 variant blocks of it (vgtpu's k_rep case)."""
    w, h = 1024, 128
    cols = [(200, 60, 40, 220), (40, 200, 60, 220), (60, 40, 200, 220)]

    def variant(k):
        def f(c, vg, _st):
            vg.beginPath(c)
            vg.rect(c, -4, -4, w + 8, h + 8)
            vg.fillPath(c, vg.color4ub(*cols[k]), vg.FillFlags.ConvexAA)
            vg.beginPath(c)
            vg.circle(c, 100, 60, 40)
            vg.fillPath(c, vg.color4ub(*cols[(k + 1) % 3]), vg.FillFlags.ConvexAA)
        return f

    draws = [variant(k) for k in range(3)]
    vb, _ctx, _ = _bake(draws, w=w, h=h)
    assert max(p.shape[0] for p in vb._tables["pteb"]) >= 128
    _check_batch(vb, draws, w=w, h=h)


def test_update_values_refreshes_in_place():
    ctx = vgt.createContext(device="cpu")
    font = _font(ctx, vgt)
    vb = VariantBatch.bake(
        ctx, [lambda c, p=p: _draw_variant(c, vgt, font, p) for p in VARIANTS],
        W, H, background=BG)
    tables = vb._tables
    vb.update_values(
        [lambda c, p=p: _draw_variant(c, vgt, font, p) for p in VARIANTS2])
    assert vb._tables is tables
    _check_batch(vb, _variant_fns(VARIANTS2), setup=_font)


def test_update_values_rejects_structural_delta():
    ctx = vgt.createContext(device="cpu")
    font = _font(ctx, vgt)
    good = [lambda c, p=p: _draw_variant(c, vgt, font, p) for p in VARIANTS]
    vb = VariantBatch.bake(ctx, good, W, H, background=BG)

    def structural(c):
        _draw_variant(c, vgt, font, VARIANTS[0])
        vgt.beginPath(c)
        vgt.circle(c, 77, 77, 9)
        vgt.fillPath(c, vgt.Colors.Red, vgt.FillFlags.ConvexAA)

    with pytest.raises(ValueError, match="structure"):
        vb.update_values([good[0], structural, good[2]])
    with pytest.raises(ValueError, match="draw_fns"):
        vb.update_values(good[:2])


def test_measure_batch_ms_per_frame_runs():
    vb, _ctx, _ = _bake(_variant_fns(VARIANTS[:2]))
    ms = measure_batch_ms_per_frame(vb, background=BG, reps_hi=3, reps_lo=1)
    assert np.isfinite(ms)


def _fuzz_scene(rng):
    shapes = []
    for _ in range(int(rng.integers(8, 16))):
        kind = rng.choice(["rect", "circle", "rrect", "stroke", "gradrect",
                           "star"])
        x, y = rng.uniform(-10, W - 5), rng.uniform(-10, H - 5)
        w, h = rng.uniform(4, 120), rng.uniform(4, 70)
        shapes.append(dict(kind=str(kind), x=x, y=y, w=w, h=h,
                           opaque=bool(rng.uniform() < 0.5),
                           r=rng.uniform(2, 30), sw=rng.uniform(0.4, 9),
                           aa=bool(rng.uniform() < 0.8)))
    return shapes


def _draw_fuzz(ctx, vg, shapes, crng):
    def col(opaque):
        a = 255 if opaque else int(crng.integers(40, 230))
        return vg.color4ub(*(int(v) for v in crng.integers(0, 256, 3)), a)

    for s in shapes:
        fill = vg.FillFlags.ConvexAA if s["aa"] else vg.FillFlags.Convex
        vg.beginPath(ctx)
        if s["kind"] == "rect":
            vg.rect(ctx, s["x"], s["y"], s["w"], s["h"])
        elif s["kind"] == "circle":
            vg.circle(ctx, s["x"], s["y"], s["r"])
        elif s["kind"] == "rrect":
            vg.roundedRect(ctx, s["x"], s["y"], s["w"], s["h"],
                           min(s["r"], s["w"] / 2, s["h"] / 2))
        elif s["kind"] == "star":
            ang = -np.pi / 2 + np.arange(5) * (4 * np.pi / 5)
            vg.moveTo(ctx, s["x"] + s["r"] * np.cos(ang[0]),
                      s["y"] + s["r"] * np.sin(ang[0]))
            for a in ang[1:]:
                vg.lineTo(ctx, s["x"] + s["r"] * np.cos(a),
                          s["y"] + s["r"] * np.sin(a))
            vg.closePath(ctx)
            fill = (vg.FillFlags.ConcaveEvenOddAA if s["aa"]
                    else vg.FillFlags.ConcaveEvenOdd)
        elif s["kind"] == "gradrect":
            g = vg.createLinearGradient(ctx, s["x"], s["y"], s["x"] + s["w"],
                                        s["y"] + s["h"], col(False), col(False))
            vg.rect(ctx, s["x"], s["y"], s["w"], s["h"])
            vg.fillPath(ctx, g, fill)
            continue
        if s["kind"] == "stroke":
            vg.moveTo(ctx, s["x"], s["y"])
            vg.cubicTo(ctx, s["x"] + s["w"] / 3, s["y"] + s["h"],
                       s["x"] + 2 * s["w"] / 3, s["y"] - s["h"] / 2,
                       s["x"] + s["w"], s["y"] + s["h"] / 3)
            vg.strokePath(ctx, col(s["opaque"]), s["sw"],
                          vg.StrokeFlags.RoundRoundAA if s["aa"]
                          else vg.StrokeFlags.ButtMiter)
        else:
            vg.fillPath(ctx, col(s["opaque"]), fill)


@pytest.mark.parametrize("seed", [3, 17, 41])
def test_fuzz_batch_matches_per_frame(seed):
    shapes = _fuzz_scene(np.random.default_rng(seed))
    draws = [lambda c, vg, _st, k=k: _draw_fuzz(
        c, vg, shapes, np.random.default_rng(1000 * seed + k)) for k in range(3)]
    vb, _ctx, _ = _bake(draws)
    _check_batch(vb, draws)


# ---- renderFrames + end(dispatch=False) (tests/test_batch.py:358-568) -------

def _scene_a(c, vg, _st):
    vg.beginPath(c)
    vg.roundedRect(c, 10, 10, 150, 90, 18)
    vg.fillPath(c, vg.color4ub(200, 80, 40, 255), vg.FillFlags.ConvexAA)


def _scene_b(c, vg, _st):
    vg.beginPath(c)
    vg.circle(c, 100, 60, 45)
    vg.fillPath(c, vg.color4ub(40, 80, 200, 180), vg.FillFlags.ConvexAA)
    vg.strokePath(c, vg.Colors.White, 3.0, vg.StrokeFlags.RoundRoundAA)


def test_render_frames_multi_canvas():
    """Heterogeneous contexts (sizes, scenes, ss) rendered back to back,
    each equal to vgtpu's end() of its scene."""
    cases = [((256, 128), _scene_a, {}), ((320, 160), _scene_b, {}),
             ((320, 160), _scene_b, {"coverage_supersample": 2})]
    ctxs = []
    for (w, h), fn, cfg in cases:
        ctx = vgt.createContext(vgt.ContextConfig(**cfg), device="cpu")
        vgt.begin(ctx, 0, w, h, 1.0)
        fn(ctx, vgt, None)
        out = vgt.end(ctx, background=BG, dispatch=False)
        assert out is None and ctx.frame_image is None
        ctxs.append(ctx)
    imgs = vgt.renderFrames(ctxs)
    for ctx, img, ((w, h), fn, cfg) in zip(ctxs, imgs, cases):
        assert tuple(img.shape) == (h, w, 4)
        assert ctx.frame_image is img
        assert ctx.profiler.times_ms["fused_dispatch"] > 0
        _close(img, _oracle(fn, w, h, **cfg), f"canvas {w}x{h} {cfg}")


def test_render_frames_requires_resident_plan():
    ctx = vgt.createContext(device="cpu")
    with pytest.raises(ValueError, match="resident"):
        vgt.renderFrames([ctx])


def test_render_frames_rejects_stale_plan():
    """begin() without end() leaves the resident plan stale."""
    ctx = vgt.createContext(device="cpu")
    vgt.begin(ctx, 0, 128, 64, 1.0)
    _scene_a(ctx, vgt, None)
    vgt.end(ctx, background=BG, dispatch=False)
    vgt.renderFrames([ctx])
    vgt.begin(ctx, 0, 128, 64, 1.0)
    with pytest.raises(ValueError, match="STALE"):
        vgt.renderFrames([ctx])


def test_render_frames_backgrounds_length_checked():
    ctx = vgt.createContext(device="cpu")
    vgt.begin(ctx, 0, 128, 64, 1.0)
    _scene_a(ctx, vgt, None)
    vgt.end(ctx, background=BG, dispatch=False)
    with pytest.raises(ValueError, match="backgrounds"):
        vgt.renderFrames([ctx], backgrounds=[BG, BG])


def test_render_frames_after_paint_patch():
    """A paint-patched resident plan (end(dispatch=False) on a values-only
    delta) renders the PATCHED colours through renderFrames."""
    def scene(col):
        def f(c, vg, _st):
            vg.beginPath(c)
            vg.roundedRect(c, 10, 10, 150, 90, 18)
            vg.fillPath(c, vg.color4ub(*col), vg.FillFlags.ConvexAA)
            vg.beginPath(c)
            vg.circle(c, 210, 64, 40)
            vg.fillPath(c, vg.color4ub(40, 80, 200, 180), vg.FillFlags.ConvexAA)
        return f

    ctx = vgt.createContext(device="cpu")
    for col in ((200, 80, 40, 200), (40, 200, 90, 200)):
        vgt.begin(ctx, 0, 256, 128, 1.0)
        scene(col)(ctx, vgt, None)
        vgt.end(ctx, background=BG, dispatch=False)
    assert ctx.profiler.counters.get("memo_paint_hits", 0) == 1
    (img,) = vgt.renderFrames([ctx])
    _close(img, _oracle(scene((40, 200, 90, 200)), 256, 128), "patched frame")


def test_render_frames_over_a_resident_layer():
    """A layered context (the layer memo's resident tiles) through
    end(dispatch=False) + renderFrames: the suffix plan composites over the
    layer (K2 form (b)'s twin)."""
    def frame(k):
        def f(c, vg, _st):
            for i in range(20):
                vg.beginPath(c)
                vg.circle(c, 20 + 14 * (i % 10), 30 + 40 * (i // 10), 9 + (i % 3))
                vg.fillPath(c, vg.color4ub(40 + 10 * i, 200 - 7 * i, 90, 200),
                            vg.FillFlags.ConvexAA)
            vg.beginPath(c)
            vg.rect(c, 30 + 50 * k, 100, 60, 30)
            vg.fillPath(c, vg.color4ub(250, 210, 60, 220), vg.FillFlags.ConvexAA)
        return f

    ctx = vgt.createContext(device="cpu")
    for k in (0.0, 0.3, 0.6):
        vgt.begin(ctx, 0, W, H, 1.0)
        frame(k)(ctx, vgt, None)
        vgt.end(ctx, background=BG, dispatch=False)
    assert ctx._layer_render is not None
    (img,) = vgt.renderFrames([ctx])
    _close(img, _oracle(frame(0.6)), "layered frame")


# ---- render_sharded: the variant axis over a mesh ----------------------------

def _cpu_mesh(n):
    from vgtpu_torch.parallel.sharding import Mesh

    return Mesh((torch.device("cpu"),) * n)


@pytest.mark.parametrize("n", [2, 4])
def test_render_sharded_matches_vgtpu_and_per_frame(n):
    """K=3 over 2 and 4 shards (padded to 4: the last variant repeats) against
    vgtpu's render_sharded on as many virtual devices (3e-6) and against the
    port's own per-variant end() images (1 u8 level)."""
    import jax

    from vgtpu.raster.batch import VariantBatch as VariantBatchJ

    draws = _variant_fns(VARIANTS)
    vb, _ctx, _ = _bake(draws, setup=_font)
    imgs = vb.render_sharded(_cpu_mesh(n), background=BG)
    assert imgs.shape == (len(VARIANTS), H, W, 4) and imgs.device.type == "cpu"

    ctx_j = vgj.createContext(vgj.ContextConfig())
    font_j = _font(ctx_j, vgj)
    vb_j = VariantBatchJ.bake(ctx_j, [lambda c, f=f: f(c, vgj, font_j) for f in draws],
                              W, H, background=BG)
    mesh_j = jax.make_mesh((n,), ("variants",), devices=jax.devices()[:n])
    ref = np.asarray(vb_j.render_sharded(mesh_j, background=BG))
    np.testing.assert_allclose(imgs.numpy(), ref, atol=3e-6, rtol=0)
    for k, f in enumerate(draws):
        c = vgt.createContext(device="cpu")
        font = _font(c, vgt)
        vgt.begin(c, 0, W, H, 1.0)
        f(c, vgt, font)
        single = vgt.end(c, background=BG)
        u8 = np.abs(image_to_u8(imgs[k]).astype(np.int16)
                    - image_to_u8(single).astype(np.int16)).max()
        assert u8 <= 1, f"variant {k}: {u8} u8 levels"


def test_render_sharded_after_update_values():
    """tests/test_batch.py's serving tick: update_values swaps the values
    and the sharded render (its value tables cached per mesh) shows them."""
    ctx = vgt.createContext(device="cpu")
    font = _font(ctx, vgt)
    vb = VariantBatch.bake(
        ctx, [lambda c, p=p: _draw_variant(c, vgt, font, p) for p in VARIANTS],
        W, H, background=BG)
    mesh = _cpu_mesh(2)
    vb.render_sharded(mesh, background=BG)          # fills the mesh's cache
    structure = vb._sharded[mesh]["struct"]
    vb.update_values(
        [lambda c, p=p: _draw_variant(c, vgt, font, p) for p in VARIANTS2])
    assert vb._sharded[mesh]["values"] is None
    imgs = vb.render_sharded(mesh, background=BG)
    assert vb._sharded[mesh]["struct"] is structure
    for k, f in enumerate(_variant_fns(VARIANTS2)):
        _close(imgs[k], _oracle(f, setup=_font), f"sharded variant {k}")


def test_measure_batch_records_on_the_batchs_device(monkeypatch):
    """measure_batch_ms_per_frame records and waits on its CUDA events
    inside torch.cuda.device(the batch's device), not on the current one:
    a batch on cuda:1 with stand-ins for the device context and events."""
    import contextlib

    from vgtpu_torch.raster import batch as batch_mod

    current = ["cuda:0"]
    seen = []

    @contextlib.contextmanager
    def device(dev):
        prev, current[0] = current[0], str(dev)
        try:
            yield
        finally:
            current[0] = prev

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            seen.append(("record", current[0]))
            self.t = float(len(seen))

        def synchronize(self):
            seen.append(("synchronize", current[0]))

        def elapsed_time(self, other):
            return other.t - self.t

    class FakeBatch:
        K = 2
        device = torch.device("cuda", 1)

        def render(self, _bg):
            seen.append(("render", current[0]))

    monkeypatch.setattr(batch_mod.torch.cuda, "device", device)
    monkeypatch.setattr(batch_mod.torch.cuda, "Event", Event)
    ms = measure_batch_ms_per_frame(FakeBatch(), reps_hi=3, reps_lo=1)
    assert np.isfinite(ms)
    assert seen and all(where == "cuda:1" for _what, where in seen), seen
    assert {what for what, _ in seen} == {"record", "synchronize", "render"}
