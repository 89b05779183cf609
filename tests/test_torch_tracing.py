"""The port's tracer (vgtpu_torch/utils/profiler.py) on the CPU: each
FrameProfiler stage keeps its host-clock total and, while a torch profiler
records, is also a CPU range vg.<stage> on the profiler's clock, nested as
the code nests and never a user annotation (which a CUDA trace would mirror
as device events).  The frame path's stages (end(), the recorder's text,
the native binner, the upload's copies), the retained pan's five phases and
renderFrames' fused dispatch; with no profiler recording, no range."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

import vgtpu_torch as vgt  # noqa: E402
from vgtpu_torch import native  # noqa: E402
from vgtpu_torch.raster.frame import plan_to_device  # noqa: E402
from vgtpu_torch.raster.retained import RetainedScene  # noqa: E402
from vgtpu_torch.scenes.small import draw_small_scene  # noqa: E402
from vgtpu_torch.utils import profiler as vgprof  # noqa: E402
from vgtpu_torch.utils.profiler import FrameProfiler  # noqa: E402

FONT = (Path(vgt.__file__).parent / "fonts" / "data" / "DejaVuSans.ttf").read_bytes()
W, H = 512, 256
BG = (0.1, 0.1, 0.12, 1.0)
PAN_PHASES = ("pan.shift", "pan.coverage", "pan.patch", "pan.resample",
              "pan.composite")


def _record(ctx, shift=0.0):
    vgt.begin(ctx, 0, W, H, 1.0)
    vgt.transformTranslate(ctx, shift, 0.0)
    draw_small_scene(ctx, FONT)
    f = vgt.createFont(ctx, "sans", FONT, len(FONT), 0)
    cfg = vgt.makeTextConfig(ctx, f, 14.0, vgt.TextAlign.TopLeft, vgt.Colors.White)
    vgt.textBox(ctx, cfg, 250, 10, 90, "a box of text that wraps over rows")


def _traced(fn):
    """fn() under a CPU torch.profiler; (result, vg.* events)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith(vgprof.RANGE_PREFIX)]


def _vg_parent(e):
    """The nearest enclosing vg.* range of a profiler event, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith(vgprof.RANGE_PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name


def _inside(e, outer) -> bool:
    return (outer.time_range.start <= e.time_range.start
            and e.time_range.end <= outer.time_range.end)


def _frame(ctx, shift=0.0):
    _record(ctx, shift)
    return vgt.end(ctx, background=BG)


def test_frame_stages_are_nested_cpu_ranges_under_torch_profiler():
    ctx = vgt.createContext(device="cpu")
    _frame(ctx)                        # the second frame takes the same path
    _img, ev = _traced(lambda: _frame(ctx, 3.0))
    names = {e.name for e in ev}
    want = {"vg.record.text", "vg.finalize", "vg.bin", "vg.textures", "vg.upload",
            "vg.upload.resolve_split", "vg.upload.aux", "vg.upload.put",
            "vg.device_dispatch"}
    if native.available():
        want.add("vg.bin.native")
    assert want <= names, sorted(want - names)
    assert not any(e.is_user_annotation for e in ev)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ev)
    top = {"vg.record.text", "vg.fingerprint", "vg.finalize", "vg.bin",
           "vg.textures", "vg.upload", "vg.device_dispatch"}
    by = {n: [e for e in ev if e.name == n] for n in names}
    for e in ev:
        if e.name in top:
            assert _vg_parent(e) is None, e.name
        elif e.name.startswith("vg.upload."):
            assert _vg_parent(e) == "vg.upload", e.name
            assert any(_inside(e, u) for u in by["vg.upload"])
    for e in by.get("vg.bin.native", []):
        assert _vg_parent(e) == "vg.bin"
        assert any(_inside(e, b) for b in by["vg.bin"])
    # the text box is one range, its rows are not ranges of their own
    assert len(by["vg.record.text"]) == 2
    # the record comes before end()'s stages on the profiler's clock
    first_end = min(e.time_range.start for e in by["vg.finalize"])
    assert max(e.time_range.end for e in by["vg.record.text"]) <= first_end


def test_frame_stage_totals_count_each_range_once():
    ctx = vgt.createContext(device="cpu")
    _frame(ctx)
    ctx.profiler.reset()
    _img, ev = _traced(lambda: _frame(ctx, 2.0))
    got = {}
    for e in ev:
        got[e.name] = got.get(e.name, 0) + 1
    for name, n in got.items():
        assert name[len(vgprof.RANGE_PREFIX):] in ctx.profiler.times_ms, name
        assert n == 1 or name in ("vg.record.text", "vg.bin.native"), (name, n)
    assert set(ctx.profiler.times_ms) == {n[len(vgprof.RANGE_PREFIX):] for n in got}


@pytest.fixture(scope="module")
def scene():
    ctx = vgt.createContext(device="cpu")
    _record(ctx)
    return ctx, RetainedScene.bake(ctx, 640, 320, background=BG)


def test_pan_phases_are_ranges_inside_pan(scene):
    ctx, sc = scene
    assert sc.profiler is ctx.profiler and sc.samp_meta is not None
    sc.render(37.25, 5)
    _img, ev = _traced(lambda: sc.render(61.5, 9))
    pans = [e for e in ev if e.name == "vg.pan"]
    assert len(pans) == 1 and _vg_parent(pans[0]) is None
    for phase in PAN_PHASES:
        es = [e for e in ev if e.name == "vg." + phase]
        assert len(es) == 1, phase
        assert _vg_parent(es[0]) == "vg.pan" and _inside(es[0], pans[0]), phase
        assert not es[0].is_user_annotation
    starts = [next(e for e in ev if e.name == "vg." + p).time_range.start
              for p in PAN_PHASES]
    assert starts == sorted(starts)
    assert {e.name for e in ev} == {"vg.pan"} | {"vg." + p for p in PAN_PHASES}


def test_pan_stages_reach_the_baking_context_report(scene):
    ctx, sc = scene
    ctx.profiler.reset()
    for view in ((0, 0), (12.5, 3), (100, 40)):
        sc.render(*view)
    t = ctx.profiler.times_ms
    assert all(t[p] > 0 for p in ("pan",) + PAN_PHASES)
    assert sum(t[p] for p in PAN_PHASES) <= t["pan"]
    assert set(ctx.profiler.report()["ms_per_frame"]) == {"pan", *PAN_PHASES}


def test_layer_path_scene_reports_to_its_context():
    """A Cacheable list moving by translation is baked as a RetainedScene
    (Context._layer_cl_bake); its pan runs inside end()'s dispatch and
    reports there."""
    ctx = vgt.createContext(device="cpu")
    cl = vgt.createCommandList(ctx, vgt.CommandListFlags.Cacheable)
    vgt.beginCommandList(ctx, cl)
    vgt.beginPath(ctx)
    vgt.rect(ctx, 10, 10, 200, 100)
    vgt.fillPath(ctx, vgt.color4ub(90, 90, 200, 200), vgt.FillFlags.ConvexAA)
    vgt.endCommandList(ctx)
    for k in range(4):
        vgt.begin(ctx, 0, 256, 128, 1.0)
        vgt.pushState(ctx)
        vgt.transformTranslate(ctx, 3 * k, 2 * k)
        vgt.submitCommandList(ctx, cl)
        vgt.popState(ctx)
        vgt.end(ctx)
    assert ctx.profiler.counters["layer_cl_hits"] >= 1
    sc = ctx.command_lists[cl.idx]._layer_scene["scene"]
    assert sc.profiler is ctx.profiler
    assert ctx.profiler.times_ms["pan"] > 0
    _img, ev = _traced(lambda: (vgt.begin(ctx, 0, 256, 128, 1.0), vgt.pushState(ctx),
                                vgt.transformTranslate(ctx, 12, 8),
                                vgt.submitCommandList(ctx, cl), vgt.popState(ctx),
                                vgt.end(ctx)))
    pans = [e for e in ev if e.name == "vg.pan"]
    assert len(pans) == 1 and _vg_parent(pans[0]) == "vg.device_dispatch"


def test_no_profiler_no_range_and_the_totals_add_up(monkeypatch):
    opened = []

    def no_range(name):
        opened.append(name)
        raise AssertionError(f"a range {name!r} opened with no profiler recording")

    monkeypatch.setattr(vgprof, "_RecordFunctionFast", no_range)
    assert not torch.autograd.profiler._is_profiler_enabled
    ctx = vgt.createContext(device="cpu")
    _frame(ctx)
    _frame(ctx, 4.0)
    sc = RetainedScene.bake(ctx, 640, 320, background=BG)
    ctx.profiler.reset()
    _frame(ctx, 1.0)
    sc.render(20.5, 6)
    assert opened == []
    t = ctx.profiler.times_ms
    for stage in ("record.text", "finalize", "bin", "textures", "upload",
                  "device_dispatch", "pan", *PAN_PHASES):
        assert t[stage] > 0, stage
    if native.available():
        assert 0 < t["bin.native"] <= t["bin"]
    assert sum(t[s] for s in ("upload.resolve_split", "upload.aux", "upload.put")) <= t["upload"]
    assert sum(t[p] for p in PAN_PHASES) <= t["pan"]


def test_stage_adds_its_time_and_closes_its_range_when_the_code_raises():
    prof = FrameProfiler()

    def boom():
        with prof.stage("fails"):
            raise KeyError("x")

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as tp:
        with pytest.raises(KeyError):
            boom()
        with prof.stage("after"):
            pass
    names = [e.name for e in tp.events()]
    assert "vg.fails" in names and "vg.after" in names
    after = next(e for e in tp.events() if e.name == "vg.after")
    assert _vg_parent(after) is None
    assert prof.times_ms["fails"] >= 0 and "after" in prof.times_ms


def _tensor_leaves(x) -> list:
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _tensor_leaves(v)]
    return [x] if isinstance(x, torch.Tensor) else []


@pytest.mark.parametrize("device_sampling", [False, True])
def test_upload_copies_equals_the_arrays_put(device_sampling):
    ctx = vgt.createContext(vgt.ContextConfig(device_sampling=device_sampling),
                            device="cpu")
    _frame(ctx)
    plan = ctx.last_plan
    prof = FrameProfiler()
    d = plan_to_device(plan, "cpu", profiler=prof)
    arrays = {k: v for k, v in d.items() if k != "bucket_flags"}
    passed = int(isinstance(plan.color_tiles, torch.Tensor))   # device colour tiles
    assert passed == int(device_sampling)
    n_put = len(_tensor_leaves(arrays)) - passed
    assert n_put > 10
    assert prof.counters["upload_copies"] == n_put
    assert prof.counters["upload_bytes"] > 0
    # end() counts the same copies a frame
    before = ctx.profiler.counters["upload_copies"]
    _frame(ctx, 5.0)
    n_frame = len(_tensor_leaves({k: v for k, v in ctx.last_device_arrays.items()
                                  if k != "bucket_flags"})) - passed
    assert ctx.profiler.counters["upload_copies"] - before == n_frame


def test_paint_patch_counts_its_copies():
    def draw(c, col):
        vgt.begin(c, 0, 256, 128, 1.0)
        vgt.beginPath(c)
        vgt.rect(c, 10, 10, 200, 100)
        vgt.fillPath(c, vgt.color4ub(*col, 200), vgt.FillFlags.ConvexAA)
        return vgt.end(c)

    ctx = vgt.createContext(device="cpu")
    draw(ctx, (200, 40, 40))
    before = ctx.profiler.counters["upload_copies"]
    draw(ctx, (40, 200, 40))
    assert ctx.profiler.counters["memo_paint_hits"] == 1
    assert ctx.profiler.counters["upload_copies"] - before == 1   # entry_paint


def test_render_frames_fused_dispatch_is_a_stage_of_each_context():
    ctxs = []
    for shift in (0.0, 6.0):
        c = vgt.createContext(device="cpu")
        _record(c, shift)
        assert vgt.end(c, background=BG, dispatch=False) is None
        ctxs.append(c)
    imgs, ev = _traced(lambda: vgt.renderFrames(ctxs))
    # one stage a context, opened together: the profiler's event tree may
    # show the nested same-named ranges as one
    fused = [e for e in ev if e.name == "vg.fused_dispatch"]
    assert 1 <= len(fused) <= len(ctxs)
    assert not any(e.is_user_annotation for e in fused)
    t = [c.profiler.times_ms["fused_dispatch"] for c in ctxs]
    assert t[0] > 0 and t[1] > 0
    for c, img in zip(ctxs, imgs):
        assert c.frame_image is img
    assert np.isfinite(imgs[0].numpy()).all()
