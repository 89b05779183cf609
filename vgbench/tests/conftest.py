"""The benchmark's own tests: on the CPU without nvcc, triton or a card.
Tests that need the card carry the `card` marker and skip here; on a
machine with the card: python3 -m pytest vgbench/tests -m card (README.md)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    """Skips the test unless torch sees a CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m card where there is one)")
    return "cuda:0"


@pytest.fixture
def small_cell():
    """small_cell(name, dpr=0.25) -> (workload, config); see _small_cell."""
    return _small_cell


def _small_cell(name: str, dpr: float = 0.25):
    """(workload, config) of a cell cut for the CPU: the frame at dpr (a
    smaller framebuffer of the same drawing), one warm-up frame, two kept
    frames, three traced, the scroll scene and steps scaled to match."""
    from vgbench import harness

    wl = harness.load_json(ROOT, "vgbench", "workloads", f"{name}.json")
    cfg = harness.load_json(ROOT, "vgbench", "configs", f"{wl['config']}.json")
    cfg["dpr"] = dpr
    p = wl["params"]
    p.update(warmup_frames=1, check_frames=2, trace_frames=3)
    if "scene" in p:
        p["scene"] = [round(v * dpr) for v in p["scene"]]
        p["step_px"] = [p["step_px"][0] * dpr, p["step_px"][1]]
    return wl, cfg
