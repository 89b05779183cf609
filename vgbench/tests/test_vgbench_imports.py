"""Nothing the benchmark runs loads jax or the JAX package (vgtpu), by
whole top-level module name: vgtpu_torch starts with vgtpu and is the
program, so a prefix test would be wrong.  The reference imports neither,
nor anything of the program."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VGBENCH = os.path.join(ROOT, "vgbench")


def imported_tops(path: str) -> set:
    """Top-level names of every module a file imports (absolute imports)."""
    tree = ast.parse(open(path).read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def py_files(d: str) -> list:
    return [os.path.join(dp, f) for dp, _dn, fs in os.walk(d) for f in fs
            if f.endswith(".py") and "out" not in dp.split(os.sep)]


def test_top_level_names_compare_whole():
    assert "vgtpu_torch".split(".")[0] != "vgtpu"
    assert imported_tops.__doc__


@pytest.mark.parametrize("path", py_files(os.path.join(VGBENCH, "reference")),
                         ids=os.path.basename)
def test_the_reference_imports_no_jax_no_vgtpu_no_program(path):
    assert not imported_tops(path) & {"jax", "jaxlib", "flax", "vgtpu", "vgtpu_torch"}


def test_no_benchmark_file_imports_jax_or_vgtpu():
    for path in py_files(VGBENCH):
        assert not imported_tops(path) & {"jax", "jaxlib", "flax", "vgtpu"}, path


SETUP = r"""
import sys
sys.path.insert(0, ROOT)
sys.path.insert(0, TESTS)
from conftest import _small_cell
from vgbench import harness
for cell in ("tiger_ui_1080p.animate", "tiger_ui_1080p.scroll", "tiger_ui_1080p_ss2.app"):
    wl, cfg = _small_cell(cell)
    env, driver = harness.make_driver(wl, cfg, ROOT, 2**31 + 9, "cpu")
    harness.run_frames(driver, driver.warmup_frames(), harness.Spans(), lambda: None)
    driver.frame(0, harness.Spans())
    driver.reference(0)
bad = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "vgtpu"})
print("LOADED", bad)
assert "vgtpu_torch" in sys.modules
"""


def test_a_cells_setup_path_loads_no_jax_and_no_vgtpu():
    code = SETUP.replace("ROOT", repr(ROOT)).replace("TESTS", repr(os.path.dirname(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


PLANTED = r"""
import sys, time
sys.path.insert(0, COPY)
sys.path.insert(1, TESTS)
from conftest import _small_cell
from vgbench import harness
assert harness.__file__.startswith(COPY)
bench = harness.load_json(COPY, "BENCHMARK.json")
wl, cfg = _small_cell("tiger_ui_1080p.animate")
args = harness.parse(["--workload", "tiger_ui_1080p.animate", "--seed", "5",
                      "--seconds", "0.2", "--trace", "TRACE"])
sys.exit(harness.run(args, bench, wl, cfg, COPY, time.perf_counter(), device="cpu",
                     cpu_sync=True))
"""
# a module object under a forbidden top-level name, as an import of it leaves
PLANT = "import sys as _sys, types as _types\n_sys.modules.setdefault({name!r}, _types.ModuleType({name!r}))\n"


@pytest.mark.parametrize("where", ["metric", "reference"])
def test_a_forbidden_import_in_a_metric_or_the_reference_gives_no_result(where, tmp_path):
    """The look at sys.modules comes last: a per-layer metric's reader
    (loaded in a traced run) or the reference (first imported by the
    check) that loads vgtpu or jax leaves the run without a result."""
    copy = str(tmp_path / "checkout")
    shutil.copytree(VGBENCH, os.path.join(copy, "vgbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    os.symlink(os.path.join(ROOT, "vgtpu_torch"), os.path.join(copy, "vgtpu_torch"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    if where == "metric":
        name, trace = "vgtpu", 1
        with open(os.path.join(copy, "vgbench", "metrics", "planted_ms.py"), "w") as f:
            f.write(PLANT.format(name=name) + "\n\ndef read(obs):\n    return 1.0\n")
        bench["per_layer"].append({"name": "planted_ms", "unit": "ms", "better": "lower",
                                   "source": "host_clock", "layer": "recorder",
                                   "moves": "frame_ms",
                                   "workloads": ["tiger_ui_1080p.animate"]})
    else:
        name, trace = "jax", 0
        with open(os.path.join(copy, "vgbench", "reference", "raster.py"), "a") as f:
            f.write("\n" + PLANT.format(name=name))
    with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    code = (PLANTED.replace("COPY", repr(copy)).replace("TRACE", str(trace))
            .replace("TESTS", repr(os.path.join(copy, "vgbench", "tests"))))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=copy, env=env, timeout=600)
    assert out.returncode == 3, out.stderr[-3000:]
    assert f"loaded ['{name}']" in out.stderr
    assert '"correct"' not in out.stdout
