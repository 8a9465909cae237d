"""Every cell of BENCHMARK.json end to end at a tiny size on the CPU, the
comparison's control and faults, the data-driven layout, and the run's
refusals. The program's slice loop runs its plain PyTorch version here.

    python -m pytest ovrbench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ovrbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# a tiny volume and frame; 512 voxels across turns on the shading's
# finite-difference gradient, as at the cells' real sizes
TINY = {"dims_xyz": [20, 18, 22],
        "render": {"width": 48, "height": 32, "sampling_rate": 24.0}}
TINY_FD = {"dims_xyz": [512, 512, 20],
           "render": {"width": 48, "height": 32, "sampling_rate": 24.0}}
SEED = 3_000_000_017  # beyond 32 bits, as the driver's seeds are
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def tiny_cell(name: str, root: Path = ROOT) -> run.Cell:
    cell = run.Cell(root, name)
    # the whole tiny frame is fewer pixels than the real limit asks for
    cell.limits = dict(cell.limits, checked_px={"min": 50})
    return cell


def run_tiny(name, traced=False, overrides=TINY, render_options=None,
             root=ROOT, seed=SEED):
    return run.run_cell(tiny_cell(name, root), seed, 0.3, traced, "cpu",
                        overrides=overrides, render_options=render_options)


def well_formed(res: dict, cell: run.Cell, traced: bool) -> None:
    assert list(res)[:5] == list(KEYS)
    assert list(res)[-1] == "compared"
    json.loads(json.dumps(res))
    names = {m["name"] for m in (cell.per_layer if traced
                                 else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    assert res["attempted"] > 0 and res["failed"] == 0
    for v in res["compared"].values():
        assert set(v) == {"value", "limit"}


@pytest.mark.parametrize("traced", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_end_to_end(name, traced):
    res, lines = run_tiny(name, traced)
    cell = tiny_cell(name)
    well_formed(res, cell, traced)
    assert res["correct"], lines
    if not traced:
        # the host-clock metrics exist on any device
        want = {m["name"] for m in cell.end_to_end} - {"peak_mem_gib"}
        assert want <= set(res["metrics"])
    else:
        assert res["attempted"] == (cell.mix["trace_views"]
                                    * cell.mix["trace_repeats"])


@pytest.mark.parametrize("name", [c for c in CELLS if "orbit" in c])
def test_cell_with_finite_difference_gradient(name):
    res, lines = run_tiny(name, overrides=TINY_FD)
    assert res["correct"], lines


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The program's own lower-precision path (bf16 resampling operands)
    in place of the timed path: the comparison must refuse it."""
    res, lines = run_tiny(name, render_options={"sw_bf16": True})
    assert not res["correct"], lines
    assert res["compared"]["rgba_err"]["value"] > res["compared"][
        "rgba_err"]["limit"]


def _stale(monkeypatch):
    """A frame that returns the renderer's state unchanged."""
    from ovr_tpu_torch import api
    real = api.Renderer.render

    def render(self):
        if self._frame is None:
            real(self)

    monkeypatch.setattr(api.Renderer, "render", render)


def _half_rows(monkeypatch):
    """Half of the fan's rows left out of the slice loop."""
    from ovr_tpu_torch.ops import swslice
    real = swslice.slice_composite

    def sc(*a, **k):
        out = real(*a, **k).clone()
        out[:, out.shape[1] // 2:] = 0.0
        return out

    monkeypatch.setattr(swslice, "slice_composite", sc)


def _altered(monkeypatch):
    """Each fan ray's red altered by 1e-2 of its alpha where it is
    composited."""
    from ovr_tpu_torch.ops import swslice
    real = swslice.slice_composite

    def sc(*a, **k):
        out = real(*a, **k).clone()
        out[0] += 1e-2 * out[7]
        return out

    monkeypatch.setattr(swslice, "slice_composite", sc)


@pytest.mark.parametrize("fault", [_stale, _half_rows, _altered],
                         ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(name, fault, monkeypatch):
    fault(monkeypatch)
    res, lines = run_tiny(name)
    assert not res["correct"], lines


def test_new_cell_from_new_files_only(tmp_path):
    """A cell, configuration, mix and per-layer metric added as new files
    and entries, with no file of the benchmark edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "ovrbench", tmp_path / "ovrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*")
              if p.is_file() and p.name != "BENCHMARK.json"}
    ob = tmp_path / "ovrbench"
    cfg = json.loads((ob / "configs" / "miranda-f32.json").read_text())
    cfg["name"] = "dummy-f32"
    (ob / "configs" / "dummy-f32.json").write_text(json.dumps(cfg))
    mix = json.loads((ob / "traffic" / "orbit-diffuse.json").read_text())
    mix["camera"]["deg_per_frame"] = 5.0
    (ob / "traffic" / "orbit-slow.json").write_text(json.dumps(mix))
    (ob / "metrics" / "frames_traced.py").write_text(
        "def read(run):\n"
        "    return None if run.trace is None else float(len("
        "run.frame_times))\n")
    (ob / "limits" / "dummy-f32.orbit-slow.json").write_text(
        json.dumps({"rgba_err": {"max": 1e-4}, "checked_px": {"min": 10}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy-f32", "source": "test",
                             "file": "ovrbench/configs/dummy-f32.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy-f32.orbit-slow",
                               "config": "dummy-f32",
                               "traffic": "orbit-slow", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "harness", "moves": "rays_per_s",
                               "workloads": ["dummy-f32.orbit-slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert {p: p.read_bytes() for p in before} == before
    res, lines = run_tiny("dummy-f32.orbit-slow", traced=True, root=tmp_path)
    assert res["correct"], lines
    assert res["metrics"]["frames_traced"]["value"] == 24.0


def _cli(cwd, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(cwd), CUDA_VISIBLE_DEVICES="",
               **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "ovrbench.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    p = _cli(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "ovrbench", tmp_path / "ovrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_loads_no_jax():
    """A whole tiny run in a fresh process leaves no JAX module, nor the
    JAX package, in sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from ovrbench.tests.test_ovrbench_cells import run_tiny\n"
        "from ovrbench import run\n"
        "res, _ = run_tiny(%r)\n"
        "assert res['correct']\n"
        "print(run.forbidden_modules())\n" % (str(ROOT), CELLS[0]))
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_card_smoke():
    """One short run of the first cell on the card, as the driver runs
    it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    p = subprocess.run(
        [sys.executable, "-m", "ovrbench.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
