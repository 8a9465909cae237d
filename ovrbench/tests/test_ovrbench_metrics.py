"""The metric arithmetic on fixed inputs: rays/s over the window, memory
and set-up, the traced loop's reduction, and the work count of known
rays."""

from __future__ import annotations

import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ovrbench import run, work

ROOT = Path(__file__).resolve().parents[2]


def reader(name):
    return run.load_module(ROOT, f"ovrbench/metrics/{name}.py")


def window_run(latencies_ms, gap_s=0.0, width=1920, height=1080):
    t, times = 100.0, []
    for ms in latencies_ms:
        times.append((t, t + ms / 1e3))
        t += ms / 1e3 + gap_s
    return types.SimpleNamespace(width=width, height=height, spp=1,
                                 frame_times=times, trace=None,
                                 peak_bytes=3 << 30, setup_s=12.5)


def test_rays_per_s_over_the_window():
    run_ = window_run([20.0] * 50, gap_s=0.005)
    span = 50 * 0.020 + 49 * 0.005
    assert reader("rays_per_s").read(run_) == pytest.approx(
        1920 * 1080 * 50 / span)


def test_memory_and_setup():
    run_ = window_run([1.0])
    assert reader("peak_mem_gib").read(run_) == pytest.approx(3.0)
    assert reader("setup_s").read(run_) == pytest.approx(12.5)


class _Ev:
    def __init__(self, name, s, e, cpu, kind):
        self._n, self._s, self._e, self._cpu, self._k = name, s, e, cpu, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._cpu
                else torch.autograd.DeviceType.CUDA)

    def activity_type(self):
        return self._k

    def is_user_annotation(self):
        return self._k == "user_annotation"


def test_trace_reduction():
    from ovrbench import trace
    ms = 1_000_000
    evs = [_Ev("ovrbench:frame", 0, 10 * ms, True, "user_annotation"),
           _Ev("ovrbench:render", 1 * ms, 7 * ms, True, "user_annotation"),
           _Ev("ovrbench:mapframe", 7 * ms, 10 * ms, True,
               "user_annotation"),
           _Ev("setup_kernel", 1 * ms, 2 * ms, False, "kernel"),
           _Ev("void swslice_kernel<float>", 2 * ms, 6 * ms, False,
               "kernel"),
           _Ev("Memcpy DtoH (Device -> Pageable)", 7 * ms, 9 * ms, False,
               "gpu_memcpy"),
           _Ev("ovrbench:render", 1 * ms, 7 * ms, False,
               "gpu_user_annotation")]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    td = trace.TraceData(prof, 1)
    assert td.window_s == pytest.approx(0.010)
    assert td.busy_s == pytest.approx(0.007)
    assert td.kernel_s(k1=True) == pytest.approx(0.004)
    assert td.kernel_s(k1=False, inside="render") == pytest.approx(0.001)
    gaps = dict((n, s) for n, s in td.idle_gaps())
    assert gaps == {"between spans": pytest.approx(0.001),
                    "render": pytest.approx(0.001),
                    "mapframe": pytest.approx(0.001)}
    run_ = types.SimpleNamespace(trace=td, bound_s=0.001)
    assert reader("k1_roofline_pct").read(run_) == pytest.approx(25.0)
    assert reader("device_idle_pct").read(run_) == pytest.approx(30.0)
    assert reader("other_kernels_ms").read(run_) == pytest.approx(1.0)


def _count(alpha, base_rate=1.0, rate=64.0):
    """The count of one frame of a constant 0.5 field whose only counted
    ray is the central one: a 4 x 4 frame counted at stride 4."""
    grid = torch.full((8, 8, 8), 0.5)
    return work.count_frame(
        grid, (0, 0, 0), (1, 1, 1), alpha, (0.0, 1.0), base_rate,
        (0.5, 0.5, -1.0), (0.5, 0.5, 0.5), (0, 1, 0), 45.0, 4, 4, rate,
        "diffuse", stride=4)


def _ray_len():
    """The length inside the unit box of the ray through pixel (2, 2) of a
    4 x 4 frame from (0.5, 0.5, -1) toward the centre, fovy 45."""
    t = 2 * math.tan(math.radians(45) / 2)
    d = np.array([-0.125 * t, 0.125 * t, 1.0])  # u = v = 2.5 / 4 - 0.5
    d /= np.linalg.norm(d)
    o = np.array([0.5, 0.5, -1.0])
    ta, tb = (0 - o) / d, (1 - o) / d
    return float(np.minimum(ta, tb).max()), float(np.maximum(ta, tb).min())


def test_work_count_of_a_known_ray():
    t0, t1 = _ray_len()
    step = 1 / 64.0
    inside = sum(1 for k in range(1000) if t0 + (k + 0.5) * step < t1)
    # a TF transparent at 0.5: nothing to count
    assert _count([0.0, 0.0, 0.0])["samples"] == 0
    # a faint TF: every sample in the box, times stride^2
    assert _count([1e-4] * 3)["samples"] == pytest.approx(16 * inside)
    # a dense TF at base rate = sampling rate (each sample's opacity is
    # the table's): samples until T <= 1e-4
    a = 0.5
    n = math.ceil(math.log(1e-4) / math.log(1 - a))
    assert n < inside
    assert _count([a] * 3, base_rate=64.0)["samples"] == 16 * n


def test_bound_picks_the_larger_time():
    t, by = work.bound_s(1e9, 1e6, "diffuse")
    assert by == "operations"
    assert t == pytest.approx(1e9 * work.ops_per_sample("diffuse")
                              / work.H100_F32_OPS_PER_S)
    t, by = work.bound_s(1.0, 3.35e12, "none")
    assert by == "bytes" and t == pytest.approx(1.0)
    assert work.ops_per_sample("none") == 81
    assert work.ops_per_sample("diffuse") == 81 + 7 + 65
    assert work.ops_per_sample("shadow") == 81 + 7 + 65 + 25
