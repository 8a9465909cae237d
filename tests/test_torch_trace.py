"""The port's spans and counters (`ovr_tpu_torch.utils.trace`) and the
benchmark's reader that places them on the profiler's clocks
(`ovrbench/program_spans.py`).

On the CPU: off (no profiler) a span is one shared no-op and a frame
records nothing; under torch.profiler the span tree of a camera change,
a TF change and a shadow frame, the readback counter, the ring's bound;
each benchmark cell at a tiny size, traced: the program's spans inside
the harness's ranges of the same layer, the readers of host spans
finite, and with the spans off the trace and the older readings as
they were. Marked `cuda` (each test skips itself without a card): K1
put down to `render.k1` once a frame, the warp's kernels to
`render.warp`, no program span among the trace's operations.

    python -m pytest tests/test_torch_trace.py
    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_trace.py -m cuda      # on the card
"""

from __future__ import annotations

import json
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import profile

from ovr_tpu_torch import api
from ovr_tpu_torch.core.scene import (Camera, Light, Scene, StructuredVolume,
                                      TransferFunction)
from ovr_tpu_torch.ops import swslice
from ovr_tpu_torch.render import integrator
from ovr_tpu_torch.utils import trace
from ovrbench import program_spans, run

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NEW = {"plan_ms", "value_ranges_ms", "majorants_ms", "frame_setup_ms",
       "warp_ms", "issue_ms", "readback_mb", "readback_gb_per_s",
       "setter_stall_ms", "readback_pinned_pct", "setup_graph_pct",
       "k1_direct_pct"}
HOST_READERS = {"plan_ms", "issue_ms", "readback_mb", "readback_pinned_pct",
                "setup_graph_pct"}
TINY = {"dims_xyz": [20, 18, 22],
        "render": {"width": 48, "height": 32, "sampling_rate": 24.0}}
SEED = 3_000_000_019
FRAME_BYTES = 48 * 32 * (4 + 3 + 1) * 4  # rgba, grad, depth as f32


@pytest.fixture(autouse=True)
def _empty_ring():
    trace.clear()
    yield
    trace.clear()


def renderer(shading="diffuse", method="auto"):
    g = torch.Generator().manual_seed(5)
    grid = torch.rand((20, 18, 22), generator=g)
    alpha = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    color = np.linspace(0.0, 1.0, 24, dtype=np.float32).reshape(8, 3)
    vol = StructuredVolume.create(grid, world_lo=[0, 0, 0],
                                  world_hi=[1, 1, 1], data_range=(0.0, 1.0),
                                  device="cpu")
    scene = Scene.create(
        vol, TransferFunction.create(color, alpha, (0.0, 1.0), device="cpu"),
        light=Light.create(direction=[0.2, 1.0, 0.3], device="cpu"),
        camera=Camera.create(from_=(0.5, 0.5, -2.0), at=(0.5, 0.5, 0.5),
                             up=(0, 1, 0), fovy=45.0, device="cpu"))
    r = api.Renderer(scene, api.RenderConfig(
        width=48, height=32, sampling_rate=24.0, method=method,
        shading=shading, use_macrocells=True))
    r.commit()
    r.render()
    r.mapframe()
    return r, color


def frame(r, eye=None, alpha=None, color=None):
    if eye is not None:
        r.set_camera(from_=eye)
    if alpha is not None:
        r.set_transfer_function(color, alpha, (0.0, 1.0))
    r.commit()
    r.render()
    return r.mapframe()


def names(spans):
    return [s.name for s in sorted(spans, key=lambda s: s.t0_ns)]


def check_tree(spans):
    """Each span's parent is the span of its name less the last part, in
    the same frame, around it in time."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        if not s.parent:
            assert "." not in s.name
            continue
        p = by_id[s.parent]
        assert s.name.rsplit(".", 1)[0] == p.name
        assert p.frame == s.frame
        assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns


READBACK = ["mapframe", "mapframe.rgba", "mapframe.grad", "mapframe.depth"]
FRAME_TAIL = ["render", "render.setup", "render.k1", "render.warp"] + READBACK


# ---- off -------------------------------------------------------------------

def test_off_span_is_one_shared_noop():
    assert not torch._C._autograd._profiler_enabled()
    a, b = trace.span("a"), trace.span("b", torch.device("cpu"))
    assert a is b
    with a:
        assert trace.stage("s") is None
    assert trace.spans() == []


def test_off_frame_records_nothing():
    r, color = renderer()
    before = api.READBACK_BYTES
    out = frame(r, eye=(0.6, 0.5, -2.0))
    assert trace.spans() == []
    # the counter counts with the spans off too
    assert api.READBACK_BYTES - before == sum(a.nbytes for a in out.values())


# ---- under the profiler ----------------------------------------------------

def test_camera_change_span_tree():
    r, _ = renderer()
    with profile():
        frame(r, eye=(0.6, 0.5, -2.0))
        frame(r, eye=(0.7, 0.5, -2.0))
    spans = trace.spans()
    check_tree(spans)
    frames = sorted({s.frame for s in spans})
    assert len(frames) == 2 and frames[1] == frames[0] + 1
    for f in frames:
        assert names([s for s in spans if s.frame == f]) == (
            ["set_camera", "commit", "commit.plan"] + FRAME_TAIL)


def test_tf_change_span_tree():
    r, color = renderer()
    with profile():
        frame(r, alpha=np.linspace(0.2, 1.0, 8), color=color)
    spans = trace.spans()
    check_tree(spans)
    assert names(spans) == [
        "set_transfer_function", "commit", "commit.macrocells",
        "commit.macrocells.value_ranges", "commit.macrocells.majorants"
    ] + FRAME_TAIL
    assert len({s.frame for s in spans}) == 1


def test_shadow_frame_span_tree():
    r, color = renderer("shadow")
    with profile():
        frame(r, eye=(0.6, 0.5, -2.0), alpha=np.linspace(0.1, 1.0, 8),
              color=color)
    spans = trace.spans()
    check_tree(spans)
    assert names(spans) == [
        "set_camera", "set_transfer_function", "commit", "commit.plan",
        "commit.macrocells", "commit.macrocells.value_ranges",
        "commit.macrocells.majorants", "commit.light_grid"] + FRAME_TAIL


def test_readback_bytes_are_the_arrays_bytes():
    r, _ = renderer()
    before = api.READBACK_BYTES
    with profile():
        out = frame(r, eye=(0.6, 0.5, -2.0))
    by = {s.name: s for s in trace.spans()}
    total = sum(a.nbytes for a in out.values())
    assert total == FRAME_BYTES
    assert by["mapframe"].counts == {"api.READBACK_BYTES": total}
    for k in ("rgba", "grad", "depth"):
        assert by[f"mapframe.{k}"].counts == {
            "api.READBACK_BYTES": out[k].nbytes}
    assert api.READBACK_BYTES - before == total
    # nothing else moved a counter on the CPU but the setup's eager run:
    # the plain slice loop launches nothing
    eager = {"shearwarp.SETUP_EAGER": 1}
    assert all(s.counts == (eager if s.name in ("render", "render.setup")
                            else {})
               for s in trace.spans() if not s.name.startswith("mapframe"))


def test_march_frame_counts_its_steps():
    r, _ = renderer(method="march")
    before = integrator.STEPS
    with profile():
        frame(r, eye=(0.6, 0.5, -2.0))
    by = {s.name: s for s in trace.spans()}
    steps = integrator.STEPS - before
    assert steps > 0
    assert by["render"].counts == {"integrator.STEPS": steps}
    assert "render.k1" not in by


def test_counters_registered_by_name(monkeypatch):
    for name in ("swslice.LAUNCHES", "swslice.LAUNCHES_BF16",
                 "integrator.STEPS", "api.READBACK_BYTES",
                 "api.READBACK_PINNED_BYTES", "api.READBACK_PINNED_ALLOCS",
                 "accel.VALUE_RANGE_SLABS", "shearwarp.SETUP_REPLAYS",
                 "shearwarp.SETUP_CAPTURES", "shearwarp.SETUP_EAGER"):
        assert name in trace.counters()
    with profile():
        with trace.span("outer"):
            with trace.span("launch"):
                monkeypatch.setattr(swslice, "LAUNCHES", swslice.LAUNCHES + 1)
    by = {s.name: s.counts for s in trace.spans()}
    assert by == {"outer.launch": {"swslice.LAUNCHES": 1},
                  "outer": {"swslice.LAUNCHES": 1}}


def test_ring_holds_no_more_than_its_bound():
    n = trace.CAPACITY + 100
    with profile():
        for _ in range(n):
            with trace.span("x"):
                pass
    spans = trace.spans()
    assert len(spans) == trace.CAPACITY
    ids = [s.id for s in spans]
    assert ids == sorted(ids) and ids[-1] - ids[0] == trace.CAPACITY - 1
    trace.clear()
    assert trace.spans() == []


def test_stages_end_at_the_next_stage_or_with_their_span():
    with profile():
        trace.stage("orphan")  # no span open: nothing recorded
        with trace.span("a"):
            trace.stage("s1")
            with trace.span("inner"):
                pass
            trace.stage("s2")
        with trace.span("b"):
            pass
    spans = trace.spans()
    check_tree(spans)
    assert names(spans) == ["a", "a.s1", "a.s1.inner", "a.s2", "b"]
    by = {s.name: s for s in spans}
    assert by["a.s1"].t1_ns <= by["a.s2"].t0_ns
    assert by["a.s2"].t1_ns <= by["a"].t1_ns
    assert trace._stack() == []


def test_a_raising_span_is_recorded_and_closed():
    with profile():
        with pytest.raises(ValueError):
            with trace.span("a"):
                trace.stage("s")
                raise ValueError("x")
        with trace.span("b"):
            pass
    assert names(trace.spans()) == ["a", "a.s", "b"]
    assert trace._stack() == []


# ---- the reader, on made-up spans ------------------------------------------

def test_levels_pick_the_innermost_and_split_gaps_whole():
    lv = program_spans.Levels([(0, 100, "render"), (10, 40, "render.setup"),
                               (40, 60, "render.k1"), (60, 90, "render.warp"),
                               (120, 150, "mapframe")])
    assert lv.innermost(5) == "render"
    assert lv.innermost(50) == "render.k1"
    assert lv.innermost(95) == "render"
    assert lv.innermost(110) is None
    gaps = [(0, 15), (85, 130)]
    got = lv.split(gaps)
    assert got == {"render": 20, "render.setup": 5, "render.warp": 5,
                   program_spans.NO_SPAN: 20, "mapframe": 10}
    assert sum(got.values()) == sum(b - a for a, b in gaps)


class _Ev:
    """A CUDA event's stand-in: a time on the device's own clock, ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _span(name, id_, parent, frame_, t0, t1, d0, d1):
    return trace.Span(name, id_, parent, frame_, t0, t1, _Ev(d0), _Ev(d1), {})


def test_device_events_anchored_on_k1():
    """Two frames; the device clock runs 1000 ms behind the profiler's
    in frame 0 and 999.9 ms in frame 1 (each anchored on its own K1)."""
    ms = 1_000_000
    spans, ops = [], []
    for f, lag in ((0, 1000.0), (1, 999.9)):
        b = 100 * f
        spans += [_span("render", 10 * f + 1, 0, f, 0, 0, b + 0, b + 30),
                  _span("render.setup", 10 * f + 2, 10 * f + 1, f, 0, 0,
                        b + 0, b + 10),
                  _span("render.k1", 10 * f + 3, 10 * f + 1, f, 0, 0,
                        b + 10, b + 20),
                  _span("render.warp", 10 * f + 4, 10 * f + 1, f, 0, 0,
                        b + 20, b + 30)]
        at = (b + lag) * ms
        ops += [(at + 2 * ms, at + 3 * ms, "setup_kernel", "kernel"),
                (at + 11 * ms, at + 20 * ms, "void swslice_kernel<float>",
                 "kernel"),
                (at + 22 * ms, at + 25 * ms, "warp_kernel", "kernel")]
    ops.sort()
    dev = program_spans.Placed.device_times(spans, ops)
    assert dev[3] == (pytest.approx(1010 * ms), pytest.approx(1020 * ms))
    assert dev[13] == (pytest.approx(1109.9 * ms), pytest.approx(1119.9 * ms))
    lv = program_spans.Levels([(a, b, {s.id: s.name for s in spans}[i])
                               for i, (a, b) in dev.items()])
    assert [lv.innermost((s + e) / 2) for s, e, _, _ in ops] == [
        "render.setup", "render.k1", "render.warp"] * 2
    # a K1 kernel without its span: nothing is placed
    assert program_spans.Placed.device_times(spans, ops[:-2]) is None


class _ProfEv:
    """A profiler event's stand-in (the calls `ovrbench.trace` makes)."""

    def __init__(self, name, s, e, cpu):
        self._n, self._s, self._e, self._cpu = name, s, e, cpu

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._cpu
                else torch.autograd.DeviceType.CUDA)


def test_readers_on_a_made_up_traced_frame(monkeypatch):
    """One frame, in ms: the harness's ranges on the profiler's clock and
    its spans 5 s earlier on perf_counter; the program's spans on
    perf_counter and their events on a device clock 1000 ms behind."""
    from ovrbench import trace as btrace
    ms, off = 1_000_000, 5_000_000_000
    harness = [("frame", 0, 10), ("setters", 0, 1), ("commit", 1, 2),
               ("render", 2, 7), ("mapframe", 7, 10)]
    ops = [("Memcpy HtoD", 0.3, 0.35), ("setup_kernel", 2.3, 2.5),
           ("void swslice_kernel<float>", 3.1, 5.0), ("warp_kernel", 5.1, 5.6),
           ("Memcpy DtoH (Device -> Pageable)", 7.3, 8.8)]
    evs = [_ProfEv("ovrbench:" + n, a * ms, b * ms, True)
           for n, a, b in harness]
    evs += [_ProfEv(n, a * ms, b * ms, False) for n, a, b in ops]
    td = btrace.TraceData(types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs))), 1)
    items = [(n, (a * ms - off) / 1e9, (b * ms - off) / 1e9)
             for n, a, b in harness]
    rows = [("set_camera", 0, 0.1, 0.9, 0.2, 0.9, {}),
            ("commit", 0, 1.1, 1.9, 1.2, 1.9, {}),
            ("commit.plan", 2, 1.2, 1.8, 1.3, 1.8, {}),
            ("render", 0, 2.1, 6.9, 2.2, 6.9,
             {"shearwarp.SETUP_REPLAYS": 3, "shearwarp.SETUP_EAGER": 1}),
            ("render.setup", 4, 2.1, 3.0, 2.2, 3.0, {}),
            ("render.k1", 4, 3.0, 5.0, 3.0, 5.0, {}),
            ("render.warp", 4, 5.0, 6.0, 5.0, 6.0, {}),
            ("render.wait", 4, 6.0, 6.9, 6.0, 6.9, {}),
            ("mapframe", 0, 7.1, 9.9, 7.2, 9.9,
             {"api.READBACK_BYTES": 3_000_000,
              "api.READBACK_PINNED_BYTES": 1_500_000}),
            ("mapframe.rgba", 9, 7.1, 9.0, 7.2, 9.0,
             {"api.READBACK_BYTES": 3_000_000})]
    spans = [trace.Span(n, i + 1, parent, 7, round(a * ms) - off,
                        round(b * ms) - off, _Ev(d0 - 1000), _Ev(d1 - 1000),
                        counts)
             for i, (n, parent, a, b, d0, d1, counts) in enumerate(rows)]
    monkeypatch.setitem(sys.modules, program_spans.MODULE,
                        types.SimpleNamespace(spans=lambda: spans,
                                              counters=trace.counters))
    run_ = types.SimpleNamespace(trace=td,
                                 spans=types.SimpleNamespace(items=items))
    want = {"plan_ms": 0.6, "frame_setup_ms": 0.2, "warp_ms": 0.5,
            "issue_ms": 3.9, "readback_mb": 3.0, "readback_gb_per_s": 2.0,
            "setter_stall_ms": 0.75, "value_ranges_ms": 0.0,
            "majorants_ms": 0.0, "readback_pinned_pct": 50.0,
            "setup_graph_pct": 75.0}
    for name, v in want.items():
        got = run.load_module(ROOT, f"ovrbench/metrics/{name}.py").read(run_)
        assert got == pytest.approx(v, abs=1e-6), name
    p = program_spans.placed(run_)
    assert p.op_span == ["set_camera", "render.setup", "render.k1",
                         "render.warp", "mapframe.rgba"]
    # the idle table accounts for every idle ns of the window
    assert sum(p.idle.values()) == pytest.approx(
        (td.window_s - td.busy_s) * 1e9)
    assert p.idle[program_spans.NO_SPAN] == pytest.approx(0.8 * ms)
    # a program that registers no pinned or setup counter (an older one)
    # reads None
    monkeypatch.setitem(sys.modules, program_spans.MODULE,
                        types.SimpleNamespace(spans=lambda: spans))
    for name in ("readback_pinned_pct", "setup_graph_pct"):
        assert run.load_module(ROOT, f"ovrbench/metrics/{name}.py"
                               ).read(run_) is None


def test_a_program_without_spans_reads_none(monkeypatch):
    """An older program (no trace module) or no recorded span: the new
    readers give None and raise nothing."""
    tr = types.SimpleNamespace(n_frames=1, ranges=[], ops=[], t0=0, t1=1)
    for mod in (None, types.SimpleNamespace(spans=lambda: [])):
        if mod is None:
            monkeypatch.delitem(sys.modules, program_spans.MODULE)
        else:
            monkeypatch.setitem(sys.modules, program_spans.MODULE, mod)
        run_ = types.SimpleNamespace(trace=tr, spans=None)
        for name in NEW:
            assert run.load_module(
                ROOT, f"ovrbench/metrics/{name}.py").read(run_) is None


# ---- the benchmark's cells at a tiny size ----------------------------------

def tiny_cell(name):
    cell = run.Cell(ROOT, name)
    cell.limits = dict(cell.limits, checked_px={"min": 50})
    return cell


def traced_run(name, device="cpu", spans_on=True):
    """A traced run of the cell; returns (result, the run's namespace)."""
    seen = {}
    real = program_spans.placed

    def spy(run_):
        seen["run"] = run_
        return real(run_)

    trace.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(program_spans, "placed", spy)
        if not spans_on:
            mp.setattr(trace, "_profiling", lambda: False)
        res, _ = run.run_cell(tiny_cell(name), SEED, 0.3, True, device,
                              overrides=TINY)
    return res, seen["run"]


@pytest.fixture(scope="module")
def cpu_runs():
    return {}


def cpu_run(cpu_runs, name, spans_on=True):
    key = (name, spans_on)
    if key not in cpu_runs:
        cpu_runs[key] = traced_run(name, "cpu", spans_on)
    return cpu_runs[key]


LAYER = {"set_camera": "setters", "set_transfer_function": "setters",
         "commit": "commit", "render": "render", "mapframe": "mapframe"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_spans_lie_in_the_harness_ranges(cpu_runs, name):
    res, run_ = cpu_run(cpu_runs, name)
    assert res["correct"]
    p = program_spans.placed(run_)
    top = [h for h in p.host if h[3].parent == 0]
    assert {h[0] for h in top} >= {"commit", "render", "mapframe"}
    assert len(top) >= 3 * run_.trace.n_frames
    tol = 50_000  # ns
    for n, a, b, _ in top:
        assert any(r == LAYER[n] and s - tol <= a and b <= e + tol
                   for r, s, e in run_.trace.ranges), (n, a, b)


@pytest.mark.parametrize("name", CELLS)
def test_cell_host_readers_finite(cpu_runs, name):
    res, _ = cpu_run(cpu_runs, name)
    cell = tiny_cell(name)
    mine = {m["name"] for m in cell.per_layer} & NEW
    for m in mine & HOST_READERS:
        assert math.isfinite(res["metrics"][m]["value"]), m
    # the device's readings are for the card
    assert not (set(res["metrics"]) & (mine - HOST_READERS))
    assert res["metrics"]["readback_mb"]["value"] == pytest.approx(
        FRAME_BYTES / 1e6)
    # frames on the host take no page-locked buffer, and replay no graph
    assert res["metrics"]["readback_pinned_pct"]["value"] == 0.0
    assert res["metrics"]["setup_graph_pct"]["value"] == 0.0
    assert res["metrics"]["issue_ms"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_cell_trace_unchanged_with_spans_off(cpu_runs, name):
    on, run_on = cpu_run(cpu_runs, name)
    off, run_off = cpu_run(cpu_runs, name, spans_on=False)
    assert trace.spans() == [] and program_spans.placed(run_off) is None
    assert [r[0] for r in run_on.trace.ranges] == [
        r[0] for r in run_off.trace.ranges]
    assert [o[2:] for o in run_on.trace.ops] == [
        o[2:] for o in run_off.trace.ops]
    assert set(off["metrics"]) == set(on["metrics"]) - NEW
    assert on["correct"] and off["correct"]


# ---- on the card -----------------------------------------------------------

@pytest.fixture(scope="module")
def card_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {on: traced_run(CELLS[0], "cuda", on) for on in (True, False)}


@pytest.mark.cuda
def test_card_k1_once_a_frame_in_its_span(card_runs):
    res, run_ = card_runs[True]
    p = program_spans.placed(run_)
    k1 = [n for (s, e, name, kind), n in zip(p.ops, p.op_span)
          if kind == "kernel" and program_spans.K1_NAME in name]
    assert k1 == ["render.k1"] * run_.trace.n_frames
    # the tiny grid's principal x views (20 voxels of u16 a column, five
    # 8-byte runs) stage runs, its other views slab windows
    assert res["metrics"]["k1_direct_pct"]["value"] == 0.0
    assert res["correct"]


@pytest.mark.cuda
def test_card_warp_kernels_in_the_warp(card_runs):
    res, run_ = card_runs[True]
    p = program_spans.placed(run_)
    kernels = [n for (s, e, name, kind), n in zip(p.ops, p.op_span)
               if kind == "kernel"]
    assert "render.wait" not in kernels
    assert kernels.count("render.warp") >= run_.trace.n_frames
    assert kernels.count("render.setup") >= run_.trace.n_frames
    for m in NEW & {"frame_setup_ms", "warp_ms", "readback_gb_per_s",
                    "readback_mb", "issue_ms", "setter_stall_ms"}:
        assert math.isfinite(res["metrics"][m]["value"]), m


@pytest.mark.cuda
def test_card_readback_lands_in_page_locked_buffers(card_runs):
    res, run_ = card_runs[True]
    assert res["metrics"]["readback_pinned_pct"]["value"] == 100.0
    p = program_spans.placed(run_)
    assert p.count("mapframe", "api.READBACK_PINNED_BYTES") == p.count(
        "mapframe", program_spans.READBACK) > 0
    assert res["correct"]


@pytest.mark.cuda
def test_card_setup_replays_in_every_traced_frame(card_runs):
    """Set-up's views capture every plan of the orbit, so each traced
    frame replays its setup, whose kernels the profiler puts down to
    `render.setup`."""
    res, run_ = card_runs[True]
    assert res["metrics"]["setup_graph_pct"]["value"] == 100.0
    p = program_spans.placed(run_)
    assert p.count("render", "shearwarp.SETUP_REPLAYS") == run_.trace.n_frames
    assert p.device_ms({"render.setup"}, ("kernel",)) > 0
    assert res["correct"]


@pytest.mark.cuda
def test_card_no_program_span_among_the_ops(card_runs):
    (_, on), (_, off) = card_runs[True], card_runs[False]
    spans = {h[0] for h in program_spans.placed(on).host}
    assert spans and not any(o[2] in spans or o[2].split(".")[0] in LAYER
                             for o in on.trace.ops)
    assert [o[2] for o in on.trace.ops] == [o[2] for o in off.trace.ops]
