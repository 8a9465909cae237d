"""A configuration names its pipeline: render settings passed through to
`api.RenderConfig`, the comparison found by name (`checks/<name>.py`),
views held while frames accumulate, and frames without the slice kernel
anchored on their readback. On the CPU, at tiny sizes.

    python -m pytest ovrbench/tests/test_ovrbench_pipelines.py -q
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import types
from pathlib import Path

import pytest

from ovrbench import check, frames, program_spans, run
from ovrbench.tests.test_ovrbench_cells import CELLS, ROOT, TINY, run_tiny

# A check module of a path-traced cell, for the plumbing: it replays each
# held frame with the program's own Renderer through `n_accumulated`
# frames (not a reference: it only shows what a check module receives).
REPLAY = '''
import numpy as np
import torch

from ovr_tpu_torch import api
from ovr_tpu_torch.core.scene import (Camera, Light, Scene,
                                      StructuredVolume, TransferFunction)


def compare(held, ctx):
    render, vr = ctx.render, ctx.value_range
    errs, counts = [], []
    for h in held:
        vol = StructuredVolume.create(
            ctx.grid, world_lo=ctx.config["world_lo"],
            world_hi=ctx.config["world_hi"], data_range=vr,
            device=ctx.device)
        scene = Scene.create(
            vol, TransferFunction.create(ctx.color, h.alpha, vr,
                                         device=ctx.device),
            light=Light.create(direction=render["light_direction"],
                               device=ctx.device),
            camera=Camera.create(from_=h.eye, at=ctx.center,
                                 up=render["up"], fovy=render["fovy"],
                                 device=ctx.device))
        r = api.Renderer(scene, api.RenderConfig(**ctx.render_fields))
        r.set_frame_accumulation(bool(ctx.mix.get("accumulate")))
        r.set_camera(from_=h.eye, at=ctx.center, up=render["up"])
        for _ in range(h.n_accumulated):
            r.commit()
            r.render()
        ref = torch.as_tensor(r.mapframe()["rgba"])
        diff = torch.abs(torch.as_tensor(np.asarray(h.rgba)) - ref)
        errs.append(float(torch.nan_to_num(diff, nan=float("inf")).max()))
        counts.append(int((ref[..., 3] > 0).sum()))
    return {"rgba_err": max(errs), "checked_px": min(counts), "errs": errs}
'''


def add_path_traced_cell(root: Path) -> str:
    """A path-traced configuration, an accumulating mix and their check,
    as new files and entries of the checkout at `root`; the cell's name."""
    ob = root / "ovrbench"
    cfg = json.loads((ob / "configs" / "chameleon-u16.json").read_text())
    cfg["name"] = "chameleon-u16-pt"
    cfg["check"] = "replay-pt"
    cfg["render"].update(path_tracing=True, max_scatters=2)
    (ob / "configs" / "chameleon-u16-pt.json").write_text(json.dumps(cfg))
    mix = json.loads((ob / "traffic" / "orbit-diffuse.json").read_text())
    mix.update(frames_per_view=4, accumulate=True, warmup_degrees=[0, 90],
               trace_views=2, trace_repeats=1)
    (ob / "traffic" / "orbit-held.json").write_text(json.dumps(mix))
    (ob / "checks" / "replay-pt.py").write_text(REPLAY)
    name = "chameleon-u16-pt.orbit-held"
    (ob / "limits" / f"{name}.json").write_text(json.dumps(
        {"rgba_err": {"max": 2e-3}, "checked_px": {"min": 1000}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "chameleon-u16-pt", "source": "test",
                             "file": "ovrbench/configs/chameleon-u16-pt.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": "chameleon-u16-pt",
                               "traffic": "orbit-held", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


def test_new_pipeline_cell_from_new_files_only(tmp_path, monkeypatch):
    """A path-traced cell whose mix holds each view for 4 accumulating
    frames, added as new files and entries: correct by its own check,
    which reads the frames each held record accumulates."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "ovrbench", tmp_path / "ovrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*")
              if p.is_file() and p.name != "BENCHMARK.json"}
    name = add_path_traced_cell(tmp_path)
    assert {p: p.read_bytes() for p in before} == before

    from ovr_tpu_torch import api
    offered, indices, seen = [], [], {}
    real_offer, real_map = check.Reservoir.offer, api.Renderer.mapframe
    real_load = run.load_module

    def offer(self, i, item):
        offered.append(item)
        real_offer(self, i, item)

    def mapframe(self):
        indices.append(self._frame_index)
        return real_map(self)

    def load_module(root, rel):
        mod = real_load(root, rel)
        if rel.startswith("ovrbench/checks/"):
            compare = mod.compare

            def spy(held, ctx):
                seen.update(held=held, ctx=ctx, mod=mod,
                            indices=list(indices))
                return compare(held, ctx)

            mod.compare = spy
        return mod

    monkeypatch.setattr(check.Reservoir, "offer", offer)
    monkeypatch.setattr(api.Renderer, "mapframe", mapframe)
    monkeypatch.setattr(run, "load_module", load_module)
    res, lines = run_tiny(name, traced=True, root=tmp_path)
    assert res["correct"], lines
    assert res["compared"]["rgba_err"]["value"] == 0.0
    assert res["attempted"] == 2 * 4
    assert "k1_roofline_pct" not in res["metrics"]
    # the harness's count is the Renderer's own, frame by frame
    assert [h.n_accumulated for h in offered] == seen["indices"][
        -len(offered):]
    assert [h.n_accumulated for h in offered] == [1, 2, 3, 4] * 2
    assert [h.k for h in offered] == list(range(8))
    # the same check, one frame off, fails
    held, ctx = seen["held"], seen["ctx"]
    assert {h.n_accumulated for h in held} - {1}
    off = [dataclasses.replace(h, n_accumulated=h.n_accumulated + 1)
           for h in held]
    assert seen["mod"].compare(off, ctx)["rgba_err"] > 2e-3


def test_render_key_that_is_no_field_stops_the_run():
    for key in ("max_scater", "shading"):
        with pytest.raises(SystemExit, match=key):
            run_tiny(CELLS[0], overrides=dict(TINY, render=dict(
                TINY["render"], **{key: 2})))


def _explicit(config, mix, render_options):
    """The parent's build of the RenderConfig, key by key."""
    from ovr_tpu_torch import api
    render = config["render"]
    return api.RenderConfig(
        width=render["width"], height=render["height"], spp=render["spp"],
        sampling_rate=render["sampling_rate"],
        base_rate=frames.Traffic(config, mix).base_rate(),
        method=render["method"], shading=mix["shading"],
        use_macrocells=render["use_macrocells"], **(render_options or {}))


@pytest.mark.parametrize("options", [None, {"sw_bf16": True}],
                         ids=["as-run", "control"])
@pytest.mark.parametrize("name", CELLS)
def test_render_config_of_the_cells_unchanged(name, options):
    from ovr_tpu_torch import api
    cell = run.Cell(ROOT, name)
    config, mix = cell.config, cell.mix
    got = api.RenderConfig(**run.render_fields(
        config["render"], mix["shading"],
        frames.Traffic(config, mix).base_rate(), options))
    want = _explicit(config, mix, options)
    for f in dataclasses.fields(api.RenderConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_views_held_over_frames():
    cfg = json.loads((ROOT / "ovrbench/configs/miranda-f32.json").read_text())
    mix = json.loads((ROOT / "ovrbench/traffic/orbit-diffuse.json")
                     .read_text())
    t1 = frames.Traffic(cfg, mix)
    t3 = frames.Traffic(cfg, dict(mix, frames_per_view=3, accumulate=True))
    assert not t1.accumulate and t3.accumulate
    w1, w3 = t1.window(), t3.window()
    one = [next(w1).eye for _ in range(3)]
    three = [next(w3).eye for _ in range(9)]
    assert three[::3] == one and three[1::3] == three[2::3] == [None] * 3
    plan = t3.traced()
    assert len(plan) == 3 * len(t1.traced())
    assert [v for _, v in plan[:6]] == [0, 0, 0, 1, 1, 1]
    assert plan[0][0] == t1.traced()[0][0] and plan[1][0].eye is None
    fixed = dict(mix, camera={"kind": "fixed"}, frames_per_view=2)
    with pytest.raises(ValueError, match="frames_per_view"):
        frames.Traffic(cfg, fixed)


# ---- the anchor, on made-up spans and operations ---------------------------

MS = 1_000_000


class _Ev:
    """A CUDA event's stand-in: a time on the device's own clock, ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _span(name, id_, frame, d0, d1):
    return types.SimpleNamespace(name=name, id=id_, frame=frame, t0_ns=id_,
                                 start=_Ev(d0), end=_Ev(d1))


def _k1_frame(f, lag, pause=0.0):
    """A shear-warp frame 100 ms after the last, its device clock `lag`
    ms behind the profiler's; `pause` ms of host time between K1's
    launch and the `render.k1` end event, after the kernel ended."""
    b = 100 * f
    spans = [_span("render", 10 * f + 1, f, b, b + 30 + pause),
             _span("render.k1", 10 * f + 2, f, b + 10, b + 20 + pause),
             _span("render.warp", 10 * f + 3, f, b + 20 + pause,
                   b + 30 + pause)]
    at = (b + lag) * MS
    ops = [(at + 10.01 * MS, at + 20 * MS, "void swslice_kernel<float>",
            "kernel"),
           (at + (22 + pause) * MS, at + (25 + pause) * MS, "warp_kernel",
            "kernel")]
    return spans, ops


def _as_before(spans, ops):
    """The anchor as it was before frames without K1: every span placed
    by its frame's K1 end."""
    k1_ops = [o for o in ops if o[3] == "kernel" and "swslice" in o[2]]
    k1_spans = sorted((s for s in spans if s.name == "render.k1"),
                      key=lambda s: s.t0_ns)
    ref = min(spans, key=lambda s: s.t0_ns).start

    def rel(ev):
        return ref.elapsed_time(ev) * 1e6

    anchor = {s.frame: op[1] - rel(s.end) for s, op in zip(k1_spans, k1_ops)}
    return {s.id: (rel(s.start) + anchor[s.frame],
                   rel(s.end) + anchor[s.frame]) for s in spans}


def test_unpaused_k1_frames_placed_as_before():
    spans, ops = [], []
    for f, lag in ((0, 1000.0), (1, 999.9), (2, 1000.3)):
        s, o = _k1_frame(f, lag)
        spans += s
        ops += o
    ops.sort()
    assert program_spans.Placed.device_times(spans, ops) == _as_before(
        spans, ops)


def test_paused_k1_frame_left_out_and_counted(capsys):
    spans, ops = [], []
    for f, pause in ((0, 0.0), (1, 50.0), (2, 0.0)):
        s, o = _k1_frame(f, 1000.0, pause)
        spans += s
        ops += o
    ops.sort()
    dev = program_spans.Placed.device_times(spans, ops)
    assert {s.frame for s in spans if s.id in dev} == {0, 2}
    err = capsys.readouterr().err
    assert "1 of 3 frames left out" in err and "[50010.0]" in err


def test_frame_without_k1_placed_by_its_readback():
    """A path-traced frame: no `render.k1`; its rgba copy, the first
    device-to-host copy after the span's host start, anchors it. A copy
    issued earlier in the frame (a host sync of the tracker) is not."""
    spans = [_span("render", 1, 0, 0.0, 40.0),
             _span("mapframe", 2, 0, 41.0, 50.0),
             _span("mapframe.rgba", 3, 0, 41.0, 45.0),
             _span("mapframe.grad", 4, 0, 45.0, 48.0)]
    lag = 500.0
    ops = [((5 + lag) * MS, (39 + lag) * MS, "tracker_kernel", "kernel"),
           ((20 + lag) * MS, (20.01 + lag) * MS,
            "Memcpy DtoH (Device -> Pageable)", "copy"),
           ((41.02 + lag) * MS, (45 + lag) * MS,
            "Memcpy DtoH (Device -> Pinned)", "copy"),
           ((45.02 + lag) * MS, (48 + lag) * MS,
            "Memcpy DtoH (Device -> Pinned)", "copy")]
    host = {1: 0.0, 2: (40.5 + lag) * MS, 3: (40.6 + lag) * MS,
            4: (44.0 + lag) * MS}
    dev = program_spans.Placed.device_times(spans, ops, host)
    assert dev[3] == ((41 + lag) * MS, (45 + lag) * MS)
    assert dev[1] == (lag * MS, (40 + lag) * MS)
    # without the host starts nothing finds the copy: nothing is placed
    assert program_spans.Placed.device_times(spans, ops) is None


def test_paused_k1_frame_placed_by_its_readback(capsys):
    """A K1 frame whose `render.k1` end event came 50 ms after the kernel
    (a host pause): its K1 anchor is refused, its readback anchors it."""
    spans, ops = _k1_frame(0, 1000.0, pause=50.0)
    spans.append(_span("mapframe.rgba", 9, 0, 81.0, 85.0))
    ops.append((1081.02 * MS, 1085 * MS, "Memcpy DtoH (Device -> Pinned)",
                "copy"))
    host = {9: 1080.5 * MS}
    dev = program_spans.Placed.device_times(spans, ops, host)
    assert dev[9] == (1081 * MS, 1085 * MS)
    k1, warp = spans[1], spans[2]
    assert dev[k1.id] == (1010 * MS, 1070 * MS)
    assert dev[warp.id][0] == 1070 * MS
    err = capsys.readouterr().err
    assert "0 of 1 frames left out; 1 K1 anchors refused" in err
    assert "on 0 K1 kernels and 1 readback copies" in err
