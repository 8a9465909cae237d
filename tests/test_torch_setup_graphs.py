"""The shear-warp frame setup's key and where a frame may replay it as a
CUDA graph (`ovr_tpu_torch.render.shearwarp`: `SetupKey`,
`SetupGraphs`), on the CPU.

The key holds every Python value and shape the setup reads: equal for
two views of one plan, different when any of them differs, blind to
the plan's fields that only the slice loop and the warp read. Frames
that cannot replay (on the CPU, under grad, with surfaces, the multi-
device hooks, `fan_only`, the path tracer's gather) run the setup
eagerly, count `SETUP_EAGER` and keep their bits. A stand-in cache that
runs `frame_setup` where a replay would be shows that the frames that
may replay do reach it, with the eager bits. The replays themselves run
on the card (tests/test_torch_cuda.py).

    python -m pytest tests/test_torch_setup_graphs.py
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from chip_smoke import with_iso
from ovr_tpu_torch import api
from ovr_tpu_torch.core.scene import Camera, Light, simple_scene
from ovr_tpu_torch.render import accel, shearwarp

W, H, RATE = 40, 30, 20.0
CENTER = (0.5, 0.5, 0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(n=20, shape=None):
    z, y, x = np.meshgrid(*(np.linspace(0, 1, k, dtype=np.float32)
                            for k in (shape or (n, n, n))), indexing="ij")
    return (0.5 + 0.4 * np.sin(9 * x) * np.cos(7 * y) * np.sin(5 * z)
            ).astype(np.float32)


def orbit_eye(deg, r=1.8):
    th = math.radians(deg)
    return (0.5 + r * math.sin(th), 0.5, 0.5 - r * math.cos(th))


def _scene(deg=10.0, shape=None, **cam):
    scene = simple_scene(_field(shape=shape), device="cpu")
    cam = dict(dict(from_=orbit_eye(deg), at=CENTER, fovy=40.0), **cam)
    return dataclasses.replace(scene, camera=Camera.create(**cam,
                                                           device="cpu"))


def _cfg(scene, shading="diffuse", **kw):
    kw = dict(dict(width=W, height=H, sampling_rate=RATE), **kw)
    return api.RenderConfig(method="auto", shading=shading,
                            **kw).resolved(scene)


class Spy(shearwarp.SetupGraphs):
    """Records the key of every frame offered to it. With `take`, the
    frames the rule admits (every rule but the device's) run
    `frame_setup` here, eagerly, where a replay would be."""

    def __init__(self, take=False):
        super().__init__()
        self.take, self.keys, self.inputs, self.taken = take, [], [], 0

    def replayable(self, key, x, *more):
        self.keys.append(key)
        self.inputs.append(x)
        return self.take and not shearwarp._wants_grad(*x, *more)

    def setup(self, key, x):
        """As a capture runs it: in the shared screen buffers."""
        self.taken += 1
        return shearwarp.frame_setup(key, x,
                                     screen=shearwarp.screen_buffers(key))


def counts():
    return (shearwarp.SETUP_REPLAYS, shearwarp.SETUP_CAPTURES,
            shearwarp.SETUP_EAGER)


def key_of(scene, cfg, **kw):
    spy = Spy()
    shearwarp.render_shearwarp(scene, cfg, scene.camera, setup_graphs=spy,
                               **kw)
    (key,) = spy.keys
    return key


def assert_same_frame(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---- the key ---------------------------------------------------------------

def test_key_equal_for_two_views_of_one_plan():
    s1, s2 = _scene(10.0), _scene(25.0)
    c1, c2 = _cfg(s1), _cfg(s2)
    assert (c1.sw.axis, c1.sw.sign) == (c2.sw.axis, c2.sw.sign)
    k1, k2 = key_of(s1, c1), key_of(s2, c2)
    assert k1 == k2 and hash(k1) == hash(k2)
    assert (k1.mode, k1.ortho, k1.jitter, k1.device) == (
        1, False, False, torch.device("cpu"))


def _lattice(scene, cfg):
    return api.build_light_grid(scene, cfg)


# each case changes one thing that the setup reads; the fields it moves
VARIANTS = {
    "axis": (dict(deg=270.0), {}, {}, {"axis"}),
    "sign": (dict(deg=170.0), {}, {}, {"sign"}),
    "n_slices": ({}, dict(sampling_rate=30.0), {}, {"n_slices"}),
    "slice0_static": (dict(from_=(0.5, 0.5, 0.3), at=(0.5, 0.52, 0.9)), {},
                      {}, {"slice0_static"}),
    "inter": ({}, dict(sw_inter_cap=48), {}, {"inter_h", "inter_w"}),
    "width": ({}, dict(width=W + 8), {}, {"width"}),
    "height": ({}, dict(height=H + 8), {}, {"height"}),
    "mode_none": ({}, dict(shading="none"), {}, {"mode"}),
    "mode_shadow": ({}, dict(shading="shadow"), "lattice", {"mode", "l_a"}),
    "ortho": (dict(height=1.3, kind="orthographic"), {}, {}, {"ortho"}),
    "dtype": ({}, dict(dtype=torch.float64), {}, {"dtype"}),
    "base_rate": ({}, dict(base_rate=0.25), {}, {"base_rate"}),
    "n_a": (dict(shape=(24, 20, 20)), {}, {}, {"n_a"}),
    "n_color": ({}, {}, "color", {"n_color"}),
    "n_alpha": ({}, {}, "alpha", {"n_alpha"}),
    "n_dir": ({}, {}, "directional", {"n_dir"}),
    "n_point": ({}, {}, "point", {"n_point"}),
    "jitter": ({}, {}, "jitter", {"jitter"}),
}


def _variant_key(name):
    scene_kw, cfg_kw, extra, _ = VARIANTS[name]
    scene = _scene(**scene_kw)
    kw = {}
    if extra == "color":
        scene = dataclasses.replace(scene, tfn=dataclasses.replace(
            scene.tfn, color=torch.rand(9, 3)))
    elif extra == "alpha":
        scene = dataclasses.replace(scene, tfn=dataclasses.replace(
            scene.tfn, alpha=torch.linspace(0.0, 1.0, 11)))
    elif extra in ("directional", "point"):
        scene = dataclasses.replace(scene, lights=(Light.create(
            direction=(0.3, 0.2, -1.0), position=(1.5, 1.2, 0.2),
            kind=extra, device="cpu"),))
    elif extra == "jitter":
        kw["jitter"] = torch.tensor(0.25)
    cfg = _cfg(scene, **cfg_kw)
    if extra == "lattice":
        kw["light_grid"] = _lattice(scene, cfg)
    return key_of(scene, cfg, **kw)


@pytest.mark.parametrize("name", VARIANTS)
def test_key_differs_with_each_value_the_setup_reads(name):
    base = key_of(_scene(), _cfg(_scene()))
    key = _variant_key(name)
    moved = {f for f in shearwarp.SetupKey._fields
             if getattr(key, f) != getattr(base, f)}
    assert moved == VARIANTS[name][3]
    assert key != base


def test_key_differs_by_device():
    scene = _scene()
    cfg = _cfg(scene)
    args = (scene, cfg, scene.camera, None, 1, 20, 0)
    assert shearwarp.setup_key(*args, "cpu") != shearwarp.setup_key(
        *args, "cuda")


def test_key_leaves_out_what_only_the_loop_and_warp_read():
    scene = _scene()
    cfg = _cfg(scene)
    sw = dataclasses.replace(cfg.sw, separable=not cfg.sw.separable,
                             swap=not cfg.sw.swap, term=not cfg.sw.term,
                             bf16=not cfg.sw.bf16,
                             fd_grad=not cfg.sw.fd_grad)
    assert key_of(scene, cfg) == key_of(scene, dataclasses.replace(cfg,
                                                                   sw=sw))


def test_an_orbit_has_four_plans():
    keys = set()
    for deg in range(0, 360, 45):
        scene = _scene(float(deg))
        keys.add(key_of(scene, _cfg(scene)))
    assert len(keys) == 4
    assert {(k.axis, k.sign) for k in keys} == {(0, 1), (0, -1), (2, 1),
                                                (2, -1)}


# ---- the setup in the screen buffers ----------------------------------------

def _setup_of(scene, cfg):
    spy = Spy()
    shearwarp.render_shearwarp(scene, cfg, scene.camera, setup_graphs=spy)
    return spy.keys[0], spy.inputs[0]


def _plain_safe_div(a, b):
    """a / b, b moved to 1e-9 with its sign (+ at -0.0) where |b| < 1e-9,
    as the JAX package does it (its f32 constants)."""
    return a / torch.where(torch.abs(b) < 1e-9,
                           torch.where(b < 0, -1e-9, 1e-9).to(b.dtype), b)


CAMERA_CASES = {"persp": {}, "ortho": dict(height=1.3, kind="orthographic"),
                "wide": dict(fovy=100.0, deg=35.0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cam", CAMERA_CASES)
def test_setup_in_the_screen_buffers_keeps_the_bits(cam, dtype):
    """`frame_setup` in the screen buffers (as a capture runs it, every
    screen-sized value made in place) gives the bits it gives without
    them, and its fan coordinates are the per-ray directions' components
    over the axial one, made safe as the JAX package does, as the (H, W, 3)
    directions give them."""
    kw = dict(CAMERA_CASES[cam])
    scene = _scene(kw.pop("deg", 10.0), **kw)
    key, x = _setup_of(scene, _cfg(scene, dtype=dtype))
    want = shearwarp.frame_setup(key, x)
    got = shearwarp.frame_setup(key, x, screen=shearwarp.screen_buffers(key))
    assert want.keys() == got.keys()
    for name, a in want.items():
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, got[name]), name
        else:
            assert a == got[name], name
    w1, w2 = shearwarp._perp_axes(key.axis)
    vv, uu = torch.meshgrid(want["v"], want["u"], indexing="ij")
    if key.ortho:
        base = want["e"][None, None, :]
    else:
        base = want["direction"][None, None, :]
    dw = (base + uu[..., None] * want["horizontal"]
          + vv[..., None] * want["vertical"])
    if key.ortho:
        p, q = dw[..., w1], dw[..., w2]
    else:
        da = dw[..., key.axis] * key.sign
        p = _plain_safe_div(dw[..., w1], da)
        q = _plain_safe_div(dw[..., w2], da)
    assert torch.equal(want["p_scr"], p) and torch.equal(want["q_scr"], q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_safe_denominator_keeps_the_bits(dtype):
    """Denominators within 1e-9 of zero, of either sign, -0.0 and NaN are
    made safe as the JAX package does (its f32 constants), with and
    without buffers, `b` its own output."""
    b = torch.tensor([0.0, -0.0, 5e-10, -5e-10, 1e-9, -1e-9, 2.0, -3.0,
                      1e-30, float("nan")], dtype=dtype)
    want = _plain_safe_div(torch.ones_like(b), b)
    got = [shearwarp._safe_div(torch.ones_like(b), b)]
    buf = b.clone()
    got.append(torch.ones_like(b) / shearwarp._safe_den(
        buf, buf, (torch.empty_like(b), torch.empty_like(b)),
        torch.empty_like(b, dtype=torch.bool)))
    for g in got:
        assert torch.equal(want[:-1], g[:-1]) and g[-1].isnan()


# ---- where a frame may replay -----------------------------------------------

def test_cpu_renderer_frames_run_eagerly_with_their_bits():
    scene = _scene()
    r = api.Renderer(scene, api.RenderConfig(
        width=W, height=H, sampling_rate=RATE, method="auto",
        shading="diffuse", use_macrocells=True))
    before = counts()
    for deg in (10.0, 100.0, 190.0, 280.0, 20.0):
        r.set_camera(from_=orbit_eye(deg), at=CENTER)
        r.commit()
        r.render()
        want = api.render(r.scene, r._cfg, camera=r._camera,
                          frame_index=r._frame_index,
                          macrocells=r._macrocells)
        for a, b in ((r._frame.rgba, want.rgba), (r._frame.grad, want.grad),
                     (r._frame.depth, want.depth)):
            assert torch.equal(a, b)
    # five Renderer frames and five direct ones, all eager
    assert counts() == (before[0], before[1], before[2] + 10)


def _frame(scene, cfg, graphs, **kw):
    return shearwarp.render_shearwarp(scene, cfg, scene.camera,
                                      setup_graphs=graphs, **kw)


def test_frames_the_rule_admits_reach_the_cache():
    """The stand-in takes a plain frame, a shadow frame with its lattice
    and a jittered one, and each keeps the eager bits."""
    for shading, kw in (("diffuse", {}), ("shadow", "lattice"),
                        ("none", {"jitter": 0.25})):
        scene = _scene()
        cfg = _cfg(scene, shading)
        if kw == "lattice":
            kw = {"light_grid": _lattice(scene, cfg)}
        spy = Spy(take=True)
        e0 = shearwarp.SETUP_EAGER
        got = _frame(scene, cfg, spy, **kw)
        assert spy.taken == 1 and shearwarp.SETUP_EAGER == e0
        assert_same_frame(got, _frame(scene, cfg, None, **kw))


def _kinds():
    scene = _scene()
    cfg = _cfg(scene)
    lo, hi = scene.volume.world_lo, scene.volume.world_hi
    n = cfg.sw.n_slices
    return {
        "grad": (scene, _cfg(scene, width=24, height=16), {}),
        "surfaces": (with_iso(scene), _cfg(scene, iso_steps=16), {}),
        "bricks": (scene, cfg, dict(sample_box=(lo, hi), clip_box=(lo, hi),
                                    slice0=0, n_slices_loc=n)),
        "band": (scene, cfg, dict(row0=4, n_rows=H - 8)),
        "fan_only": (scene, cfg, dict(fan_only=True)),
    }


@pytest.mark.parametrize("kind", ["grad", "surfaces", "bricks", "band",
                                  "fan_only"])
def test_frames_that_cannot_replay_run_eagerly_with_their_bits(kind):
    scene, cfg, kw = _kinds()[kind]
    if kind == "grad":
        grid = scene.volume.grid.clone().requires_grad_(True)
        scene = dataclasses.replace(scene, volume=dataclasses.replace(
            scene.volume, grid=grid))
    spy = Spy(take=True)
    e0 = shearwarp.SETUP_EAGER
    got = _frame(scene, cfg, spy, **kw)
    assert spy.taken == 0 and shearwarp.SETUP_EAGER == e0 + 1
    want = _frame(scene, cfg, None, **kw)
    n = 4 if kind == "fan_only" else len(want)
    assert_same_frame(got[:n], want[:n])
    if kind == "grad":
        got[0].sum().backward()
        assert torch.isfinite(grid.grad).all()


def test_path_traced_gather_runs_eagerly():
    scene = _scene()
    cfg = _cfg(scene, path_tracing=True, pt_dense=True, pt_lattice=16,
               pt_dirs=6)
    before = counts()
    got = api.render(scene, cfg, _setup_graphs=Spy(take=True))
    want = api.render(scene, cfg)
    assert torch.equal(got.rgba, want.rgba)
    assert counts() == (before[0], before[1], before[2] + 2)


def test_macrocell_frames_on_the_cpu_never_capture():
    scene = _scene()
    cfg = _cfg(scene)
    mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    graphs = shearwarp.SetupGraphs()
    before = counts()
    for _ in range(2):
        got = api.render(scene, cfg, macrocells=mc, _setup_graphs=graphs)
    assert counts() == (before[0], before[1], before[2] + 2)
    assert torch.equal(got.rgba, api.render(scene, cfg, macrocells=mc).rgba)
    assert not graphs._graphs
