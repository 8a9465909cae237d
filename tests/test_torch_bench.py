"""The port's bench (ovr_tpu_torch.bench) against the repository's
bench.py and the JAX package, on the CPU.

bench.py's main is one function, so its scene edits and config
(`bench.py:87-179`) are written out here on the JAX side (`jax_setup`)
from its own `build_scene`; the port builds them from the same knobs.
Sizes: 16^3, 48x32, rate 16, 1 warm-up and 2 frames. Tolerances, those
the port's render tests use: rgba and normals 5e-5, depth 2e-4 against
JAX's XLA slice loop (early termination on: 5e-4, the JAX suite's
termination bound); sw_bf16 against JAX's kernel in interpret mode by
tests/test_torch_render.py's bf16 frame rule; the Monte-Carlo path
tracer under JAX's replayed draws by tests/test_torch_pathtracer.py's
rule (rgba within 1e-4 on 99.5% of the pixels); gradients within 2e-3 of
the largest element of `jax.grad`'s; losses rtol 1e-5. The TF alpha of
BENCH_OPAQUE is `linspace(0.6, 1, 16)` in each package, two of whose
values differ by one f32 ulp (6e-8).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import bench as jbench
from ovr_tpu import api as japi
from ovr_tpu.core.scene import Camera as JCamera
from ovr_tpu.core.scene import Light as JLight
from ovr_tpu.neural import field as jfield
from ovr_tpu.neural import hashgrid as jhash
from ovr_tpu.neural import train as jtrain
from ovr_tpu.render import accel as jaccel
from ovr_tpu.render import ptdense as jptdense
from ovr_tpu_torch import bench
from ovr_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from ovr_tpu_torch.ops import swslice
from ovr_tpu_torch.render import pathtracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"BENCH_DEVICE": "cpu", "BENCH_GRID": "16", "BENCH_WIDTH": "48",
         "BENCH_HEIGHT": "32", "BENCH_RATE": "16", "BENCH_FRAMES": "2",
         "BENCH_WARMUP": "1"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_launch():
    n0 = swslice.LAUNCHES
    yield
    assert swslice.LAUNCHES == n0, "a CPU test launched the slice kernel"


def knobs(**kw):
    return bench.read_knobs(dict(SMALL, **kw))


def jax_setup(k, field=None):
    """bench.py's scene edits, config, neural proxy and macrocells
    (`bench.py:87-179`) for the knobs `k`, in the JAX package; `field`
    the BENCH_NEURAL volume. Returns (scene, cfg, macrocells)."""
    js = jbench.build_scene(k.grid)
    if k.eye_inside:
        js = dataclasses.replace(js, camera=JCamera.create(
            from_=(0.5, 0.45, 0.3), at=(0.55, 0.5, 1.6), fovy=45.0))
    base = 1.0
    if k.opaque:
        js = dataclasses.replace(js, tfn=dataclasses.replace(
            js.tfn, alpha=jnp.linspace(0.6, 1.0, 16)))
        base = k.opaque_base if k.opaque_base is not None else k.rate / 4
    vol = js.volume
    if k.store == "bf16":
        vol = dataclasses.replace(vol, grid=vol.grid.astype(jnp.bfloat16))
    elif k.store == "u8":
        vol = dataclasses.replace(vol, grid=jnp.clip(
            jnp.round(vol.grid * 255), 0, 255).astype(jnp.uint8))
    js = dataclasses.replace(js, volume=vol)
    if k.n_lights:
        js = dataclasses.replace(js, lights=tuple(
            JLight.create(direction=(0.4 * i - 0.6, 0.3, -1.0),
                          intensity=0.5 + 0.1 * i)
            for i in range(k.n_lights)))
    if field is not None:
        js = dataclasses.replace(js, volume=field)
    jc = japi.RenderConfig(
        width=k.width, height=k.height, spp=1, sampling_rate=k.rate,
        base_rate=base, shading=k.shading, fast_math=True,
        use_macrocells=True, method=k.method,
        ray_chunk=int(k.ray_chunk) if k.ray_chunk else None,
        adaptive_scale=k.adaptive, sw_bf16=k.bf16, sw_term=k.term,
        sw_skip=k.skip, sw_col_win=k.colwin, sw_persist=k.persist,
        path_tracing=bool(k.pt),
        pt_dense=k.pt == "dense").resolved(js)
    if field is not None:
        r = k.proxy
        jc = dataclasses.replace(jc, neural_proxy_res=r).resolved(js)
        mc_grid = (jtrain.bake_grid(field, (r, r, r))
                   if jc.sw is not None else None)
    else:
        mc_grid = js.volume.grid
    jmc = (None if mc_grid is None else jaccel.build_macrocells(
        mc_grid, js.tfn.alpha, js.tfn.value_range))
    return js, jc, jmc


def jax_first_frame(js, jc, jmc):
    """bench.py's frame 0 in the JAX package: its own shadow lattice and
    dense PT fields; a neural proxy baked inside `render`."""
    lg = (japi.build_light_grid(js, jc) if japi._wants_light_grid(jc)
          else None)
    ptf = (jax.jit(jptdense.prepare, static_argnums=1)(js, jc)
           if jc.path_tracing and jc.pt_dense and jc.sw is not None
           else None)
    return japi.render(js, jc, frame_index=0, macrocells=jmc,
                       light_grid=lg, pt_fields=ptf)


def scene_arrays(scene):
    """A scene's arrays (either package's; numbers as float64, a bf16
    grid through f32)."""
    grid = scene.volume.grid
    if isinstance(grid, torch.Tensor) and grid.dtype == torch.bfloat16:
        scene = dataclasses.replace(scene, volume=dataclasses.replace(
            scene.volume, grid=grid.float()))
    out = {}
    for k, v in arrays_from_scene(scene).items():
        v = np.asarray(v)
        out[k] = v.astype(np.float64) if (
            v.dtype.kind in "fiu" or v.dtype == ml_dtypes.bfloat16) else v
    return out


# ---- the scene -------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 24])
def test_build_scene_is_bench_py_bit_for_bit(n):
    js = jbench.build_scene(n)
    ts = bench.build_scene(n, "cpu")
    np.testing.assert_array_equal(ts.volume.grid.numpy(),
                                  np.asarray(js.volume.grid))
    for f in ("from_", "at", "up", "fovy", "height"):
        np.testing.assert_array_equal(getattr(ts.camera, f).numpy(),
                                      np.asarray(getattr(js.camera, f)))
    assert ts.camera.kind == js.camera.kind
    got, want = scene_arrays(ts), scene_arrays(js)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


SCENE_KNOBS = [dict(BENCH_EYE="inside"), dict(BENCH_OPAQUE="1"),
               dict(BENCH_OPAQUE="1", BENCH_OPAQUE_BASE="2.5"),
               dict(BENCH_STORE="f32"), dict(BENCH_STORE="bf16"),
               dict(BENCH_STORE="u8"), dict(BENCH_EXTRA_LIGHTS="6"),
               dict(BENCH_STORE="u8", BENCH_EXTRA_LIGHTS="2",
                    BENCH_EYE="inside")]


@pytest.mark.parametrize("env", SCENE_KNOBS,
                         ids=["-".join(e.values()) for e in SCENE_KNOBS])
def test_scene_knobs_match_bench_py(env):
    """The port's scene and config for each scene knob against the same
    edits to bench.py's JAX scene, carried over through convert.py."""
    k = knobs(**env)
    s = bench.build_setup(k)
    js, jc, _ = jax_setup(k)
    carried = scene_from_arrays(arrays_from_scene(js), device="cpu")
    assert s.scene.volume.grid.dtype == carried.volume.grid.dtype
    got, want = scene_arrays(s.scene), scene_arrays(carried)
    assert got.keys() == want.keys()
    for key in got:
        if got[key].dtype.kind not in "fiu":  # the `kind` strings
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            continue
        tol = 1e-7 if key == "tfn.alpha" else 0.0
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol,
                                   err_msg=key)
    for f in ("base_rate", "max_steps", "shadow_max_steps", "sampling_rate",
              "sw_term", "sw_skip", "sw_bf16"):
        assert getattr(s.cfg, f) == getattr(jc, f), f
    assert (s.cfg.sw is None) == (jc.sw is None)
    if jc.sw is not None:
        assert (s.cfg.sw.axis, s.cfg.sw.n_slices) == (jc.sw.axis,
                                                     jc.sw.n_slices)


# ---- the first frame of each forward mode -----------------------------------

def _channels(frame):
    rgba, grad, depth = (np.asarray(x) for x in (frame.rgba, frame.grad,
                                                 frame.depth))
    return np.concatenate([np.moveaxis(rgba[..., :3], -1, 0),
                           np.moveaxis(grad, -1, 0), depth[None],
                           rgba[None, ..., 3]])


def assert_bf16_frames_close(tf, jf):
    """tests/test_torch_render.py's sw_bf16 frame rule against JAX's
    kernel forward: 2.5% of the values beyond 2e-5, rgba within 8e-3,
    normals and depth within 2e-2 (a value the two loops round apart at a
    bf16 tie reaches the screen as a whole bf16 ulp)."""
    d = np.abs(_channels(tf) - _channels(jf))
    assert float((d > 2e-5).mean()) <= 0.025
    assert float(d[[0, 1, 2, 7]].max()) <= 8e-3
    assert float(d[3:7].max()) <= 2e-2


FORWARD = {
    "none": dict(BENCH_SHADING="none"),
    "diffuse": {},
    "shadow": dict(BENCH_SHADING="shadow"),
    "march": dict(BENCH_METHOD="march"),
    "bf16": dict(BENCH_BF16="1", BENCH_TERM="0"),
    "noterm": dict(BENCH_TERM="0"),
    "noskip": dict(BENCH_SKIP="0", BENCH_TERM="0"),
    "lights6": dict(BENCH_EXTRA_LIGHTS="6"),
    "opaque": dict(BENCH_OPAQUE="1"),
    "opaque-noterm": dict(BENCH_OPAQUE="1", BENCH_TERM="0"),
    "eye-inside": dict(BENCH_EYE="inside"),
    "u8": dict(BENCH_STORE="u8"),
    "adaptive2-march": dict(BENCH_ADAPTIVE="2", BENCH_METHOD="march"),
    "raychunk-march": dict(BENCH_RAY_CHUNK="500", BENCH_METHOD="march"),
    "pt-dense": dict(BENCH_PT="dense"),
    "colwin-legacy": dict(BENCH_COLWIN="1", BENCH_PERSIST="0",
                          BENCH_TERM="0"),
}


@pytest.mark.parametrize("mode", list(FORWARD))
def test_first_frame_matches_jax(mode):
    """Frame 0 of the bench's forward frame (chain 0) against
    `ovr_tpu.api.render` on the same scene and config (the dense path
    tracer's scatter orders cut from 24 to 4 in both: JAX compiles each
    order's 14 sweeps)."""
    k = knobs(**FORWARD[mode])
    js, jc, jmc = jax_setup(k)
    if k.bf16:  # JAX's kernel in interpret mode, which rounds as the port
        jc = dataclasses.replace(jc, sw=dataclasses.replace(jc.sw,
                                                            pallas=True))
    s = bench.build_setup(k)
    if k.pt == "dense":
        jc = dataclasses.replace(jc, max_scatters=4)
        s.cfg = dataclasses.replace(s.cfg, max_scatters=4)
    with torch.no_grad():
        tf = bench.forward_frame(s)(0, torch.zeros(()))
    jf = jax_first_frame(js, jc, jmc)
    assert float(tf.rgba[..., 3].max()) > 0.1  # the volume is in view
    if k.bf16:
        assert s.cfg.sw.bf16
        assert_bf16_frames_close(tf, jf)
        return
    # early termination on the slice kernel's path: the JAX suite's bound
    tol = 5e-4 if k.term and s.cfg.sw is not None else 5e-5
    np.testing.assert_allclose(tf.rgba.numpy(), np.asarray(jf.rgba),
                               atol=tol)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf.grad),
                               atol=tol)
    np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth),
                               atol=max(tol, 2e-4))


def test_first_mc_path_traced_frame_matches_jax(monkeypatch):
    """BENCH_PT=mc's frame 0 under JAX's draws (`render`'s key for frame
    0, replayed as tests/test_torch_pathtracer.py's JaxDraws)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)

    class JaxDraws(pathtracer.Draws):
        def __init__(self, key):
            self.key = key

        def fold_in(self, i):
            return JaxDraws(jax.random.fold_in(self.key, i))

        def uniform(self, shape, dtype=torch.float32, device=None):
            return torch.from_numpy(np.array(jax.random.uniform(
                self.key, shape, jnp.float32)))

    monkeypatch.setattr(pathtracer, "GeneratorDraws",
                        lambda generator: JaxDraws(key))
    k = knobs(BENCH_PT="mc")
    js, jc, jmc = jax_setup(k)
    s = bench.build_setup(k)
    with torch.no_grad():
        tf = bench.forward_frame(s)(0, torch.zeros(()))
    jf = jax_first_frame(js, jc, jmc)
    d = np.abs(tf.rgba.numpy() - np.asarray(jf.rgba)).max(-1)
    assert (d <= 1e-4).mean() >= 0.995, (d > 1e-4).mean()
    assert float(tf.rgba[..., :3].max()) > 0.05


def _jax_neural_field():
    """BENCH_NEURAL's field in the JAX package (`PRNGKey(0)`, hidden 64,
    2 hidden layers), its hash grid cut to 4 levels of 2^12 entries (JAX
    compiles a loop per level)."""
    return jfield.init_field(
        jax.random.PRNGKey(0), jhash.HashGridConfig(
            n_levels=4, log2_table_size=12, base_resolution=4,
            max_resolution=32), hidden=64, n_hidden=2)


def _carry(monkeypatch, jf):
    """The port's bench renders JAX's field `jf`, carried over."""
    port = scene_from_arrays(arrays_from_scene(dataclasses.replace(
        jbench.build_scene(16), volume=jf)), device="cpu").volume
    monkeypatch.setattr(bench, "neural_field", lambda device: port)


def test_first_neural_frame_matches_jax(monkeypatch):
    """BENCH_NEURAL=fwd's frame 0 (the 16^3 proxy baked by the port's
    `bake_grid_host`, JAX's baked inside `render`) with JAX's field, its
    tables scaled by 1e4 (the ngp init gives a field constant to ~1e-4)."""
    jf = _jax_neural_field()
    jf = dataclasses.replace(jf, tables=jf.tables * 1e4)
    _carry(monkeypatch, jf)
    k = knobs(BENCH_NEURAL="fwd", BENCH_PROXY="16")
    js, jc, jmc = jax_setup(k, field=jf)
    s = bench.build_setup(k)
    assert s.proxy is not None and s.cfg.sw is not None
    with torch.no_grad():
        tf = bench.forward_frame(s)(0, torch.zeros(()))
    jfr = jax_first_frame(js, jc, jmc)
    assert float(tf.rgba[..., 3].max()) > 0.1
    np.testing.assert_allclose(tf.rgba.numpy(), np.asarray(jfr.rgba),
                               atol=5e-4)
    np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jfr.depth),
                               atol=5e-4)


def test_neural_train_step_loss_matches_jax(monkeypatch):
    """BENCH_NEURAL=train's first step (16^3 proxy, lr 1e-3, zero target)
    against JAX's `make_image_train_step` on the same field: its loss.
    (Later losses are not held: the ngp init's gradients in most table
    entries are rounding noise, and Adam's first update moves each entry
    by lr times the sign of its gradient.)"""
    jf = _jax_neural_field()
    _carry(monkeypatch, jf)
    k = knobs(BENCH_NEURAL="train", BENCH_PROXY="16")
    js, jc, _ = jax_setup(k, field=jf)
    jstep, jstate = jtrain.make_image_train_step(js, jc, lr=1e-3)
    _, jl = jstep(jstate, js.camera,
                  jnp.zeros((k.height, k.width, 4), jnp.float32))
    s = bench.build_setup(k)
    n0 = swslice.PLAIN_CALLS
    loss = bench.train_frame(s)(0, torch.zeros(()))
    assert swslice.PLAIN_CALLS == n0 + 1  # the forward's slice loop
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)


# ---- the backward ----------------------------------------------------------

def _close_grads(got, want, tol=2e-3):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale,
                               want / scale, atol=tol)


@pytest.mark.parametrize("shading,eye", [("none", ""),
                                         ("diffuse", "inside"),
                                         ("shadow", "inside")])
def test_backward_grads_match_jax(shading, eye):
    """BENCH_BACKWARD's gradients of mean(rgba^2) + mean(grad^2) in the
    grid and the TF alpha against `jax.grad` of bench.py's loss. The
    shaded modes are held from BENCH_EYE=inside: from the default eye the
    field's z = 0 face (sin(8z) = 0, the blob's term ~1e-5 there) faces
    the camera, its normals are rounding noise, and one ulp of noise on
    the voxels moves JAX's own diffuse gradients by up to 1.1 (grid) and
    0.88 (alpha) of their largest element; from inside, by 4.6e-4."""
    k = knobs(BENCH_BACKWARD="1", BENCH_SHADING=shading, BENCH_EYE=eye)
    js, jc, _ = jax_setup(k)
    lgb = (japi.build_light_grid(js, jc) if japi._wants_light_grid(jc)
           else None)

    def loss(g, a):
        sc = dataclasses.replace(
            js, volume=dataclasses.replace(js.volume, grid=g),
            tfn=dataclasses.replace(js.tfn, alpha=a))
        f = japi.render(sc, jc, light_grid=lgb)
        return jnp.mean(f.rgba ** 2) + jnp.mean(f.grad ** 2)

    jg, ja = jax.grad(loss, argnums=(0, 1))(js.volume.grid, js.tfn.alpha)
    s = bench.build_setup(k)
    n0 = swslice.PLAIN_CALLS
    tg, ta = bench.make_grad_step(s)(s.scene.volume.grid,
                                     s.scene.tfn.alpha)
    assert swslice.PLAIN_CALLS == n0 + 1  # the forward's slice loop
    _close_grads(tg.numpy(), jg)
    _close_grads(ta.numpy(), ja)


def test_backward_keeps_a_bf16_grid_in_bf16():
    k = knobs(BENCH_BACKWARD="1", BENCH_STORE="bf16")
    s = bench.build_setup(k)
    tg, ta = bench.make_grad_step(s)(s.scene.volume.grid,
                                     s.scene.tfn.alpha)
    assert tg.dtype == torch.bfloat16 and bool(torch.isfinite(ta).all())


# ---- BENCH_TIMEVAR ---------------------------------------------------------

def bench_py_timesteps(n, k_steps, store):
    """bench.py's host timesteps (`bench.py:273-287`), bf16 through
    ml_dtypes."""
    ax = np.linspace(0, 1, n, dtype=np.float32)
    x, y, zz = ax[None, None, :], ax[None, :, None], ax[:, None, None]
    out = []
    for k in range(k_steps):
        ph = 2 * np.pi * k / k_steps
        gk = (0.5 + 0.35 * np.sin(12 * x + ph) * np.cos(10 * y)
              * np.sin(8 * zz - ph)).astype(np.float32)
        if store == "bf16":
            gk = gk.astype(ml_dtypes.bfloat16)
        elif store == "u8":
            gk = np.clip(np.round(gk * 255), 0, 255).astype(np.uint8)
        out.append(gk)
    return out


@pytest.mark.parametrize("store", ["f32", "bf16", "u8"])
@pytest.mark.parametrize("n", [24, 64])
def test_timevar_steps_are_bench_py_bit_for_bit(store, n):
    got = bench.timevar_steps(n, 3, store)
    want = bench_py_timesteps(n, 3, store)
    for g, w in zip(got, want):
        if store == "bf16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            assert g.numpy().dtype == w.dtype
            np.testing.assert_array_equal(g.numpy(), w)


def test_timevar_frame_k_renders_step_k():
    """Frames 0..3 of BENCH_TIMEVAR=3 (bf16 storage) render steps 0, 1, 2,
    0, each against JAX's frame of that step."""
    k = knobs(BENCH_TIMEVAR="3", BENCH_STORE="bf16")
    js, jc, jmc = jax_setup(k)
    steps = bench_py_timesteps(k.grid, 3, "bf16")
    frame = bench.timevar_frame(bench.build_setup(k))
    for i in range(4):
        with torch.no_grad():
            tf = frame(i, torch.zeros(()))
        sc = dataclasses.replace(js, volume=dataclasses.replace(
            js.volume, grid=jnp.asarray(steps[i % 3])))
        jf = japi.render(sc, jc, frame_index=i, macrocells=jmc)
        np.testing.assert_allclose(tf.rgba.numpy(), np.asarray(jf.rgba),
                                   atol=5e-4)


# ---- keys, metric, book, the program ---------------------------------------

KEYS = [
    ({}, "cpu-16-48x32-16.0-diffuse-auto"),
    (dict(BENCH_SHADING="shadow", BENCH_STORE="bf16"),
     "cpu-16-48x32-16.0-shadow-auto-sbf16"),
    (dict(BENCH_GRID="1024", BENCH_RATE="1024"),
     "cpu-1024-48x32-1024.0-diffuse-auto"),
    (dict(BENCH_GRID="1024", BENCH_STORE="f32"),
     "cpu-1024-48x32-16.0-diffuse-auto-sf32"),
    (dict(BENCH_BACKWARD="1", BENCH_SHADING="none"),
     "cpu-16-48x32-16.0-none-auto-bwd"),
    (dict(BENCH_EXTRA_LIGHTS="6", BENCH_RAY_CHUNK="4096",
          BENCH_METHOD="march"),
     "cpu-16-48x32-16.0-diffuse-march-l6-rc4096"),
    (dict(BENCH_BF16="1", BENCH_TERM="0", BENCH_SKIP="0",
          BENCH_PERSIST="0", BENCH_COLWIN="1"),
     "cpu-16-48x32-16.0-diffuse-auto-mm16-noterm-noskip-legacy-cw"),
    (dict(BENCH_OPAQUE="1", BENCH_EYE="inside", BENCH_ADAPTIVE="2.5"),
     "cpu-16-48x32-16.0-diffuse-auto-opq-eyein-as2.5"),
    (dict(BENCH_PT="dense"), "cpu-16-48x32-16.0-diffuse-auto-ptdense"),
    (dict(BENCH_TIMEVAR="4", BENCH_STORE="u8"),
     "cpu-16-48x32-16.0-diffuse-auto-su8-tv4"),
    (dict(BENCH_MESH="2x1"), "cpu-16-48x32-16.0-diffuse-auto-mesh2x1"),
    (dict(BENCH_NEURAL="fwd"), "cpu-16-48x32-16.0-diffuse-auto-nffwd512"),
    (dict(BENCH_NEURAL="train", BENCH_PROXY="128"),
     "cpu-16-48x32-16.0-diffuse-auto-nftrain128"),
]


@pytest.mark.parametrize("env,key", KEYS, ids=[k for _, k in KEYS])
def test_config_key_is_bench_py(env, key):
    """Keys written out by hand from `bench.py:354-370` (platform cpu)."""
    k = knobs(**env)
    cfg = bench.api.RenderConfig(neural_proxy_res=k.proxy or 512,
                                 shading=k.shading)
    assert bench.config_key(k, cfg) == key


def test_metric_text_is_bench_py():
    k = knobs(BENCH_BACKWARD="1", BENCH_STORE="bf16")
    cfg = bench.api.RenderConfig(shading="diffuse", sw=object())
    assert bench.metric_text(k, cfg) == (
        "backward rays/s (16^3 bf16 grid, 48x32, diffuse shading, "
        "shear-warp compositing, grid+TF grads via bounded-memory adjoint)")
    k = knobs(BENCH_NEURAL="train", BENCH_PROXY="128")
    cfg = bench.api.RenderConfig(shading="diffuse", neural_proxy_res=128)
    assert bench.metric_text(k, cfg) == (
        "forward rays/s (16^3 f32 grid, 48x32, diffuse shading, neural "
        "hash-grid MLP via baked 128^3 proxy, full train step)")
    k = knobs(BENCH_PT="mc")
    assert bench.metric_text(k, cfg).endswith(
        "delta-tracking path tracer, macrocell DDA)")


def test_main_prints_one_line_and_keeps_its_book(monkeypatch, capsys,
                                                  tmp_path):
    """`main` in process: one JSON line with exactly the four keys;
    `vs_baseline` null on a key's first run and a ratio on its second;
    the slice loop ran once a frame (the plain version on the CPU)."""
    book = tmp_path / "book.json"
    monkeypatch.setattr(bench, "BASELINE_PATH", str(book))
    lines = []
    for _ in range(2):
        n0 = swslice.PLAIN_CALLS
        assert bench.main(dict(SMALL)) == 0
        assert swslice.PLAIN_CALLS == n0 + 3
        out = capsys.readouterr()
        assert len(out.out.splitlines()) == 1
        lines.append(json.loads(out.out.splitlines()[-1]))
        assert "bench: key cpu-16-48x32-16.0-diffuse-auto" in out.err
    for line in lines:
        assert set(line) == {"metric", "value", "unit", "vs_baseline"}
        assert line["unit"] == "rays/s"
        assert math.isfinite(line["value"]) and line["value"] > 0
        assert line["metric"] == ("forward rays/s (16^3 f32 grid, 48x32, "
                                  "diffuse shading, shear-warp "
                                  "compositing)")
    assert lines[0]["vs_baseline"] is None
    assert lines[1]["vs_baseline"] == pytest.approx(
        lines[1]["value"] / lines[0]["value"])
    assert json.loads(book.read_text()) == {
        "cpu-16-48x32-16.0-diffuse-auto": lines[0]["value"]}


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_mesh_runs_gloo_ranks(mesh, tmp_path):
    """BENCH_MESH over gloo CPU ranks: every rank rendered its frames
    through the slice loop, the value is finite, the key bench.py's."""
    res = bench.run(dict(SMALL, BENCH_MESH=mesh, OMP_NUM_THREADS="1"),
                    book=str(tmp_path / "book.json"))
    assert res["key"] == f"cpu-16-48x32-16.0-diffuse-auto-mesh{mesh}"
    assert len(res["ranks"]) == 2
    assert all(r["plain_calls"] == 3 for r in res["ranks"])
    v = res["line"]["value"]
    assert math.isfinite(v) and v > 0
    slowest = max(r["seconds"] for r in res["ranks"])
    assert v == pytest.approx(48 * 32 * 2 / slowest)


def test_no_card_exits_nonzero_without_a_line():
    """Without a CUDA device and without BENCH_DEVICE=cpu the program
    exits non-zero and prints no JSON line."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-m", "ovr_tpu_torch.bench"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr
