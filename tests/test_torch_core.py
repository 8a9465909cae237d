"""Core modules of the PyTorch port (ovr_tpu_torch) against the JAX package.

Sampling math, camera basis, finalize, macrocells, the swept shadow
lattice, the shear-warp plan and scene conversion are fed the same numpy
inputs in both packages. Also the port's own contract: it never imports
JAX or `ovr_tpu`, its entry points default to the card, and features
that raised NotImplementedError until they were ported render and match
the JAX package (neural fields: tests/test_torch_neural.py).
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu.core import sampling as jsamp
from ovr_tpu.core.scene import Camera as JCamera
from ovr_tpu.core.scene import Light as JLight
from ovr_tpu.core.scene import simple_scene as jsimple
from ovr_tpu import api as japi
from ovr_tpu.render import accel as jaccel
from ovr_tpu.render import camera as jcamera
from ovr_tpu.render import integrator as jig
from ovr_tpu.render import lightgrid as jlg
from ovr_tpu_torch import api
from ovr_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from ovr_tpu_torch.core import sampling
from ovr_tpu_torch.core.scene import (Camera, StructuredVolume,
                                      simple_scene)
from ovr_tpu_torch.ops import swslice
from ovr_tpu_torch.render import accel, camera, integrator, lightgrid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and a torch thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(b.numpy() if isinstance(
        b, torch.Tensor) else b), np.asarray(a), atol=atol, rtol=rtol)


def smooth_grid(n=24, shape=None):
    z, y, x = np.meshgrid(*[np.linspace(0, 1, d, dtype=np.float32)
                            for d in (shape or (n, n, n))], indexing="ij")
    return (0.5 + 0.45 * np.sin(6 * x) * np.cos(5 * y)
            * np.sin(4 * z + 1.0)).astype(np.float32)


def test_sampling_functions_match(rng):
    smp = rng.uniform(-0.2, 1.2, (64,)).astype(np.float32)
    vr = np.array([0.1, 0.9], np.float32)
    color = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (12,)).astype(np.float32)
    close(jsamp.normalize_value(smp, vr), sampling.normalize_value(
        t(smp), t(vr)), 1e-7)
    for a, b in zip(jsamp.classify(color, alpha, vr, smp),
                    sampling.classify(t(color), t(alpha), t(vr), t(smp))):
        close(a, b, 1e-6)
    a_in = np.concatenate([rng.uniform(0, 1, 60), [0.0, 1.0, 0.5, 1.0]]
                          ).astype(np.float32)
    step = np.concatenate([rng.uniform(0, 2, 60), [1.0, 1.0, 1e-9, 0.0]]
                          ).astype(np.float32)
    base = np.float32(1.0)
    close(jsamp.opacity_correction(a_in, base, step),
          sampling.opacity_correction(t(a_in), t(base), t(step)), 1e-6)
    v = np.concatenate([rng.normal(size=(8, 3)), np.zeros((1, 3))]
                       ).astype(np.float32)
    # rsqrt rounds differently in XLA and torch: 2 ulp of 1.0
    close(jsamp.safe_normalize(v), sampling.safe_normalize(t(v)), 2.4e-7)
    for dt_j, dt_t in [(jnp.uint8, torch.uint8), (jnp.uint16, torch.uint16),
                       (jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)]:
        assert jsamp.storage_scale(dt_j) == sampling.storage_scale(dt_t)


def test_intersect_box_degenerate_directions(rng):
    """Axis-parallel and near-parallel rays (|d| < 1e-12 on an axis),
    origins inside and outside that slab."""
    n = 96
    org = rng.uniform(-0.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:16, 0] = 0.0
    d[16:32, 1] = 1e-13
    d[32:40, :2] = 0.0
    d[40:44] = 0.0
    lo = np.zeros(3, np.float32)
    hi = np.array([1.0, 0.8, 1.2], np.float32)
    t0 = np.zeros(n, np.float32)
    t1 = np.full(n, 3.4e38, np.float32)
    ja = jsamp.intersect_box(org, d, lo, hi, t0, t1)
    ta = sampling.intersect_box(t(org), t(d), t(lo), t(hi), t(t0), t(t1))
    for a, b in zip(ja, ta):
        close(a, b, 1e-5, rtol=1e-6)


@pytest.mark.parametrize("kind", ["perspective", "orthographic"])
def test_camera_basis_matches(kind):
    kw = dict(from_=(0.3, 1.2, -1.7), at=(0.5, 0.4, 0.6), up=(0.1, 1.0, 0.0),
              fovy=37.0, height=1.4, kind=kind)
    jb = jcamera.camera_basis(JCamera.create(**kw), 96, 54)
    tb = camera.camera_basis(Camera.create(**kw, device="cpu"), 96, 54)
    for a, b in zip(jb, tb):
        close(a, b, 1e-6)
    close(jcamera.pixel_screen_coords(7, 5),
          camera.pixel_screen_coords(7, 5, device="cpu"), 0.0)


def test_finalize_matches(rng):
    n = 50
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    grad = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    depth = rng.uniform(0, 3, (n,)).astype(np.float32)
    alpha = rng.uniform(0, 1, (n,)).astype(np.float32)
    alpha[:10] = 0.0
    alpha[10:12] = 1e-13
    for a, b in zip(jig.finalize(color, grad, depth, alpha),
                    integrator.finalize(t(color), t(grad), t(depth),
                                        t(alpha))):
        close(a, b, 1e-7)


@pytest.mark.parametrize("dtype", ["f32", "u8", "u16"])
def test_build_macrocells_matches(dtype):
    g = smooth_grid(shape=(40, 36, 50))
    if dtype == "u8":
        g = np.clip(np.round(g * 255), 0, 255).astype(np.uint8)
    elif dtype == "u16":
        g = np.clip(np.round(g * 65535), 0, 65535).astype(np.uint16)
    alpha = np.concatenate([np.zeros(24), np.linspace(0, 1, 8)]
                           ).astype(np.float32)
    vr = np.array([0.2, 0.85], np.float32)
    jm = jaccel.build_macrocells(jnp.asarray(g), jnp.asarray(alpha),
                                 jnp.asarray(vr))
    tm = accel.build_macrocells(t(g), t(alpha), t(vr))
    assert tm.vol_dims == jm.vol_dims and tm.mc_dims == jm.mc_dims
    for f in ("value_lo", "value_hi", "majorant"):
        close(getattr(jm, f), getattr(tm, f), 1e-7)
    assert 0 < float((tm.majorant > 1.19e-7).float().mean()) < 1


@pytest.mark.parametrize("direction,dtype", [
    ((-907.108, 2205.875, -400.0267), "f32"),
    ((0.9, 0.2, -0.3), "f32"),
    ((0.1, -0.3, -1.0), "u8"),
    ((-0.2, 0.1, 0.95), "f32"),
    ((0.6, 0.5, 0.4), "u16"),
])
def test_light_grid_swept_matches(direction, dtype):
    g = smooth_grid(shape=(20, 24, 28))
    if dtype == "u8":
        g = np.clip(np.round(g * 255), 0, 255).astype(np.uint8)
    elif dtype == "u16":
        g = np.clip(np.round(g * 65535), 0, 65535).astype(np.uint16)
    color = np.stack([np.linspace(0, 1, 16), 0.5 * np.ones(16),
                      np.linspace(1, 0, 16)], -1).astype(np.float32)
    alpha = np.linspace(0.0, 1.0, 16).astype(np.float32)
    vr = np.array([0.05, 0.95], np.float32)
    base = np.float32(1.0)
    lo = np.array([0.0, -0.5, 0.2], np.float32)
    hi = np.array([1.0, 0.7, 1.4], np.float32)
    ld = jsamp.safe_normalize(jnp.asarray(direction, jnp.float32))
    res = (16, 12, 20)
    ja = jlg.build_light_grid_swept(
        (jnp.asarray(g), jnp.asarray(color), jnp.asarray(alpha),
         jnp.asarray(vr), jnp.asarray(base)), ld, lo, hi, None, res)
    ta = lightgrid.build_light_grid_swept(
        (t(g), t(color), t(alpha), t(vr), t(base)), t(np.asarray(ld)),
        t(lo), t(hi), res)
    close(ja, ta, 1e-5)


def test_api_build_light_grid_matches():
    js = jsimple(smooth_grid(24))
    ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    jc = japi.RenderConfig(width=16, height=16, sampling_rate=16.0,
                           shading="shadow").resolved(js)
    tc = api.RenderConfig(width=16, height=16, sampling_rate=16.0,
                          shading="shadow").resolved(ts)
    close(japi.build_light_grid(js, jc), api.build_light_grid(ts, tc), 1e-5)


PLAN_CAMERAS = {
    "persp": dict(from_=(0.5, 0.5, -1.8), at=(0.5, 0.5, 0.5), fovy=45.0),
    "ortho": dict(from_=(0.5, 0.5, -2.0), at=(0.5, 0.5, 0.5), height=1.4,
                  kind="orthographic"),
    "rolled": dict(from_=(0.5, 0.5, -1.8), at=(0.5, 0.5, 0.5),
                   up=(1.0, 0.0, 0.0), fovy=45.0),
    "oblique": dict(from_=(1.2, 1.1, -1.5), at=(0.5, 0.5, 0.5), fovy=40.0),
    "x_neg": dict(from_=(2.3, 0.5, 0.5), at=(0.5, 0.5, 0.5), fovy=45.0),
    "y_up": dict(from_=(0.5, 2.3, 0.5), at=(0.5, 0.5, 0.5), up=(0, 0, 1),
                 fovy=45.0),
    "inside": dict(from_=(0.45, 0.4, 0.25), at=(0.7, 0.3, 0.9), fovy=40.0),
    "wide_inside": dict(from_=(0.5, 0.5, 0.5), at=(0.5, 0.5, 1.5),
                        fovy=150.0),
}


@pytest.mark.parametrize("cam", sorted(PLAN_CAMERAS))
def test_resolve_static_matches(cam):
    js = dataclasses.replace(jsimple(smooth_grid(24)),
                             camera=JCamera.create(**PLAN_CAMERAS[cam]))
    ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    kw = dict(width=64, height=48, sampling_rate=40.0, shading="diffuse",
              method="auto")
    jp = japi.RenderConfig(**kw).resolved(js).sw
    tp = api.RenderConfig(**kw).resolved(ts).sw
    if jp is None:
        assert tp is None
        return
    for f in ("axis", "sign", "n_slices", "inter_h", "inter_w", "swap",
              "separable", "row_chunk", "term", "fd_grad", "slice0_static"):
        assert getattr(tp, f) == getattr(jp, f), f


def test_common_rgba_table_matches(rng):
    from ovr_tpu.render import shearwarp as jsw
    from ovr_tpu_torch.render import shearwarp
    color = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    for na in (16, 37):
        alpha = rng.uniform(0, 1, (na,)).astype(np.float32)
        close(jsw._common_rgba_table(color, alpha),
              shearwarp._common_rgba_table(t(color), t(alpha)), 1e-6)


@pytest.mark.parametrize("dtype", ["u8", "u16", "bf16", "f32"])
def test_scene_conversion_and_data_range(dtype):
    g = smooth_grid(16)
    if dtype == "u8":
        raw = np.clip(np.round(g * 255), 0, 255).astype(np.uint8)
    elif dtype == "u16":
        raw = np.clip(np.round(g * 65535), 0, 65535).astype(np.uint16)
    elif dtype == "bf16":
        raw = jnp.asarray(g).astype(jnp.bfloat16)
    else:
        raw = g
    js = dataclasses.replace(jsimple(raw), lights=(
        JLight.create(direction=(0.3, 0.1, -1.0), intensity=0.7),))
    ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    assert str(ts.volume.grid.dtype).endswith(
        {"u8": "uint8", "u16": "uint16", "bf16": "bfloat16",
         "f32": "float32"}[dtype])
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(js.volume.grid, jnp.float32)),
        ts.volume.grid.float().numpy())
    # StructuredVolume.create applies the same data_range rule
    direct = (torch.from_numpy(np.asarray(raw.astype(jnp.float32))).to(
        torch.bfloat16) if dtype == "bf16" else raw)
    vol = StructuredVolume.create(direct, device="cpu")
    close(js.volume.data_range, vol.data_range, 1e-7)
    close(js.tfn.value_range, ts.tfn.value_range, 0.0)
    assert len(ts.lights) == 1 and ts.lights[0].kind == "directional"
    close(js.lights[0].intensity, ts.lights[0].intensity, 0.0)


def test_port_never_imports_jax():
    """No module of the port imports jax or ovr_tpu: checked in a fresh
    interpreter through sys.modules, and by a scan of the sources."""
    mods = ["ovr_tpu_torch." + os.path.splitext(os.path.relpath(
        os.path.join(d, f), os.path.join(REPO, "ovr_tpu_torch")))[0]
        .replace(os.sep, ".")
        for d, _, fs in os.walk(os.path.join(REPO, "ovr_tpu_torch"))
        for f in fs if f.endswith(".py") and f != "__init__.py"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ovr_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ovr_tpu)\b", re.M)
    files = [os.path.join(d, f)
             for d, _, fs in os.walk(os.path.join(REPO, "ovr_tpu_torch"))
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    for path in files:
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device would work")
    with pytest.raises((RuntimeError, AssertionError)):
        simple_scene(smooth_grid(8))
    with pytest.raises((RuntimeError, AssertionError)):
        Camera.create(from_=(0, 0, -2), at=(0.5, 0.5, 0.5))


def _tiny_scene(**kw):
    scene = simple_scene(smooth_grid(16), device="cpu")
    return dataclasses.replace(scene, **kw)


@pytest.mark.parametrize("what", ["point_light", "five_lights", "sw_bf16"])
def test_former_raises_render_and_match_jax(what):
    """Shear-warp frames that raised NotImplementedError until the light
    table and the kernel's bf16 variant were ported: a point light and
    five extra directional lights (more than the JAX kernel's 4 slots),
    and sw_bf16. They render through `method="auto"` (on the CPU the
    plain version, no launch) and match the JAX package: the light rigs
    its XLA loop (the only loop that runs them there) at 5e-5 (rgba and
    normals) and 2e-4 (depth), sw_bf16 its kernel forward in interpret
    mode at tests/test_torch_render.py's bf16 bound."""
    from tests.test_torch_render import _forced, assert_bf16_frames_close
    js = dataclasses.replace(jsimple(smooth_grid(16)), camera=JCamera.create(
        from_=(0.5, 0.45, -1.8), at=(0.5, 0.5, 0.5), fovy=45.0))
    kw = dict(width=16, height=16, sampling_rate=8.0, shading="diffuse",
              method="auto", sw_term=False)
    if what == "point_light":
        js = dataclasses.replace(js, lights=(JLight.create(
            kind="point", position=(0.5, 1.8, 0.5), intensity=1.2),))
    elif what == "five_lights":
        js = dataclasses.replace(js, lights=tuple(
            JLight.create(direction=(0.1 * i, 0.3, -1.0)) for i in range(5)))
    else:
        kw["sw_bf16"] = True
    ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    tc = api.RenderConfig(**kw).resolved(ts)
    jc = japi.RenderConfig(**kw).resolved(js)
    assert tc.sw is not None and jc.sw is not None
    before = swslice.LAUNCHES
    tf = api.render(ts, tc)
    assert swslice.LAUNCHES == before
    assert float(tf.rgba[..., 3].max()) > 0.1
    if what == "sw_bf16":
        assert_bf16_frames_close(tf, japi.render(js, _forced(jc)))
        return
    jf = japi.render(js, jc)
    for name, tol in (("rgba", 5e-5), ("grad", 5e-5), ("depth", 2e-4)):
        np.testing.assert_allclose(getattr(tf, name).numpy(),
                                   np.asarray(getattr(jf, name)), atol=tol)


@pytest.mark.parametrize("what", ["instances", "sparse_sampling", "focus",
                                  "geometry"])
def test_surfaces_instances_sparse_render_and_match_jax(what):
    """Features that raised NotImplementedError until they were ported:
    volume instances and surfaces through `api.render` (method="auto":
    a plan per volume; shear-warp with the exit map), sparse sampling and
    its focus through `Renderer`. They render on the CPU and match the
    JAX package: rgba and normals 5e-5, depth 2e-4."""
    from tests.test_torch_geometry import _geometries
    from tests.test_torch_multivol import _scenes as mv_scenes
    kw = dict(width=16, height=16, sampling_rate=8.0, shading="diffuse",
              method="auto")
    if what == "instances":
        js, ts = mv_scenes()
    else:
        js = dataclasses.replace(jsimple(smooth_grid(16)),
                                 camera=JCamera.create(
                                     from_=(0.5, 0.45, -1.8),
                                     at=(0.5, 0.5, 0.5), fovy=45.0))
        if what == "geometry":
            js = dataclasses.replace(js, geometries=_geometries(("mesh",)))
        ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    if what in ("sparse_sampling", "focus"):
        kw["method"] = "march"
        jr, tr = japi.Renderer(js, japi.RenderConfig(**kw)), api.Renderer(
            ts, api.RenderConfig(**kw))
        for r in (jr, tr):
            r.set_sparse_sampling(True)
            if what == "focus":
                r.set_focus((0.3, 0.6), 0.1, 0.05)
            r.render()
        jf, tf = jr.mapframe(), tr.mapframe()
        assert 0 < (tf["rgba"][..., 3] > 0).mean() < 0.5
    else:
        tc = api.RenderConfig(**kw).resolved(ts)
        assert tc.sw is not None
        jf = japi.render(js, japi.RenderConfig(**kw).resolved(js))
        tf = api.render(ts, tc)
        jf, tf = ({k: np.asarray(getattr(f, k)) for k in
                   ("rgba", "grad", "depth")} for f in (jf, tf))
    for name, tol in (("rgba", 5e-5), ("grad", 5e-5), ("depth", 2e-4)):
        np.testing.assert_allclose(tf[name], jf[name], atol=tol)
    assert float(tf["rgba"][..., 3].max()) > 0.1


def test_convert_carries_geometries_and_instances():
    """A JAX scene with a textured mesh, an isosurface, a placed geometry
    instance and a placed volume instance crosses over through
    `convert` and renders (march and shear-warp) the bits of the same
    scene built with the port's constructors from the same arrays."""
    from ovr_tpu.core import scene as jsc
    from ovr_tpu_torch.core import scene as tsc
    from tests.test_torch_geometry import XFM, _mesh_arrays
    from tests.test_torch_multivol import XFM as VXFM
    verts, faces, uvs, colors, tex = _mesh_arrays()
    grid, grid2 = smooth_grid(16), smooth_grid(8)
    mat = dict(kd=(0.9, 0.8, 0.7), ks=(0.3, 0.3, 0.3), ns=20.0, map_kd=tex)
    iso = dict(kd=(0.2, 0.6, 0.9))
    cam = dict(from_=(0.9, 0.5, -1.9), at=(0.9, 0.5, 0.5), fovy=50.0)
    box = dict(world_lo=(1.1, 0.0, 0.0), world_hi=(2.1, 1.0, 1.0))

    def build(m, dev):
        d = {} if dev is None else {"device": dev}
        mesh = m.TriangleMesh.create(verts, faces, colors=colors, uvs=uvs,
                                     **d)
        vol2 = m.StructuredVolume.create(grid2, **box, **d)
        tfn2 = m.TransferFunction.create(
            np.full((4, 3), 0.5, np.float32), np.linspace(0, 0.6, 4),
            (0.0, 1.0), **d)
        scene = m.simple_scene(grid, **d)
        return dataclasses.replace(
            scene, camera=m.Camera.create(**cam, **d), geometries=(
                m.GeometryInstance.create(mesh, m.Material.create(**mat, **d),
                                          xfm=XFM, **d),
                m.GeometryInstance.create(m.Isosurface.create(0.8, **d),
                                          m.Material.create(**iso, **d),
                                          **d)),
            instances=(m.VolumeInstance.create(vol2, tfn2, xfm=VXFM),))

    ts = scene_from_arrays(arrays_from_scene(build(jsc, None)), device="cpu")
    direct = build(tsc, "cpu")
    for method in ("march", "auto"):
        kw = dict(width=24, height=16, sampling_rate=12.0, shading="diffuse",
                  method=method)
        frames = [api.render(s, api.RenderConfig(**kw).resolved(s))
                  for s in (ts, direct)]
        for k in ("rgba", "grad", "depth"):
            assert torch.equal(getattr(frames[0], k), getattr(frames[1], k))
        assert float(frames[0].rgba[..., 3].max()) > 0.5


def test_cpu_render_never_launches():
    scene = _tiny_scene()
    cfg = api.RenderConfig(width=16, height=16, sampling_rate=8.0,
                           shading="diffuse", method="shearwarp"
                           ).resolved(scene)
    before = swslice.LAUNCHES
    frame = api.render(scene, cfg)
    assert swslice.LAUNCHES == before
    assert torch.isfinite(frame.rgba).all()
