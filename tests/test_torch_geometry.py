"""Surfaces in the port (ovr_tpu_torch.render.geometry, the march's t_cap
and shear-warp's exit map) against the JAX package, on the CPU.

The same numpy scene (a 24^3 volume, a UV sphere that cuts it, with
vertex colours, uvs and a texture, an isosurface, a placed instance)
goes through the JAX package's functions and the port's. Tolerances:
mesh and isosurface hits 1e-5 in t and in the normal, surface colours
5e-5; frames rgba and normals 5e-5, depth 2e-4 (shear-warp frames
against JAX's XLA slice loop, which is what JAX runs on the CPU and the
only JAX loop that clamps the fan rays at the surface); under sw_bf16
the bound of tests/test_torch_render.py's XLA-loop comparison. The
port's own rule against its march is JAX's (tests/test_geometry.py:
121-147): the 95th percentile of the premultiplied difference over the
frame's interior < 0.06. Gradients (grid, TF alpha, mesh vertices)
within 2e-3 of the largest element of JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import uv_sphere
from ovr_tpu import api as japi
from ovr_tpu.core import scene as jsc
from ovr_tpu.render import geometry as jgeo
from ovr_tpu_torch import api
from ovr_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from ovr_tpu_torch.core import scene as tsc
from ovr_tpu_torch.ops import swslice
from ovr_tpu_torch.render import geometry as tgeo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(n=24, amp=0.45, phase=0.0):
    """A smooth test volume; `phase` > 0 leaves no face flat (on a flat
    face the shading normal is 0 and its gradient rounding noise)."""
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    return (0.5 + amp * np.sin(6 * x + phase) * np.cos(5 * y + phase)
            * np.sin(4 * z + 1.0)).astype(np.float32)


def _mesh_arrays(seed=0):
    verts, faces, uvs = uv_sphere(16, 8, (0.5, 0.5, 0.55), 0.3)
    rng = np.random.default_rng(seed)
    colors = (0.5 + 0.5 * rng.random(verts.shape)).astype(np.float32)
    tex = rng.random((8, 8, 3)).astype(np.float32)
    return verts, faces, uvs, colors, tex


XFM = np.array([[0.9, -0.2, 0.0, 0.1], [0.2, 0.9, 0.0, -0.05],
                [0.0, 0.0, 1.1, -0.05]], np.float32)


def _geometries(kinds):
    """JAX geometry instances: "mesh" (textured, vertex-coloured sphere),
    "iso" (the volume's isosurface at 0.7), "xfm" (the sphere, placed),
    "quad" (a backdrop inside the volume at z = 0.8, tests/test_geometry.
    py's), "quad_mid" (the same at z = 0.4)."""
    verts, faces, uvs, colors, tex = _mesh_arrays()
    mesh = jsc.TriangleMesh.create(verts, faces, colors=colors, uvs=uvs)
    out = []
    for k in kinds:
        if k == "mesh":
            out.append(jsc.GeometryInstance.create(mesh, jsc.Material.create(
                kd=(0.9, 0.8, 0.7), ks=(0.3, 0.3, 0.3), ns=20.0,
                map_kd=tex)))
        elif k == "iso":
            out.append(jsc.GeometryInstance.create(
                jsc.Isosurface.create([0.7, 0.9]),
                jsc.Material.create(kd=(0.2, 0.6, 0.9))))
        elif k == "xfm":
            out.append(jsc.GeometryInstance.create(mesh, jsc.Material.create(
                kd=(0.9, 0.3, 0.2), ks=(0.5, 0.5, 0.5), ns=8.0), xfm=XFM))
        elif k.startswith("quad"):
            z = 0.8 if k == "quad" else 0.4
            q = [[-3.0, -3.0, z], [3.0, -3.0, z], [3.0, 3.0, z],
                 [-3.0, 3.0, z]]
            out.append(jsc.GeometryInstance.create(
                jsc.TriangleMesh.create(q, [[0, 1, 2], [0, 2, 3]]),
                jsc.Material.create(kd=(1.0, 0.0, 0.0), ks=(0, 0, 0))))
    return tuple(out)


CAM = dict(from_=(0.5, 0.5, -1.8), at=(0.5, 0.5, 0.5), fovy=45.0)
ORTHO = dict(from_=(0.5, 0.5, -2.0), at=(0.5, 0.5, 0.5), height=1.4,
             kind="orthographic")


def _scenes(kinds=("mesh",), cam=CAM, grid=None):
    js = dataclasses.replace(
        jsc.simple_scene(_field() if grid is None else grid),
        camera=jsc.Camera.create(**cam), geometries=_geometries(kinds))
    return js, scene_from_arrays(arrays_from_scene(js), device="cpu")


def _rays(seed=1, n=300):
    """Rays from scattered origins toward the sphere's neighbourhood."""
    rng = np.random.default_rng(seed)
    org = rng.uniform(-0.5, 1.5, (n, 3)).astype(np.float32)
    org[:, 2] = rng.uniform(-2.0, -1.0, n)
    tgt = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    d = tgt - org
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return org, d


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_intersect_mesh_matches_jax(monkeypatch):
    """Hits, normals, colours and uvs; blocks of 32 triangles and of a
    few rays (the port's ray blocking) give JAX's unblocked result."""
    verts, faces, uvs, colors, _ = _mesh_arrays()
    jm = jsc.TriangleMesh.create(verts, faces, colors=colors, uvs=uvs)
    tm = tsc.TriangleMesh.create(verts, faces, colors=colors, uvs=uvs,
                                 device="cpu")
    org, d = _rays()
    want = jgeo.intersect_mesh(jnp.asarray(org), jnp.asarray(d), jm,
                               chunk=32)
    monkeypatch.setattr(tgeo, "RAY_BLOCK_ELEMS", 32 * 40)
    got = tgeo.intersect_mesh(_t(org), _t(d), tm, chunk=32)
    t_j, t_p = np.asarray(want[0]), got[0].numpy()
    hit = t_j < 1e30
    assert hit.sum() > 50 and (~hit).sum() > 20
    np.testing.assert_array_equal(t_p < 1e30, hit)
    np.testing.assert_allclose(t_p[hit], t_j[hit], atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_mesh_culling_and_blocks_keep_the_hits(monkeypatch):
    """Blocks of 16 triangles (most culled by their bounding boxes) and
    of 64 rays give the bits of one unculled block of every triangle,
    for rays from one broadcast origin and from scattered ones."""
    verts, faces, _, _, _ = _mesh_arrays()
    tris = torch.from_numpy(verts)[torch.from_numpy(faces)]
    org, d = _rays(7, n=500)
    eye = torch.tensor([0.45, 0.55, -1.8])
    tgt = np.random.default_rng(8).uniform((0.15, 0.15, 0.2),
                                            (0.85, 0.85, 0.9), (500, 3))
    d_eye = torch.from_numpy(tgt.astype(np.float32)) - eye
    d_eye = d_eye / d_eye.norm(dim=1, keepdim=True)
    for o, dd in ((_t(org), _t(d)), (eye.expand(500, 3), d_eye)):
        monkeypatch.setattr(tgeo, "RAY_BLOCK_ELEMS", 1 << 24)
        t1, j1 = tgeo._nearest_triangle(o, dd, tris, tris.shape[0])
        monkeypatch.setattr(tgeo, "RAY_BLOCK_ELEMS", 64 * 16)
        t2, j2 = tgeo._nearest_triangle(o, dd, tris, 16)
        assert int((t1 < 1e30).sum()) > 50
        assert torch.equal(t1, t2) and torch.equal(j1, j2)


def test_sample_texture_matches_jax():
    rng = np.random.default_rng(2)
    tex = rng.random((5, 7, 3)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (200, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.sample_texture(_t(tex), _t(uv)).numpy(),
        np.asarray(jgeo.sample_texture(jnp.asarray(tex), jnp.asarray(uv))),
        atol=1e-6)


def test_intersect_isosurface_matches_jax():
    js, ts = _scenes(("iso",))
    org, d = _rays(3)
    jv, tv = js.volume, ts.volume
    iso_j, iso_t = js.geometries[0].geometry, ts.geometries[0].geometry
    tj, nj = jgeo.intersect_isosurface(
        jv.grid, js.tfn.value_range, jv.world_lo, jv.world_hi,
        jnp.asarray(org), jnp.asarray(d), iso_j, 64)
    tp, npn = tgeo.intersect_isosurface(
        tv.grid, ts.tfn.value_range, tv.world_lo, tv.world_hi, _t(org),
        _t(d), iso_t, 64)
    tj, nj = np.asarray(tj), np.asarray(nj)
    hit = tj < 1e30
    assert hit.sum() > 50
    np.testing.assert_array_equal(tp.numpy() < 1e30, hit)
    np.testing.assert_allclose(tp.numpy()[hit], tj[hit], atol=1e-5)
    np.testing.assert_allclose(npn.numpy(), nj, atol=1e-5)


def test_shade_phong_matches_jax():
    rng = np.random.default_rng(4)
    nrm = rng.normal(size=(64, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    view = rng.normal(size=(64, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    base = rng.random((64, 3)).astype(np.float32)
    ldir = np.array([0.3, 0.8, -0.5], np.float32)
    ldir /= np.linalg.norm(ldir)
    kw = dict(kd=(0.7, 0.5, 0.3), ks=(0.4, 0.4, 0.4), ns=12.0)
    lkw = dict(direction=ldir, color=(1.0, 0.9, 0.8), ambient=0.3)
    want = jgeo.shade_phong(jsc.Material.create(**kw), jnp.asarray(base),
                            jnp.asarray(nrm), jsc.Light.create(**lkw),
                            jnp.asarray(ldir), jnp.asarray(view))
    got = tgeo.shade_phong(tsc.Material.create(**kw, device="cpu"),
                           _t(base), _t(nrm),
                           tsc.Light.create(**lkw, device="cpu"), _t(ldir),
                           _t(view))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_render_geometries_matches_jax():
    """A textured mesh, an isosurface and a placed instance: the nearest
    hit's shaded colour, opacity and t."""
    js, ts = _scenes(("mesh", "iso", "xfm"))
    org, d = _rays(5)
    want = jgeo.render_geometries(js, jnp.asarray(org), jnp.asarray(d),
                                  iso_steps=64, chunk=64)
    got = tgeo.render_geometries(ts, _t(org), _t(d), iso_steps=64, chunk=64)
    assert float(got[1].sum()) > 50
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5)
    tj = np.asarray(want[2])
    np.testing.assert_allclose(got[2].numpy()[tj < 1e30], tj[tj < 1e30],
                               atol=1e-5)


def _frames(js, ts, **kw):
    kw = dict(dict(width=48, height=40, sampling_rate=32.0), **kw)
    jc = japi.RenderConfig(**kw).resolved(js)
    tc = api.RenderConfig(**kw).resolved(ts)
    jkw, tkw = {}, {}
    if kw.get("shading") == "shadow":
        lg = japi.build_light_grid(js, jc)
        jkw["light_grid"], tkw["light_grid"] = lg, _t(lg)
    before = swslice.LAUNCHES
    tf = api.render(ts, tc, **tkw)
    assert swslice.LAUNCHES == before  # CPU tensors: the plain version
    return japi.render(js, jc, **jkw), tf, tc


def _close(jf, tf, rgba=5e-5, depth=2e-4):
    np.testing.assert_allclose(tf.rgba.numpy(), np.asarray(jf.rgba),
                               atol=rgba)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf.grad),
                               atol=rgba)
    np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth),
                               atol=depth)


@pytest.mark.parametrize("shading,kinds", [
    ("diffuse", ("mesh", "iso")), ("none", ("xfm",)),
    ("shadow", ("mesh",))])
def test_march_with_geometry_matches_jax(shading, kinds):
    """The march capped at the surface (t_cap) and the surface blended
    behind the volume in colour, depth and alpha."""
    js, ts = _scenes(kinds)
    jf, tf, tc = _frames(js, ts, shading=shading, method="march")
    assert tc.sw is None
    _close(jf, tf)
    assert float(tf.rgba[..., 3].max()) == 1.0  # an opaque surface


# (camera, shading, geometries, extra config)
SW_CASES = [
    (CAM, "none", ("mesh",), {}),
    (CAM, "diffuse", ("mesh", "iso"), {}),
    (ORTHO, "diffuse", ("xfm",), {}),
    (CAM, "shadow", ("mesh",), {}),
    (CAM, "diffuse", ("mesh",), {"sw_term": False}),
]


@pytest.mark.parametrize("cam,shading,kinds,extra", SW_CASES,
                         ids=["none", "diffuse", "ortho-xfm", "shadow",
                              "no-term"])
def test_shearwarp_with_geometry_matches_jax(cam, shading, kinds, extra):
    """Shear-warp frames with surfaces against JAX's XLA slice loop: the
    fan rays clamped at the surface through the exit map, the surface
    composited behind the volume before the warp."""
    js, ts = _scenes(kinds, cam=cam)
    jf, tf, tc = _frames(js, ts, shading=shading, method="shearwarp",
                         **extra)
    assert tc.sw is not None
    _close(jf, tf)
    assert float(tf.rgba[..., 3].max()) > 0.99


def test_shearwarp_with_geometry_bf16_against_jax_xla_loop():
    """sw_bf16 with a surface against JAX's XLA loop under sw_bf16 (the
    only JAX loop with the clamp), at the bound of
    tests/test_torch_render.py's test_bf16_render_against_jax_xla_loop
    (JAX's own two loops differ by as much)."""
    js, ts = _scenes(("mesh",))
    jf, tf, tc = _frames(js, ts, shading="diffuse", method="shearwarp",
                         sw_bf16=True, sw_term=False)
    assert tc.sw.bf16
    d = [np.abs(tf.rgba.numpy() - np.asarray(jf.rgba)),
         np.abs(tf.grad.numpy() - np.asarray(jf.grad)),
         np.abs(tf.depth.numpy() - np.asarray(jf.depth))]
    assert float(d[0].max()) <= 5e-2 and float(d[0].mean()) <= 1e-3
    assert float(d[1].max()) <= 1e-2
    assert float(d[2].max()) <= 3e-2 and float(d[2].mean()) <= 4e-3


def _premul(frame):
    r = frame.rgba.detach().numpy()
    return r[..., :3] * r[..., 3:4]


@pytest.mark.parametrize("quad,clamped", [("quad", True),
                                          ("quad_mid", True),
                                          ("quad_mid", False)],
                         ids=["exit-map", "exit-map-mid", "no-exit-map"])
def test_shearwarp_geometry_against_march(monkeypatch, quad, clamped):
    """The port's shear-warp frame against its own march (the scene and
    rule of tests/test_geometry.py:121-147: a backdrop inside the volume,
    p95 over the interior < 0.06). Without the exit map the slice loop
    composites the volume behind the backdrop; with the backdrop at
    z = 0.4 the rule rejects that (at JAX's z = 0.8 only a fifth of the
    volume lies behind it, and p95 is 0.055 unclamped)."""
    _, ts = _scenes((quad,), cam=dict(from_=(0.5, 0.5, -1.5),
                                        at=(0.5, 0.5, 0.5), fovy=60.0),
                    grid=_field(amp=0.5))
    cfg_m = api.RenderConfig(width=48, height=40, sampling_rate=48.0,
                             shading="none").resolved(ts)
    cfg_s = dataclasses.replace(cfg_m, method="shearwarp").resolved(ts)
    if not clamped:
        orig = swslice.slice_composite
        monkeypatch.setattr(swslice, "slice_composite", lambda *a, **k: orig(
            *a, **dict(k, exit_map=None)))
    err = np.abs(_premul(api.render(ts, cfg_m))
                 - _premul(api.render(ts, cfg_s))).max(-1)[3:-3, 3:-3]
    p95 = float(np.quantile(err, 0.95))
    assert (p95 < 0.06) == clamped, p95


def _bench_field(n):
    """chip_smoke.py's bench field, in numpy."""
    ax = np.linspace(0, 1, n, dtype=np.float32)
    x, y, z = ax[None, None, :], ax[None, :, None], ax[:, None, None]
    g = 0.5 + 0.35 * np.sin(12 * x) * np.cos(10 * y) * np.sin(8 * z)
    return (g + 0.15 * np.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2
                                + (z - 0.5) ** 2) * 40)).astype(np.float32)


def test_isosurface_march_gap_is_the_references():
    """chip_smoke.py's isosurface case (the bench field at 0.5), cut to
    48^3 and a 96x54 probe: shear-warp and the march intersect the
    folded surface on different rays, and its one-voxel FD normals shade
    the hits apart, so the two paths differ well beyond 0.06 at the 95th
    percentile over the surface's interior, in the JAX package as in the
    port; the port's 95th percentile is the JAX package's within 1e-3
    (a few hits at the folds, where the bracketing compares equal
    values, land a bracketing step apart: 23 of 5184 pixels differ by
    up to 1.9e-3)."""
    from scipy import ndimage

    js = dataclasses.replace(
        jsc.simple_scene(_bench_field(48)), camera=jsc.Camera.create(
            from_=(0.5, 0.5, -1.6), at=(0.5, 0.5, 0.5), fovy=45.0),
        geometries=(jsc.GeometryInstance.create(jsc.Isosurface.create(0.5)),))
    ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    err = []
    for mod, sc in ((japi, js), (api, ts)):
        out = {}
        for m in ("shearwarp", "march"):
            cfg = mod.RenderConfig(width=96, height=54, sampling_rate=96.0,
                                   shading="diffuse", method=m).resolved(sc)
            f = np.asarray(mod.render(sc, cfg).rgba)
            out[m] = f[..., :3] * f[..., 3:]
        err.append(np.abs(out["march"] - out["shearwarp"]).max(-1))
    org, d = _rays_of(ts, 96, 54)
    hit = (tgeo.render_geometries(ts, org, d)[1] > 0).numpy().reshape(54, 96)
    inner = ndimage.binary_erosion(hit, np.ones((7, 7)), border_value=0)
    inner[:3], inner[-3:], inner[:, :3], inner[:, -3:] = (False,) * 4
    p95 = [float(np.quantile(e[inner], 0.95)) for e in err]
    assert inner.sum() > 300 and p95[0] > 0.06, p95
    assert abs(p95[1] - p95[0]) <= 1e-3, p95


def _rays_of(scene, w, h):
    from ovr_tpu_torch.render.camera import generate_rays, pixel_screen_coords
    return generate_rays(scene.camera, pixel_screen_coords(
        w, h, torch.float32, "cpu").reshape(-1, 2), w, h)


def _grads_jax(js, cfg_kw):
    cfg = japi.RenderConfig(**cfg_kw).resolved(js)
    mesh = js.geometries[0].geometry

    def loss(grid, alpha, verts):
        g0 = js.geometries[0]
        geo = dataclasses.replace(g0, geometry=dataclasses.replace(
            mesh, verts=verts))
        s = dataclasses.replace(
            js, volume=dataclasses.replace(js.volume, grid=grid),
            tfn=dataclasses.replace(js.tfn, alpha=alpha),
            geometries=(geo,) + js.geometries[1:])
        f = japi.render(s, cfg)
        return jnp.mean(f.rgba ** 2) + jnp.mean(f.grad ** 2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        js.volume.grid, js.tfn.alpha, mesh.verts)]


def _loss_port(ts, cfg, grid, alpha, verts):
    g0 = ts.geometries[0]
    geo = dataclasses.replace(g0, geometry=dataclasses.replace(
        g0.geometry, verts=verts))
    s = dataclasses.replace(
        ts, volume=dataclasses.replace(ts.volume, grid=grid),
        tfn=dataclasses.replace(ts.tfn, alpha=alpha),
        geometries=(geo,) + ts.geometries[1:])
    f = api.render(s, cfg)
    return torch.mean(f.rgba ** 2) + torch.mean(f.grad ** 2)


def _grads_port(ts, cfg_kw):
    cfg = api.RenderConfig(**cfg_kw).resolved(ts)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (ts.volume.grid, ts.tfn.alpha,
                        ts.geometries[0].geometry.verts)]
    loss = _loss_port(ts, cfg, *leaves)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)], cfg


@pytest.mark.parametrize("method,shading", [("shearwarp", "none"),
                                            ("shearwarp", "diffuse"),
                                            ("march", "diffuse")])
def test_geometry_gradients_match_jax(method, shading):
    """Gradients of the grid, the TF alpha and the mesh vertices: through
    the exit map and the surface composite (shear-warp) or t_cap (the
    march). The field has no flat face."""
    js, ts = _scenes(("mesh",), grid=_field(phase=0.3))
    cfg_kw = dict(width=32, height=24, sampling_rate=24.0, shading=shading,
                  method=method)
    want = _grads_jax(js, cfg_kw)
    got, _ = _grads_port(ts, cfg_kw)
    for g, w in zip(got, want):
        scale = float(np.abs(w).max())
        assert scale > 0
        assert float(np.abs(g - w).max()) <= 2e-3 * scale


def test_vertex_gradient_against_central_difference():
    """The shear-warp frame's derivative along a random direction of the
    mesh vertices against a central difference of the forward."""
    _, ts = _scenes(("mesh",), grid=_field(phase=0.3))
    cfg_kw = dict(width=32, height=24, sampling_rate=24.0,
                  shading="diffuse", method="shearwarp")
    (_, _, g_v), cfg = _grads_port(ts, cfg_kw)
    verts = ts.geometries[0].geometry.verts.double()
    rng = np.random.default_rng(6)
    u = torch.from_numpy(rng.normal(size=verts.shape))
    u /= u.norm()
    eps = 1e-3

    def f(s):
        with torch.no_grad():
            return float(_loss_port(ts, cfg, ts.volume.grid, ts.tfn.alpha,
                                    (verts + s * eps * u).float()))

    fd = (f(1.0) - f(-1.0)) / (2 * eps)
    ad = float((torch.from_numpy(g_v).double() * u).sum())
    assert abs(fd - ad) <= 2e-2 * max(abs(fd), 1e-4), (fd, ad)
