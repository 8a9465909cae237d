"""The path tracers in the port (ovr_tpu_torch.render.pathtracer and
ptdense, the `pt_fields` gather in shearwarp, and their dispatch in api)
against the JAX package, on the CPU.

The Monte-Carlo tracker is held against JAX's with JAX's own threefry
draws replayed into the port (`JaxDraws`: the same `fold_in` chain of
keys, so every ray draws the same numbers at the same step): hit and
albedo equal and t within 1e-5 on at least 99.5% of rays, rgba within
1e-4 on at least 99.5% of pixels (the rest would be acceptance ties,
counted; none so far). Its statistics on the port's own generator are
held to the JAX suite's analytic checks (tests/test_pathtracer.py).
The dense solver's lattices, sweeps and scatter solution within 1e-5 of
their largest element, its frames within rgba 5e-5 and depth 2e-4 (and
under sw_bf16 by tests/test_torch_swslice.py's tie rule), its
gradients within 2e-3 of the largest element of `jax.grad`'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu import api as japi
from ovr_tpu.core import scene as jsc
from ovr_tpu.render import accel as jaccel
from ovr_tpu.render import pathtracer as jpt
from ovr_tpu.render import ptdense as jpd
from ovr_tpu_torch import api
from ovr_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from ovr_tpu_torch.core.sampling import intersect_box
from ovr_tpu_torch.core.scene import (Camera, Scene, StructuredVolume,
                                      TransferFunction)
from ovr_tpu_torch.ops import swslice
from ovr_tpu_torch.render import accel, pathtracer, ptdense
from ovr_tpu_torch.render.camera import generate_rays, pixel_screen_coords


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxDraws(pathtracer.Draws):
    """JAX's threefry draws replayed: `fold_in` folds the JAX key,
    `uniform` is `jax.random.uniform` of the key, as a CPU tensor."""

    def __init__(self, key):
        self.key = key

    def fold_in(self, i):
        return JaxDraws(jax.random.fold_in(self.key, i))

    def uniform(self, shape, dtype=torch.float32, device=None):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.key, shape, jnp.float32)))


def _field(n, phase=0.3):
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    return (0.5 + 0.45 * np.sin(5 * x + phase) * np.cos(4 * y + phase)
            * np.sin(3 * z + 1.0)).astype(np.float32)


CAMS = {"persp": dict(from_=(0.5, 0.55, -1.8), at=(0.5, 0.5, 0.5),
                      fovy=40.0),
        "ortho": dict(from_=(-1.5, 0.4, 0.45), at=(0.5, 0.5, 0.5),
                      kind="orthographic", height=1.3)}


def _scenes(n=16, cam="persp", density=2.0, u8=False, ambient=1.0):
    """The same scene in both packages: a smooth field (u8: quantized to
    uint8), an 8-node TF, density scale `density`."""
    g = _field(n)
    if u8:
        g = np.round(g * 255).astype(np.uint8)
    color = np.stack([np.linspace(0.2, 1.0, 8), np.full(8, 0.6),
                      np.linspace(1.0, 0.2, 8)], -1).astype(np.float32)
    vol = jsc.StructuredVolume.create(g)
    tfn = jsc.TransferFunction.create(
        color, (np.linspace(0, 1, 8) ** 1.5).astype(np.float32),
        (0.0, 1.0))
    js = jsc.Scene.create(vol, tfn, camera=jsc.Camera.create(**CAMS[cam]),
                          light=jsc.Light.create(ambient=ambient),
                          density_scale=density)
    return js, scene_from_arrays(arrays_from_scene(js), device="cpu")


def _leaves(scene):
    return (scene.volume.grid, scene.tfn.color, scene.tfn.alpha,
            scene.tfn.value_range, scene.density_scale)


def _rays(ts, w=16, h=12):
    """Camera rays of the port's scene and their box interval."""
    screen = pixel_screen_coords(w, h, torch.float32, "cpu").reshape(-1, 2)
    org, d = generate_rays(ts.camera, screen, w, h)
    t0 = torch.zeros(org.shape[0])
    t0, t1 = intersect_box(org, d, ts.volume.world_lo, ts.volume.world_hi,
                           t0, torch.full_like(t0, 3.4e38))
    return org, d, torch.clamp(t0, min=0.0), t1


def _j(x):
    return jnp.asarray(x.numpy())


def _agree(ours, theirs, frac=0.995):
    """Tracker results (hit, t, albedo): equal hit and albedo and t within
    1e-5 on at least `frac` of the rays. Returns the share."""
    hit, t, alb = (x.numpy() for x in ours)
    jhit, jt, jalb = (np.asarray(x) for x in theirs)
    same = ((hit == jhit) & (np.abs(alb - jalb).max(-1) <= 1e-6)
            & ((np.abs(t - jt) <= 1e-5) | ~jhit))
    assert same.mean() >= frac, same.mean()
    return same.mean()


def _frames_agree(tf, jf, frac=0.995, tol=1e-4):
    d = np.abs(tf.rgba.numpy() - np.asarray(jf.rgba)).max(-1)
    assert (d <= tol).mean() >= frac, (d > tol).mean()


# ---- the Monte-Carlo tracker ---------------------------------------------

def test_uniform_sample_sphere_matches_jax(rng):
    u = rng.uniform(size=(2000, 2)).astype(np.float32)
    np.testing.assert_allclose(
        pathtracer.uniform_sample_sphere(torch.from_numpy(u)).numpy(),
        np.asarray(jpt.uniform_sample_sphere(jnp.asarray(u))), atol=1e-6)


@pytest.mark.parametrize("tracker", ["global", "dda"])
def test_trackers_match_jax_under_replayed_draws(tracker):
    js, ts = _scenes()
    org, d, t0, t1 = _rays(ts)
    key = jax.random.PRNGKey(11)
    cfg = pathtracer.PTConfig(max_track_steps=256)
    jcfg = jpt.PTConfig(max_track_steps=256)
    lo, hi = ts.volume.world_lo, ts.volume.world_hi
    if tracker == "global":
        ours = pathtracer.delta_track_global(
            _leaves(ts), lo, hi, org, d, t0, t1, JaxDraws(key), cfg)
        theirs = jpt.delta_track_global(
            _leaves(js), js.volume.world_lo, js.volume.world_hi, _j(org),
            _j(d), _j(t0), _j(t1), key, jcfg)
    else:
        mc = accel.build_macrocells(ts.volume.grid, ts.tfn.alpha,
                                    ts.tfn.value_range)
        jmc = jaccel.build_macrocells(js.volume.grid, js.tfn.alpha,
                                      js.tfn.value_range)
        ours = pathtracer.delta_track_dda(
            _leaves(ts), lo, hi, org, d, t0, t1, JaxDraws(key), cfg, mc)
        theirs = jpt.delta_track_dda(
            _leaves(js), js.volume.world_lo, js.volume.world_hi, _j(org),
            _j(d), _j(t0), _j(t1), key, jcfg, jmc)
    assert 0.1 < float(ours[0].float().mean()) < 0.95  # not trivial
    _agree(ours, theirs)


def test_dda_retires_stalled_rays_with_jax_result():
    """Grazing rays whose nudge past a cell face rounds away (found among
    random rays through an empty 1024^3 macrocell grid): JAX's DDA loop
    keeps them to `max_track_steps` and returns them unchanged, not hit;
    the port retires them at once with the same (hit, t, albedo)."""
    org = torch.tensor([[0.5625289678573608, 0.7619836330413818,
                         0.3959999084472656],
                        [0.5471283793449402, 0.643352210521698,
                         0.8723160624504089],
                        [0.5, 0.5, 0.2]])
    d = torch.tensor([[-0.002569335512816906, 0.9543392658233643,
                       -0.2987140715122223],
                      [-0.00033942502341233194, 0.037107568234205246,
                       -0.9993112087249756],
                      [0.6, 0.0, 0.8]])
    lo, hi = torch.zeros(3), torch.ones(3)
    t0, t1 = intersect_box(org, d, lo, hi, torch.zeros(3),
                           torch.full((3,), 3.4e38))
    t0 = torch.clamp(t0, min=0.0)
    z = np.zeros((64, 64, 64), np.float32)
    mc = accel.MacrocellGrid(*(torch.from_numpy(z),) * 3,
                             vol_dims=(1024, 1024, 1024))
    jmc = jaccel.MacrocellGrid(*(jnp.asarray(z),) * 3,
                               vol_dims=(1024, 1024, 1024))
    leaves = (np.zeros((4, 4, 4), np.float32), np.zeros((4, 3), np.float32),
              np.zeros(4, np.float32), np.array([0.0, 1.0], np.float32),
              np.float32(1.0))
    key = jax.random.PRNGKey(0)
    pathtracer.LEVEL_STEPS.clear()
    ours = pathtracer.delta_track_dda(
        tuple(torch.as_tensor(x) for x in leaves), lo, hi, org, d, t0, t1,
        JaxDraws(key), pathtracer.PTConfig(max_track_steps=1000), mc)
    theirs = jpt.delta_track_dda(
        tuple(jnp.asarray(x) for x in leaves), jnp.zeros(3), jnp.ones(3),
        _j(org), _j(d), _j(t0), _j(t1), key,
        jpt.PTConfig(max_track_steps=1000), jmc)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(theirs[0]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(theirs[1]))
    t = ours[1].numpy()
    assert t[0] < t1[0] and t[1] < t1[1]  # stalled inside the box
    assert t[2] >= t1[2]  # the third ray walks out
    assert pathtracer.LEVEL_STEPS[-1] < 100


@pytest.mark.parametrize("tracker", ["global", "dda"])
def test_trace_paths_matches_jax(tracker):
    js, ts = _scenes()
    org, d, _, _ = _rays(ts)
    key = jax.random.PRNGKey(5)
    mc = accel.build_macrocells(ts.volume.grid, ts.tfn.alpha,
                                ts.tfn.value_range)
    jmc = jaccel.build_macrocells(js.volume.grid, js.tfn.alpha,
                                  js.tfn.value_range)
    dda = tracker == "dda"
    rad, alpha = pathtracer.trace_paths(
        _leaves(ts), ts.volume.world_lo, ts.volume.world_hi, org, d,
        JaxDraws(key), ts.light.ambient,
        pathtracer.PTConfig(max_scatters=8, use_dda=dda), mc)
    jrad, jalpha = jpt.trace_paths(
        _leaves(js), js.volume.world_lo, js.volume.world_hi, _j(org), _j(d),
        key, js.light.ambient, jpt.PTConfig(max_scatters=8, use_dda=dda),
        jmc)
    np.testing.assert_array_equal(alpha.numpy(), np.asarray(jalpha))
    err = np.abs(rad.numpy() - np.asarray(jrad)).max(-1)
    assert (err <= 1e-4).mean() >= 0.995
    assert float(rad.max()) > 0.05


@pytest.mark.parametrize("tracker,spp,chunk", [
    ("global", 1, None), ("dda", 2, None), ("dda", 1, 100)])
def test_render_frame_matches_jax(tracker, spp, chunk):
    """`render_frame` with the sample jitter (spp 2) and chunked rays
    (the last chunk padded, each chunk from the same key) against JAX's
    under its replayed draws."""
    js, ts = _scenes(cam="ortho" if spp == 2 else "persp")
    kw = dict(width=16, height=12, spp=spp, sampling_rate=16.0,
              path_tracing=True, use_macrocells=tracker == "dda",
              max_scatters=8, ray_chunk=chunk)
    jc, tc = japi.RenderConfig(**kw).resolved(js), api.RenderConfig(
        **kw).resolved(ts)
    mc = accel.build_macrocells(ts.volume.grid, ts.tfn.alpha,
                                ts.tfn.value_range)
    jmc = jaccel.build_macrocells(js.volume.grid, js.tfn.alpha,
                                  js.tfn.value_range)
    key = jax.random.PRNGKey(3)
    tf = pathtracer.render_frame(ts, tc, ts.camera, JaxDraws(key), mc)
    jf = jpt.render_frame(js, jc, js.camera, key, jmc)
    _frames_agree(tf, jf)
    assert tf.depth is None and float(tf.rgba[..., :3].max()) > 0.05


def _const_scene(alpha=0.5, n=16):
    grid = np.full((n, n, n), 0.5, np.float32)
    tfn = TransferFunction.create(
        np.tile(np.array([[1.0, 0.5, 0.25]], np.float32), (4, 1)),
        np.full(4, alpha, np.float32), (0.0, 1.0), device="cpu")
    cam = Camera.create(from_=(0.5, 0.5, -2.0), at=(0.5, 0.5, 0.5),
                        kind="orthographic", height=0.5, device="cpu")
    return Scene.create(StructuredVolume.create(grid, device="cpu"), tfn,
                        camera=cam)


def _collision_fraction(track, scene, n=4096, seed=0):
    org = torch.tensor([[0.5, 0.5, -1.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    g = torch.Generator().manual_seed(seed)
    hit, t, albedo = track(_leaves(scene), scene.volume.world_lo,
                           scene.volume.world_hi, org, d, torch.ones(n),
                           torch.full((n,), 2.0),
                           pathtracer.GeneratorDraws(g))
    return float(hit.float().mean()), hit, t, albedo


def test_global_tracker_transmittance():
    """tests/test_pathtracer.py's rule on the port's generator: collision
    probability through a homogeneous slab is 1 - exp(-sigma L); hits lie
    in the medium and carry the TF albedo."""
    alpha = 0.5
    scene = _const_scene(alpha)
    cfg = pathtracer.PTConfig(max_track_steps=256)
    frac, hit, t, albedo = _collision_fraction(
        lambda *a: pathtracer.delta_track_global(*a, cfg), scene)
    np.testing.assert_allclose(frac, 1.0 - np.exp(-alpha), atol=0.02)
    tn = t[hit].numpy()
    assert np.all((tn >= 1.0) & (tn <= 2.0))
    np.testing.assert_allclose(albedo[hit].numpy(),
                               np.tile([[1.0, 0.5, 0.25]], (len(tn), 1)),
                               atol=1e-5)


def test_dda_tracker_statistics():
    """DDA tracking matches the global tracker's distribution (collision
    fraction, mean depth of the truncated exponential), and never
    collides in an empty volume."""
    alpha = 0.7
    scene = _const_scene(alpha, n=48)
    mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    cfg = pathtracer.PTConfig(max_track_steps=512)
    frac, hit, t, _ = _collision_fraction(
        lambda *a: pathtracer.delta_track_dda(*a, cfg, mc), scene)
    np.testing.assert_allclose(frac, 1.0 - np.exp(-alpha), atol=0.03)
    want = 1 / alpha - np.exp(-alpha) / (1 - np.exp(-alpha))
    np.testing.assert_allclose((t[hit] - 1.0).mean().item(), want, atol=0.03)
    empty = _const_scene(0.0, n=32)
    mc0 = accel.build_macrocells(empty.volume.grid, empty.tfn.alpha,
                                 empty.tfn.value_range)
    pathtracer.LEVEL_STEPS.clear()
    frac0, *_ = _collision_fraction(
        lambda *a: pathtracer.delta_track_dda(
            *a, pathtracer.PTConfig(max_track_steps=64), mc0), empty, n=256)
    # one iteration a macrocell: the loop ends once every ray is out
    assert frac0 == 0.0 and pathtracer.LEVEL_STEPS[-1] <= 3


def test_pt_frame_bounds_and_energy():
    """The MC frame through `api.render` (macrocells, spp 2): finite,
    alpha 1 on box hits, rgb <= ambient; a denser white medium scatters
    more ambient light back."""
    scene = _const_scene(alpha=0.4)
    mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    cfg = api.RenderConfig(width=8, height=8, spp=2, sampling_rate=16.0,
                           path_tracing=True, use_macrocells=True,
                           max_scatters=8, method="auto").resolved(scene)
    assert cfg.sw is None  # the tracker renders MC frames
    rgba = api.render(scene, cfg, macrocells=mc).rgba.numpy()
    assert rgba.shape == (8, 8, 4) and np.isfinite(rgba).all()
    assert rgba[4, 4, 3] == 1.0
    assert rgba[..., :3].max() <= float(scene.light.ambient) + 1e-5
    vals = []
    for alpha in (0.1, 0.9):
        s = _const_scene(alpha, n=8)
        s = dataclasses.replace(s, tfn=dataclasses.replace(
            s.tfn, color=torch.ones(4, 3)))
        c = api.RenderConfig(width=4, height=4, spp=16, sampling_rate=8.0,
                             path_tracing=True,
                             max_scatters=16).resolved(s)
        vals.append(float(api.render(s, c, frame_index=2).rgba[..., :3]
                          .mean()))
    assert vals[1] > 0.1 and vals[0] > 0.0 and vals[1] > vals[0]


def test_mc_u8_scene_matches_jax():
    """A uint8 grid: the tracker samples it through the storage scale, as
    JAX's does (replayed draws, DDA)."""
    js, ts = _scenes(u8=True)
    assert ts.volume.grid.dtype == torch.uint8
    kw = dict(width=12, height=12, sampling_rate=16.0, path_tracing=True,
              use_macrocells=True, max_scatters=6)
    jc, tc = japi.RenderConfig(**kw).resolved(js), api.RenderConfig(
        **kw).resolved(ts)
    key = jax.random.PRNGKey(8)
    tf = pathtracer.render_frame(
        ts, tc, ts.camera, JaxDraws(key),
        accel.build_macrocells(ts.volume.grid, ts.tfn.alpha,
                               ts.tfn.value_range))
    jf = jpt.render_frame(js, jc, js.camera, key, jaccel.build_macrocells(
        js.volume.grid, js.tfn.alpha, js.tfn.value_range))
    _frames_agree(tf, jf)


# ---- the dense solver ----------------------------------------------------

def _rel(a, b, tol=1e-5):
    b = np.asarray(b)
    assert np.abs(np.asarray(a) - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("u8", [False, True])
def test_build_lattices_matches_jax(u8):
    js, ts = _scenes(u8=u8)
    for res in ((16, 16, 16), (8, 12, 10)):
        s, a = ptdense.build_lattices(_leaves(ts), res)
        js_, ja = jpd.build_lattices(_leaves(js), res)
        _rel(s.numpy(), js_)
        _rel(a.numpy(), ja)


@pytest.mark.parametrize("direction", [
    (0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0),
    tuple(np.array([1.0, -1.0, 1.0]) / np.sqrt(3.0)),
    tuple(np.array([-1.0, 1.0, -1.0]) / np.sqrt(3.0))])
def test_sweep_direction_matches_jax(rng, direction):
    """Axial and diagonal sweeps of a non-cubic lattice, with and without
    emission, against JAX's (numpy spacing and float32 tensor spacing)."""
    sigma = rng.uniform(0.0, 3.0, size=(6, 8, 10)).astype(np.float32)
    emis = rng.uniform(size=(6, 8, 10, 3)).astype(np.float32)
    for spacing in (np.array([0.1, 0.125, 1 / 6]),
                    np.array([0.1, 0.125, 1 / 6], np.float32)):
        sp_t = (torch.from_numpy(spacing) if spacing.dtype == np.float32
                else spacing)
        sp_j = jnp.asarray(spacing) if spacing.dtype == np.float32 \
            else spacing
        t, _ = ptdense.sweep_direction(torch.from_numpy(sigma), None,
                                       direction, sp_t, include_emis=False)
        jt, _ = jpd.sweep_direction(jnp.asarray(sigma), None, direction,
                                    sp_j, include_emis=False)
        _rel(t.numpy(), jt)
        t, r = ptdense.sweep_direction(torch.from_numpy(sigma),
                                       torch.from_numpy(emis), direction,
                                       sp_t)
        jt, jr = jpd.sweep_direction(jnp.asarray(sigma), jnp.asarray(emis),
                                     direction, sp_j)
        _rel(t.numpy(), jt)
        _rel(r.numpy(), jr)


def test_sweep_uniform_slab_axial():
    """JAX's analytic check: marching +z from plane k crosses planes
    k..n-1 of a uniform slab; -z mirrors it."""
    n, sig_v = 16, 0.8
    sigma = torch.full((n, n, n), sig_v)
    spacing = np.full(3, 1.0 / n)
    a = 1.0 - np.exp(-sig_v / n)
    want = (1.0 - a) ** (n - np.arange(n))
    t_f, _ = ptdense.sweep_direction(sigma, None, (0.0, 0.0, 1.0), spacing,
                                     include_emis=False)
    np.testing.assert_allclose(t_f[:, 8, 8].numpy(), want, rtol=1e-5)
    t_b, _ = ptdense.sweep_direction(sigma, None, (0.0, 0.0, -1.0),
                                     spacing, include_emis=False)
    np.testing.assert_allclose(t_b[:, 8, 8].numpy(), want[::-1], rtol=1e-5)


def test_solve_scatter_and_prepare_match_jax():
    js, ts = _scenes(n=12, ambient=0.8)
    kw = dict(width=16, height=16, sampling_rate=12.0, path_tracing=True,
              pt_dense=True, pt_lattice=10, max_scatters=4, pt_dirs=14,
              method="auto")
    jc, tc = japi.RenderConfig(**kw).resolved(js), api.RenderConfig(
        **kw).resolved(ts)
    sig, j = ptdense.prepare(ts, tc)
    jsig, jj = jpd.prepare(js, jc)
    assert sig.shape == (10, 10, 10) and j.shape == (10, 10, 10, 3)
    _rel(sig.numpy(), jsig)
    _rel(j.numpy(), jj)
    # the 6 axial directions alone, at another depth
    cfg6 = ptdense.PTDenseConfig(levels=2, n_dirs=6)
    alb = torch.rand(10, 10, 10, 3, generator=torch.Generator()
                     .manual_seed(1))
    spacing = torch.full((3,), 0.1)
    _rel(ptdense.solve_scatter(sig, alb, ts.light.ambient, spacing,
                               cfg6).numpy(),
         jpd.solve_scatter(jsig, _j(alb), js.light.ambient,
                           jnp.full((3,), 0.1), jpd.PTDenseConfig(
                               levels=2, n_dirs=6)))


@pytest.mark.parametrize("cam,u8", [("persp", False), ("ortho", False),
                                    ("persp", True)])
def test_dense_frame_matches_jax(cam, u8):
    """`api.render` with pt_dense (method auto: planned with shading none
    even for a shadow config) against JAX's: rgba 5e-5, depth 2e-4; the
    slice kernel is never launched and its plain version never runs."""
    js, ts = _scenes(cam=cam, u8=u8)
    kw = dict(width=20, height=16, sampling_rate=16.0, path_tracing=True,
              pt_dense=True, pt_lattice=12, max_scatters=6, method="auto",
              shading="shadow", shadow_grid=False)
    jc, tc = japi.RenderConfig(**kw).resolved(js), api.RenderConfig(
        **kw).resolved(ts)
    assert tc.sw is not None and jc.sw is not None
    for f in ("axis", "sign", "n_slices", "inter_h", "inter_w", "swap",
              "separable", "slice0_static"):
        assert getattr(tc.sw, f) == getattr(jc.sw, f), f
    n0, plain = swslice.LAUNCHES, swslice.slice_composite_plain
    swslice.slice_composite_plain = None  # must not be reached
    try:
        tf = api.render(ts, tc)
    finally:
        swslice.slice_composite_plain = plain
    assert swslice.LAUNCHES == n0
    jf = japi.render(js, jc)
    np.testing.assert_allclose(tf.rgba.numpy(), np.asarray(jf.rgba),
                               atol=5e-5)
    np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth),
                               atol=2e-4)
    assert float(tf.rgba[..., 3].max()) > 0.5


def test_dense_frame_bf16_matches_jax():
    """sw_bf16: the gather's matmul operands rounded to bf16, as JAX's
    `_mm` takes them, held by the slice loop's bf16 tie rule."""
    from tests.test_torch_swslice import assert_bf16_close
    js, ts = _scenes()
    kw = dict(width=20, height=16, sampling_rate=16.0, path_tracing=True,
              pt_dense=True, pt_lattice=12, max_scatters=6, method="auto",
              sw_bf16=True)
    jc, tc = japi.RenderConfig(**kw).resolved(js), api.RenderConfig(
        **kw).resolved(ts)
    assert tc.sw.bf16 and jc.sw.bf16
    tf, jf = api.render(ts, tc), japi.render(js, jc)

    def stack(f):
        rgba, grad, depth = (np.asarray(x) for x in (f.rgba, f.grad,
                                                     f.depth))
        return np.concatenate([np.moveaxis(rgba[..., :3], -1, 0),
                               np.moveaxis(grad, -1, 0), depth[None],
                               rgba[None, ..., 3]])
    assert_bf16_close(stack(tf), stack(jf))
    f32 = api.render(ts, dataclasses.replace(
        tc, sw=dataclasses.replace(tc.sw, bf16=False), sw_bf16=False))
    assert float((f32.rgba - tf.rgba).abs().max()) > 0  # bf16 took effect


def test_dense_tracks_mc_mean_image():
    """tests/test_pathtracer.py's dense-vs-MC rule on the port alone:
    mean premultiplied radiance over the interior within 0.035 of the
    MC mean (spp 48), energy within 20%."""
    g = np.meshgrid(*([np.linspace(0, 1, 24)] * 3), indexing="ij")
    grid = (0.5 + 0.5 * np.sin(5 * g[2]) * np.cos(4 * g[1])
            * np.sin(3 * g[0])).astype(np.float32)
    tfn = TransferFunction.create(
        np.stack([np.linspace(0.2, 1.0, 8), np.full(8, 0.6),
                  np.linspace(1.0, 0.2, 8)], -1).astype(np.float32),
        (np.linspace(0, 1, 8) ** 1.5).astype(np.float32), (0.0, 1.0),
        device="cpu")
    scene = Scene.create(
        StructuredVolume.create(grid, device="cpu"), tfn,
        camera=Camera.create(from_=(0.5, 0.5, -1.8), at=(0.5, 0.5, 0.5),
                             fovy=40.0, device="cpu"))
    w = h = 24
    cfg_mc = api.RenderConfig(width=w, height=h, spp=48, sampling_rate=24.0,
                              path_tracing=True,
                              max_scatters=8).resolved(scene)
    mc = api.render(scene, cfg_mc, frame_index=5).rgba.numpy()
    cfg_d = api.RenderConfig(width=w, height=h, sampling_rate=24.0,
                             path_tracing=True, pt_dense=True,
                             pt_lattice=48, max_scatters=8,
                             method="auto").resolved(scene)
    assert cfg_d.sw is not None
    de = api.render(scene, cfg_d).rgba.numpy()
    mc_pm, de_pm = mc[..., :3] * mc[..., 3:], de[..., :3] * de[..., 3:]
    interior = mc[..., 3] > 0.999
    interior[:3] = interior[-3:] = False
    interior[:, :3] = interior[:, -3:] = False
    assert interior.sum() > 100
    assert np.abs(de_pm - mc_pm)[interior].mean() < 0.035
    assert abs(de_pm[interior].sum() - mc_pm[interior].sum()) \
        < 0.2 * mc_pm[interior].sum() + 1e-3


def test_renderer_caches_and_drops_pt_fields():
    """`Renderer.commit` builds the dense lattices once; a TF, volume or
    density change drops them (as JAX's setters do) and the next frame
    rebuilds them; a camera change keeps them."""
    _, ts = _scenes(n=12)
    r = api.Renderer(ts, api.RenderConfig(
        width=12, height=12, sampling_rate=12.0, path_tracing=True,
        pt_dense=True, pt_lattice=8, max_scatters=4, method="auto"))
    r.render()
    fields = r._pt_fields
    assert fields is not None and np.isfinite(r.mapframe()["rgba"]).all()
    r.set_camera(from_=(0.45, 0.5, -1.7))
    r.render()
    assert r._pt_fields is fields
    for change in (lambda: r.set_transfer_function(
                       np.ones((4, 3)), np.linspace(0, 0.5, 4), (0, 1)),
                   lambda: r.set_volume_data(_field(12, 0.9)),
                   lambda: r.set_volume_density_scale(3.0)):
        change()
        assert r._pt_fields is None
        r.render()
        assert r._pt_fields is not None and r._pt_fields is not fields
        fields = r._pt_fields


def test_pt_plans_match_jax():
    """Plans: MC frames take no shear-warp plan; a dense frame of a scene
    with a volume instance takes none either (JAX plans no instances for
    it); `method="shearwarp"` raises where JAX's does."""
    from tests.test_torch_multivol import _scenes as mv_scenes
    js, ts = _scenes()
    kw = dict(width=16, height=16, sampling_rate=16.0, path_tracing=True,
              method="auto")
    assert api.RenderConfig(**kw).resolved(ts).sw is None
    assert japi.RenderConfig(**kw).resolved(js).sw is None
    jmv, tmv = mv_scenes()
    kw["pt_dense"] = True
    assert api.RenderConfig(**kw).resolved(tmv).sw is None
    assert japi.RenderConfig(**kw).resolved(jmv).sw is None
    kw["method"] = "shearwarp"
    for cfg, scene in ((api.RenderConfig(**kw), tmv),
                       (japi.RenderConfig(**kw), jmv)):
        with pytest.raises(ValueError, match="ineligible"):
            cfg.resolved(scene)


def test_dense_gradients_match_jax():
    """The gradient of mean(rgba^2) of a dense frame (16^3, lattice 8)
    with respect to the grid and the TF alpha: autograd through the
    solver and `over_scan` against `jax.grad` of the same JAX render,
    within 2e-3 of the largest element."""
    js, ts = _scenes()
    kw = dict(width=20, height=16, sampling_rate=16.0, path_tracing=True,
              pt_dense=True, pt_lattice=8, max_scatters=4, method="auto")
    jc, tc = japi.RenderConfig(**kw).resolved(js), api.RenderConfig(
        **kw).resolved(ts)

    def jloss(grid, alpha):
        s = dataclasses.replace(
            js, volume=dataclasses.replace(js.volume, grid=grid),
            tfn=dataclasses.replace(js.tfn, alpha=alpha))
        return jnp.mean(japi.render(s, jc).rgba ** 2)

    jg = jax.grad(jloss, argnums=(0, 1))(js.volume.grid, js.tfn.alpha)
    grid = ts.volume.grid.clone().requires_grad_(True)
    alpha = ts.tfn.alpha.clone().requires_grad_(True)
    s = dataclasses.replace(
        ts, volume=dataclasses.replace(ts.volume, grid=grid),
        tfn=dataclasses.replace(ts.tfn, alpha=alpha))
    (api.render(s, tc).rgba ** 2).mean().backward()
    for ours, theirs in ((grid.grad, jg[0]), (alpha.grad, jg[1])):
        theirs = np.asarray(theirs)
        assert np.abs(theirs).max() > 0
        _rel(ours.numpy(), theirs, tol=2e-3)
