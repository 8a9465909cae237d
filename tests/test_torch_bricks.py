"""The port's bricked volumes, ring and gather compositing, bricked frames
and bricked train step (ovr_tpu_torch.parallel.bricks) and
`integrator.march_segment` against the JAX package's, on the CPU.

As in tests/test_torch_parallel.py: the JAX side on this process's 8
virtual CPU devices, the port's in gloo CPU ranks started once for the
module, on the same mesh shapes ((1, 2), (1, 4), (2, 2)); each port rank
holds its own slab only. Tolerances: `brick_volume` bit for bit;
`march_segment` and the bricked frames 5e-5 (rgba, normals), depth
2e-4; ring against gather 1e-6; the bricked train step's slabs 3e-4 of
the largest element at most and 3e-6 on average (JAX's own bound for
its bricked step against the unbricked one), the halos 1e-6, the TF
tables 2e-4; against the port's unbricked frame, JAX's bricked-vs-
unbricked bounds (1e-3 unshaded, 3e-2 shaded).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu import api as japi
from ovr_tpu.core import sampling as jsamp
from ovr_tpu.parallel import bricks as jbricks
from ovr_tpu.parallel import mesh as jmesh
from ovr_tpu.render import camera as jcamera
from ovr_tpu.render import integrator as jig
from ovr_tpu_torch import api
from ovr_tpu_torch.convert import (arrays_from_fields, arrays_from_scene,
                                   bricked_from_arrays, scene_from_arrays)
from ovr_tpu_torch.core import sampling
from ovr_tpu_torch.parallel import bricks
from ovr_tpu_torch.parallel.mesh import make_mesh
from ovr_tpu_torch.render import camera, integrator
from tests.test_torch_parallel import jscene, run_tasks, task


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and a torch thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VIEWS = {"asc": (0.5, 0.5, -1.6), "desc": (0.5, 0.5, 2.6),
         "transverse": (-1.6, 0.4, 0.5), "ring": (-1.2, 0.7, 0.2)}


def sw_cfg(shading, align):
    return dict(width=16, height=16, sampling_rate=48.0, shading=shading,
                method="shearwarp", sw_slice_align=align)


def march_cfg(shading):
    return dict(width=16, height=16, sampling_rate=48.0, shading=shading)


# (name, view, mesh, config, shadow lattice); as tests/test_bricks.py
SW_FRAMES = [(f"sw-{shading}-{view}", view, (1, 4), sw_cfg(shading, 4),
              shading == "shadow")
             for view in ("asc", "desc", "transverse")
             for shading in ("none", "diffuse", "shadow")]
OTHER_FRAMES = [
    ("sw-none-asc-2x2", "asc", (2, 2), sw_cfg("none", 2), False),
    ("march-none-asc-2x2", "asc", (2, 2), march_cfg("none"), False),
    ("march-diffuse-asc-2x2", "asc", (2, 2), march_cfg("diffuse"), False),
    ("sw-none-asc-1x2", "asc", (1, 2), sw_cfg("none", 2), False),
]
FRAMES = SW_FRAMES + OTHER_FRAMES
SLOW = ("desc", "transverse")  # views tests/test_bricks.py marks slow
TRAIN_LR = 0.25
# (name, view, mesh, config)
TRAINS = [("train-sw-1x4", "asc", (1, 4), sw_cfg("none", 4)),
          ("train-march-2x2", "asc", (2, 2), march_cfg("none"))]


def lattice(js, cfg):
    return np.asarray(japi.build_light_grid(
        js, japi.RenderConfig(**cfg).resolved(js)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tasks = []
    for name, view, mesh, cfg, lat in FRAMES:
        js = jscene(VIEWS[view])
        extra = {"light_grid": lattice(js, cfg)} if lat else {}
        tasks.append(task(name, "bricked_frame", mesh, js, cfg, **extra))
    js = jscene(VIEWS["ring"])
    for ring in (True, False):
        tasks.append(task(f"ring-{ring}", "bricked_frame", (1, 4), js,
                          march_cfg("diffuse"), ring=ring))
    for name, view, mesh, cfg in TRAINS:
        tasks.append(task(name, "bricked_train", mesh, jscene(VIEWS[view]),
                          cfg, target=np.zeros((16, 16, 4), np.float32),
                          lr=TRAIN_LR))
    return run_tasks(tasks, 4, str(tmp_path_factory.mktemp("bricks")))


def jax_bricked(js, cfg, mesh, lat):
    m = jmesh.make_mesh(*mesh)
    bv = jbricks.brick_volume(js.volume, mesh[1])
    lg = japi.build_light_grid(js, cfg) if lat else None
    return np.asarray(jax.jit(lambda s, b, g: jbricks.render_bricked(
        s, b, cfg, m, light_grid=g))(js, bv, lg))


@pytest.mark.parametrize("n_bricks", [2, 4])
def test_brick_volume_matches_jax(n_bricks):
    js = jscene(VIEWS["asc"])
    ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    want = jbricks.brick_volume(js.volume, n_bricks)
    got = bricks.brick_volume(ts.volume, n_bricks)
    for f, w in arrays_from_fields(want).items():
        np.testing.assert_array_equal(getattr(got, f).numpy(), w)
    one = bricks.brick_volume(ts.volume, n_bricks, only=1)
    assert one.index == 1
    np.testing.assert_array_equal(one.bricks[0].numpy(),
                                  np.asarray(want.bricks[1]))
    # a rank that loads only its rows builds the same brick
    rows = bricks.slab_rows(24, n_bricks, 1)
    mine = bricks.from_slab(ts.volume.grid[rows], ts.volume.world_lo,
                            ts.volume.world_hi, 24, n_bricks, 1)
    for f in arrays_from_fields(want):
        assert torch.equal(getattr(mine, f), getattr(one, f))


@pytest.mark.parametrize("shading", ["none", "diffuse"])
def test_march_segment_matches_jax(shading):
    """One brick's segment of the global lattice, premultiplied."""
    js = jscene(VIEWS["asc"])
    ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    jbv = jbricks.brick_volume(js.volume, 4)
    tbv = bricked_from_arrays(arrays_from_fields(jbv), device="cpu")
    cfg = march_cfg(shading)
    jc = japi.RenderConfig(**cfg).resolved(js)
    b = 2
    sc = np.random.default_rng(0).uniform(0.1, 0.9, (64, 2)).astype(
        np.float32)

    def run(scene, bv, xp, stack, cam_mod, samp, ig):
        """The bricked march's segment (`_render_brick_rows`), in the
        package whose modules are given."""
        org, d = cam_mod.generate_rays(scene.camera, xp(sc), 16, 16)
        zero = 0.0 * org[:, 0]
        t0g, t1g = samp.intersect_box(org, d, scene.volume.world_lo,
                                      scene.volume.world_hi, zero,
                                      zero + 3.4e38)
        t0g = t0g * (t0g > 0)
        t1g = t1g + (t0g - t1g) * (t1g < t0g)
        te, tx = samp.intersect_box(org, d, bv.own_lo[b], bv.own_hi[b],
                                    t0g, t1g)
        tx = tx + (te - tx) * (tx < te)
        blo, bhi = bv.brick_lo[b], bv.brick_hi[b]
        _, cdir, chor, cver = cam_mod.camera_basis(scene.camera, 16, 16)
        norm = samp.safe_normalize
        ctx = ig.ShadeContext(
            light_dir=norm(scene.light.direction),
            wtc=stack([norm(chor), norm(cver), -cdir]),
            world_lo=blo, world_hi=bhi,
            grad_hi=(scene.volume.world_hi - blo) / (bhi - blo))
        leaves = (bv.bricks[b], scene.tfn.color, scene.tfn.alpha,
                  scene.tfn.value_range, xp(1.0))
        mcfg = ig.MarchConfig(max_steps=jc.max_steps, shading=shading,
                              shadow_max_steps=jc.shadow_max_steps)
        return ig.march_segment(org, d, leaves, ctx, mcfg, xp(1.0 / 48.0),
                                t0g, t1g, te, tx, jc.max_steps)

    want = run(js, jbv, lambda x: jnp.asarray(x, jnp.float32), jnp.stack,
               jcamera, jsamp, jig)
    got = run(ts, tbv, lambda x: torch.tensor(x, dtype=torch.float32),
              torch.stack, camera, sampling, integrator)
    for g, w, tol in zip(got, want, (5e-5, 5e-5, 2e-4, 5e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=0)
    assert float(got[3].max()) > 0.05  # the segment holds volume


@pytest.mark.parametrize(
    "name,view,mesh,cfg,lat",
    [pytest.param(*f, marks=pytest.mark.slow) if f[1] in SLOW else f
     for f in FRAMES], ids=[f[0] for f in FRAMES])
def test_bricked_frame_matches_jax(ranks, name, view, mesh, cfg, lat):
    """Each rank holds its slab only; the gathered frame is the JAX
    package's bricked frame on the same mesh, and within JAX's bounds of
    the port's unbricked frame."""
    js = jscene(VIEWS[view])
    jc = japi.RenderConfig(**cfg).resolved(js)
    want = jax_bricked(js, jc, mesh, lat)
    got = ranks[0][name]["frame"]
    for r in range(1, mesh[0] * mesh[1]):
        # each brick associates the ring's over-composites its own way
        np.testing.assert_allclose(ranks[r][name]["frame"], got, atol=1e-6,
                                   rtol=0)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    assert float(got[..., 3].max()) > 0.1
    if mesh[0] == 1:
        ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
        lg = torch.tensor(lattice(js, cfg)) if lat else None
        ref = api.render(ts, api.RenderConfig(**cfg).resolved(ts),
                         light_grid=lg).rgba.numpy()
        tol = 1e-3 if cfg["shading"] == "none" else 3e-2
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def test_ring_equals_gather(ranks):
    """Four bricks along a ray direction oblique to every axis: the ring
    of three hops and the one all-gather give the same frame."""
    ring, gat = ranks[0]["ring-True"]["frame"], ranks[0]["ring-False"][
        "frame"]
    np.testing.assert_allclose(ring, gat, atol=1e-6, rtol=0)
    assert float(ring[..., 3].max()) > 0.1


@pytest.mark.parametrize("name,view,mesh,cfg", TRAINS,
                         ids=[t[0] for t in TRAINS])
def test_bricked_train_step_matches_jax(ranks, name, view, mesh, cfg):
    """One bricked train step: every rank's updated slab against JAX's
    (the slab alone on the rank; the halo exchange and the sum over
    tiles), the halos against the neighbours' rows, the TF tables and
    the loss."""
    js = jscene(VIEWS[view])
    jc = japi.RenderConfig(**cfg).resolved(js)
    n_t, n_b = mesh
    step = jbricks.make_train_step_bricked(jc, jmesh.make_mesh(*mesh),
                                           lr=TRAIN_LR)
    bv2, _, tfa2, loss = step(jbricks.brick_volume(js.volume, n_b),
                              js.tfn.color, js.tfn.alpha, js, js.camera,
                              jnp.zeros((16, 16, 4), jnp.float32))
    want = np.asarray(bv2.bricks)
    scale = float(np.abs(want).max())
    for r in range(n_t * n_b):
        t, b = divmod(r, n_b)
        got = ranks[r][name]
        d = np.abs(got["slab"] - want[b]) / scale
        assert d.max() < 3e-4, (r, d.max())
        assert d.mean() < 3e-6, (r, d.mean())
        if b:  # my halo rows are my neighbour's updated rows
            np.testing.assert_allclose(
                got["slab"][:2], ranks[r - 1][name]["slab"][-4:-2],
                atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["tf_alpha"], np.asarray(tfa2),
                                   atol=2e-4, rtol=0)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)


def test_converted_bricked_volume_renders():
    """A JAX BrickedVolume carried across (`convert`) renders through the
    port on one rank (a 1 x 1 mesh, no job) as JAX's does."""
    js = jscene(VIEWS["asc"])
    cfg = sw_cfg("diffuse", 1)
    jc = japi.RenderConfig(**cfg).resolved(js)
    want = jax_bricked(js, jc, (1, 1), False)
    ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    tbv = bricked_from_arrays(arrays_from_fields(
        jbricks.brick_volume(js.volume, 1)), device="cpu")
    got = bricks.render_bricked(ts, tbv, api.RenderConfig(**cfg).resolved(
        ts), make_mesh(1, 1, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)
