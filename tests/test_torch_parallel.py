"""The port's row-band rendering, replicated train step and multi-process
jobs (ovr_tpu_torch.parallel.tiles, .multihost) against the JAX package's
(ovr_tpu.parallel), on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices of
tests/conftest.py; the port's side in gloo CPU ranks
(tests/test_torch_parallel_ranks.py, no JAX there), started once for the
module (`ranks`, a wall limit of 300 s), with the same mesh shapes. The
parametrised tests read the ranks' results. Tolerances: frames 5e-5
(rgba); the train step's loss rtol 1e-5 and its state 2e-5 of each
array's largest element.
"""

import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu import api as japi
from ovr_tpu.core.scene import Camera as JCamera
from ovr_tpu.core.scene import simple_scene as jsimple
from ovr_tpu.parallel import mesh as jmesh
from ovr_tpu.parallel import tiles as jtiles
from ovr_tpu_torch import api
from ovr_tpu_torch.convert import (arrays_from_fields, arrays_from_scene,
                                   scene_from_arrays,
                                   train_state_from_arrays)
from ovr_tpu_torch.parallel import multihost, tiles
from ovr_tpu_torch.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "test_torch_parallel_ranks.py")
RANKS_TIMEOUT = 300.0  # seconds for one module's job of ranks


def field(n=24):
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    return (0.5 + 0.45 * np.sin(6 * x) * np.cos(5 * y)
            * np.sin(4 * z + 1.0)).astype(np.float32)


def jscene(cam_from, fovy=60.0, n=24):
    return dataclasses.replace(jsimple(field(n)), camera=JCamera.create(
        from_=cam_from, at=(0.5, 0.5, 0.5), fovy=fovy))


def task(name, kind, mesh, js, cfg, **kw):
    """A task of the rank worker on the JAX scene `js` (f32 arrays)."""
    arrays = {k: np.asarray(v) for k, v in arrays_from_scene(js).items()}
    return dict(kw, name=name, kind=kind, mesh=mesh, scene=arrays, cfg=cfg)


def run_tasks(tasks, world_size, tmp):
    """Run the tasks in a job of gloo CPU ranks; {rank: {task: result}}."""
    spec = os.path.join(tmp, "spec.pkl")
    with open(spec, "wb") as f:
        pickle.dump(tasks, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    multihost.run_ranks([sys.executable, WORKER, spec, tmp], world_size,
                        RANKS_TIMEOUT, env=env)
    out = {}
    for r in range(world_size):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out[r] = pickle.load(f)
    return out


CAM = (0.5, 0.5, -1.8)
# (name, rendering settings, light lattice)
FRAMES = [
    ("sw-none", dict(method="shearwarp", shading="none"), False),
    ("sw-diffuse", dict(method="shearwarp", shading="diffuse"), False),
    ("sw-shadow", dict(method="shearwarp", shading="shadow"), True),
    ("march-diffuse", dict(shading="diffuse", sampling_rate=16.0), False),
]
TRAINS = [
    ("sw", dict(method="shearwarp", shading="none", sampling_rate=16.0)),
    ("march", dict(shading="none", sampling_rate=12.0)),
]
TRAIN_LR, TRAIN_MOMENTUM, TRAIN_STEPS = 0.5, 0.5, 2


def frame_cfg(kw):
    return dict(dict(width=48, height=32, sampling_rate=24.0), **kw)


def train_cfg(kw):
    return dict(dict(width=16, height=16), **kw)


def train_target(js):
    """A brighter TF's frame, the train steps' target."""
    bright = dataclasses.replace(js, tfn=dataclasses.replace(
        js.tfn, alpha=jnp.clip(js.tfn.alpha * 1.5, 0, 1)))
    cfg = japi.RenderConfig(**train_cfg(dict(shading="none"))).resolved(js)
    return np.asarray(japi.render(bright, cfg).rgba)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    js = jscene(CAM, fovy=45.0)
    tasks = []
    for name, kw, lat in FRAMES:
        extra = {}
        if lat:
            cfg = japi.RenderConfig(**frame_cfg(kw)).resolved(js)
            extra["light_grid"] = np.asarray(japi.build_light_grid(js, cfg))
        tasks.append(task(name, "tiles_frame", (2, 1), js, frame_cfg(kw),
                          **extra))
    target = train_target(js)
    for name, kw in TRAINS:
        tasks.append(task(f"train-{name}", "tiles_train", (2, 1), js,
                          train_cfg(kw), target=target, lr=TRAIN_LR,
                          momentum=TRAIN_MOMENTUM, steps=TRAIN_STEPS))
    tasks.append(task("gathered", "gathered", (2, 1), js,
                      dict(width=8, height=8, sampling_rate=8.0,
                           shading="none")))
    return run_tasks(tasks, 2, str(tmp_path_factory.mktemp("tiles")))


@pytest.mark.parametrize("name,kw,lat", FRAMES, ids=[f[0] for f in FRAMES])
def test_banded_frame_matches_jax(ranks, name, kw, lat):
    """Two row bands, each its own fan (shear-warp) or rays (march),
    gathered: the JAX package's banded frame on a (2, 1) mesh."""
    js = jscene(CAM, fovy=45.0)
    cfg = japi.RenderConfig(**frame_cfg(kw)).resolved(js)
    lg = japi.build_light_grid(js, cfg) if lat else None
    m = jmesh.make_mesh(n_tiles=2, n_bricks=1)
    want = np.asarray(jax.jit(lambda s, g: jtiles.render_sharded(
        s, cfg, m, light_grid=g))(js, lg))
    got = ranks[0][name]["frame"]
    np.testing.assert_array_equal(ranks[1][name]["frame"], got)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    assert float(got[..., 3].max()) > 0.1


@pytest.mark.parametrize("name,kw", TRAINS, ids=[t[0] for t in TRAINS])
def test_train_step_matches_jax(ranks, name, kw):
    """Two replicated train steps on a (2, 1) mesh: the loss and the
    updated grid, TF tables and momenta of JAX's step, alike on both
    ranks."""
    js = jscene(CAM, fovy=45.0)
    cfg = japi.RenderConfig(**train_cfg(kw)).resolved(js)
    step = jtiles.make_train_step(cfg, jmesh.make_mesh(2, 1), lr=TRAIN_LR,
                                  momentum=TRAIN_MOMENTUM)
    state = jtiles.init_train_state(js)
    target = jnp.asarray(train_target(js))
    losses = []
    for _ in range(TRAIN_STEPS):
        state, loss = step(state, js, js.camera, target)
        losses.append(float(loss))
    got = ranks[0][f"train-{name}"]
    for k, v in got.items():
        np.testing.assert_array_equal(ranks[1][f"train-{name}"][k], v)
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for f in ("grid", "tf_color", "tf_alpha", "m_grid", "m_color",
              "m_alpha"):
        want = np.asarray(getattr(state, f))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got[f], want, atol=2e-5 * scale, rtol=0,
                                   err_msg=f)


def test_two_ranks_gather_the_single_rank_frame(ranks):
    """Two ranks through `multihost.initialize` on a free TCP port:
    `gather_frame` of their march bands is the frame one rank renders
    (rays are independent; a batch's vectorised tail may round an ulp
    apart), the same on both ranks."""
    a, b = ranks[0]["gathered"], ranks[1]["gathered"]
    assert a["frame"].shape == (8, 8, 4)
    np.testing.assert_array_equal(a["frame"], b["frame"])
    np.testing.assert_allclose(a["frame"], a["single"], atol=1e-6, rtol=0)
    assert str(a["transport"]) == "gloo"


def test_converted_train_state_steps_as_jax():
    """A JAX TrainState carried across (`convert`) takes the port's train
    step on one rank (a 1 x 1 mesh, no job) as JAX's step on a 1 x 1
    mesh does: loss rtol 1e-5, state 2e-5 of each array's largest
    element."""
    js = jscene(CAM, fovy=45.0)
    kw = train_cfg(TRAINS[0][1])
    jc = japi.RenderConfig(**kw).resolved(js)
    jstate = jtiles.init_train_state(js)
    target = train_target(js)
    want, wloss = jtiles.make_train_step(jc, jmesh.make_mesh(1, 1),
                                         lr=TRAIN_LR)(
        jstate, js, js.camera, jnp.asarray(target))
    ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    state = train_state_from_arrays(arrays_from_fields(jstate), device="cpu")
    for f in ("grid", "tf_color", "tf_alpha"):
        assert torch.equal(getattr(state, f),
                           getattr(tiles.init_train_state(ts), f))
    step = tiles.make_train_step(api.RenderConfig(**kw).resolved(ts),
                                 make_mesh(1, 1, device="cpu"), lr=TRAIN_LR)
    got, loss = step(state, ts, ts.camera, torch.from_numpy(target))
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-5)
    for f, w in arrays_from_fields(want).items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(getattr(got, f).numpy(), w,
                                   atol=2e-5 * max(scale, 1e-30), rtol=0,
                                   err_msg=f)
