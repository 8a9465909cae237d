"""One gloo CPU rank of the port's multi-device tests
(tests/test_torch_parallel.py, tests/test_torch_bricks.py), run as a
script by those modules; it holds no tests itself. Imports neither JAX
nor the JAX package.

    python test_torch_parallel_ranks.py <spec.pkl> <out_dir> <init_method> \
        <world_size> <rank>

The spec is a list of tasks (dicts of numpy arrays and settings, see
`TASKS`); every rank runs every task in order, each on a mesh over the
first T x B ranks of the job, and writes its results ({task name: {key:
numpy array}}) to <out_dir>/rank<rank>.pkl.
"""

import dataclasses
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ovr_tpu_torch import api  # noqa: E402
from ovr_tpu_torch.convert import scene_from_arrays  # noqa: E402
from ovr_tpu_torch.parallel import bricks, multihost, tiles  # noqa: E402
from ovr_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


def _np(t):
    return t.detach().cpu().numpy()


def _setup(task):
    scene = scene_from_arrays(task["scene"], device="cpu")
    cfg = api.RenderConfig(**task["cfg"]).resolved(scene)
    lg = task.get("light_grid")
    return scene, cfg, None if lg is None else torch.from_numpy(lg)


def tiles_frame(task, mesh):
    scene, cfg, lg = _setup(task)
    band = tiles.render_sharded(scene, cfg, mesh, light_grid=lg)
    return {"frame": multihost.gather_frame(band, mesh)}


def tiles_train(task, mesh):
    scene, cfg, _ = _setup(task)
    step = tiles.make_train_step(cfg, mesh, lr=task["lr"],
                                 momentum=task["momentum"])
    state = tiles.init_train_state(scene)
    target = torch.from_numpy(task["target"])
    losses = []
    for _ in range(task["steps"]):
        state, loss = step(state, scene, scene.camera, target)
        losses.append(float(loss))
    out = {f.name: _np(getattr(state, f.name))
           for f in dataclasses.fields(state)}
    return dict(out, loss=np.asarray(losses))


def bricked_frame(task, mesh):
    scene, cfg, lg = _setup(task)
    # this rank holds its own slab only
    bv = bricks.brick_volume(scene.volume, mesh.n_bricks, only=mesh.brick)
    band = bricks.render_bricked(scene, bv, cfg, mesh, light_grid=lg,
                                 use_ring=task.get("ring", True))
    return {"frame": multihost.gather_frame(band, mesh)}


def bricked_train(task, mesh):
    scene, cfg, _ = _setup(task)
    step = bricks.make_train_step_bricked(cfg, mesh, lr=task["lr"])
    bv = bricks.brick_volume(scene.volume, mesh.n_bricks, only=mesh.brick)
    bv2, tfc, tfa, loss = step(bv, scene.tfn.color, scene.tfn.alpha, scene,
                               scene.camera, torch.from_numpy(task["target"]))
    return {"slab": _np(bv2.bricks[0]), "tf_color": _np(tfc),
            "tf_alpha": _np(tfa), "loss": np.asarray(float(loss))}


def gathered(task, mesh):
    """Two ranks of `multihost.global_mesh`: the gathered banded march
    and the same frame rendered on one rank."""
    scene, cfg, _ = _setup(task)
    mesh = multihost.global_mesh(n_bricks=1, device="cpu")
    band = tiles.render_sharded(scene, cfg, mesh)
    return {"frame": multihost.gather_frame(band, mesh),
            "single": _np(api.render(scene, cfg).rgba),
            "transport": np.asarray(mesh.transport)}


TASKS = {f.__name__: f for f in (tiles_frame, tiles_train, bricked_frame,
                                 bricked_train, gathered)}


def main():
    spec, out_dir, init, world, rank = sys.argv[1:6]
    torch.set_num_threads(1)
    multihost.initialize(init, int(world), int(rank), backend="gloo",
                         timeout=240.0)
    with open(spec, "rb") as f:
        tasks = pickle.load(f)
    results = {}
    for task in tasks:
        mesh = make_mesh(*task["mesh"], device="cpu", timeout=240.0)
        if mesh is not None:
            results[task["name"]] = TASKS[task["kind"]](task, mesh)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
