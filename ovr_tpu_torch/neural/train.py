"""Training loops and bakes for neural-field volumes (port of
`ovr_tpu.neural.train`).

1. `fit_to_grid` compresses a dense grid into the field by sampling
   random points (the reference's planned instant-vnr objective).
2. `make_image_train_step` is inverse rendering: the field is optimised
   so that its rendered frames match targets, gradients flowing through
   the whole render.
3. `bake_grid` (differentiable, chunked) and `bake_grid_host` (slab by
   slab, no gradient) evaluate the field on a voxel-centre lattice: the
   shear-warp proxy, the macrocell bake, export to a dense grid.

Both loops use `torch.optim.Adam(lr)`, whose defaults (betas (0.9,
0.999), eps 1e-8) are optax.adam's, and update the field's parameters in
place.
"""

from __future__ import annotations

import torch

from ovr_tpu_torch.core.sampling import clip, sample_volume
from ovr_tpu_torch.neural.field import NeuralFieldVolume, field_sample
from ovr_tpu_torch.neural.losses import LOSSES


def fit_to_grid(field: NeuralFieldVolume, grid: torch.Tensor, *,
                steps: int = 500, batch: int = 1 << 14, lr: float = 1e-2,
                loss: str = "l2", draws=None):
    """Fit the field to a dense (Z, Y, X) grid by random point sampling;
    step k trains on `draws.fold_in(k).uniform((batch, 3))` points
    (`render.pathtracer.Draws`; default: a `torch.Generator` on the
    field's device seeded with 0, read in order).

    Returns (field, losses (steps,)): the field trained in place and the
    loss of each step before its update."""
    from ovr_tpu_torch.render.pathtracer import GeneratorDraws

    dev = field.tables.device
    if draws is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        draws = GeneratorDraws(gen)
    loss_fn = LOSSES[loss]
    params = [q.requires_grad_(True) for q in field.parameters()]
    opt = torch.optim.Adam(params, lr=lr)
    losses = torch.empty(steps, device=dev)
    for k in range(steps):
        p = draws.fold_in(k).uniform((batch, 3), torch.float32, dev)
        with torch.no_grad():
            target = sample_volume(grid, p)
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            value = loss_fn(field_sample(field, p), target)
        value.backward()
        opt.step()
        losses[k] = value.detach()
    return field, losses


def make_image_train_step(scene, cfg, *, lr: float = 1e-2,
                          loss: str = "l2"):
    """Inverse rendering step: optimise the neural field `scene.volume`
    so that `api.render(scene, cfg, camera=camera)` matches a target
    frame (H, W, 4).

    Returns (step(state, camera, target) -> (state, loss), state0): the
    state is (the field's parameters, their Adam optimiser); a step
    updates them in place and returns the loss before the update."""
    from ovr_tpu_torch import api

    field: NeuralFieldVolume = scene.volume
    loss_fn = LOSSES[loss]
    params = tuple(q.requires_grad_(True) for q in field.parameters())
    state0 = (params, torch.optim.Adam(params, lr=lr))

    def step(state, camera, target):
        _, opt = state
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            frame = api.render(scene, cfg, camera=camera)
            value = loss_fn(frame.rgba, target)
        value.backward()
        opt.step()
        return state, value.detach()

    return step, state0


def _centers(n: int, device) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n


def _lattice(zs, ys, xs) -> torch.Tensor:
    """(len(zs) * len(ys) * len(xs), 3) points (x, y, z), x fastest."""
    pz, py, px = torch.meshgrid(zs, ys, xs, indexing="ij")
    return torch.stack([px, py, pz], dim=-1).reshape(-1, 3)


def bake_grid(field: NeuralFieldVolume, dims: tuple[int, int, int],
              chunk: int = 1 << 16) -> torch.Tensor:
    """Evaluate the field on an (X, Y, Z) = `dims` voxel-centre lattice,
    `chunk` points at a time; returns the (Z, Y, X) grid. Differentiable:
    under grad with parameters that require it, autograd keeps every
    chunk's activations."""
    x, y, z = dims
    dev = field.tables.device
    p = _lattice(_centers(z, dev), _centers(y, dev), _centers(x, dev))
    out = torch.cat([field_sample(field, p[i:i + chunk])
                     for i in range(0, p.shape[0], chunk)])
    return out.reshape(z, y, x)


def bake_grid_host(field: NeuralFieldVolume, dims: tuple[int, int, int],
                   max_slab_points: int = 1 << 24) -> torch.Tensor:
    """`bake_grid` slab by slab along z, `max_slab_points // (X * Y)`
    planes at a time (the last slab padded with planes clipped to z = 1
    and cut off), without a gradient: the bake `Renderer.commit` caches.
    A slab of 16.7 M points holds about 10 GB of activations. A slab is
    never deeper than the lattice (the JAX package pads a small lattice
    up to `max_slab_points` and discards the padding)."""
    x, y, z = dims
    dev = field.tables.device
    zs_per = min(z, max(1, max_slab_points // (x * y)))
    xs, ys = _centers(x, dev), _centers(y, dev)
    out = torch.empty((z, y, x), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for z0 in range(0, z, zs_per):
            zs = clip((torch.arange(z0, z0 + zs_per, dtype=torch.float32,
                                    device=dev) + 0.5) / z, 0.0, 1.0)
            slab = field_sample(field, _lattice(zs, ys, xs))
            n = min(zs_per, z - z0)
            out[z0:z0 + n] = slab.reshape(zs_per, y, x)[:n]
    return out
