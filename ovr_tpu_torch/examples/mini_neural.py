"""Minimal neural-field volume demo — fit, render, differentiate (port of
`examples/mini_neural.py`).

Mirror of the reference's `projects/experiment/mini_pytorch` /
`mini_tensorrt` NN-in-the-loop examples (`README.md:21-23`) and its
"add neural representation renderer" TODO (`README.md:12`): fit a
hash-grid MLP to a dense volume, render it through the baked-proxy
shear-warp fast path, and take gradients of a render loss with respect
to the network weights — all in torch autograd.

Usage: python -m ovr_tpu_torch.examples.mini_neural [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ovr_tpu_torch import api
from ovr_tpu_torch.core.scene import Camera, Scene, simple_scene
from ovr_tpu_torch.io.image import save_image
from ovr_tpu_torch.neural.field import NeuralFieldVolume, init_field
from ovr_tpu_torch.neural.hashgrid import HashGridConfig
from ovr_tpu_torch.neural.train import bake_grid_host, fit_to_grid

GRID_CFG = HashGridConfig(n_levels=8, max_resolution=64)


def make_target(n: int = 48) -> np.ndarray:
    """The dense synthetic volume the field is fitted to."""
    ax = np.linspace(0, 1, n, dtype=np.float32)
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    return (0.5 + 0.4 * np.sin(9 * x) * np.cos(7 * y) * np.sin(5 * z)
            ).astype(np.float32)


def fit(field: NeuralFieldVolume, target: np.ndarray, steps: int = 200,
        batch: int = 1 << 12, lr: float = 5e-3, draws=None):
    """Fit the field to the target by random point sampling (in place);
    returns the losses (steps,)."""
    grid = torch.from_numpy(target).to(field.tables.device)
    _, losses = fit_to_grid(field, grid, steps=steps, batch=batch, lr=lr,
                            draws=draws)
    return losses


def field_scene(field: NeuralFieldVolume, target: np.ndarray) -> Scene:
    """The target's TF and box template with the FIELD (not the target)
    as the volume."""
    dev = field.tables.device
    scene = simple_scene(target, device=dev)
    return dataclasses.replace(
        scene, volume=field,
        camera=Camera.create(from_=(0.5, 0.4, -1.5), at=(0.5, 0.5, 0.5),
                             fovy=45.0, device=dev))


def render_field(scene: Scene, width: int = 160, height: int = 120,
                 rate: float = 48.0, proxy_res: int = 64):
    """(cfg, frame) of the field through its baked proxy on the
    shear-warp fast path (the slice kernel on the card)."""
    cfg = api.RenderConfig(width=width, height=height, sampling_rate=rate,
                           shading="diffuse", method="auto",
                           neural_proxy_res=proxy_res).resolved(scene)
    proxy = bake_grid_host(scene.volume, (proxy_res,) * 3)
    with torch.no_grad():
        return cfg, api.render(scene, cfg, proxy_grid=proxy)


def weight_gradients(scene: Scene, cfg):
    """d mean(rgba^2) / d (tables, weights): `api.render` bakes the
    proxy inside the autograd graph, so the whole chain differentiates
    (render -> proxy bake -> MLP). Returns (tables' gradient, [(dW,
    db), ...])."""
    field = scene.volume
    params = [field.tables] + [x for wb in field.weights for x in wb]
    with torch.enable_grad():
        loss = torch.mean(api.render(scene, cfg).rgba ** 2)
        grads = torch.autograd.grad(loss, params)
    return grads[0], [tuple(grads[1 + 2 * i:3 + 2 * i])
                      for i in range(len(field.weights))]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("mini_neural")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(os.path.dirname(__file__),
                                                 "mini_neural.png"))
    args = p.parse_args(argv)
    target = make_target()
    field = init_field(0, GRID_CFG, hidden=32, n_hidden=2,
                       device=args.device)
    losses = fit(field, target)
    print(f"fit: loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f}")
    scene = field_scene(field, target)
    cfg, frame = render_field(scene)
    rgba = frame.rgba.cpu().numpy()
    save_image(args.out, rgba[..., :3] + (1.0 - rgba[..., 3:4]))
    print(f"wrote {args.out}  (alpha mean {rgba[..., 3].mean():.3f})")
    _, g_w = weight_gradients(scene, cfg)
    g0 = g_w[0][0]
    print(f"d loss / d W0: shape {tuple(g0.shape)}, "
          f"|g| {float(g0.abs().mean()):.2e}")
    return {"loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "alpha_mean": float(rgba[..., 3].mean()),
            "grad_w0_abs_mean": float(g0.abs().mean())}


if __name__ == "__main__":
    main()
