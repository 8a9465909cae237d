"""Minimal standalone volume renderer — the embedding surface (port of
`examples/mini_renderer.py`).

Mirror of the reference's `projects/experiment/mini_optix7` /
`mini_ospray` standalone renderers (`README.md:21-23`: "simplified
versions of the main renderer … useful for embedded rendering"): build a
scene from raw arrays, render it with `api.render`, write a PNG, then
take the gradient of a loss with respect to the voxels through torch
autograd — no `api.Renderer` facade, no scene files.

Usage: python -m ovr_tpu_torch.examples.mini_renderer [--device cpu]
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


def make_volume(n: int = 64) -> np.ndarray:
    """The repo's synthetic multi-frequency test volume."""
    ax = np.linspace(0, 1, n, dtype=np.float32)
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    g = 0.5 + 0.35 * np.sin(12 * x) * np.cos(10 * y) * np.sin(8 * z)
    g += 0.15 * np.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2
                         + (z - 0.5) ** 2) * 40)
    return g.astype(np.float32)


def build_scene(grid: np.ndarray, device="cuda") -> Scene:
    """The volume in a [0,1]^3 box + the default rainbow transfer
    function (simple_scene), perspective camera, headlight."""
    scene = simple_scene(grid, device=device)
    return dataclasses.replace(
        scene, camera=Camera.create(from_=(0.5, 0.4, -1.6),
                                    at=(0.5, 0.5, 0.5), fovy=45.0,
                                    device=device))


def render_frame(scene: Scene, width: int = 320, height: int = 240,
                 rate: float = 96.0, shading: str = "diffuse"):
    """(cfg, frame): method="auto" takes the fused shear-warp fast path
    (the slice kernel on the card) when eligible. The frame holds
    premultiplied rgba + gradient/depth channels."""
    cfg = api.RenderConfig(width=width, height=height, sampling_rate=rate,
                           shading=shading, method="auto").resolved(scene)
    with torch.no_grad():
        return cfg, api.render(scene, cfg)


def grid_gradient(scene: Scene, cfg) -> torch.Tensor:
    """d mean(rgba^2) / d grid: the same render is differentiable end to
    end (the slice kernel forward, its analytic adjoint backward)."""
    grid = scene.volume.grid.detach().clone().requires_grad_(True)
    s = dataclasses.replace(
        scene, volume=dataclasses.replace(scene.volume, grid=grid))
    with torch.enable_grad():
        loss = torch.mean(api.render(s, cfg).rgba ** 2)
        (g,) = torch.autograd.grad(loss, grid)
    return g


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("mini_renderer")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(os.path.dirname(__file__),
                                                 "mini_render.png"))
    args = p.parse_args(argv)
    scene = build_scene(make_volume(), args.device)
    cfg, frame = render_frame(scene)
    rgba = frame.rgba.cpu().numpy()
    # composite onto white and save
    save_image(args.out, rgba[..., :3] + (1.0 - rgba[..., 3:4]))
    print(f"wrote {args.out}  (alpha mean {rgba[..., 3].mean():.3f})")
    g = grid_gradient(scene, cfg)
    print(f"d loss / d grid: shape {tuple(g.shape)}, "
          f"|g| {float(g.abs().mean()):.2e}")
    return {"alpha_mean": float(rgba[..., 3].mean()),
            "grad_abs_mean": float(g.abs().mean())}


if __name__ == "__main__":
    main()
