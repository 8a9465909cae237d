"""Screen-row-band rendering and the replicated distributed train step
(port of `ovr_tpu.parallel.tiles`).

A frame is embarrassingly parallel over pixels, so each rank of the
`tiles` axis renders one band of screen rows; the forward needs no
communication until the frame is assembled (`multihost.gather_frame`).
With a shear-warp plan each band composites its own ray fan, shrunk to
the band's footprint (`render_shearwarp(..., row0=, n_rows=)`), so a
rank launches the slice kernel once per frame on its band. The train
step renders the band, takes the local loss over the global pixel count,
and all-reduces the loss and every parameter gradient over the mesh
before an SGD-with-momentum update that every rank applies alike.

Functions return this rank's band (rows [row0, row0 + H / n_tiles) of
the frame), where the JAX package returns a row-sharded global array.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ovr_tpu_torch import api
from ovr_tpu_torch.core.scene import Camera, Scene
from ovr_tpu_torch.parallel.mesh import Mesh
from ovr_tpu_torch.render import integrator as ig
from ovr_tpu_torch.render import shearwarp
from ovr_tpu_torch.render.camera import generate_rays, pixel_screen_coords


def bands(height: int, mesh: Mesh) -> tuple[int, int]:
    """(row0, rows) of this rank's band of screen rows."""
    if height % mesh.n_tiles:
        raise ValueError("height must divide evenly over tiles")
    hb = height // mesh.n_tiles
    return mesh.tile * hb, hb


def band_cfg(cfg: api.RenderConfig, n_tiles: int) -> api.RenderConfig:
    """The plan of one band: the fan's rows shrunk to
    rnd8(max(64, inter_h // n_tiles))."""
    inter_h = max(8, -(-max(64, cfg.sw.inter_h // n_tiles) // 8) * 8)
    return dataclasses.replace(cfg, sw=dataclasses.replace(
        cfg.sw, inter_h=inter_h))


def march_cfg(cfg: api.RenderConfig) -> ig.MarchConfig:
    """The march settings the multi-device paths use (the JAX package's
    tiles and bricks modules: no adaptive steps)."""
    return ig.MarchConfig(
        max_steps=cfg.max_steps, shading=cfg.shading,
        shadow_scale=cfg.shadow_scale,
        shadow_max_steps=cfg.shadow_max_steps or 1)


def _rgba(color, grad, depth, alpha, rows: int, width: int):
    color, _, _, alpha = ig.finalize(color, grad, depth, alpha)
    return torch.cat([color, alpha[..., None]], -1).reshape(rows, width, 4)


def _render_rows(scene: Scene, camera: Camera, cfg: api.RenderConfig,
                 screen_rows: torch.Tensor) -> torch.Tensor:
    """The march's rgba for a block of screen rows (rows, W, 2) ->
    (rows, W, 4)."""
    h, w = screen_rows.shape[:2]
    org, direction = generate_rays(camera, screen_rows.reshape(-1, 2),
                                   cfg.width, cfg.height)
    out = ig.march(org, direction, api._leaves(scene, cfg),
                   api._shade_ctx(scene, camera, cfg), march_cfg(cfg),
                   api._step(cfg, org.device))
    return _rgba(*out, h, w)


def _screen_rows(cfg: api.RenderConfig, mesh: Mesh) -> torch.Tensor:
    row0, hb = bands(cfg.height, mesh)
    return pixel_screen_coords(cfg.width, cfg.height, cfg.dtype,
                               mesh.device)[row0:row0 + hb]


def render_sharded(scene: Scene, cfg: api.RenderConfig, mesh: Mesh,
                   camera: Optional[Camera] = None,
                   light_grid=None) -> torch.Tensor:
    """This rank's band (H / n_tiles, W, 4) of the frame, rows split over
    the tile axis (cfg.height % n_tiles == 0). Takes the shear-warp path
    when cfg carries a plan (cfg.sw), else the march."""
    if camera is None:
        camera = scene.camera
    if cfg.sw is not None:
        return render_sharded_shearwarp(scene, cfg, mesh, camera,
                                        light_grid)
    return _render_rows(scene, camera, cfg, _screen_rows(cfg, mesh))


def render_sharded_shearwarp(scene: Scene, cfg: api.RenderConfig,
                             mesh: Mesh, camera: Optional[Camera] = None,
                             light_grid=None) -> torch.Tensor:
    """Shear-warp on this rank's band of screen rows: its own fan, shrunk
    to the band (`band_cfg`), composited and warped locally; no
    communication, the volume replicated. Shadow shading needs
    `light_grid` (without one it shades as diffuse, as in the JAX
    package)."""
    if camera is None:
        camera = scene.camera
    row0, hb = bands(cfg.height, mesh)
    out = shearwarp.render_shearwarp(
        scene, band_cfg(cfg, mesh.n_tiles), camera, light_grid=light_grid,
        row0=row0, n_rows=hb)
    return _rgba(*out, hb, cfg.width)


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Optimizable scene parameters and their SGD momentum."""

    grid: torch.Tensor
    tf_color: torch.Tensor
    tf_alpha: torch.Tensor
    m_grid: torch.Tensor
    m_color: torch.Tensor
    m_alpha: torch.Tensor


def init_train_state(scene: Scene) -> TrainState:
    z = torch.zeros_like
    return TrainState(
        grid=scene.volume.grid, tf_color=scene.tfn.color,
        tf_alpha=scene.tfn.alpha, m_grid=z(scene.volume.grid),
        m_color=z(scene.tfn.color), m_alpha=z(scene.tfn.alpha))


def _apply_params(scene: Scene, grid, tf_color, tf_alpha) -> Scene:
    volume = dataclasses.replace(scene.volume, grid=grid)
    tfn = dataclasses.replace(scene.tfn, color=tf_color, alpha=tf_alpha)
    return dataclasses.replace(scene, volume=volume, tfn=tfn)


def make_train_step(cfg: api.RenderConfig, mesh: Mesh, lr: float = 1e-2,
                    momentum: float = 0.9):
    """A distributed train step: render this rank's band, L2 loss against
    the target over the global pixel count, all-reduce the loss and the
    gradients of the grid and both TF tables over the mesh, then SGD with
    momentum (TF tables clipped to [0, 1]).

    Returns step(state, scene, camera, target) -> (state, loss); `target`
    is the whole (H, W, 4) frame (each rank reads its band), parameters
    and the returned state are the same on every rank."""
    row0, hb = bands(cfg.height, mesh)
    cfg_band = band_cfg(cfg, mesh.n_tiles) if cfg.sw is not None else None

    def local_loss(scene, camera, target_rows):
        if cfg.sw is not None:
            # the banded shear-warp through the slice loop's adjoint
            out = shearwarp.render_shearwarp(scene, cfg_band, camera,
                                             row0=row0, n_rows=hb)
            rgba = _rgba(*out, hb, cfg.width)
        else:
            rgba = _render_rows(scene, camera, cfg, _screen_rows(cfg, mesh))
        return torch.sum((rgba - target_rows) ** 2) / (
            cfg.height * cfg.width * 4)

    def step(state: TrainState, scene: Scene, camera: Camera,
             target: torch.Tensor):
        leaves = [t.detach().requires_grad_(True)
                  for t in (state.grid, state.tf_color, state.tf_alpha)]
        with torch.enable_grad():
            loss = local_loss(_apply_params(scene, *leaves), camera,
                              target[row0:row0 + hb])
            grads = torch.autograd.grad(loss, leaves)
        # every rank ends with the global loss and gradients
        loss = mesh.all_reduce(loss.detach())
        g_grid, g_color, g_alpha = (mesh.all_reduce(g) for g in grads)
        m_grid = momentum * state.m_grid + g_grid
        m_color = momentum * state.m_color + g_color
        m_alpha = momentum * state.m_alpha + g_alpha
        return TrainState(
            grid=state.grid - lr * m_grid,
            tf_color=torch.clamp(state.tf_color - lr * m_color, 0.0, 1.0),
            tf_alpha=torch.clamp(state.tf_alpha - lr * m_alpha, 0.0, 1.0),
            m_grid=m_grid, m_color=m_color, m_alpha=m_alpha), loss

    return step
