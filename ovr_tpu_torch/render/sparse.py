"""Foveated sparse sampling: keep probability and a fixed budget of rays
(port of `ovr_tpu.render.sparse`).

Each pixel's keep probability is
    p = (1 - base) * exp(-0.5 r^2 / sigma^2) + base
around a focus centre; a noise value per pixel (tiled spatio-temporal
blue noise, or uniform) divided by p ranks the pixels, and the `budget`
best-ranked are rendered, in that order, and scattered into the previous
frame. A fixed budget keeps the launch size static, as in the JAX
package. Ties rank by the lower pixel index, as `jax.lax.top_k` ranks
them: the 128^2 blue-noise tile repeats across the frame and p is
symmetric about the focus, so scores do tie, and `torch.topk` promises
no order among them; a stable sort does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ovr_tpu_torch.render.bluenoise import _R2, void_and_cluster

STBN_SIZE = 128
STBN_FRAMES = 64


@dataclasses.dataclass(frozen=True)
class FocusParams:
    """Sparse-sampling focus: `center` (2,) in [0, 1]^2, `scale` the
    Gaussian's sigma, `base_noise` the background keep probability."""

    center: Any
    scale: Any
    base_noise: Any

    @staticmethod
    def create(center=(0.5, 0.5), scale=0.2, base_noise=0.1,
               device="cuda") -> "FocusParams":
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        return FocusParams(center=f32(center), scale=f32(scale),
                           base_noise=f32(base_noise))


def keep_probability(width: int, height: int, focus: FocusParams
                     ) -> torch.Tensor:
    """Per-pixel keep probability, (H, W)."""
    dev = focus.center.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    ys = (torch.arange(height, dtype=torch.float32, device=dev)
          + 0.5) / height
    sy, sx = torch.meshgrid(ys, xs, indexing="ij")
    r2 = (sx - focus.center[0]) ** 2 + (sy - focus.center[1]) ** 2
    sigma2 = focus.scale * focus.scale
    return ((1.0 - focus.base_noise)
            * torch.exp(-0.5 * r2 / torch.clamp(sigma2, min=1e-12))
            + focus.base_noise)


_BN_BASE: dict = {}


def _blue_noise_base(device) -> torch.Tensor:
    """The void-and-cluster threshold matrix (built once, disk-cached)."""
    key = str(device)
    if key not in _BN_BASE:
        _BN_BASE[key] = torch.from_numpy(
            void_and_cluster(STBN_SIZE)).to(device)
    return _BN_BASE[key]


def _stbn_tile(frame_index: int, device) -> torch.Tensor:
    """The frame's slice of the spatio-temporal stack: the blue-noise
    tile shifted toroidally along the R2 sequence (in float32, as the
    JAX package computes the shift)."""
    f = torch.tensor(float(frame_index), dtype=torch.float32) % STBN_FRAMES
    ox = int(torch.floor((f * _R2[0]) % 1.0 * STBN_SIZE))
    oy = int(torch.floor((f * _R2[1]) % 1.0 * STBN_SIZE))
    return torch.roll(_blue_noise_base(device), (oy, ox), dims=(0, 1))


def sample_noise(generator: Optional[torch.Generator], width: int,
                 height: int, frame_index: int, noise: str = "stbn",
                 device="cuda") -> torch.Tensor:
    """(H, W) noise in [0, 1): the tiled spatio-temporal blue noise, or
    "uniform" numbers from `generator` (drawn on its device)."""
    if noise == "uniform":
        return torch.rand((height, width), generator=generator,
                          device=generator.device).to(device)
    tile = _stbn_tile(frame_index, device)
    ty = torch.arange(height, device=device) % STBN_SIZE
    tx = torch.arange(width, device=device) % STBN_SIZE
    return tile[ty[:, None], tx[None, :]]


def select_samples(generator, width: int, height: int, focus: FocusParams,
                   frame_index: int, budget: int,
                   noise: str = "stbn") -> torch.Tensor:
    """The `budget` flat pixel indices (y * W + x) of lowest noise / p,
    in that order, ties by the lower index, on the focus's device. The
    scores are computed and sorted on the host in float32, so a scene on
    the card and its copy on the CPU march the same rays: the card's
    expf and the CPU's round some values apart by an ulp, which reorders
    scores that are that close."""
    host = FocusParams(*(t.detach().cpu() for t in (
        focus.center, focus.scale, focus.base_noise)))
    p = keep_probability(width, height, host)
    n = sample_noise(generator, width, height, frame_index, noise,
                     device="cpu")
    score = n / torch.clamp(p, min=1e-12)
    idx = torch.sort(score.reshape(-1), stable=True).indices[:budget]
    return idx.to(focus.center.device)


def scatter_to_frame(prev: torch.Tensor, idx: torch.Tensor,
                     values: torch.Tensor) -> torch.Tensor:
    """`prev` (H, W, C) with the rows (B, C) of `values` written at the
    flat indices `idx`."""
    h, w, c = prev.shape
    return prev.reshape(-1, c).index_put((idx,), values).reshape(h, w, c)


def render_sparse(scene, cfg, camera=None,
                  focus: Optional[FocusParams] = None, frame_index: int = 0,
                  generator: Optional[torch.Generator] = None,
                  prev_frame=None, budget: Optional[int] = None,
                  macrocells=None, noise: str = "stbn"):
    """A sparse march frame: `budget` rays (default W*H/8) marched and
    scattered into `prev_frame` (or a black frame). Returns (Frame, the
    flat sample indices). `generator` draws the "uniform" noise (default:
    one seeded with 0)."""
    from ovr_tpu_torch import api
    from ovr_tpu_torch.render import integrator as ig
    from ovr_tpu_torch.render.camera import generate_rays

    if cfg.max_steps is None:
        raise ValueError("call cfg.resolved(scene) first")
    dev = scene.device
    dt = cfg.dtype
    if camera is None:
        camera = scene.camera
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    if focus is None:
        focus = FocusParams.create(device=dev)
    if budget is None:
        budget = max(cfg.width * cfg.height // 8, 1)

    idx = select_samples(generator, cfg.width, cfg.height, focus,
                         frame_index, budget, noise)
    ix = (idx % cfg.width).to(dt)
    iy = (idx // cfg.width).to(dt)
    screen = torch.stack([(ix + 0.5) / cfg.width, (iy + 0.5) / cfg.height],
                         -1)
    org, direction = generate_rays(camera, screen, cfg.width, cfg.height)
    ctx = api._shade_ctx(scene, camera, cfg)
    march_fn = ig.march_while if cfg.fast_math else ig.march
    color, grad, depth, alpha = march_fn(
        org, direction, api._leaves(scene, cfg), ctx,
        ig.MarchConfig(max_steps=cfg.max_steps, shading=cfg.shading,
                       shadow_scale=cfg.shadow_scale,
                       shadow_max_steps=cfg.shadow_max_steps or 1),
        api._step(cfg, dev),
        occupancy=macrocells if cfg.use_macrocells else None)
    color, grad, depth, alpha = ig.finalize(color, grad, depth, alpha)
    rgba = torch.cat([color, alpha[:, None]], -1)

    h, w = cfg.height, cfg.width
    if prev_frame is None:
        prev_rgba = torch.zeros((h, w, 4), dtype=dt, device=dev)
        prev_grad = torch.zeros((h, w, 3), dtype=dt, device=dev)
        prev_depth = torch.zeros((h, w), dtype=dt, device=dev)
    else:
        prev_rgba, prev_grad = prev_frame.rgba, prev_frame.grad
        prev_depth = (prev_frame.depth if prev_frame.depth is not None
                      else torch.zeros((h, w), dtype=dt, device=dev))
    return api.Frame(
        rgba=scatter_to_frame(prev_rgba, idx, rgba),
        grad=scatter_to_frame(prev_grad, idx, grad),
        depth=scatter_to_frame(prev_depth[..., None], idx,
                               depth[:, None])[..., 0]), idx
