"""Camera basis, rays, screen projection and optical flow (port of
`ovr_tpu.render.camera`).

direction = normalize(at - from); horizontal = t * aspect *
normalize(cross(direction, up)) with t = 2 tan(fovy/2) (perspective) or
the image-plane height (orthographic); vertical =
cross(horizontal, direction) / aspect. A perspective ray is
normalize(direction + (sx-0.5) horizontal + (sy-0.5) vertical) from the
eye; an orthographic one starts at eye + (sx-0.5) horizontal + (sy-0.5)
vertical along the shared direction.
"""

from __future__ import annotations

import math

import torch

from ovr_tpu_torch.core.sampling import safe_normalize
from ovr_tpu_torch.core.scene import ORTHOGRAPHIC, Camera


def camera_basis(camera: Camera, width: int, height: int):
    """Returns (position (3,), direction (3,), horizontal (3,),
    vertical (3,))."""
    aspect = width / float(height)
    direction = safe_normalize(camera.at - camera.from_)
    if camera.kind == ORTHOGRAPHIC:
        t = camera.height
    else:
        t = 2.0 * torch.tan(camera.fovy * (math.pi / 180.0) * 0.5)
    horizontal = t * aspect * safe_normalize(
        torch.linalg.cross(direction, camera.up))
    vertical = torch.linalg.cross(horizontal, direction) / aspect
    return camera.from_, direction, horizontal, vertical


def pixel_screen_coords(width: int, height: int, dtype=torch.float32,
                        device="cuda") -> torch.Tensor:
    """Normalized screen coords at pixel centers; (H, W, 2) in [0,1]^2."""
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5) / width
    ys = (torch.arange(height, dtype=dtype, device=device) + 0.5) / height
    sy, sx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([sx, sy], dim=-1)


def generate_rays(camera: Camera, screen: torch.Tensor, width: int,
                  height: int):
    """Rays for normalized screen positions `screen` (..., 2). Returns
    (org (..., 3), dir (..., 3)); dir is normalized for perspective."""
    position, direction, horizontal, vertical = camera_basis(camera, width,
                                                             height)
    du = screen[..., 0:1] - 0.5
    dv = screen[..., 1:2] - 0.5
    if camera.kind == ORTHOGRAPHIC:
        org = position + du * horizontal + dv * vertical
        return org, direction.expand(org.shape)
    d = safe_normalize(direction + du * horizontal + dv * vertical)
    return position.expand(d.shape), d


def world_to_camera_normal(camera: Camera, width: int, height: int,
                           n_world: torch.Tensor) -> torch.Tensor:
    """Rotate world-space normals into the camera frame (x = normalized
    horizontal, y = normalized vertical, z = -direction)."""
    _, direction, horizontal, vertical = camera_basis(camera, width, height)
    x = safe_normalize(horizontal)
    y = safe_normalize(vertical)
    z = -direction
    return torch.stack([torch.sum(n_world * x, dim=-1),
                        torch.sum(n_world * y, dim=-1),
                        torch.sum(n_world * z, dim=-1)], dim=-1)


def project_to_screen(camera: Camera, width: int, height: int,
                      p: torch.Tensor) -> torch.Tensor:
    """Project world points onto the normalized screen plane (+0.5 at
    the centre); affine in p (no perspective divide)."""
    position, _, horizontal, vertical = camera_basis(camera, width, height)
    w = p - position
    r2 = torch.sum(horizontal * horizontal)
    t2 = torch.sum(vertical * vertical)
    sx = torch.sum(w * horizontal, dim=-1) / r2
    sy = torch.sum(w * vertical, dim=-1) / t2
    return torch.stack([sx, sy], dim=-1) + 0.5


def optical_flow(camera: Camera, last_camera: Camera, width: int,
                 height: int, p: torch.Tensor) -> torch.Tensor:
    """Screen-space motion of world points p between two camera poses."""
    return (project_to_screen(camera, width, height, p)
            - project_to_screen(last_camera, width, height, p))


def blended_flow(camera: Camera, last_camera: Camera, width: int,
                 height: int, org: torch.Tensor, direction: torch.Tensor,
                 depth_premult: torch.Tensor, alpha: torch.Tensor
                 ) -> torch.Tensor:
    """The alpha-blended optical flow, reconstructed from the
    premultiplied depth: the projection is affine, so sum_i w_i
    flow(p_i) = flow_lin(org * alpha + dir * depth_premult) + (alpha - 1)
    * flow(0). Returns the straight (alpha-divided) flow, 0 where alpha
    is 0."""
    p_sum = org * alpha[..., None] + direction * depth_premult[..., None]
    f_p = optical_flow(camera, last_camera, width, height, p_sum)
    f_0 = optical_flow(camera, last_camera, width, height,
                       torch.zeros_like(org))
    f_premult = f_p + (alpha[..., None] - 1.0) * f_0
    safe = torch.maximum(alpha, alpha.new_full((), 1e-20))[..., None]
    return torch.where(alpha[..., None] > 0, f_premult / safe, 0.0)
