"""Camera basis and screen coordinates (port of `ovr_tpu.render.camera`).

direction = normalize(at - from); horizontal = t * aspect *
normalize(cross(direction, up)) with t = 2 tan(fovy/2) (perspective) or
the image-plane height (orthographic); vertical =
cross(horizontal, direction) / aspect.
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
