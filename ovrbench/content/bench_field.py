"""bench.py's synthetic field, made on the device, with seeded noise.

The field is a frozen copy of the arithmetic of the repository's
`bench.py` (as `ovr_tpu_torch/bench.py:field_on_device` builds it on the
card), on linspace(0, 1, n) along each axis:

    g = 0.5 + 0.35 sin(12 x) cos(10 y) sin(8 z)
            + 0.15 exp(-40 |(x, y, z) - 0.5|^2)

plus uniform noise in [-NOISE, NOISE] drawn from the seed by a
`torch.Generator` on the grid's device (a scanner's or a solver's noise
floor), clamped to [0, 1]. The seed changes every voxel but not where
the field is dense or empty, so every seed asks the renderer for the
same work. Dense everywhere (0.15 to 1), like a mixing layer. Made in
slabs of Z planes, straight into the storage type, so that no full-size
float32 temporary exists beside a 16-bit grid.
"""

from __future__ import annotations

import torch

SLAB = 64  # Z planes made at a time
NOISE = 1e-3


def values(x, y, z):
    """The field at broadcastable float32 coordinates."""
    g = 0.5 + 0.35 * torch.sin(12 * x) * torch.cos(10 * y) * torch.sin(8 * z)
    return g + 0.15 * torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2
                                  + (z - 0.5) ** 2) * 40)


def store(g, dtype):
    """A [0, 1] float32 field in the storage type: 16-bit as
    round(g * 65535)."""
    if dtype == torch.uint16:
        return torch.clamp(torch.round(g * 65535.0), 0, 65535).to(dtype)
    return g.to(dtype)


def make(dims_zyx, dtype, seed: int, device, inside=None) -> torch.Tensor:
    """The (Z, Y, X) grid in `dtype` on `device`. `inside(x, y, z)`, if
    given, is a bool mask of the voxels that keep the field; the others
    are 0 (no noise)."""
    nz, ny, nx = dims_zyx
    f32 = torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x = torch.linspace(0, 1, nx, dtype=f32, device=device)[None, None, :]
    y = torch.linspace(0, 1, ny, dtype=f32, device=device)[None, :, None]
    zs = torch.linspace(0, 1, nz, dtype=f32, device=device)[:, None, None]
    grid = torch.empty((nz, ny, nx), dtype=dtype, device=device)
    for k in range(0, nz, SLAB):
        z = zs[k:k + SLAB]
        g = values(x, y, z)
        noise = torch.rand(g.shape, generator=gen, dtype=f32, device=device)
        g = torch.clamp(g + (2.0 * noise - 1.0) * NOISE, 0.0, 1.0)
        if inside is not None:
            g = torch.where(inside(x, y, z), g, 0.0)
        grid[k:k + SLAB] = store(g, dtype)
    return grid
