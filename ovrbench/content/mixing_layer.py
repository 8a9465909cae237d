"""A Richtmyer-Meshkov-like mixing layer in 8 bits, made on the device.

Two pure fluids, both exactly 0, meet at a perturbed interface

    z = h(x, y) = 0.5 + sum_k a_k sin(2 pi (p_k x) + u_k) sin(2 pi (q_k y) + v_k)

(a few fixed 2-D modes: the bubbles and spikes the shock leaves), with
x, y, z on linspace(0, 1, n) along each axis. Around it lies the mixing
layer, |z - h| < HALF_WIDTH (0.2 of the height). Inside the layer:

    g = taper (0.3 + f),  taper = 1 - ((z - h) / HALF_WIDTH)^2,

clamped to [0, 1], where f in [0, 1] is a fixed sum of OCTAVES octaves of
sinusoids in x, y and the distance z - h from the interface (so the
structure follows the interface), stored as round(g * 255) plus seeded
noise of -1, 0 or +1 step, clamped to 1..255. Outside the layer every
voxel is 0, with no noise: the pure fluids are empty space for the
renderer to skip. The seed moves voxels inside the layer but never the
zero set, so every seed asks for the same work.

The grid is made in slabs of SLAB planes along z, straight into `uint8`:
no float32 temporary is larger than one slab (at 2048 x 2048 x 1920 a
float32 copy of the grid would be 32 GB). The dataset itself (the
entropy field of LLNL's simulation) is not in the repository.
"""

from __future__ import annotations

import math

import torch

SLAB = 16  # z planes made at a time
HALF_WIDTH = 0.2  # of the height, on each side of the interface
# the interface's modes: amplitude, x and y wave numbers, x and y phases
MODES = ((0.060, 2.0, 3.0, 0.3, 1.1),
         (0.040, 5.0, 4.0, 2.0, 0.7),
         (0.025, 9.0, 7.0, 0.4, 2.5))
# the layer's structure: wave numbers along x, y and z - h, and phases
OCTAVES = ((5.0, 4.0, 9.0, 0.2, 1.3, 0.5),
           (11.0, 13.0, 21.0, 2.1, 0.4, 1.7),
           (23.0, 19.0, 43.0, 1.2, 2.8, 0.9),
           (47.0, 41.0, 83.0, 0.6, 1.9, 2.2))


def interface(x, y):
    """h(x, y) at broadcastable float32 coordinates."""
    h = torch.full(torch.broadcast_shapes(x.shape, y.shape), 0.5,
                   dtype=x.dtype, device=x.device)
    for a, p, q, u, v in MODES:
        h = h + a * torch.sin(2 * math.pi * p * x + u) * torch.sin(
            2 * math.pi * q * y + v)
    return h


def structure(x, y, d):
    """f in [0, 1] at x, y and the distance d = z - h (broadcastable)."""
    f, total = 0.0, 0.0
    for o, (kx, ky, kd, px, py, pd) in enumerate(OCTAVES):
        w = 0.5 ** o
        f = f + w * (torch.sin(kx * x + px) * torch.sin(ky * y + py)
                     * torch.sin(kd * d + pd))
        total += w
    return 0.5 + 0.5 * f / total


def make(dims_zyx, dtype, seed: int, device) -> torch.Tensor:
    """The (Z, Y, X) `uint8` grid on `device` (`dtype` must be uint8)."""
    if dtype != torch.uint8:
        raise ValueError(f"the mixing layer is stored as uint8, not {dtype}")
    nz, ny, nx = dims_zyx
    f32 = torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x = torch.linspace(0, 1, nx, dtype=f32, device=device)[None, None, :]
    y = torch.linspace(0, 1, ny, dtype=f32, device=device)[None, :, None]
    zs = torch.linspace(0, 1, nz, dtype=f32, device=device)[:, None, None]
    h = interface(x, y)  # (1, Y, X)
    grid = torch.empty((nz, ny, nx), dtype=torch.uint8, device=device)
    for k in range(0, nz, SLAB):
        d = zs[k:k + SLAB] - h
        inside = torch.abs(d) < HALF_WIDTH
        taper = 1.0 - (d / HALF_WIDTH) ** 2
        g = torch.clamp(taper * (0.3 + structure(x, y, d)), 0.0, 1.0)
        noise = torch.floor(3.0 * torch.rand(g.shape, generator=gen,
                                             dtype=f32, device=device))
        v = torch.clamp(torch.round(g * 255.0) + noise - 1.0, 1.0, 255.0)
        grid[k:k + SLAB] = torch.where(inside, v, 0.0).to(torch.uint8)
    return grid
