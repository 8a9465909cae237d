"""A CT-like volume: bench.py's seeded field inside an ellipsoidal body,
air (exactly 0) around it.

The body is the ellipsoid centred in the box with semi-axes 0.42, 0.36
and 0.46 of the box along x, y and z; inside it the voxels hold
`bench_field`'s values (0.15 to 1, with its seeded noise), outside
exactly 0, as air reads in a CT. The body is the same for every seed, so
that every seed has the same empty space to skip.
"""

from __future__ import annotations

from ovrbench.content import bench_field

SEMI_AXES = (0.42, 0.36, 0.46)  # of the box, along x, y, z


def inside(x, y, z):
    ax, ay, az = SEMI_AXES
    return (((x - 0.5) / ax) ** 2 + ((y - 0.5) / ay) ** 2
            + ((z - 0.5) / az) ** 2) <= 1.0


def make(dims_zyx, dtype, seed: int, device):
    return bench_field.make(dims_zyx, dtype, seed, device, inside=inside)
