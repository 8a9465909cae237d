"""The comparison that decides `correct`: what every pipeline's check
shares.

Frames of the measured window (or of the traced plan) are drawn from
the seed: a reservoir over all of them (`Reservoir`), so every frame is
equally likely to be held. Each held frame is a `Held` record: the eye
and the TF alpha it was rendered with, its rgba as `Renderer.mapframe`
returned it, its index `k` in the window or the traced plan, and
`n_accumulated`, the frames the Renderer rendered since the last camera
or TF call, this one included (1 unless the mix accumulates and holds a
view: `frames.py`), counted by the harness from the setter calls it
made.

After the window the configuration's check module (`checks/<check>.py`,
named by the configuration's key `check`, `shearwarp` where it has
none) holds the records against its plain reference:
`compare(held, ctx)` returns {"rgba_err", "checked_px", "errs" (one a
held frame)}, and `verdict` holds those numbers against the cell's
limits (`limits/<cell>.json`):
- `rgba_err`: the largest absolute difference of any rgba channel over
  the checked pixels of every held frame (at most its limit);
- `checked_px`: the fewest checked pixels with content (the reference's
  alpha above 0) in a held frame (at least its limit), so that a check
  never passes by looking at empty space.
`content_box` is for a check module that draws its pixels where the
volume has content.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Held:
    """A frame held for the comparison."""

    eye: tuple
    alpha: np.ndarray
    rgba: np.ndarray
    k: int
    n_accumulated: int


class Reservoir:
    """A uniform sample of k frames of a stream of unknown length."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 3])
        self.items: list = []

    def offer(self, i: int, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = item


def content_box(grid, world_lo, world_hi) -> tuple:
    """World corners of the box of the grid's voxels that are not 0,
    widened by a voxel on each side (what trilinear reads can reach)."""
    raw = grid.view(torch.int16) if grid.dtype == torch.uint16 else grid
    lo, hi = np.asarray(world_lo, np.float64), np.asarray(world_hi, np.float64)
    dims = np.array(grid.shape[::-1])  # x, y, z
    out_lo, out_hi = lo.copy(), lo.copy()
    for a, dim in enumerate((2, 1, 0)):  # x, y, z along grid dims 2, 1, 0
        other = tuple(d for d in (0, 1, 2) if d != dim)
        occ = torch.nonzero((raw != 0).any(dim=other[1]).any(
            dim=other[0])).reshape(-1)
        if occ.numel() == 0:
            return None
        i0, i1 = int(occ.min()) - 1, int(occ.max()) + 2
        cell = (hi[a] - lo[a]) / dims[a]
        out_lo[a] = lo[a] + max(i0, 0) * cell
        out_hi[a] = lo[a] + min(i1, dims[a]) * cell
    return tuple(out_lo), tuple(out_hi)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit, holds)]) for the compared numbers
    against `limits` ({"rgba_err": {"max": x}, "checked_px": {"min": n}})."""
    rows = []
    for name, lim in limits.items():
        v = numbers.get(name)
        if "max" in lim:
            rows.append((name, v, lim["max"], v is not None
                         and v <= lim["max"]))
        else:
            rows.append((name, v, lim["min"], v is not None
                         and v >= lim["min"]))
    return bool(rows) and all(r[3] for r in rows), rows
