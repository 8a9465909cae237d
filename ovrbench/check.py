"""The comparison that decides `correct`.

Frames of the measured window are drawn from the seed (a reservoir over
all of them, so every frame is equally likely to be held). After the
window, each held frame's rgba, as `Renderer.mapframe` returned it, is
compared with the reference frame (`reference.shearwarp`) made from the
same grid, TF, camera and light, on the screen pixels that the
reference's fan tiles cover: 16 drawn over the whole fan (one in each
cell of a 4 x 4 split) and 48 among the tiles whose rays meet the box of
the voxels that are not 0 (a volume is often a body in air, a small part
of the frame). The numbers compared, each against its limit in
`limits/<cell>.json`:
- `rgba_err`: the largest absolute difference of any rgba channel over
  the covered pixels of every held frame (at most its limit);
- `checked_px`: the fewest covered pixels with content (the reference's
  alpha above 0) in a held frame (at least its limit), so that a check
  never passes by looking at empty space.
"""

from __future__ import annotations

import numpy as np
import torch

from ovrbench.reference import lightgrid, shearwarp


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


def reference_inputs(grid, config, render, shading, color, alpha,
                     base_rate, eye, center):
    return shearwarp.Inputs(
        grid=grid, world_lo=tuple(config["world_lo"]),
        world_hi=tuple(config["world_hi"]), color=color, alpha=alpha,
        value_range=tuple(config["value_range"]), eye=tuple(eye),
        at=tuple(center), up=tuple(render["up"]), fovy=render["fovy"],
        light_dir=tuple(render["light_direction"]), width=render["width"],
        height=render["height"], sampling_rate=render["sampling_rate"],
        base_rate=base_rate, shading=shading)


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


def compare(held, grid, config, render, shading, color, base_rate, center,
            seed: int) -> dict:
    """Hold each (eye, alpha, rgba) of `held` against the reference.
    Returns {"rgba_err", "checked_px", "errs" (per frame)}."""
    rng = np.random.default_rng([seed, 4])
    box = content_box(grid, config["world_lo"], config["world_hi"])
    lattices = {}
    errs, counts = [], []
    for eye, alpha, rgba in held:
        lat = None
        if shading == "shadow":
            key = np.asarray(alpha, np.float32).tobytes()
            if key not in lattices:
                lattices[key] = lightgrid.build(
                    grid, config["world_lo"], config["world_hi"], alpha,
                    config["value_range"], base_rate,
                    render["light_direction"])
            lat = lattices[key]
        inp = reference_inputs(grid, config, render, shading, color, alpha,
                               base_rate, eye, center)
        frame = shearwarp.Frame(inp, lattice=lat)
        with torch.no_grad():
            ref, covered = frame.render(frame.tile_origins(rng, box))
        prog = torch.as_tensor(np.asarray(rgba), device=grid.device)
        diff = torch.abs(prog.to(torch.float32) - ref)[covered]
        # a NaN or an infinity is as far off as can be
        diff = torch.nan_to_num(diff, nan=float("inf"))
        errs.append(float(diff.max()) if diff.numel() else float("inf"))
        counts.append(int((covered & (ref[..., 3] > 0)).sum()))
    return {"rgba_err": max(errs) if errs else float("inf"),
            "checked_px": min(counts) if counts else 0, "errs": errs}


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
