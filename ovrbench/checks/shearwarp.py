"""The check of the shear-warp pipeline (`api.Renderer` -> `shearwarp`
-> the slice kernel -> warp), the default of a configuration without a
`check` key.

`compare`: each held frame (`check.Held`) against the plain float32
shear-warp reference (`reference/shearwarp.py`; the shadow lattice from
`reference/lightgrid.py`, built once per TF) made from the same grid,
TF, camera and light, on the screen pixels that the reference's fan
tiles cover: 16 drawn over the whole fan (one in each cell of a 4 x 4
split) and 48 among the tiles whose rays meet the box of the voxels
that are not 0 (`check.content_box`: a volume is often a body in air, a
small part of the frame). The tiles come from the stream [seed, 4],
drawn in the order of the held frames. The frame is deterministic, so
`n_accumulated` is not read.

`bound`: the slice kernel's least time for each traced view, counted by
`work.py` from the cell's inputs, for `k1_roofline_pct`.
"""

from __future__ import annotations

import numpy as np
import torch

from ovrbench import check, work
from ovrbench.reference import lightgrid, shearwarp


def reference_inputs(ctx, alpha, eye) -> shearwarp.Inputs:
    config, render = ctx.config, ctx.render
    return shearwarp.Inputs(
        grid=ctx.grid, world_lo=tuple(config["world_lo"]),
        world_hi=tuple(config["world_hi"]), color=ctx.color, alpha=alpha,
        value_range=tuple(config["value_range"]), eye=tuple(eye),
        at=tuple(ctx.center), up=tuple(render["up"]), fovy=render["fovy"],
        light_dir=tuple(render["light_direction"]), width=render["width"],
        height=render["height"], sampling_rate=render["sampling_rate"],
        base_rate=ctx.base_rate, shading=ctx.shading)


def compare(held, ctx) -> dict:
    """Hold each record of `held` against the reference. Returns
    {"rgba_err", "checked_px", "errs" (per frame)}."""
    rng = np.random.default_rng([ctx.seed, 4])
    grid, config = ctx.grid, ctx.config
    box = check.content_box(grid, config["world_lo"], config["world_hi"])
    lattices = {}
    errs, counts = [], []
    for h in held:
        lat = None
        if ctx.shading == "shadow":
            key = np.asarray(h.alpha, np.float32).tobytes()
            if key not in lattices:
                lattices[key] = lightgrid.build(
                    grid, config["world_lo"], config["world_hi"], h.alpha,
                    config["value_range"], ctx.base_rate,
                    ctx.render["light_direction"])
            lat = lattices[key]
        frame = shearwarp.Frame(reference_inputs(ctx, h.alpha, h.eye),
                                lattice=lat)
        with torch.no_grad():
            ref, covered = frame.render(frame.tile_origins(rng, box))
        prog = torch.as_tensor(np.asarray(h.rgba), device=grid.device)
        diff = torch.abs(prog.to(torch.float32) - ref)[covered]
        # a NaN or an infinity is as far off as can be
        diff = torch.nan_to_num(diff, nan=float("inf"))
        errs.append(float(diff.max()) if diff.numel() else float("inf"))
        counts.append(int((covered & (ref[..., 3] > 0)).sum()))
    return {"rgba_err": max(errs) if errs else float("inf"),
            "checked_px": min(counts) if counts else 0, "errs": errs}


def bound(ctx, views) -> dict:
    """{view: (least seconds of the slice kernel, "bytes" or
    "operations")} for each traced view's first held record."""
    config, render = ctx.config, ctx.render
    lat_shape = None
    if ctx.shading == "shadow":
        lat_shape = lightgrid.resolution(tuple(ctx.grid.shape))
    out = {}
    for v, h in views.items():
        w = work.count_frame(
            ctx.grid, config["world_lo"], config["world_hi"], h.alpha,
            ctx.value_range, ctx.base_rate, h.eye, ctx.center, render["up"],
            render["fovy"], render["width"], render["height"],
            render["sampling_rate"], ctx.shading, lattice_shape=lat_shape)
        out[v] = work.bound_s(w["samples"], w["bytes"], ctx.shading)
    return out
