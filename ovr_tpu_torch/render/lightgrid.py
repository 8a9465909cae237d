"""Shadow-alpha lattice by a dense light-axis sweep.

Port of `ovr_tpu.render.lightgrid.build_light_grid_swept`: the lattice's
transmittance obeys a plane-to-plane recurrence along the light's
dominant axis, T(plane k) = shift(T(plane k-1)) * (1 - a(midpoint
sample)), where the shift is the constant lateral drift of the light
direction per plane. Each step is two small resampling products. The
lattice stores alpha = 1 - T at texel centers over the volume's box.
"""

from __future__ import annotations

import numpy as np
import torch

from ovr_tpu_torch.core.sampling import (classify, opacity_correction,
                                         storage_scale)


def _hat(pos: torch.Tensor, n: int) -> torch.Tensor:
    """(len(pos), n) linear-interpolation weights, zero outside [0, n-1]
    unless the caller clamps `pos`."""
    i = torch.arange(n, dtype=pos.dtype, device=pos.device)
    return torch.clamp(1.0 - torch.abs(pos[:, None] - i[None, :]), min=0.0)


def build_light_grid_swept(scene_leaves, light_dir, world_lo, world_hi,
                           res: tuple[int, int, int]) -> torch.Tensor:
    """Shadow-alpha lattice (res_z, res_y, res_x) for a dense grid.

    `scene_leaves` = (grid, color_table, alpha_table, value_range, base);
    `light_dir` points toward the light."""
    grid, color_table, alpha_table, value_range, base = scene_leaves
    ld = light_dir.detach().cpu().numpy().astype(np.float64)
    ld = ld / max(np.linalg.norm(ld), 1e-30)
    axis = int(np.argmax(np.abs(ld)))
    sgn = 1 if ld[axis] >= 0 else -1
    w1, w2 = [w for w in (0, 1, 2) if w != axis]

    dt = world_lo.dtype
    dev = grid.device
    ext_np = (world_hi - world_lo).detach().cpu().numpy().astype(np.float64)
    res_xyz = (res[2], res[1], res[0])
    n_a, n_c, n_r = res_xyz[axis], res_xyz[w1], res_xyz[w2]
    # the volume with the light axis first; sweep index 0 is the
    # light-side face, read through `slab` instead of a flipped copy
    gv = grid.permute(2 - axis, 2 - w2, 2 - w1)
    vz, vr, vc = gv.shape

    def slab(i):
        return gv[vz - 1 - i] if sgn > 0 else gv[i]

    def ar(n):
        return torch.arange(n, dtype=dt, device=dev)

    qc = (ar(n_c) + 0.5) / n_c
    qr = (ar(n_r) + 0.5) / n_r
    drift1 = float(ld[w1] / ld[axis] * ext_np[axis] / ext_np[w1]) * (-sgn)
    drift2 = float(ld[w2] / ld[axis] * ext_np[axis] / ext_np[w2]) * (-sgn)
    dq = 1.0 / n_a
    step_world = torch.tensor(
        float(ext_np[axis]) * dq / max(abs(float(ld[axis])), 1e-12), dtype=dt,
        device=dev)

    # the drift per plane is constant, so every resampling matrix is too:
    # T shifts by a full plane step (open boundary: outside the box the
    # shadow ray sees T = 1), samples sit half a step toward the light
    wc_t = _hat((qc + drift1 * (-dq)) * n_c - 0.5, n_c)
    wr_t = _hat((qr + drift2 * (-dq)) * n_r - 0.5, n_r)
    cover = (wr_t @ torch.ones((n_r, n_c), dtype=dt, device=dev)) @ wc_t.T
    pc = torch.clamp((qc + drift1 * (-0.5 * dq)) * vc - 0.5, 0.0, vc - 1.0)
    pr = torch.clamp((qr + drift2 * (-0.5 * dq)) * vr - 0.5, 0.0, vr - 1.0)
    wc_s = _hat(pc, vc)
    wr_s = _hat(pr, vr)
    gs = storage_scale(grid.dtype)

    t = torch.ones((n_r, n_c), dtype=dt, device=dev)
    planes = []
    for k in range(n_a):
        qa_k = (torch.tensor(float(k), dtype=dt) + 0.5) * dq
        cz = torch.clamp((qa_k - 0.5 * dq) * vz - 0.5, 0.0, vz - 1.0)
        k0 = int(min(max(int(torch.floor(cz)), 0), max(vz - 2, 0)))
        fzz = (cz - k0).to(dev)
        s0 = slab(k0).to(dt)
        s1 = slab(min(k0 + 1, vz - 1)).to(dt)
        plane = (s0 * (1.0 - fzz) + s1 * fzz) * gs
        smp = wr_s @ plane @ wc_s.T
        _, a = classify(color_table, alpha_table, value_range, smp)
        a = opacity_correction(a, base, step_world)
        t = (wr_t @ t @ wc_t.T + (1.0 - cover)) * (1.0 - a)
        planes.append(1.0 - t)
    lat = torch.stack(planes)  # (n_a, n_r, n_c), light face first
    if sgn > 0:
        lat = lat.flip(0)
    inv = np.argsort([2 - axis, 2 - w2, 2 - w1])
    return lat.permute(*[int(i) for i in inv]).contiguous()


def default_resolution(vol_shape, cap: int = 128) -> tuple[int, int, int]:
    """Volume resolution per axis, clamped to [8, cap]."""
    return tuple(int(min(max(d, 8), cap)) for d in vol_shape)
