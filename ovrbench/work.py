"""The yardstick of the slice kernel's roofline: operations per sample,
the H100's peaks, and the work a frame needs, counted by the benchmark.

The operation table and the peaks are frozen copies of the repository's
`chip_smoke.py` (its `ops_per_sample` and `H100_*` constants, counted
from `ovr_tpu_torch/csrc/swslice.cu`): f32 operations per sample (add,
mul, div, compare/select, min/max, abs, floor and each of expf/log1pf/
rsqrtf count one; a clamp two), without the work shared by a fan row,
column or plane:
  sample: 4 z-lerps (3 each) + 2 row lerps (3) + column lerp (3)     21
  classify: normalize (4), table index (5), 4 channel lerps (13),
            rgb clamp (6)                                           28
  opacity: overlap (6), 1-(1-a)^kk with expf/log1pf (10), the
           nearly-equal branch (3), dt_w > 0 (1)                    20
  composite r, g, b, depth, transmittance                           12
Shaded modes add the gradient (finite differences 7, analytic 12), the
axial term and normal (18), the primary light (7), the shade (10), the
camera-space normal (24) and three more composited channels (6); shadow
adds the lattice read (21) and the shadow factor (4).

The samples a frame needs are counted here, not by the program: the
screen rays of every `stride`-th pixel in each direction are marched at
the configuration's sampling rate through the box (trilinear reads of
the grid, the TF's opacity corrected for the step), and a sample counts
where its opacity is above zero and the ray's transmittance before it is
above 1e-4; the count is scaled by stride^2. Any renderer that gives the
same image has to take these samples. The bytes are those of the voxels
(8 per counted sample, each voxel once), of the lattice texels the
counted samples read in shadow mode, of the TF table, and of the frame
written once (8 float32 channels a pixel): the marked voxels are a union
over the counted rays only, so the bytes too stay a lower bound.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ovrbench.reference.shearwarp import _f32, safe_normalize, storage_scale

H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet, at 700 W
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, at 700 W
T_EPS = 1e-4

OPS_SAMPLE, OPS_COMPOSITE = 21 + 28 + 20, 12
OPS_GRAD = 7  # finite differences: the gradient of every cell's fan
OPS_SHADE, OPS_SHADOW = 18 + 7 + 10 + 24 + 6, 21 + 4
MODE = {"none": 0, "diffuse": 1, "shadow": 2}


def ops_per_sample(shading: str) -> int:
    mode = MODE[shading]
    ops = OPS_SAMPLE + OPS_COMPOSITE
    if mode >= 1:
        ops += OPS_GRAD + OPS_SHADE
    if mode == 2:
        ops += OPS_SHADOW
    return ops


def bound_s(samples: float, nbytes: float, shading: str) -> tuple:
    """(least seconds, "bytes" or "operations") for this work."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = samples * ops_per_sample(shading) / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _trilinear_index(p, dims_xyz):
    """Corner voxel indices (N, 8) (flat, Z-major) and weights (N, 8) of
    object-space points p (N, 3) in [0, 1], half-texel centred, clamped."""
    xd, yd, zd = dims_xyz
    n = torch.tensor([xd, yd, zd], dtype=p.dtype, device=p.device)
    c = torch.clamp(p * n - 0.5, min=0.0)
    c = torch.minimum(c, n - 1.0)
    i0 = torch.floor(c)
    f = c - i0
    i0 = i0.long()
    top = torch.tensor([xd - 1, yd - 1, zd - 1], device=p.device)
    i1 = torch.minimum(i0 + 1, top)
    idx, w = [], []
    for bz in (0, 1):
        for by in (0, 1):
            for bx in (0, 1):
                ix = i1[:, 0] if bx else i0[:, 0]
                iy = i1[:, 1] if by else i0[:, 1]
                iz = i1[:, 2] if bz else i0[:, 2]
                wx = f[:, 0] if bx else 1.0 - f[:, 0]
                wy = f[:, 1] if by else 1.0 - f[:, 1]
                wz = f[:, 2] if bz else 1.0 - f[:, 2]
                idx.append((iz * yd + iy) * xd + ix)
                w.append(wx * wy * wz)
    return torch.stack(idx, 1), torch.stack(w, 1)


def _flat_values(grid):
    """A flat float32-readable view of the grid's raw values."""
    flat = grid.reshape(-1)
    if flat.dtype == torch.uint16:
        return flat.view(torch.int16), True
    return flat, False


def count_frame(grid, world_lo, world_hi, alpha, value_range, base_rate,
                eye, at, up, fovy, width, height, sampling_rate, shading,
                stride: int = 4, lattice_shape=None) -> dict:
    """The samples and bytes one frame needs (module note)."""
    dev = grid.device
    f32 = torch.float32
    lo, hi = _f32(world_lo, dev), _f32(world_hi, dev)
    ext = hi - lo
    frm, tgt, upv = (_f32(x, dev) for x in (eye, at, up))
    direction = safe_normalize(tgt - frm)
    t = 2.0 * math.tan(math.radians(float(fovy)) * 0.5)
    aspect = width / float(height)
    horizontal = t * aspect * safe_normalize(torch.linalg.cross(direction,
                                                                upv))
    vertical = torch.linalg.cross(horizontal, direction) / aspect
    us = (torch.arange(stride // 2, width, stride, dtype=f32, device=dev)
          + 0.5) / width - 0.5
    vs = (torch.arange(stride // 2, height, stride, dtype=f32, device=dev)
          + 0.5) / height - 0.5
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    d = safe_normalize(direction + uu.reshape(-1, 1) * horizontal
                       + vv.reshape(-1, 1) * vertical)
    o = frm.expand_as(d)
    small = torch.abs(d) < 1e-12
    rcp = 1.0 / torch.where(small, torch.ones_like(d), d)
    ta, tb = (lo - o) * rcp, (hi - o) * rcp
    t0 = torch.clamp(torch.minimum(ta, tb).amax(1), min=0.0)
    t1 = torch.maximum(ta, tb).amin(1)
    step = 1.0 / float(sampling_rate)
    alpha_t = _f32(alpha, dev).reshape(-1)
    n_tab = alpha_t.shape[0]
    vr = _f32(value_range, dev)
    gs = storage_scale(grid.dtype)
    zd, yd, xd = grid.shape
    flat, u16 = _flat_values(grid)
    kk = float(base_rate) * step
    trans = torch.ones(d.shape[0], dtype=f32, device=dev)
    tcur = t0 + 0.5 * step
    live = tcur < t1
    samples = torch.zeros((), dtype=torch.float64, device=dev)
    touched = torch.zeros(grid.numel(), dtype=torch.bool, device=dev)
    lat_touched = (None if lattice_shape is None else torch.zeros(
        int(np.prod(lattice_shape)), dtype=torch.bool, device=dev))
    max_steps = int(math.ceil(float(torch.linalg.norm(ext)) / step)) + 2
    for _ in range(max_steps):
        if not bool(live.any()):
            break
        ids = torch.nonzero(live).squeeze(1)
        pos = o[ids] + tcur[ids, None] * d[ids]
        p = (pos - lo) / ext
        idx, w = _trilinear_index(p, (xd, yd, zd))
        raw = flat[idx]
        if u16:
            raw = raw.to(torch.int32) & 0xFFFF
        val = (raw.to(f32) * w).sum(1) * gs
        v = (torch.clamp(val, vr[0], vr[1]) - vr[0]) / (vr[1] - vr[0])
        c = v * (n_tab - 1)
        i0 = torch.clamp(torch.floor(c).long(), 0, n_tab - 1)
        i1 = torch.clamp(i0 + 1, max=n_tab - 1)
        fr = c - i0.to(f32)
        a_tab = alpha_t[i0] * (1.0 - fr) + alpha_t[i1] * fr
        a = 1.0 - torch.exp(kk * torch.log1p(-torch.clamp(a_tab, 0.0,
                                                          1.0 - 1e-7)))
        need = (a > 0.0) & (trans[ids] > T_EPS)
        samples += need.sum()
        touched[idx[need].reshape(-1)] = True
        if lat_touched is not None:
            lz, ly, lx = lattice_shape
            lidx, _ = _trilinear_index(p[need], (lx, ly, lz))
            lat_touched[lidx.reshape(-1)] = True
        trans[ids] = trans[ids] * (1.0 - a)
        tcur = tcur + step
        live = (tcur < t1) & (trans > T_EPS)
    n_samples = float(samples) * stride * stride
    nbytes = (float(touched.sum()) * grid.element_size()
              + n_tab * 4 * 4 + width * height * 8 * 4)
    if lat_touched is not None:
        nbytes += float(lat_touched.sum()) * 4
    return {"samples": n_samples, "bytes": nbytes}
