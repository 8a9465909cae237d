"""Plain shadow lattice for the reference frame.

The lattice holds, at each texel centre of a (res_z, res_y, res_x) grid
over the volume's box, the alpha that a ray toward the light gathers.
Along the light's dominant axis its transmittance obeys a plane-to-plane
recurrence: T(plane k) = shift(T(plane k - 1)) * (1 - a(k)), where the
shift is the light's constant lateral drift per plane (outside the box T
is 1) and a(k) is the opacity-corrected TF alpha of the volume sampled
half a plane toward the light. Each step is two linear-interpolation
products; float32 products run without TF32. The resolution per axis is
the volume's clamped to [8, cap] with cap = clamp(max(shape) / 4, 128,
512).
"""

from __future__ import annotations

import numpy as np
import torch

from ovrbench.reference.shearwarp import _f32, safe_normalize, storage_scale


def resolution(shape) -> tuple:
    cap = min(512, max(128, max(shape) // 4))
    return tuple(int(min(max(d, 8), cap)) for d in shape)


def _hat(pos, n):
    i = torch.arange(n, dtype=pos.dtype, device=pos.device)
    return torch.clamp(1.0 - torch.abs(pos[:, None] - i[None, :]), min=0.0)


def _classify_alpha(alpha_table, value_range, sample):
    lo, hi = value_range[0], value_range[1]
    scale = 1.0 / (hi - lo)
    v = (torch.minimum(torch.maximum(sample, lo), hi) - lo) * scale
    n = alpha_table.shape[0]
    one = torch.ones((), dtype=v.dtype, device=v.device)
    v = torch.minimum(torch.maximum(v, torch.zeros_like(one)), one)
    c = v * (n - 1)
    i0f = torch.floor(c)
    f = c - i0f
    i0 = i0f.long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    return alpha_table[i0] * (1 - f) + alpha_table[i1] * f


def _opacity(alpha, base, step):
    k = base * step
    dev = alpha.device
    hi = torch.full((), 1.0 - 1e-7, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    a = torch.minimum(torch.maximum(alpha, zero), hi)
    corrected = torch.minimum(torch.maximum(1.0 - torch.pow(1.0 - a, k),
                                            zero), one)
    return torch.where(torch.abs(k - 1.0) < 1e-7,
                       torch.minimum(torch.maximum(alpha, zero), one),
                       corrected)


def build(grid, world_lo, world_hi, alpha, value_range, base_rate,
          light_dir) -> torch.Tensor:
    """The lattice (res_z, res_y, res_x) float32 for a (Z, Y, X) grid."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _build(grid, world_lo, world_hi, alpha, value_range,
                      base_rate, light_dir)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def _build(grid, world_lo, world_hi, alpha, value_range, base_rate,
           light_dir):
    dev = grid.device
    dt = torch.float32
    lo, hi = _f32(world_lo, dev), _f32(world_hi, dev)
    alpha_t = _f32(alpha, dev).reshape(-1)
    vr = _f32(value_range, dev)
    base = base_rate * torch.ones((), dtype=dt, device=dev)
    ld_t = safe_normalize(_f32(light_dir, dev))
    res = resolution(tuple(grid.shape))
    ld = ld_t.detach().cpu().numpy().astype(np.float64)
    ld = ld / max(np.linalg.norm(ld), 1e-30)
    axis = int(np.argmax(np.abs(ld)))
    sgn = 1 if ld[axis] >= 0 else -1
    w1, w2 = [w for w in (0, 1, 2) if w != axis]
    ext_np = (hi - lo).detach().cpu().numpy().astype(np.float64)
    res_xyz = (res[2], res[1], res[0])
    n_a, n_c, n_r = res_xyz[axis], res_xyz[w1], res_xyz[w2]
    gv = grid.permute(2 - axis, 2 - w2, 2 - w1)
    vz, vr_n, vc = gv.shape

    def slab(i):
        s = gv[vz - 1 - i] if sgn > 0 else gv[i]
        if s.dtype == torch.uint16:
            return (s.view(torch.int16).to(torch.int32) & 0xFFFF).to(dt)
        return s.to(dt)

    def ar(n):
        return torch.arange(n, dtype=dt, device=dev)

    qc = (ar(n_c) + 0.5) / n_c
    qr = (ar(n_r) + 0.5) / n_r
    drift1 = float(ld[w1] / ld[axis] * ext_np[axis] / ext_np[w1]) * (-sgn)
    drift2 = float(ld[w2] / ld[axis] * ext_np[axis] / ext_np[w2]) * (-sgn)
    dq = 1.0 / n_a
    step_world = torch.tensor(
        float(ext_np[axis]) * dq / max(abs(float(ld[axis])), 1e-12),
        dtype=dt, device=dev)
    wc_t = _hat((qc + drift1 * (-dq)) * n_c - 0.5, n_c)
    wr_t = _hat((qr + drift2 * (-dq)) * n_r - 0.5, n_r)
    cover = (wr_t @ torch.ones((n_r, n_c), dtype=dt, device=dev)) @ wc_t.T
    pc = torch.clamp((qc + drift1 * (-0.5 * dq)) * vc - 0.5, 0.0, vc - 1.0)
    pr = torch.clamp((qr + drift2 * (-0.5 * dq)) * vr_n - 0.5, 0.0,
                     vr_n - 1.0)
    wc_s = _hat(pc, vc)
    wr_s = _hat(pr, vr_n)
    gs = storage_scale(grid.dtype)
    t = torch.ones((n_r, n_c), dtype=dt, device=dev)
    planes = []
    for k in range(n_a):
        qa_k = (torch.tensor(float(k), dtype=dt) + 0.5) * dq
        cz = torch.clamp((qa_k - 0.5 * dq) * vz - 0.5, 0.0, vz - 1.0)
        k0 = int(min(max(int(torch.floor(cz)), 0), max(vz - 2, 0)))
        fzz = (cz - k0).to(dev)
        s0 = slab(k0)
        s1 = slab(min(k0 + 1, vz - 1))
        plane = (s0 * (1.0 - fzz) + s1 * fzz) * gs
        smp = wr_s @ plane @ wc_s.T
        a = _opacity(_classify_alpha(alpha_t, vr, smp), base, step_world)
        t = (wr_t @ t @ wc_t.T + (1.0 - cover)) * (1.0 - a)
        planes.append(1.0 - t)
    lat = torch.stack(planes)
    if sgn > 0:
        lat = lat.flip(0)
    inv = np.argsort([2 - axis, 2 - w2, 2 - w1])
    return lat.permute(*[int(i) for i in inv]).contiguous()
