"""Shear-warp volume rendering (port of `ovr_tpu.render.shearwarp`).

The renderer picks the volume axis most parallel to the view, composites
sample planes perpendicular to it front to back in an intermediate "ray
fan" (P, Q) in which every plane is an axis-aligned, uniformly scaled
image of a voxel slice, and warps the fan to the screen at the end. Per
fan pixel the covered world interval of each plane comes from the exact
ray/box slab test, so the result is the box-clipped Riemann sum of the
emission-absorption integral with samples at plane centers.

The slice loop is one call of `ops.swslice.slice_composite`: the CUDA
kernel for a volume on the card, its plain PyTorch version for one on the
CPU. Surfaces (`scene.geometries`) are intersected with the fan rays in
closed form; the nearest opaque hit clamps each fan ray's interval
through the slice loop's exit map, and the shaded surface composites
behind the loop's output before the warp. The frame is differentiable:
the slice loop's backward is the bounded-memory analytic adjoint, and
the warp and the rest are plain tensor ops that autograd
differentiates.

The work before the slice loop (`frame_setup`: the fan, the plane
schedule, the RGBA table and the kernel's scalars; some 300 small
operations) depends on the plan and a few small tensors only. A
`Renderer` on the card captures it as a CUDA graph once per plan and
replays it in later frames (`SetupGraphs`): the same kernels, the same
bits, one launch. Every other caller runs it eagerly.

The plan keeps the fields of `ovr_tpu`'s `SwStatic` that change results;
the TPU's VMEM tiling fields have no counterpart here (README, "TPU knobs
on Hopper").
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ovr_tpu_torch.core import sampling
from ovr_tpu_torch.core.sampling import (clip, intersect_box, safe_normalize,
                                         scalar)
from ovr_tpu_torch.core.scene import ORTHOGRAPHIC, PERSPECTIVE, Camera
from ovr_tpu_torch.neural.field import is_field
from ovr_tpu_torch.ops import adjoint, swslice
from ovr_tpu_torch.render import geometry
from ovr_tpu_torch.render.ptdense import full_f32
from ovr_tpu_torch.render.camera import camera_basis
from ovr_tpu_torch.utils import trace

SETUP_REPLAYS = 0  # frames whose setup replayed a captured CUDA graph
SETUP_CAPTURES = 0  # frames whose setup ran eagerly and was then captured
SETUP_EAGER = 0  # frames whose setup ran eagerly only
trace.register_counter("shearwarp.SETUP_REPLAYS", lambda: SETUP_REPLAYS)
trace.register_counter("shearwarp.SETUP_CAPTURES", lambda: SETUP_CAPTURES)
trace.register_counter("shearwarp.SETUP_EAGER", lambda: SETUP_EAGER)
# captured setups a `SetupGraphs` keeps: an interior eye's trims (up to
# 8 a view direction) besides an orbit's four plans; ~38 KB of the card
# each
SETUP_GRAPHS = 32


@dataclasses.dataclass(frozen=True)
class SwStatic:
    """Host-side shear-warp plan (embedded in RenderConfig)."""

    axis: int  # principal world axis 0/1/2 (x/y/z)
    sign: int  # +1: planes traversed in +axis order; -1: reversed
    n_slices: int  # sample planes across the slab
    inter_h: int  # intermediate (ray-fan) rows (Q)
    inter_w: int  # intermediate cols (P)
    swap: bool = False  # screen v (not u) pairs with P in the final warp
    # P depends on one screen axis only and Q on the other: both warp
    # passes share their positions across the frame
    separable: bool = False
    # rows per weight chunk of the TPU's batched warp matmuls; the
    # two-tap gather warp here builds no weight tensor and needs none
    row_chunk: int = 16
    term: bool = True  # early ray termination in the fused kernel
    # bf16 resampling operands in the slice loop and the warp (sw_bf16)
    bf16: bool = False
    # shading gradient: fan-space finite differences (True) or the
    # analytic bilinear derivative (False)
    fd_grad: bool = True
    # interior eye: planes [0, slice0_static) lie behind the eye's axial
    # plane and cover no ray interval; the schedule starts here
    slice0_static: int = 0
    # views along the grid's fastest axis (x): the (median, 90th
    # percentile) voxels of a slice-kernel block's footprint over the
    # planes that read one staged run (`_run_footprint`), from which the
    # kernel's launcher sizes its run staging; (0, 0) for other views
    run_footprint: tuple = (0, 0)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _np_basis(camera, width, height):
    """Host-side numpy copy of `camera_basis`."""
    aspect = width / float(height)
    d = _np(camera.at).astype(np.float64) - _np(camera.from_).astype(
        np.float64)
    d = d / max(np.linalg.norm(d), 1e-30)
    if camera.kind == ORTHOGRAPHIC:
        t = float(_np(camera.height))
    else:
        t = 2.0 * np.tan(np.deg2rad(float(_np(camera.fovy))) * 0.5)
    h = np.cross(d, _np(camera.up).astype(np.float64))
    h = t * aspect * h / max(np.linalg.norm(h), 1e-30)
    v = np.cross(h, d) / aspect
    return d, h, v


def resolve_static(scene, camera, cfg) -> Optional[SwStatic]:
    """Build the plan, or None when shear-warp is ineligible."""
    vol = scene.volume
    if not hasattr(vol, "grid") or vol.grid.ndim != 3:
        return None
    if min(vol.grid.shape) < 2 or scene.instances:
        return None
    if cfg.shading == "shadow" and not cfg.shadow_grid:
        return None
    d, h, v = _np_basis(camera, cfg.width, cfg.height)
    axis = int(np.argmax(np.abs(d)))
    if abs(d[axis]) < 1e-6:
        return None
    sign = 1 if d[axis] >= 0 else -1
    lo = float(_np(vol.world_lo)[axis])
    hi = float(_np(vol.world_hi)[axis])
    eye = _np(camera.from_).astype(np.float64)
    inside = (camera.kind != ORTHOGRAPHIC
              and lo - 1e-6 <= eye[axis] <= hi + 1e-6)
    w1, w2 = _perp_axes(axis)
    swap = bool(abs(h[w1]) < abs(v[w1]))
    mot = abs(v[w1]) if swap else abs(h[w1])
    oth = abs(h[w2]) if swap else abs(v[w2])
    if mot < 1e-9 or oth < 1e-9:
        return None
    eps = 1e-6 * (np.linalg.norm(h) + np.linalg.norm(v))
    cross = ((abs(v[w1]), abs(h[w2])) if not swap
             else (abs(h[w1]), abs(v[w2])))
    axial = (abs(h[axis]), abs(v[axis]))
    separable = bool(max(*cross, *axial) < eps)
    ext = (_np(vol.world_hi).astype(np.float64)
           - _np(vol.world_lo).astype(np.float64))
    n_slices = max(4, int(round(float(ext[axis]) * cfg.sampling_rate)))
    align = max(1, int(cfg.sw_slice_align))
    n_slices = -(-n_slices // align) * align
    zyx = vol.grid.shape
    dims_xyz = (zyx[2], zyx[1], zyx[0])
    cap = int(cfg.sw_inter_cap)

    def rnd(x):
        return int(-(-x // 8) * 8)

    # fan resolution: 2 samples per voxel laterally, never beyond ~1.25x
    # the paired screen axis
    scr_p = cfg.height if swap else cfg.width
    scr_q = cfg.width if swap else cfg.height
    wi = rnd(min(cap, max(64, min(2 * dims_xyz[w1], int(1.25 * scr_p)))))
    hi_i = rnd(min(cap, max(64, min(2 * dims_xyz[w2],
                                    int(1.25 * scr_q)))))
    slice0_static = 0
    if inside:
        # interior eye: border rays must still advance along the axis
        us = np.linspace(-0.5, 0.5, 65)
        uu = np.concatenate([us, us, np.full(65, -0.5), np.full(65, 0.5)])
        vv = np.concatenate([np.full(65, -0.5), np.full(65, 0.5), us, us])
        den = (d[axis] + uu * h[axis] + vv * v[axis]) * sign
        if den.min() < 0.15 * abs(d[axis]):
            return None
        # planes behind the eye's axial plane cover no ray interval; the
        # start is quantized to n_slices/8 steps
        z_eye = (eye[axis] - lo) if sign > 0 else (hi - eye[axis])
        dz_s = float(ext[axis]) / n_slices
        s0 = int(max(0.0, z_eye / dz_s - 1.0))
        qstep = max(1, n_slices // 8)
        slice0_static = max(0, min((s0 // qstep) * qstep, n_slices - 4))
    big = wi >= 1024 or dims_xyz[w1] >= 512
    run_fp = (0, 0)
    if axis == 0:
        lo_w = _np(vol.world_lo).astype(np.float64)
        run_fp = _run_footprint(
            d, h, v, eye, lo_w, ext, dims_xyz, sign, n_slices,
            slice0_static, (cfg.height, cfg.width), (hi_i, wi),
            camera.kind == ORTHOGRAPHIC, big,
            swslice.run_planes(vol.grid.dtype, dims_xyz[w2], cfg.sw_bf16))
    return SwStatic(axis=axis, sign=sign, n_slices=n_slices,
                    inter_h=hi_i, inter_w=wi, swap=swap,
                    separable=separable, term=bool(cfg.sw_term),
                    bf16=bool(cfg.sw_bf16), fd_grad=bool(big),
                    slice0_static=slice0_static, run_footprint=run_fp)


@functools.lru_cache(maxsize=64)
def _run_samples(fan, fd, na, run_planes, n_slices, slice0, sign,
                 n_samples):
    """The camera-independent part of `_run_footprint`: of n_samples
    block rows and columns spread over the fan, the extreme sample rows
    and columns (fan indices + 0.5, with the FD halo: its rows lie on the
    fan's lattice past its edges, its columns are clamped to the fan),
    (axis: rows, columns; edge x sample); and of n_samples runs spread
    along x, the axial extent of the planes that read each (their two
    slabs lie in its voxels, so their axial texel lies in [first - 1,
    last + 1)), clipped to the schedule, as fractions of the box (run
    end x sample)."""
    k = np.arange(n_samples)
    halo = 1 if fd else 0
    idx = []
    for n_fan, b, clamp in ((fan[0], swslice.BLOCK_ROWS, False),
                            (fan[1], swslice.BLOCK_COLS, True)):
        first = k * (-(-n_fan // b) - 1) // (n_samples - 1) * b - halo
        last = np.minimum(first + halo + b, n_fan) - 1 + halo
        if clamp:
            first, last = np.maximum(first, 0), np.minimum(last, n_fan - 1)
        idx.append(np.concatenate([first, last]) + 0.5)
    z_lo, z_hi = slice0 / n_slices, 1.0
    if sign < 0:
        z_lo, z_hi = 0.0, 1.0 - z_lo
    first = k * (na // run_planes - 1) // (n_samples - 1) * run_planes
    z = np.concatenate([first - 0.5, first + run_planes + 0.5]) / na
    return np.stack(idx), np.clip(z, z_lo, z_hi)


def _run_footprint(d, h, v, eye, lo, ext, dims_xyz, sign, n_slices, slice0,
                   screen, fan, ortho, fd, run_planes, n_samples=12):
    """For a view along x (the grid's fastest axis), the (median, 90th
    percentile) over the view's slice-kernel blocks and staged runs of the
    voxels (rows x columns) a block's footprint covers over the planes
    that read one run: the run buffers must hold it (csrc/swslice.cu,
    `plan`). Host-side, from the camera basis (`_np_basis`) and the plan;
    it follows `frame_setup`'s fan and schedule and the kernel's
    footprint rule on a grid of n_samples^3 (block row, block column,
    run), counting only pairs whose block centre lies inside the grid's
    section on the run's planes. (0, 0) where none does. It runs on every
    camera change, so it keeps to a few dozen array operations."""
    (height, width), ns = screen, n_samples
    idx, z = _run_samples(fan, fd, dims_xyz[0], run_planes, n_slices,
                          slice0, sign, ns)
    d, h, v, eye, lo, ext = (np.asarray(x, dtype=np.float64).tolist()
                             for x in (d, h, v, eye, lo, ext))
    # the fan's range over the screen's corner rays, rows (z) then
    # columns (y), as `frame_setup` takes it (in Python floats: a handful
    # of numbers)
    su, sv = 0.5 - 0.5 / width, 0.5 - 0.5 / height
    base = eye if ortho else d
    x_lo, step = [], []
    for c, n_fan in ((2, fan[0]), (1, fan[1])):
        xs = []
        for cu, cv in ((-su, -sv), (su, -sv), (-su, sv), (su, sv)):
            x = base[c] + cu * h[c] + cv * v[c]
            xs.append(x if ortho
                      else x / ((d[0] + cu * h[0] + cv * v[0]) * sign))
        m = 0.01 * (max(xs) - min(xs)) + 1e-6
        x_lo.append(min(xs) - m)
        step.append((max(xs) - min(xs) + 2 * m) / n_fan)
    edges = idx * np.array(step)[:, None] + np.array(x_lo)[:, None]
    lam = z * ext[0] + (lo[0] - eye[0])
    lam *= 1.0 / d[0] if ortho else float(sign)  # (2 * ns,): run ends
    n1 = np.array([[[dims_xyz[2] - 1.0]], [[dims_xyz[1] - 1.0]]])
    scale = np.array([[[dims_xyz[2] / ext[2]]], [[dims_xyz[1] / ext[1]]]])
    # the texel of fan coordinate x on plane lam (the kernel's vr_of /
    # vc_of): (x * lam + e - origin) * scale, or (x + d * lam - origin) *
    # scale in orthographic views
    shift = np.array([[[c - o]] for c, o in (
        (0.0 if ortho else eye[2], lo[2] + 0.5 * ext[2] / dims_xyz[2]),
        (0.0 if ortho else eye[1], lo[1] + 0.5 * ext[1] / dims_xyz[1]))])
    slope = np.array([[[d[2]]], [[d[1]]]])

    def texel(x, lam_):
        # (axis, edge, run end) texel positions
        if ortho:
            return (x[:, :, None] + slope * lam_ + shift) * scale
        return (x[:, :, None] * lam_ + shift) * scale

    t = texel(edges, lam)
    corners = (t[:, :ns, :ns], t[:, :ns, ns:], t[:, ns:, :ns], t[:, ns:, ns:])
    # the voxel span [floor(first), floor(last) + 1], clamped to the grid
    # as the kernel clamps it (axis, block, run), and whether the block's
    # centre is inside the section
    t_lo = np.minimum(np.minimum(corners[0], corners[1]),
                      np.minimum(corners[2], corners[3]))
    t_hi = np.maximum(np.maximum(corners[0], corners[1]),
                      np.maximum(corners[2], corners[3]))
    t_lo = np.floor(np.minimum(np.maximum(t_lo, 0.0), n1))
    t_hi = np.floor(np.minimum(np.maximum(t_hi, 0.0), n1))
    span = np.minimum(t_hi + 1.0, n1) - t_lo + 1.0
    mid = texel((edges[:, :ns] + edges[:, ns:]) * 0.5,
                (lam[:ns] + lam[ns:]) * 0.5)
    ok = (mid >= 0.0) & (mid <= n1)
    inside = ok[0][:, None, :] & ok[1][None, :, :]
    if not ortho:
        inside &= (lam[:ns] + lam[ns:] > 0)[None, None, :]
    area = (span[0][:, None, :] * span[1][None, :, :])[inside]
    if area.size == 0:
        return (0, 0)
    i50, i90 = (area.size - 1) // 2, (area.size - 1) * 9 // 10
    area = np.partition(area, (i50, i90))
    return (int(area[i50]), int(area[i90]))


# ---------------------------------------------------------------------------
# dense building blocks
# ---------------------------------------------------------------------------

def _interp_matrix(src_pos: torch.Tensor, n_in: int) -> torch.Tensor:
    """(O, I) linear-interpolation weights: row o holds the two weights
    for continuous source index src_pos[o], clamp-addressed."""
    p = torch.clamp(src_pos, 0.0, n_in - 1.0)
    i = torch.arange(n_in, dtype=src_pos.dtype, device=src_pos.device)
    return torch.clamp(1.0 - torch.abs(p[:, None] - i[None, :]), min=0.0)


def _taps(pos: torch.Tensor, n: int):
    """Two-tap form of clamp-addressed linear interpolation: indices
    (i0, i1) and the weight f of i1."""
    return swslice._taps(torch.clamp(torch.nan_to_num(pos, nan=0.0), 0.0,
                                     n - 1.0), n)


def _weights(f, bf16: bool):
    """The two taps' weights (1 - f, f), rounded to bf16 under `bf16`."""
    if bf16:
        return swslice.bf16_round(1.0 - f), swslice.bf16_round(f)
    return 1.0 - f, f


def warp_rows(img: torch.Tensor, pos: torch.Tensor,
              bf16: bool = False) -> torch.Tensor:
    """Resample each row r of img (R, I, C) at continuous column
    positions pos (R, O) -> (R, O, C), by a two-tap gather. `bf16`
    rounds the image and the weights to bf16 and sums in f32, as the JAX
    package's weight matmuls do (`ovr_tpu.render.shearwarp.warp_rows`)."""
    r, n_in, ch = img.shape
    i0, i1, f = _taps(pos, n_in)
    if bf16:
        img = swslice.bf16_round(img)
    g0 = torch.gather(img, 1, i0[..., None].expand(-1, -1, ch))
    g1 = torch.gather(img, 1, i1[..., None].expand(-1, -1, ch))
    w0, w1 = _weights(f[..., None].to(img.dtype), bf16)
    return g0 * w0 + g1 * w1


def warp_separable(img: torch.Tensor, row_pos: torch.Tensor,
                   col_pos: torch.Tensor, bf16: bool = False
                   ) -> torch.Tensor:
    """out[v, u, c] = img[row_pos[v], col_pos[u], c] (bilinear): rows,
    then columns, each with shared positions. `bf16` rounds the image,
    the weights and the row pass's result to bf16, as the JAX package's
    two matmuls take them (`ovr_tpu.render.shearwarp.warp_separable`)."""
    hi_i, wi_i, _ = img.shape
    r0, r1, fr = _taps(row_pos, hi_i)
    if bf16:
        img = swslice.bf16_round(img)
    w0, w1 = _weights(fr[:, None, None].to(img.dtype), bf16)
    t = img[r0] * w0 + img[r1] * w1  # (H, Wi, C)
    if bf16:
        t = swslice.bf16_round(t)
    c0, c1, fc = _taps(col_pos, wi_i)
    w0, w1 = _weights(fc[None, :, None].to(img.dtype), bf16)
    return t[:, c0] * w0 + t[:, c1] * w1


def _perp_axes(axis: int) -> tuple[int, int]:
    p = [w for w in (0, 1, 2) if w != axis]
    return p[0], p[1]


def _volume_view(grid: torch.Tensor, axis: int, sign: int) -> torch.Tensor:
    """Permute (Z, Y, X) so dim0 = principal axis in traversal order,
    dim1 = rows = perp[1], dim2 = cols = perp[0]. sign < 0 flips dim0
    (a copy; the fused kernel walks a storage-ordered view backward
    instead)."""
    w1, w2 = _perp_axes(axis)
    g = grid.permute(2 - axis, 2 - w2, 2 - w1)
    return g.flip(0) if sign < 0 else g


def _safe_div(a, b):
    return a / _safe_den(b)


def _safe_den(b, out=None, scratch=(None, None), mask=None):
    """`b`, or 1e-9 with its sign where |b| < 1e-9 (+1e-9 at -0.0): a
    denominator safe to divide by. `out` (which may be `b`), the two
    `scratch` planes of b's shape and dtype and the bool `mask` are
    buffers to work in, or None."""
    eps = float(np.float32(1e-9))  # the JAX package's f32 constant
    tiny = torch.where(torch.lt(b, 0, out=mask),
                       scalar(-eps, b.dtype, b.device),
                       scalar(eps, b.dtype, b.device), out=scratch[0])
    small = torch.lt(torch.abs(b, out=scratch[1]), 1e-9, out=mask)
    return torch.where(small, tiny, b, out=out)


def _common_rgba_table(color_table, alpha_table):
    """Merge the TF's color (Nc, 3) and alpha (Na,) nodal tables onto one
    K = max(Nc, Na) grid as a (K, 4) table (piecewise-linear re-noding of
    the coarser one)."""
    k = max(color_table.shape[0], alpha_table.shape[0])
    xs = torch.linspace(0.0, 1.0, k, dtype=color_table.dtype,
                        device=color_table.device)

    def renode(tab):
        t2 = tab if tab.ndim == 2 else tab[:, None]
        n = t2.shape[0]
        if n == k:
            return t2
        return _interp_matrix(xs * (n - 1), n) @ t2

    return torch.cat([renode(color_table), renode(alpha_table)], dim=1)


def _kernel_scalars(dt, device, *, lo1, ex1, lo2, ex2, e1, e2, dw1, dw2,
                    half, dz, off, vr, base, lam0, n_a, dlam, exa, ortho,
                    ld=(0.0, 0.0, 0.0), k1o=0.0, k2o=0.0, inv_da=0.0,
                    dzdlam=1.0, n_la=2.0, wtcp=None, clo1=None, cex1=None,
                    clo2=None, cex2=None, cla=None, cha=None, smp0=0.0,
                    smpsc=None, glo1=None, gex1=None, glo2=None, gex2=None,
                    za0=0.0, zsg=1.0):
    """Assemble the ops.swslice scalar vector (S_* layout, N_SCALARS)."""
    if wtcp is None:
        wtcp = torch.zeros((3, 3), dtype=dt, device=device)
    clo1 = lo1 if clo1 is None else clo1
    cex1 = ex1 if cex1 is None else cex1
    clo2 = lo2 if clo2 is None else clo2
    cex2 = ex2 if cex2 is None else cex2
    cla = lam0 if cla is None else cla
    cha = lam0 + exa * dlam if cha is None else cha
    smpsc = float(n_a) / exa if smpsc is None else smpsc
    glo1 = lo1 if glo1 is None else glo1
    gex1 = ex1 if gex1 is None else gex1
    glo2 = lo2 if glo2 is None else glo2
    gex2 = ex2 if gex2 is None else gex2
    vals = [lo1, ex1, lo2, ex2, e1, e2, dw1, dw2, half, dz, off, vr[0],
            1.0 / (vr[1] - vr[0]), base, lam0, float(n_a), dlam, exa,
            1.0 if ortho else 0.0, ld[0], ld[1], ld[2], k1o, k2o, inv_da,
            dzdlam, n_la,
            wtcp[0, 0], wtcp[0, 1], wtcp[0, 2],
            wtcp[1, 0], wtcp[1, 1], wtcp[1, 2],
            wtcp[2, 0], wtcp[2, 1], wtcp[2, 2],
            clo1, cex1, clo2, cex2, cla, cha, smp0, smpsc,
            glo1, gex1, glo2, gex2, za0, zsg]
    vals += [0.0] * (swslice.N_SCALARS - len(vals))

    def as_t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dt).reshape(())
        # a fill, not a host-to-device copy (which waits for the stream)
        return torch.full((), float(x), dtype=dt, device=device)

    return torch.stack([as_t(x) for x in vals])


def _setup_lights(scene) -> list:
    """The scene's lights that shade in the slice loop, directional (and
    sunSky) ones first, then point lights: ambient lights add nothing
    there, as in the JAX package."""
    return ([lt for lt in scene.lights if lt.kind in ("directional",
                                                      "sunsky")]
            + [lt for lt in scene.lights if lt.kind == "point"])


def _extra_lights_fan(lights, n_dir, w1, w2, axis, dt):
    """The extra lights (`_setup_lights`, as (vector, intensity, color),
    the first `n_dir` directional) as the slice loop's light table
    (L, 4), or None without any: directional rows (d_w1, d_w2, d_axis,
    I), then point rows (p_w1, p_w2, p_axis, I), each with
    I = 2 * intensity * mean(color) and its vector in fan-axis order
    (`ovr_tpu.render.shearwarp._extra_lights_fan`)."""
    rows = []
    for i, (vec, intensity, color) in enumerate(lights):
        inten = 2.0 * intensity * torch.mean(color)
        d = safe_normalize(vec) if i < n_dir else vec
        rows.append(torch.stack([d[w1], d[w2], d[axis], inten]))
    return torch.stack(rows).to(dt) if rows else None


def _fan_rays(pg, qg, e, direction, axis, sign, ortho):
    """The fan's rays in world space: origins and directions (Hi, Wi, 3)
    in the fan's ray parameter (the directions unnormalized: axial
    component `sign` in perspective), and each ray's speed (Hi, Wi),
    |direction| per unit of the parameter."""
    w1, w2 = _perp_axes(axis)
    hi_i, wi_i = qg.shape[0], pg.shape[0]
    pp = pg[None, :].expand(hi_i, wi_i)
    qq = qg[:, None].expand(hi_i, wi_i)
    comps = [None] * 3
    comps[w1], comps[w2] = pp, qq
    if ortho:
        comps[axis] = e[axis].expand(hi_i, wi_i)
        return (torch.stack(comps, -1), direction.expand(hi_i, wi_i, 3),
                torch.ones_like(pp))
    comps[axis] = torch.full_like(pp, float(sign))
    return (e.expand(hi_i, wi_i, 3), torch.stack(comps, -1),
            torch.sqrt(pp * pp + qq * qq + 1.0))


# ---------------------------------------------------------------------------
# the frame setup: fan, plane schedule, RGBA table, scalars
# ---------------------------------------------------------------------------

class SetupKey(NamedTuple):
    """Every Python value and shape that `frame_setup` reads: two frames
    of one key run the same operations on inputs of the same shapes. The
    plan's `separable`, `swap`, `term`, `bf16` and `fd_grad` are left
    out: only the slice loop and the warp read them."""

    axis: int
    sign: int
    n_slices: int
    slice0_static: int
    inter_h: int
    inter_w: int
    width: int
    height: int
    mode: Optional[int]  # the slice loop's; None: the path tracer's gather
    ortho: bool
    dtype: torch.dtype
    base_rate: float
    n_a: int  # the grid's length along the axis
    n_color: int  # TF table lengths
    n_alpha: int
    l_a: int  # the shadow lattice's length along the axis (mode 2), or 0
    n_dir: int  # extra lights: directional, then point
    n_point: int
    jitter: bool
    device: torch.device


def setup_key(scene, cfg, camera, jitter, mode, n_a, l_a, device) -> SetupKey:
    """The key of a frame of `scene` through the plan `cfg.sw`: `mode`,
    `n_a`, `l_a` and `device` as `SetupKey` has them."""
    sw = cfg.sw
    lights = _setup_lights(scene)
    n_dir = sum(lt.kind != "point" for lt in lights)
    return SetupKey(
        sw.axis, sw.sign, sw.n_slices, sw.slice0_static, sw.inter_h,
        sw.inter_w, cfg.width, cfg.height, mode,
        camera.kind == ORTHOGRAPHIC, cfg.dtype, float(cfg.base_rate), n_a,
        scene.tfn.color.shape[0], scene.tfn.alpha.shape[0], l_a, n_dir,
        len(lights) - n_dir, jitter is not None, torch.device(device))


def setup_inputs(scene, camera, jitter) -> tuple:
    """The tensors `frame_setup` reads, in its order: the camera's
    from_, at, up, fovy and height; the volume's world box; the TF's
    color, alpha and value range; the light's direction; (vector,
    intensity, color) of each extra light (`_setup_lights`); then
    `jitter`, where given (a tensor or a number)."""
    vol, tfn = scene.volume, scene.tfn
    x = [camera.from_, camera.at, camera.up, camera.fovy, camera.height,
         vol.world_lo, vol.world_hi, tfn.color, tfn.alpha, tfn.value_range,
         scene.light.direction]
    for lt in _setup_lights(scene):
        x += [lt.position if lt.kind == "point" else lt.direction,
              lt.intensity, lt.color]
    return tuple(x) if jitter is None else (*x, jitter)


def frame_setup(key: SetupKey, x, screen=None, row0=None, n_rows=None,
                sample_box=None, clip_box=None, slice0=None,
                n_slices_loc=None) -> dict:
    """The frame's work before the slice loop, from the inputs
    (`setup_inputs`) and the key's values alone: the screen's fan
    coordinates and their ranges, the fan's rays `pg`/`qg`, the plane
    schedule `k0` (and mode 2's `k0l`), the merged RGBA table, the
    light table and the scalar vector. Returns what the slice loop and
    the warp read. `screen`: `screen_buffers(key)`, which receive p_scr,
    q_scr and what makes them; without, they are new tensors. The hooks
    are `render_shearwarp`'s."""
    dt = key.dtype
    opts = dict(dtype=dt, device=key.device)
    axis, sign, ortho = key.axis, key.sign, key.ortho
    w1, w2 = _perp_axes(axis)
    (from_, at, up, fovy, height, lo, hi, color, alpha, value_range,
     light_dir) = x[:11]
    n_lights = key.n_dir + key.n_point
    lights = [x[11 + 3 * i:14 + 3 * i] for i in range(n_lights)]
    jitter = x[-1] if key.jitter else None
    camera = Camera(from_, at, up, fovy, height,
                    kind=ORTHOGRAPHIC if ortho else PERSPECTIVE)
    n_a = key.n_a
    ext = hi - lo
    smp_lo, smp_hi = (lo, hi) if sample_box is None else sample_box
    clp_lo, clp_hi = (lo, hi) if clip_box is None else clip_box
    if slice0 is None:
        # interior-eye trim: start at the plan's first plane that can
        # cover any ray interval (a bricked caller passes its own range)
        s0s = int(key.slice0_static)
        slice0 = torch.full((), float(s0s), **opts)
        if n_slices_loc is None:
            n_slices_loc = key.n_slices - s0s
    else:
        slice0 = torch.as_tensor(slice0, **opts)
    n_loc = key.n_slices if n_slices_loc is None else int(n_slices_loc)
    e, direction, horizontal, vertical = camera_basis(camera, key.width,
                                                      key.height)

    # ---- screen ray-fan coordinates ---------------------------------------
    u = (torch.arange(key.width, **opts) + 0.5) / key.width - 0.5
    nr_loc = key.height if n_rows is None else int(n_rows)
    base_row = 0.0 if row0 is None else float(row0)
    v = (torch.arange(nr_loc, **opts) + 0.5 + base_row) / key.height - 0.5
    p_out, q_out, den, mask = (None,) * 4 if screen is None else screen

    def plane(c0, c, out):
        # c0 + u * horizontal[c] + v * vertical[c] over the (H, W) screen:
        # a row plus a column, with no screen-sized temporary
        return torch.add((c0 + u * horizontal[c])[None, :],
                         (v * vertical[c])[:, None], out=out)

    if ortho:
        p_scr = plane(e[w1], w1, p_out)
        q_scr = plane(e[w2], w2, q_out)
    else:
        # the ray directions' components over the axial one, in the
        # screen buffers where given (p_out and q_out serve as scratch
        # until they take their own planes)
        da = _safe_den(torch.mul(plane(direction[axis], axis, den), sign,
                                 out=den), den, (p_out, q_out), mask)
        p_scr = torch.div(plane(direction[w1], w1, p_out), da, out=p_out)
        q_scr = torch.div(plane(direction[w2], w2, q_out), da, out=q_out)

    def _rng(x):
        m = 0.01 * (torch.max(x) - torch.min(x)) + 1e-6
        return torch.min(x) - m, torch.max(x) + m

    p_lo, p_hi = _rng(p_scr)
    q_lo, q_hi = _rng(q_scr)
    hi_i, wi_i = key.inter_h, key.inter_w
    dp = (p_hi - p_lo) / wi_i
    dq = (q_hi - q_lo) / hi_i
    pg = p_lo + (torch.arange(wi_i, **opts) + 0.5) * dp
    qg = q_lo + (torch.arange(hi_i, **opts) + 0.5) * dq
    if ortho:
        dlam = 1.0 / torch.clamp(torch.abs(direction[axis]), min=1e-12)
        inv_da = 1.0 / torch.where(torch.abs(direction[axis]) < 1e-12,
                                   torch.full_like(direction[axis], 1e-12),
                                   direction[axis])
    else:
        dlam = 1.0
        inv_da = torch.full((), float(sign), **opts)

    # ---- sample-plane schedule --------------------------------------------
    dz = ext[axis] / key.n_slices
    off = (torch.full((), 0.5, **opts) if jitter is None
           else torch.as_tensor(jitter, **opts))
    jj = slice0 + torch.arange(n_loc, **opts)
    z_rel = (jj + off) * dz
    z_abs = lo[axis] + z_rel if sign > 0 else hi[axis] - z_rel
    if ortho:
        lam = (z_abs - e[axis]) / direction[axis]
    else:
        lam = (z_abs - e[axis]) * sign
    s = dict(p_scr=p_scr, q_scr=q_scr, p_lo=p_lo, q_lo=q_lo, dp=dp, dq=dq,
             pg=pg, qg=qg, u=u, v=v, e=e, direction=direction,
             horizontal=horizontal, vertical=vertical, lam=lam, z_rel=z_rel,
             dz=dz, dlam=dlam, n_loc=n_loc)
    if key.mode is None:
        return s  # the path tracer's gather reads the fan and schedule
    # axial texel mapping through the sample box, traversal coordinates
    smp0 = ((smp_lo[axis] - lo[axis]) if sign > 0
            else (hi[axis] - smp_hi[axis]))
    smp_ext = smp_hi[axis] - smp_lo[axis]
    c = torch.clamp((z_rel - smp0) / smp_ext * n_a - 0.5, 0.0, n_a - 1.0)
    s["k0"] = torch.clamp(torch.floor(c).to(torch.int32), 0, n_a - 2)
    # the clip box's axial interval in ray-parameter units
    den_a = direction[axis] if ortho else (1.0 / sign)
    cl_a = (clp_lo[axis] - e[axis]) / den_a
    cl_b = (clp_hi[axis] - e[axis]) / den_a
    cla = torch.minimum(cl_a, cl_b)
    cha = torch.maximum(cl_a, cl_b)
    lo1, lo2 = smp_lo[w1], smp_lo[w2]
    ex1, ex2 = smp_hi[w1] - smp_lo[w1], smp_hi[w2] - smp_lo[w2]

    s["rgba_tab"] = _common_rgba_table(color, alpha)
    base = key.base_rate * torch.ones((), **opts)
    half = 0.5 * dz * dlam
    clip_scalars = dict(
        clo1=clp_lo[w1], cex1=clp_hi[w1] - clp_lo[w1], clo2=clp_lo[w2],
        cex2=clp_hi[w2] - clp_lo[w2], cla=cla, cha=cha,
        smp0=smp0, smpsc=n_a / smp_ext,
        glo1=lo[w1], gex1=ext[w1], glo2=lo[w2], gex2=ext[w2],
        za0=lo[axis] if sign > 0 else hi[axis], zsg=float(sign))
    zdt = torch.zeros((), **opts)
    common = dict(
        lo1=lo1, ex1=ex1, lo2=lo2, ex2=ex2, e1=e[w1], e2=e[w2],
        dw1=direction[w1] if ortho else zdt,
        dw2=direction[w2] if ortho else zdt,
        half=half, dz=dz, off=off + slice0, vr=value_range, base=base,
        lam0=lam[0] - (off + slice0) * dz * dlam, n_a=n_a, dlam=dlam,
        exa=ext[axis], ortho=ortho, **clip_scalars)
    s["lights"] = s["k0l"] = None
    if key.mode == 0:
        s["sc"] = _kernel_scalars(dt, key.device, **common)
        return s
    # ---- shaded (diffuse/shadow) path -------------------------------------
    light_dir = safe_normalize(light_dir)
    wtc = torch.stack([safe_normalize(horizontal),
                       safe_normalize(vertical), -direction])
    wtcp = torch.stack([wtc[:, w1], wtc[:, w2], wtc[:, axis]], dim=1)
    s["lights"] = _extra_lights_fan(lights, key.n_dir, w1, w2, axis, dt)
    n_la = 2.0
    if key.mode == 2:
        l_a = key.l_a
        cl = torch.clamp(z_rel / ext[axis] * l_a - 0.5, 0.0, l_a - 1.0)
        s["k0l"] = torch.clamp(torch.floor(cl).to(torch.int32), 0,
                               max(l_a - 2, 0))
        n_la = float(l_a)
    s["sc"] = _kernel_scalars(
        dt, key.device, ld=(light_dir[w1], light_dir[w2], light_dir[axis]),
        k1o=direction[w1] if ortho else zdt,
        k2o=direction[w2] if ortho else zdt, inv_da=inv_da,
        dzdlam=dz * dlam, n_la=n_la, wtcp=wtcp, **common)
    return s


def screen_buffers(key: SetupKey) -> tuple:
    """The (height, width) buffers `frame_setup` makes its screen-sized
    values in: p_scr, q_scr and their denominator in the key's dtype,
    and a mask."""
    opts = dict(device=key.device)
    shape = (key.height, key.width)
    return (*(torch.empty(shape, dtype=key.dtype, **opts) for _ in range(3)),
            torch.empty(shape, dtype=torch.bool, **opts))


def _graph_input(t, device) -> bool:
    return isinstance(t, torch.Tensor) and t.device == device


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


class SetupGraphs:
    """The frame setups of one `api.Renderer` captured as CUDA graphs,
    one per `SetupKey`, the least recently used dropped past
    `SETUP_GRAPHS`.

    A key's first frame runs `frame_setup` eagerly: that is the frame's
    setup, and the warm-up that a capture needs. It then captures the
    function (which runs nothing) on copies of its inputs. Every later
    frame of the key copies its inputs into those and replays the graph:
    the same kernels on the same values, so the same bits, for a few
    copies and one launch in place of some 300 dispatches.

    All the graphs share one memory pool and one set of screen buffers
    (`screen`): p_scr, q_scr, the denominator they divide by and a mask.
    `frame_setup` makes every screen-sized value in those, so the pool
    keeps the setup's small tensors only, and a Renderer holds one
    frame's worth of setup memory however many plans it has seen. That
    is safe because a frame reads its graph's outputs on the stream that
    replayed it, before the next replay of any graph; a graph's outputs
    hold until then.

    A capture records on a side stream of its own and neither waits for
    the card nor empties the allocator's cache, as `torch.cuda.graph`
    does: a frame that captures issues without a host wait, as a replay
    does, for some milliseconds more of host time."""

    def __init__(self):
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._pool = self._stream = None
        self._screen = None

    @staticmethod
    def replayable(key: SetupKey, x, *more) -> bool:
        """Whether a frame of these inputs (`setup_inputs`) can replay: on
        a CUDA device with every input there (`jitter` may be a number
        anywhere), and no input, nor any of `more`, requiring grad."""
        tensors = x[:-1] if key.jitter else x
        return (key.device.type == "cuda"
                and all(_graph_input(t, key.device) for t in tensors)
                and not _wants_grad(*x, *more))

    def setup(self, key: SetupKey, x) -> dict:
        """`frame_setup(key, x)`, replayed where `key` was captured."""
        global SETUP_REPLAYS, SETUP_CAPTURES
        hit = self._graphs.get(key)
        if hit is not None:
            self._graphs.move_to_end(key)
            graph, statics, out = hit
            for st, t in zip(statics, x):
                if _graph_input(t, key.device):
                    st.copy_(t)
                else:  # a jitter number: a fill, not a copy from the host
                    st.fill_(float(t))
            graph.replay()
            SETUP_REPLAYS += 1
            return out
        p = self._screen[0] if self._screen is not None else None
        if (p is None or p.shape != (key.height, key.width)
                or p.dtype != key.dtype or p.device != key.device):
            # a pool whose graphs are all gone cannot take another
            # capture until the allocator frees it: take a new one
            self._graphs.clear()
            self._pool = None
            self._screen = screen_buffers(key)
        out = frame_setup(key, x, screen=self._screen)
        statics = [t.clone() if _graph_input(t, key.device)
                   else torch.full((), float(t), dtype=key.dtype,
                                   device=key.device) for t in x]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(key.device)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (the batch renderer's
        # uploads) neither break the capture nor fail
        with sampling.fresh_constants(), torch.cuda.stream(self._stream):
            graph.capture_begin(self._pool, capture_error_mode="thread_local")
            try:
                captured = frame_setup(key, statics, screen=self._screen)
            finally:
                graph.capture_end()
        self._graphs[key] = (graph, statics, captured)
        if len(self._graphs) > SETUP_GRAPHS:
            self._graphs.popitem(last=False)
        SETUP_CAPTURES += 1
        return out


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------

def render_shearwarp(scene, cfg, camera, jitter=None, light_grid=None,
                     macrocells=None, pt_fields=None, row0=None, n_rows=None,
                     sample_box=None, clip_box=None, slice0=None,
                     n_slices_loc=None, fan_only=False, setup_graphs=None):
    """Render one frame. Returns premultiplied (color (N,3), grad (N,3),
    depth (N,), alpha (N,)) flat screen buffers (finalize with
    `integrator.finalize`).

    `jitter`: scalar in [0,1) shifting every sample plane by that
    fraction of the plane spacing (default 0.5 = plane centers).
    `light_grid`: the shadow lattice (`api.build_light_grid`), used when
    cfg.shading == 'shadow'. `macrocells`: `accel.build_macrocells` of
    the volume, for the fused kernel's empty-plane skipping.

    With `scene.geometries` the surfaces are rendered on the fan rays
    (`geometry.render_geometries`); where one is opaque, its hit clamps
    the ray's interval (the slice loop's `exit_map`), and it composites
    behind the volume (premultiplied, its depth scaled by the ray's
    speed) before the warp, as the JAX package's XLA slice loop does.

    `pt_fields`: (sigma (D,H,W), J (D,H,W,3)), the dense path tracer's
    lattices (`render.ptdense`): the planes of the scene volume's plan
    sample them instead of the volume and composite opacity
    1 - exp(-sigma dt) and emission J (`_pt_composite`, plain PyTorch:
    the JAX package runs this gather in its XLA loop, never in the slice
    kernel); no surfaces, shading or plane skipping.

    Hooks of the multi-device paths (`parallel.tiles`, `parallel.bricks`;
    the plane schedule always comes from scene.volume's world box, which
    a bricked caller sets to the global box):
    `row0`/`n_rows`: render only screen rows [row0, row0 + n_rows) of the
    cfg.height frame; the fan shrinks to the band's footprint (pair with
    a smaller sw.inter_h). `sample_box` (lo, hi): the world box of
    scene.volume.grid's texels (a brick's halo'd sampling box); default
    the volume box. `clip_box` (lo, hi): the box that clamps each ray's
    interval (a brick's ownership range); default the volume box.
    `slice0`/`n_slices_loc`: run only planes [slice0, slice0 +
    n_slices_loc) of the schedule (default: from the plan's interior-eye
    trim `slice0_static` to the end; a caller's `slice0` is never
    trimmed). `fan_only`: return (color, grad, depth, alpha, ascending,
    warp) in the fan, before the warp: `ascending` (Hi, Wi) bool is each
    fan ray's world +z orientation (the bricks' compositing order) and
    `warp(c, g, d, a)` does the deferred warp to the screen. No
    macrocell skipping with a box or a plane range, as in the JAX
    package.

    `setup_graphs`: a `SetupGraphs` (the Renderer's), which replays the
    setup (`frame_setup`) as a CUDA graph where it can: on the card,
    nothing under grad, no surfaces, `pt_fields`, hooks or `fan_only`.
    Every other frame runs it eagerly, with the same bits."""
    global SETUP_EAGER
    sw: SwStatic = cfg.sw
    if sw is None:
        raise ValueError("cfg.sw unresolved; call cfg.resolved(scene)")
    bricked = (sample_box is not None or clip_box is not None
               or slice0 is not None)
    if pt_fields is not None and (bricked or fan_only):
        raise ValueError("pt_fields takes no brick hooks")
    dt = cfg.dtype
    vol = scene.volume
    # a path-traced neural field has no grid; its planes sample sigma
    src = pt_fields[0] if is_field(vol) else vol.grid
    dev = src.device
    # the stages of the enclosing span (utils.trace): the setup up to the
    # slice loop, the loop ("k1"), the warp
    trace.stage("setup", dev)
    axis, sign = sw.axis, sw.sign
    w1, w2 = _perp_axes(axis)
    ortho = camera.kind == ORTHOGRAPHIC

    # the slice loop reads a storage-ordered view and walks it backward
    # when sign < 0 (no flipped copy of the volume)
    grid = _volume_view(src, axis, 1)
    maj_v = None
    zyx = src.shape
    if (macrocells is not None and cfg.sw_skip and not bricked
            and tuple(macrocells.vol_dims) == (zyx[2], zyx[1], zyx[0])):
        # a control input: no cotangent flows into the majorants
        maj_v = _volume_view(macrocells.majorant.detach().float(), axis,
                             1).contiguous()
    if pt_fields is not None:
        mode = None
    elif cfg.shading == "none":
        mode = 0
    else:
        mode = 2 if (cfg.shading == "shadow"
                     and light_grid is not None) else 1
    lgrid = None
    if mode == 2:
        lgrid = _volume_view(light_grid.to(dt), axis, sign).contiguous()
    key = setup_key(scene, cfg, camera, jitter, mode, grid.shape[0],
                    0 if lgrid is None else lgrid.shape[0], dev)
    x = setup_inputs(scene, camera, jitter)
    if (setup_graphs is not None and mode is not None and not bricked
            and row0 is None and n_rows is None and n_slices_loc is None
            and not fan_only and not scene.geometries
            and setup_graphs.replayable(key, x, src, light_grid)):
        s = setup_graphs.setup(key, x)
    else:
        SETUP_EAGER += 1
        s = frame_setup(key, x, row0=row0, n_rows=n_rows,
                        sample_box=sample_box, clip_box=clip_box,
                        slice0=slice0, n_slices_loc=n_slices_loc)
    pg, qg, e, direction = s["pg"], s["qg"], s["e"], s["direction"]
    warp = (cfg, sw, s["p_scr"], s["q_scr"], s["p_lo"], s["q_lo"], s["dp"],
            s["dq"], pg, s["u"], s["v"], e, direction, s["horizontal"],
            s["vertical"], axis, w1, w2, sign, ortho)
    if pt_fields is not None:
        return _sw_warp_out(*_pt_composite(
            pt_fields, sw, vol, pg, qg, e, direction, s["lam"], s["z_rel"],
            s["dz"], s["dlam"], s["n_loc"], axis, sign, ortho), *warp)

    exit_map = bg = None
    if scene.geometries:
        hi_i, wi_i = sw.inter_h, sw.inter_w
        ovec, dvec, speed = _fan_rays(pg, qg, e, direction, axis, sign,
                                      ortho)
        bg_rgb, bg_a, t_bg = geometry.render_geometries(
            scene, ovec.reshape(-1, 3), dvec.reshape(-1, 3),
            iso_steps=cfg.iso_steps, chunk=cfg.geometry_chunk)
        bg = (bg_rgb.reshape(hi_i, wi_i, 3), bg_a.reshape(hi_i, wi_i),
              t_bg.reshape(hi_i, wi_i), speed)
        exit_map = torch.where(bg[1] > 0, bg[2], geometry.BIG)
    trace.stage("k1", dev)
    out8 = swslice.slice_composite(
        grid, s["rgba_tab"], s["sc"], pg, qg, s["k0"], s["n_loc"],
        mode=mode, lgrid=lgrid, k0l=s["k0l"], lights=s["lights"],
        n_dir=key.n_dir if mode else 0, majorant_v=maj_v, term=sw.term,
        fd=sw.fd_grad, bf16=sw.bf16, axial_flip=sign < 0, exit_map=exit_map,
        run_footprint=sw.run_footprint)
    trace.stage("warp", dev)
    color = out8[0:3].permute(1, 2, 0)
    grad = out8[3:6].permute(1, 2, 0)
    depth, alpha = out8[6], out8[7]
    if bg is not None:  # the surface behind the volume (premultiplied)
        bg_rgb, bg_a, t_bg, speed = bg
        tr = 1.0 - alpha
        color = color + (tr * bg_a)[..., None] * bg_rgb
        depth = depth + tr * bg_a * torch.minimum(
            t_bg, scalar(1e30, t_bg.dtype, t_bg.device)) * speed
        alpha = alpha + tr * bg_a
    if fan_only:
        dvec = _fan_rays(pg, qg, e, direction, axis, sign, ortho)[1]
        return (color, grad, depth, alpha, dvec[..., 2] >= 0,
                lambda c_, g_, d_, a_: _sw_warp_out(c_, g_, d_, a_, *warp))
    return _sw_warp_out(color, grad, depth, alpha, *warp)


def _mm(a, b, bf16: bool):
    """a @ b in f32 (TF32 off), with bfloat16 operands under `bf16`
    (products of two bf16 are exact in f32), as the JAX package's `_mm`."""
    if bf16:
        a, b = swslice.bf16_round(a), swslice.bf16_round(b)
    with full_f32():
        return a @ b


def _pt_composite(pt_fields, sw: SwStatic, vol, pg, qg, e, direction, lam,
                  z_rel, dz, dlam, n_loc, axis, sign, ortho):
    """The dense path tracer's camera gather in the fan: per plane of the
    scene volume's schedule, sigma and each channel of J z-lerped between
    two lattice slabs and resampled at the fan rays by two interpolation
    matmuls (bf16 operands under sw.bf16), opacity
    1 - exp(-max(sigma, 0) dt_w) over the ray's box-clipped interval,
    emission J unclipped, composited front to back by
    `ops.adjoint.over_scan` (differentiable, bounded memory). Mirrors the
    `pt_fields` branch of the JAX package's XLA slice loop. Returns the
    fan's premultiplied (color, grad (zero), depth, alpha)."""
    sig_lat, j_lat = pt_fields
    w1, w2 = _perp_axes(axis)
    dt = pg.dtype
    grid = _volume_view(sig_lat, axis, sign)  # (A, Nr, Nc)
    jv = j_lat.permute(2 - axis, 2 - w2, 2 - w1, 3)  # (A, Nr, Nc, 3)
    jlat = jv.flip(0) if sign < 0 else jv
    n_a, n_r, n_c = grid.shape
    lo, hi = vol.world_lo, vol.world_hi
    ext = hi - lo
    c = clip(z_rel / ext[axis] * n_a - 0.5, 0.0, n_a - 1.0)
    k0 = torch.clamp(torch.floor(c).to(torch.int32), 0, n_a - 2)
    fz = c - k0.to(dt)
    ovec, dvec, speed = _fan_rays(pg, qg, e, direction, axis, sign, ortho)
    l_in, l_out = intersect_box(ovec, dvec, lo, hi, torch.zeros_like(speed),
                                torch.full_like(speed, 3.4e38))
    l_out = torch.maximum(l_out, l_in)
    bf16 = sw.bf16

    def f(p, j):
        k = p["kz"][j]
        lam_j, fz_j = p["lam"][j], p["fz"][j]
        zero = scalar(0.0, lam_j.dtype, lam_j.device)
        sl, jsl = p["grid"][k:k + 2], p["jlat"][k:k + 2]
        plane = sl[0] * (1.0 - fz_j) + sl[1] * fz_j
        jplane = jsl[0] * (1.0 - fz_j) + jsl[1] * fz_j
        if ortho:
            x1 = p["pg"] + p["dw1"] * lam_j
            x2 = p["qg"] + p["dw2"] * lam_j
        else:
            x1 = p["ew1"] + p["pg"] * lam_j
            x2 = p["ew2"] + p["qg"] * lam_j
        wc = _interp_matrix((x1 - p["lo1"]) / p["ex1"] * n_c - 0.5, n_c)
        wr = _interp_matrix((x2 - p["lo2"]) / p["ex2"] * n_r - 0.5, n_r)
        # sigma and the three channels of J through the same two products
        planes = torch.cat([plane[None], jplane.permute(2, 0, 1)])
        smp = _mm(_mm(wr, planes, bf16), wc.T, bf16)  # (4, Hi, Wi)
        seg_lo = torch.maximum(lam_j - p["half"], p["lin"])
        seg_hi = torch.minimum(lam_j + p["half"], p["lout"])
        dt_w = torch.maximum(seg_hi - seg_lo, zero) * p["speed"]
        a = 1.0 - torch.exp(-torch.maximum(smp[0], zero) * dt_w)
        v = torch.cat([smp[1:], (lam_j * p["speed"])[None]])
        return v, a

    params = dict(
        grid=grid, jlat=jlat, kz=k0.tolist(), fz=fz, lam=lam, pg=pg, qg=qg,
        lin=l_in, lout=l_out, speed=speed, half=0.5 * dz * dlam,
        ew1=e[w1], ew2=e[w2], dw1=direction[w1], dw2=direction[w2],
        lo1=lo[w1], lo2=lo[w2], ex1=ext[w1], ex2=ext[w2])
    big_v, trans = adjoint.over_scan(f, n_loc, params)
    color = big_v[:3].permute(1, 2, 0)
    return (color, torch.zeros_like(color), big_v[3], 1.0 - trans)


def _sw_warp_out(color, grad, depth, alpha, cfg, sw: SwStatic, p_scr, q_scr,
                 p_lo, q_lo, dp, dq, pg, u, v, e, direction, horizontal,
                 vertical, axis, w1, w2, sign, ortho):
    """Final warp: intermediate (Q, P) -> screen (v, u), then flatten.

    O[v, u] = stack[cq(u, v), cp(u, v)] as two 1D passes: first resample
    each intermediate column at the rows that the screen rows of its
    ray need (inverting P along the paired screen axis in closed form),
    then resample each screen row at cp."""
    stack = torch.cat([color, grad, depth[..., None], alpha[..., None]],
                      dim=-1)
    cp = (p_scr - p_lo) / dp - 0.5  # (H, W) continuous col index

    def q_to_row(q):
        return (q - q_lo) / dq - 0.5

    def q_at(us, vs):
        """Q value of the ray at screen params (us, vs)."""
        if ortho:
            return e[w2] + us * horizontal[w2] + vs * vertical[w2]
        num = direction[w2] + us * horizontal[w2] + vs * vertical[w2]
        den = (direction[axis] + us * horizontal[axis]
               + vs * vertical[axis]) * sign
        return _safe_div(num, den)

    if sw.separable:
        cq = q_to_row(q_scr)
        if not sw.swap:
            out = warp_separable(stack, cq[:, 0], cp[0, :], sw.bf16)
        else:
            out = warp_separable(stack, cq[0, :], cp[:, 0],
                                 sw.bf16).transpose(0, 1)
    elif not sw.swap:
        vs = v[:, None]  # (H, 1)
        pi = pg[None, :]  # (1, Wi)
        if ortho:
            us = _safe_div(pi - e[w1] - vs * vertical[w1], horizontal[w1])
        else:
            num = (pi * (direction[axis] + vs * vertical[axis]) * sign
                   - direction[w1] - vs * vertical[w1])
            den = horizontal[w1] - pi * horizontal[axis] * sign
            us = _safe_div(num, den)
        r1 = q_to_row(q_at(us, vs))  # (H, Wi)
        t = warp_rows(stack.transpose(0, 1), r1.T, sw.bf16)  # (Wi, H, C)
        out = warp_rows(t.transpose(0, 1), cp, sw.bf16)  # (H, W, C)
    else:
        us = u[None, :]  # (1, W)
        pi = pg[:, None]  # (Wi, 1)
        if ortho:
            vs = _safe_div(pi - e[w1] - us * horizontal[w1], vertical[w1])
        else:
            num = (pi * (direction[axis] + us * horizontal[axis]) * sign
                   - direction[w1] - us * horizontal[w1])
            den = vertical[w1] - pi * vertical[axis] * sign
            vs = _safe_div(num, den)
        r1 = q_to_row(q_at(us, vs))  # (Wi, W)
        t = warp_rows(stack.transpose(0, 1), r1, sw.bf16)  # (Wi, W, C)
        out = warp_rows(t.transpose(0, 1), cp.T, sw.bf16).transpose(0, 1)
    color = out[..., 0:3].reshape(-1, 3)
    grad = out[..., 3:6].reshape(-1, 3)
    depth = out[..., 6].reshape(-1)
    alpha = torch.clamp(out[..., 7], 0.0, 1.0).reshape(-1)
    return color, grad, depth, alpha
