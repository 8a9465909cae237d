"""Dense path tracer: discrete-ordinates radiative transfer (port of
`ovr_tpu.render.ptdense`).

The reference's path-tracing pipeline
(`ovr/devices/optix7/shaders_pathtracing.cu:269-542`) delta-tracks each
ray to a collision, scatters isotropically (albedo = TF color), and
collects ambient light on escape after >= 1 scatter. This module solves
the *same transport equation* by dense lattice sweeps, the classic
discrete-ordinates (S_N) method:

  Let sigma(x) = alpha(x) * density_scale (the tracker's collision rate)
  and J(x) = expected radiance leaving a collision at x. The reference's
  estimator computes exactly

      J = albedo * ( ambient * E_esc  +  K J )                      (*)
      L(pixel) = integral of  sigma * T_cam * J  along the camera ray

  where E_esc(x) = mean_dir T(x -> boundary) and (K J)(x) =
  mean_dir integral of sigma * T * J along a ray from x. Both means are
  approximated by an M-direction quadrature (6 axial + 8 diagonal,
  equal-weighted); each directional term is computed for EVERY lattice
  point at once by a plane-by-plane shear sweep whose constant fractional
  lateral shift is two small matmuls, and (*) is solved by source
  iteration with the reference's collision budget (max_scatters / 2
  levels).

The camera gather L goes through the shear-warp frame:
`render_shearwarp(..., pt_fields=(sigma, J))` composites the
emission-absorption integral with per-plane opacity 1 - exp(-sigma dt)
and emission J (plain PyTorch, differentiable via `ops.adjoint.over_scan`).
The shift products are plain f32 matmuls, as the JAX package's are
(XLA, outside any Pallas kernel), with TF32 off. Differentiable by
autograd end to end.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ovr_tpu_torch.core.sampling import classify
from ovr_tpu_torch.neural.field import (is_field, sample_any_volume,
                                        volume_repr)

# 14-direction quadrature: 6 axial + 8 diagonals, equal weights (keeps
# the quadrature mean isotropic; within the method's lattice bias).
_AX = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
_DIAG = [np.array((sx, sy, sz)) / np.sqrt(3.0)
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
DIRECTIONS = np.array(_AX + _DIAG, np.float64)


@dataclasses.dataclass(frozen=True)
class PTDenseConfig:
    levels: int = 12        # source-iteration depth = collision budget
    n_dirs: int = 14        # 6 axial (+ 8 diagonal when 14)


@contextlib.contextmanager
def full_f32():
    """Matmuls on the card in full f32 (no TF32) inside the block."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def build_lattices(leaves, res: tuple[int, int, int]):
    """sigma (D,H,W) = classified alpha * density_scale and albedo
    (D,H,W,3) = TF color at lattice cell centers (the delta tracker's
    acceptance rate and throughput factor, shaders_pathtracing.cu:
    330-334, 520). u8/u16 grids sample through their storage scale."""
    grid, color_table, alpha_table, value_range, density_scale = leaves
    d, h, w = res
    opts = dict(dtype=torch.float32, device=color_table.device)
    zs = (torch.arange(d, **opts) + 0.5) / d
    ys = (torch.arange(h, **opts) + 0.5) / h
    xs = (torch.arange(w, **opts) + 0.5) / w
    pz, py, px = torch.meshgrid(zs, ys, xs, indexing="ij")
    p = torch.stack([px, py, pz], -1).reshape(-1, 3)
    rgb, a = classify(color_table, alpha_table, value_range,
                      sample_any_volume(grid, p))
    sigma = (a * density_scale).reshape(d, h, w)
    return sigma, rgb.reshape(d, h, w, 3)


def _shift_matrix(n: int, delta, dtype, device) -> torch.Tensor:
    """(n, n) resample matrix: row i holds the hat weights of source
    position i + delta, ZERO outside [0, n-1] (out-of-lattice = vacuum)."""
    pos = torch.arange(n, dtype=dtype, device=device) + float(delta)
    idx = torch.arange(n, dtype=dtype, device=device)[None, :]
    return torch.clamp(1.0 - torch.abs(pos[:, None] - idx), min=0.0)


def _spacing(spacing) -> np.ndarray:
    """World units per voxel (x, y, z) as numpy: a float32 tensor stays
    float32 (the JAX package's traced spacing), numbers are float64."""
    if isinstance(spacing, torch.Tensor):
        return spacing.detach().cpu().numpy()
    return np.asarray(spacing, np.float64)


def sweep_direction(sigma, emis, direction, spacing,
                    include_emis: bool = True):
    """One directional sweep: for every lattice point, marching along
    `direction` (unit, world axes x/y/z) with per-plane opacity
    a = 1 - exp(-sigma ds),

      T(x) = prod_k (1 - a_k)                      escape transmittance
      R(x) = sum_k a_k E_k prod_{j<k} (1 - a_j)    in-scattered gather

    Planes perpendicular to the principal axis are processed far-to-near;
    each reads the next plane's running (T, R) at a constant fractional
    lateral offset (two shift matmuls). Returns (T (D,H,W),
    R (D,H,W,3) | None). `spacing` = world units per voxel, (x, y, z).
    """
    d3 = np.asarray(direction, np.float64)
    axis = int(np.argmax(np.abs(d3)))
    sgn = 1 if d3[axis] >= 0 else -1
    gdim = 2 - axis  # grid dims are (z, y, x)
    sig = torch.movedim(sigma, gdim, 0)
    em = torch.movedim(emis, gdim, 0) if include_emis else None
    if sgn < 0:  # traversal order: +dim0 = +direction
        sig = sig.flip(0)
        em = em.flip(0) if include_emis else None
    n_a, n1, n2 = sig.shape
    rem = [g for g in (0, 1, 2) if g != gdim]
    lat_world = [2 - g for g in rem]  # world axes of dims 1, 2
    # the lateral shifts in the spacing's precision (a float32 spacing
    # rounds d3 to float32 first, as JAX does with a traced spacing)
    sp = _spacing(spacing)
    dc = d3.astype(sp.dtype)
    ds = sp[axis] / abs(dc[axis])
    dt, dev = sig.dtype, sig.device
    w1 = _shift_matrix(n1, dc[lat_world[0]] * ds / sp[lat_world[0]], dt,
                       dev)
    w2 = _shift_matrix(n2, dc[lat_world[1]] * ds / sp[lat_world[1]], dt,
                       dev)
    # weight mass lost off-lattice escapes with T = 1
    esc_miss = 1.0 - w1.sum(1)[:, None] * w2.sum(1)[None, :]
    w2t = w2.T

    a = 1.0 - torch.exp(-sig * float(ds))
    t_next = torch.ones((n1, n2), dtype=dt, device=dev)
    r_next = torch.zeros((n1, n2, 3), dtype=dt, device=dev)
    ts, rs = [], []
    with full_f32():
        for k in range(n_a - 1, -1, -1):
            t_sh = w1 @ t_next @ w2t + esc_miss
            ak = a[k]
            t_next = (1.0 - ak) * t_sh
            ts.append(t_next)
            if include_emis:
                sh = torch.einsum("lk,ikc->ilc", w2,
                                  torch.einsum("ij,jkc->ikc", w1, r_next))
                r_next = ak[..., None] * em[k] + (1.0 - ak)[..., None] * sh
                rs.append(r_next)
    # the planes came out n_a-1..0; ascending = reverse; undo the sgn < 0
    # flip by reversing again — the two cancel when sgn < 0.
    t_field = torch.stack(ts if sgn < 0 else ts[::-1])
    t_field = torch.movedim(t_field, 0, gdim)
    r_field = None
    if include_emis:
        r_field = torch.movedim(torch.stack(rs if sgn < 0 else rs[::-1]),
                                0, gdim)
    return t_field, r_field


def solve_scatter(sigma, albedo, ambient, spacing, cfg: PTDenseConfig):
    """Source iteration for J = albedo * (ambient * E_esc + K J).
    Returns J (D,H,W,3)."""
    dirs = DIRECTIONS[:cfg.n_dirs]
    wq = 1.0 / len(dirs)

    e_esc = torch.zeros_like(sigma)
    for d3 in dirs:
        t_f, _ = sweep_direction(sigma, None, d3, spacing,
                                 include_emis=False)
        e_esc = e_esc + wq * t_f

    j0 = albedo * (ambient * e_esc)[..., None]
    j = j0
    for _ in range(cfg.levels - 1):
        kj = torch.zeros_like(j)
        for d3 in dirs:
            _, r_f = sweep_direction(sigma, j, d3, spacing)
            kj = kj + wq * r_f
        j = j0 + albedo * kj
    return j


def prepare(scene, cfg):
    """Build (sigma, J) for the scene — camera-independent; rebuild when
    the volume, TF, density scale, or ambient changes. The lattice is
    min(grid, cfg.pt_lattice) per axis (a neural field counts as
    128^3); max_scatters // 2 levels."""
    vol = scene.volume
    leaves = (volume_repr(vol), scene.tfn.color, scene.tfn.alpha,
              scene.tfn.value_range, scene.density_scale)
    shape = (128, 128, 128) if is_field(vol) else vol.grid.shape
    res = tuple(min(int(s), cfg.pt_lattice) for s in shape)
    sigma, albedo = build_lattices(leaves, res)
    ext = vol.world_hi - vol.world_lo
    spacing = torch.stack([ext[i] / res[2 - i] for i in (0, 1, 2)])
    ptc = PTDenseConfig(levels=max(cfg.max_scatters // 2, 1),
                        n_dirs=cfg.pt_dirs)
    j = solve_scatter(sigma, albedo, scene.light.ambient, spacing, ptc)
    return sigma, j


def render_frame_dense(scene, cfg, camera, pt_fields=None):
    """Render the path-traced image densely: solve (or reuse) the
    scatter lattices, then composite L = integral sigma T J through the
    shear-warp fan (cfg.sw must be resolved with pt eligibility)."""
    from ovr_tpu_torch.api import Frame
    from ovr_tpu_torch.render import integrator as ig
    from ovr_tpu_torch.render.shearwarp import render_shearwarp

    if pt_fields is None:
        pt_fields = prepare(scene, cfg)
    color, grad, depth, alpha = render_shearwarp(
        scene, cfg, camera, pt_fields=pt_fields)
    color, grad, depth, alpha = ig.finalize(color, grad, depth, alpha)
    # reference CH sets alpha = 1 on any box hit (:541): alpha from the
    # fan composite is the box-coverage footprint after the warp, but the
    # tracker's alpha is binary; keep the composite (anti-aliased edge).
    rgba = torch.cat([color, alpha[..., None]], -1)
    return Frame(rgba=rgba.reshape(cfg.height, cfg.width, 4),
                 grad=grad.reshape(cfg.height, cfg.width, 3),
                 depth=depth.reshape(cfg.height, cfg.width))
