"""Volume, transfer-function and ray/box math on tensors.

Port of `ovr_tpu.core.sampling`: the tex3D-style trilinear fetch with
the CUDA half-texel clamp and its forward-difference gradient, the
normalized-integer storage scale, value normalization, the nodal 1D TF
lookup (`array1d_nodal`), opacity correction, a zero-safe normalize and
the ray/box slab test with its degenerate-direction guard.

Every clip is `clip` (min of max), whose gradient halves at a bound as
`jnp.clip`'s does; `torch.clamp` would pass the whole cotangent.
"""

from __future__ import annotations

import contextlib
import functools

import torch


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """min(max(x, lo), hi), which halves the cotangent where x equals a
    bound, as `jnp.clip` does. `lo`/`hi`: numbers or tensors that
    broadcast against x."""
    if not isinstance(lo, torch.Tensor):
        lo = scalar(lo, x.dtype, x.device)
    if not isinstance(hi, torch.Tensor):
        hi = scalar(hi, x.dtype, x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


_fresh = False  # inside `fresh_constants`


@functools.lru_cache(maxsize=256)
def _cached_scalar(value: float, dtype, device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def scalar(value: float, dtype, device) -> torch.Tensor:
    """A 0-d constant, made once per (value, dtype, device): a
    `torch.maximum` bound without a fill launch per call. Read-only.
    Inside `fresh_constants`, a new one each call."""
    if _fresh:
        return torch.full((), value, dtype=dtype, device=device)
    return _cached_scalar(value, dtype, device)


@contextlib.contextmanager
def fresh_constants():
    """`scalar` makes a new constant each call inside. A CUDA graph
    captured there fills its own constants and reads them by address; a
    cached one could leave the cache and its memory be reused while the
    graph still reads it."""
    global _fresh
    was, _fresh = _fresh, True
    try:
        yield
    finally:
        _fresh = was


@functools.lru_cache(maxsize=64)
def axis_constants(xd: int, yd: int, zd: int, dtype, device):
    """(X, Y, Z) and (1/X, 1/Y, 1/Z) in `dtype`, (X-1, Y-1, Z-1) in
    int32, on `device`; made once per grid shape (a tensor from host
    numbers is a copy to the device on every call)."""
    return (torch.tensor([xd, yd, zd], dtype=dtype, device=device),
            torch.tensor([xd - 1, yd - 1, zd - 1], dtype=torch.int32,
                         device=device),
            torch.tensor([1.0 / xd, 1.0 / yd, 1.0 / zd], dtype=dtype,
                         device=device))


def sample_volume(grid: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a (Z, Y, X) grid at normalized coords p (..., 3)
    = (x, y, z) in [0, 1]^3 (clamped). Texel centers sit at (i + 0.5) /
    dim; coordinates outside the centers clamp (CUDA clamp addressing
    with linear filtering). The 8 corners are one gather indexed per
    axis, so each corner's offset is formed inside the gather in int64
    (a flat int32 index would overflow past ~1290^3) and no 8 indices per
    point are stored; bf16 and integer grids gather their own type and
    interpolate in p's dtype; u8/u16 scale by the storage scale."""
    zd, yd, xd = grid.shape[-3:]
    dims, top, _ = axis_constants(xd, yd, zd, p.dtype, p.device)
    c = clip(p, 0.0, 1.0) * dims - 0.5
    c = clip(c, 0.0, dims - 1.0)
    i0f = torch.floor(c)
    f = c - i0f
    i0 = i0f.int()
    ii = torch.stack([i0, torch.minimum(i0 + 1, top)], dim=-1)  # (..., 3, 2)
    xs, ys, zs = ii.unbind(-2)
    # CUDA's index kernels have no uint16 version: gather its int16 bits
    u16 = grid.dtype == torch.uint16
    src = grid.view(torch.int16) if u16 else grid
    # corners in the order 000, 100, 010, 110, 001, 101, 011, 111 (x
    # fastest): [z][y][x] of the broadcast gather
    cs = src[zs[..., :, None, None], ys[..., None, :, None],
             xs[..., None, None, :]]
    if u16:
        cs = cs.to(torch.int32) & 0xFFFF
    cs = cs.reshape(cs.shape[:-3] + (8,)).to(p.dtype)
    fx, fy, fz = (t[..., None] for t in f.unbind(-1))
    cx = cs[..., 0::2] * (1 - fx) + cs[..., 1::2] * fx  # c00 c10 c01 c11
    cy = cx[..., 0::2] * (1 - fy) + cx[..., 1::2] * fy  # c0 c1
    out = cy[..., 0] * (1 - fz[..., 0]) + cy[..., 1] * fz[..., 0]
    return out * storage_scale(grid.dtype)


def fd_points(p: torch.Tensor, rdim: torch.Tensor, hi=1.0,
              center: bool = False):
    """The forward-difference step per axis (flipped where p + rdim
    would cross `hi`) and the probe points: (stp (..., 3), points
    (..., 3, 3), row a = p moved by stp[a] along axis a); with `center`,
    p itself first (points (..., 4, 3))."""
    stp = torch.where(p + rdim > hi, -rdim, rdim)
    eye = _probe_axes(center, p.dtype, p.device)
    return stp, p[..., None, :] + stp[..., None, :] * eye


@functools.lru_cache(maxsize=16)
def _probe_axes(center: bool, dtype, device) -> torch.Tensor:
    """The 3x3 identity, below a zero row with `center`."""
    eye = torch.eye(3, dtype=dtype, device=device)
    if center:
        eye = torch.cat([torch.zeros_like(eye[:1]), eye])
    return eye


def gradient_of(sample_fn, p: torch.Tensor, center_value: torch.Tensor,
                rdim: torch.Tensor, hi=1.0) -> torch.Tensor:
    """Forward-difference gradient of a scalar field in [0,1]^3, step
    `rdim` per axis; steps that would cross `hi` (the volume's upper
    boundary in local coordinates) flip sign. Unnormalized: per axis
    (f(p + step) - f(p)) / step."""
    stp, pts = fd_points(p, rdim, hi)
    return (sample_fn(pts) - center_value[..., None]) / stp


def volume_gradient(grid: torch.Tensor, p: torch.Tensor,
                    center_value: torch.Tensor) -> torch.Tensor:
    """`gradient_of` for a dense grid with a one-voxel step per axis."""
    zd, yd, xd = grid.shape[-3:]
    rdim = axis_constants(xd, yd, zd, p.dtype, p.device)[2]
    return gradient_of(lambda q: sample_volume(grid, q), p, center_value,
                       rdim)


def storage_scale(dtype) -> float:
    """Normalized-integer storage scale: a u8/u16 grid samples as
    raw * 1/int_max. Floats scale by 1."""
    if dtype.is_floating_point:
        return 1.0
    return 1.0 / float(torch.iinfo(dtype).max)


def normalize_value(sample: torch.Tensor, value_range: torch.Tensor
                    ) -> torch.Tensor:
    """Map a raw sample into [0,1] TF coordinates via the value range."""
    lo = value_range[..., 0]
    hi = value_range[..., 1]
    scale = 1.0 / (hi - lo)
    return (clip(sample, lo, hi) - lo) * scale


def sample_table_1d(table: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Nodal 1D table lookup: linear interpolation at v * (N - 1)."""
    n = table.shape[0]
    v = clip(v, 0.0, 1.0)
    c = v * (n - 1)
    i0f = torch.floor(c)
    f = c - i0f
    i0 = i0f.long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    lo = table[i0]
    hi = table[i1]
    if table.ndim == 2:
        f = f[..., None]
    return lo * (1 - f) + hi * f


def classify(color_table, alpha_table, value_range, sample):
    """TF classification of a raw sample -> (rgb (..., 3), alpha (...))."""
    v = normalize_value(sample, value_range)
    return sample_table_1d(color_table, v), sample_table_1d(alpha_table, v)


def opacity_correction(alpha, base, step):
    """1 - (1-a)^(base*step), clamped to [0, 1]; the table alpha as is
    where base*step is within 1e-7 of 1."""
    k = base * step
    a = clip(alpha, 0.0, 1.0 - 1e-7)
    corrected = clip(1.0 - torch.pow(1.0 - a, k), 0.0, 1.0)
    return torch.where(torch.abs(k - 1.0) < 1e-7, clip(alpha, 0.0, 1.0),
                       corrected)


def safe_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize along the last axis with a zero-safe guard."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.maximum(n2, scalar(eps, n2.dtype, n2.device)))


def intersect_box(org, direction, lower, upper, t0, t1):
    """Ray/AABB slab test; returns clipped (t0, t1) (empty when t1 <= t0).
    Directions with |d| < 1e-12 on an axis count as parallel to it: the
    slab then clips everything or nothing by the origin's side."""
    big = torch.tensor(1e20, dtype=org.dtype, device=org.device)
    small = torch.abs(direction) < 1e-12
    rcp = torch.where(small, 1.0,
                      1.0 / torch.where(small, 1.0, direction))
    t_lo = torch.where(small, torch.where(org >= lower, -big, big),
                       (lower - org) * rcp)
    t_hi = torch.where(small, torch.where(org <= upper, big, -big),
                       (upper - org) * rcp)
    tmin = torch.minimum(t_lo, t_hi)
    tmax = torch.maximum(t_lo, t_hi)
    t0 = torch.maximum(t0, tmin.amax(dim=-1))
    t1 = torch.minimum(t1, tmax.amin(dim=-1))
    return t0, t1
