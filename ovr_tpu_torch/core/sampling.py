"""Transfer-function and ray/box math on tensors.

Port of the parts of `ovr_tpu.core.sampling` that the shear-warp path
uses: the normalized-integer storage scale, value normalization, the
nodal 1D TF lookup (`array1d_nodal`), opacity correction, a zero-safe
normalize and the ray/box slab test with its degenerate-direction guard.
"""

from __future__ import annotations

import torch


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
    return (torch.clamp(sample, lo, hi) - lo) * scale


def sample_table_1d(table: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Nodal 1D table lookup: linear interpolation at v * (N - 1)."""
    n = table.shape[0]
    v = torch.clamp(v, 0.0, 1.0)
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
    a = torch.clamp(alpha, 0.0, 1.0 - 1e-7)
    corrected = torch.clamp(1.0 - torch.pow(1.0 - a, k), 0.0, 1.0)
    return torch.where(torch.abs(k - 1.0) < 1e-7,
                       torch.clamp(alpha, 0.0, 1.0), corrected)


def safe_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize along the last axis with a zero-safe guard."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=eps))


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
