"""Macrocell value ranges and transfer-function majorants.

Port of `ovr_tpu.render.accel`'s builder: per 16-voxel macrocell, the
(lo, hi) value range over an 18-voxel window at stride 16 (one voxel of
halo on each side, so every trilinear fetch inside the cell is covered)
and the majorant, the max TF opacity over the cell's widened node-index
range. The fused slice kernel skips planes whose covering majorants are
all <= 1.19e-7; the march asks the grid for the majorant at a point and
for the distance to the exit of the cell around it (`majorant_at`,
`cell_exit_t`: the lockstep form of a per-ray DDA). JAX's
`reduce_window` over the whole grid becomes a build one z-slab of
macrocell layers at a time (`compute_value_ranges`), so that its
temporaries stay within `VALUE_RANGE_BUDGET` whatever the grid's size.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ovr_tpu_torch.core.sampling import axis_constants, storage_scale
from ovr_tpu_torch.utils import trace

MACROCELL_SIZE = 16
WINDOW = MACROCELL_SIZE + 2  # a cell's voxels and one of halo each side
VALUE_RANGE_BUDGET = 512 << 20  # bytes of temporaries a value-range slab

VALUE_RANGE_SLABS = 0  # slabs built by `compute_value_ranges`
trace.register_counter("accel.VALUE_RANGE_SLABS", lambda: VALUE_RANGE_SLABS)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class MacrocellGrid:
    """Per-macrocell (value_lo, value_hi, majorant), each (MZ, MY, MX)."""

    value_lo: torch.Tensor
    value_hi: torch.Tensor
    majorant: torch.Tensor
    vol_dims: tuple[int, int, int]  # (X, Y, Z) voxel dims

    @property
    def mc_dims(self) -> tuple[int, int, int]:
        """(MX, MY, MZ)."""
        mz, my, mx = self.value_lo.shape
        return (mx, my, mz)

    # ---- the march's queries (object space p in [0,1]^3) ----

    def cell_index(self, p_obj: torch.Tensor) -> torch.Tensor:
        """Macrocell (x, y, z) containing object-space points (..., 3)."""
        xd, yd, zd = self.vol_dims
        dims = axis_constants(xd, yd, zd, p_obj.dtype, p_obj.device)[0]
        mx, my, mz = self.mc_dims
        top = axis_constants(mx, my, mz, p_obj.dtype, p_obj.device)[1]
        cell = torch.floor(p_obj * dims / MACROCELL_SIZE).long()
        return torch.minimum(torch.clamp(cell, min=0), top)

    def majorant_at(self, p_obj: torch.Tensor) -> torch.Tensor:
        c = self.cell_index(p_obj)
        mx = self.mc_dims[0]
        idx = (c[..., 2] * self.majorant.shape[1] + c[..., 1]) * mx \
            + c[..., 0]
        return self.majorant.reshape(-1)[idx]

    def is_empty(self, p_obj: torch.Tensor, eps: float = 1.19e-7
                 ) -> torch.Tensor:
        return self.majorant_at(p_obj) <= eps

    def cell_exit_t(self, org, direction, t, world_lo, world_hi,
                    eps: float = 1e-5):
        """World-space t at which each ray leaves the macrocell that
        contains org + t*dir, nudged `eps` past the boundary."""
        extent = world_hi - world_lo
        pos = org + t[..., None] * direction
        p_obj = (pos - world_lo) / extent
        c = self.cell_index(p_obj).to(org.dtype)
        xd, yd, zd = self.vol_dims
        dims = axis_constants(xd, yd, zd, org.dtype, org.device)[0]
        cell_w = MACROCELL_SIZE / dims  # object units per cell
        blo = world_lo + c * cell_w * extent
        bhi = world_lo + (c + 1.0) * cell_w * extent
        small = torch.abs(direction) < 1e-12
        rcp = 1.0 / torch.where(small, 1.0, direction)
        t_far = torch.maximum((blo - org) * rcp, (bhi - org) * rcp)
        t_far = torch.where(small, 3.4e38, t_far)
        return t_far.amin(dim=-1) + eps


def _pool_dtype(dtype) -> torch.dtype:
    """u8 and bf16 grids pool in bfloat16 (exact for integers <= 256),
    others in float32."""
    return (torch.bfloat16 if dtype in (torch.bfloat16, torch.uint8)
            else torch.float32)


def _back(n: int) -> int:
    """Voxels past the end of an axis of n that its last window reaches."""
    return (_cdiv(n, MACROCELL_SIZE) - 1) * MACROCELL_SIZE + WINDOW - 1 - n


def _widened(x, dim: int, back: int):
    """x along `dim` with its first element repeated once before it and
    its last `back` times after it. A window reaching past the grid's
    edge holds the edge voxel too, so the repeats change no window's max
    or min: they stand for the -inf and +inf pads of JAX's
    `reduce_window`."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, 1), x]
                     + [x.narrow(dim, n - 1, 1)] * back, dim)


def _windows(x, dim: int):
    """The windows of 18 at stride 16 along `dim`, as a last dim."""
    return x.unfold(dim, WINDOW, MACROCELL_SIZE)


def _slab_bytes(layers: int, dims, wdt) -> int:
    """Bytes of the temporaries of a slab of `layers` macrocell layers,
    its planes copied into a buffer of the pooling type."""
    _, yd, xd = dims
    my, mx = _cdiv(yd, MACROCELL_SIZE), _cdiv(xd, MACROCELL_SIZE)
    n = (layers * MACROCELL_SIZE + 2) * yd * xd
    # per extreme: the z windows' result, it widened along y, the y
    # windows' result, it widened along x, and the cells
    n += 2 * layers * (yd * xd + (yd + 1 + _back(yd)) * xd + my * xd
                       + my * (xd + 1 + _back(xd)) + my * mx)
    return n * wdt.itemsize


def _slab_layers(dims, wdt) -> int:
    """Macrocell layers a slab: the most whose temporaries fit
    `VALUE_RANGE_BUDGET` (at least one)."""
    mz = _cdiv(dims[0], MACROCELL_SIZE)
    layers = 1
    while (layers < mz and _slab_bytes(layers + 1, dims, wdt)
           <= VALUE_RANGE_BUDGET):
        layers += 1
    return layers


def compute_value_ranges(grid: torch.Tensor):
    """Per-macrocell (lo, hi) in normalized units: the min and max over an
    18-voxel window at stride 16, one voxel of halo each side. The grid
    is read one z-slab of macrocell layers at a time, sized from
    `VALUE_RANGE_BUDGET`: the slab's planes with their halo, cast to the
    pooling type (`_pool_dtype`; a view of the grid where no cast or edge
    is needed), are reduced along z, then y, then x. Max and min are
    exact, so the slabs and the order change no bit. No value comes to
    the host. The storage scale applies to the small per-cell results."""
    global VALUE_RANGE_SLABS
    dims = tuple(grid.shape)
    zd = dims[0]
    mz = _cdiv(zd, MACROCELL_SIZE)
    wdt = _pool_dtype(grid.dtype)
    layers = _slab_layers(dims, wdt)
    los, his = [], []
    for a in range(0, mz, layers):
        b = min(a + layers, mz)
        z0 = max(a * MACROCELL_SIZE - 1, 0)
        z1 = min(b * MACROCELL_SIZE + 1, zd)
        front = z0 - (a * MACROCELL_SIZE - 1)
        back = b * MACROCELL_SIZE + 1 - z1
        if wdt != grid.dtype or front or back:
            x = grid.new_empty((front + z1 - z0 + back,) + dims[1:],
                               dtype=wdt)
            x[front:front + z1 - z0] = grid[z0:z1]
            if front:
                x[0] = x[1]
            if back:
                x[-back:] = x[-back - 1]
        else:
            x = grid[z0:z1]
        lo, hi = torch.aminmax(_windows(x, 0), dim=-1)
        del x
        for dim in (1, 2):
            back_d = _back(lo.shape[dim])
            lo = _windows(_widened(lo, dim, back_d), dim).amin(-1)
            hi = _windows(_widened(hi, dim, back_d), dim).amax(-1)
        los.append(lo)
        his.append(hi)
        VALUE_RANGE_SLABS += 1
    s = storage_scale(grid.dtype)
    return torch.cat(los).float() * s, torch.cat(his).float() * s


def _range_max_table(alpha: torch.Tensor) -> list[torch.Tensor]:
    """Sparse table for O(1) range-max queries over the alpha table."""
    n = alpha.shape[0]
    levels = [alpha]
    k = 1
    while 2 * k <= n:
        prev = levels[-1]
        m = prev.shape[0] - k
        levels.append(torch.maximum(prev[:m], prev[k:k + m]))
        k *= 2
    return levels


def compute_majorants(value_lo, value_hi, alpha_table, tfn_value_range):
    """Max TF opacity over each cell's clamped, normalized value range,
    with the node-index window widened by one on each side."""
    n = alpha_table.shape[0]
    vr_lo = tfn_value_range[..., 0]
    vr_hi = tfn_value_range[..., 1]
    rcp = 1.0 / (vr_hi - vr_lo)
    lo = (torch.clamp(value_lo, vr_lo, vr_hi) - vr_lo) * rcp
    hi = (torch.clamp(value_hi, vr_lo, vr_hi) - vr_lo) * rcp
    i_lo = torch.clamp(torch.floor(lo * (n - 1) + 0.5).long() - 1, 0, n - 1)
    i_hi = torch.clamp(torch.floor(hi * (n - 1) + 0.5).long() + 1, 0, n - 1)

    levels = _range_max_table(alpha_table)
    length = i_hi - i_lo + 1
    k = torch.floor(torch.log2(length.float())).long()
    k = torch.clamp(k, 0, len(levels) - 1)
    padded = torch.stack([F.pad(lv, (0, n - lv.shape[0]),
                                value=float("-inf")) for lv in levels])
    pow2 = torch.bitwise_left_shift(torch.ones_like(k), k)
    a = padded[k, i_lo]
    b = padded[k, i_hi - pow2 + 1]
    return torch.maximum(a, b)


def build_macrocells(grid, alpha_table, tfn_value_range) -> MacrocellGrid:
    """Build the partition for a (Z, Y, X) grid."""
    dev = grid.device
    with trace.span("macrocells", dev):
        with trace.span("value_ranges", dev):
            lo, hi = compute_value_ranges(grid)
        with trace.span("majorants", dev):
            maj = compute_majorants(lo, hi, alpha_table, tfn_value_range)
    zd, yd, xd = grid.shape
    return MacrocellGrid(value_lo=lo, value_hi=hi, majorant=maj,
                         vol_dims=(xd, yd, zd))
