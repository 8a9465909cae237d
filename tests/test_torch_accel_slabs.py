"""The macrocell value ranges built slab by slab
(`ovr_tpu_torch.render.accel.compute_value_ranges`) against a plain
float64 whole-grid reference, on the CPU: equal to the bit for every
storage type, on dims no multiple of 16, whatever the budget makes of
the slabs; the slab counter; and the budget's reckoning of a slab's
temporaries against what the build allocated.

    python -m pytest tests/test_torch_accel_slabs.py -q
"""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from ovr_tpu_torch.core.sampling import storage_scale
from ovr_tpu_torch.render import accel

DTYPES = {"u8": torch.uint8, "u16": torch.uint16, "bf16": torch.bfloat16,
          "f32": torch.float32}
DIMS = [(37, 21, 50), (50, 33, 17)]  # z, y, x: none a multiple of 16


def make_grid(dims, dtype, seed=7):
    g = torch.rand(dims, generator=torch.Generator().manual_seed(seed))
    if dtype == torch.uint8:
        return torch.round(g * 255).to(torch.uint8)
    if dtype == torch.uint16:
        return torch.round(g * 65535).to(torch.int32).to(torch.uint16)
    return g.to(dtype)


def raw64(grid):
    if grid.dtype == torch.uint16:
        return grid.to(torch.int32).to(torch.float64)
    return grid.to(torch.float64)


def reference(grid):
    """(lo, hi): the min and max of every 18-voxel window at stride 16,
    the grid padded by a voxel in front of each axis and as far as the
    last window reaches behind it (+inf for the min, -inf for the max),
    in float64, then scaled as the build scales its cells."""
    v = raw64(grid)
    m = [math.ceil(d / 16) for d in v.shape]
    pad = []
    for n, c in reversed(list(zip(v.shape, m))):
        pad += [1, (c - 1) * 16 + 18 - 1 - n]
    lo_p = F.pad(v, pad, value=math.inf)
    hi_p = F.pad(v, pad, value=-math.inf)
    lo = torch.empty(m, dtype=torch.float64)
    hi = torch.empty(m, dtype=torch.float64)
    for k in range(m[0]):
        for j in range(m[1]):
            for i in range(m[2]):
                w = (slice(16 * k, 16 * k + 18), slice(16 * j, 16 * j + 18),
                     slice(16 * i, 16 * i + 18))
                lo[k, j, i] = lo_p[w].min()
                hi[k, j, i] = hi_p[w].max()
    s = storage_scale(grid.dtype)
    return lo.float() * s, hi.float() * s


def budget_for(kind, dims, wdt):
    mz = math.ceil(dims[0] / 16)
    if kind == "one_slab":
        return 1 << 40, 1
    if kind == "two_slabs":
        half = math.ceil(mz / 2)
        return accel._slab_bytes(half, dims, wdt), 2
    return 1, mz  # below one layer's bytes: a layer a slab


@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("kind", ["one_slab", "two_slabs", "layer_a_slab"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_slabs_equal_the_whole_grid_reference(dtype, kind, dims,
                                              monkeypatch):
    grid = make_grid(dims, DTYPES[dtype])
    wdt = accel._pool_dtype(grid.dtype)
    budget, slabs = budget_for(kind, dims, wdt)
    monkeypatch.setattr(accel, "VALUE_RANGE_BUDGET", budget)
    n0 = accel.VALUE_RANGE_SLABS
    lo, hi = accel.compute_value_ranges(grid)
    want_lo, want_hi = reference(grid)
    assert lo.dtype == hi.dtype == torch.float32
    assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)
    assert accel.VALUE_RANGE_SLABS - n0 == slabs


class Allocations(TorchDispatchMode):
    """Bytes of the storages the operations made: each output whose
    storage is none of the operation's inputs' (not a view, not written
    in place)."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = {t.untyped_storage().data_ptr() for t in
               torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        for t in torch.utils._pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() not in ins):
                self.sizes.append(t.untyped_storage().nbytes())
        return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_counters_count_what_the_slabs_allocate(dtype, monkeypatch):
    """Slabs of two layers: `_slab_bytes`, from which the budget sizes a
    slab, is what each slab allocated, every storage but the two
    results' (cells concatenated, widened to float32 and scaled); the
    slab counter counts the two."""
    dims = (50, 33, 17)
    grid = make_grid(dims, DTYPES[dtype])
    wdt = accel._pool_dtype(grid.dtype)
    monkeypatch.setattr(accel, "VALUE_RANGE_BUDGET",
                        accel._slab_bytes(2, dims, wdt))
    n0 = accel.VALUE_RANGE_SLABS
    with Allocations() as seen:
        lo, _ = accel.compute_value_ranges(grid)
    assert accel.VALUE_RANGE_SLABS - n0 == 2  # 4 layers, 2 a slab
    cells = lo.numel()
    e = wdt.itemsize
    results = 2 * cells * e + 2 * cells * 4 * (2 if wdt != torch.float32
                                               else 1)
    counted = sum(seen.sizes) - results
    assert counted == 2 * accel._slab_bytes(2, dims, wdt)
    # each slab's temporaries from their shapes: the planes (with the
    # halo) where cast or at the grid's edge, then per extreme the
    # layers' z, y and x windows and the widened arrays between them
    _, yd, xd = dims
    my, mx = math.ceil(yd / 16), math.ceil(xd / 16)
    per_layer = 2 * (yd * xd + (16 * my + 2) * xd + my * xd
                     + my * (16 * mx + 2) + my * mx)
    # both slabs touch an end of the grid, so both copy their planes
    want = 2 * ((16 * 2 + 2) * yd * xd + 2 * per_layer)
    assert counted == want * e


def test_interior_slabs_of_a_float_grid_copy_no_planes(monkeypatch):
    """A float32 grid pools in its own type: a slab inside the grid is
    read in place, so it allocates only its windows' arrays."""
    dims = (80, 20, 20)  # 5 layers
    grid = make_grid(dims, torch.float32)
    monkeypatch.setattr(accel, "VALUE_RANGE_BUDGET",
                        accel._slab_bytes(1, dims, torch.float32))
    with Allocations() as seen:
        lo, hi = accel.compute_value_ranges(grid)
    planes = 18 * 20 * 20 * 4
    results = 2 * lo.numel() * 4 * 2
    # the two slabs at the grid's ends copy their planes, the three
    # inside copy none
    assert sum(seen.sizes) - results == (
        5 * accel._slab_bytes(1, dims, torch.float32) - 3 * planes)
    want_lo, want_hi = reference(grid)
    assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)


@pytest.mark.parametrize("dims,dtype,layers", [
    ((1920, 2048, 2048), torch.uint8, 3),  # Richtmyer-Meshkov
    ((1024, 1024, 1024), torch.float32, 6),  # miranda
    ((1080, 1024, 1024), torch.uint16, 6),  # chameleon
])
def test_slab_sizing_at_published_sizes(dims, dtype, layers):
    """From the budget alone (no grid is made): the most layers whose
    temporaries fit it."""
    wdt = accel._pool_dtype(dtype)
    assert accel._slab_layers(dims, wdt) == layers
    assert accel._slab_bytes(layers, dims, wdt) \
        <= accel.VALUE_RANGE_BUDGET \
        < accel._slab_bytes(layers + 1, dims, wdt)
