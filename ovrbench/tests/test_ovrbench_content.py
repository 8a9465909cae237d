"""The seeded volume generators' promises, at small sizes on the CPU.

    python -m pytest ovrbench/tests/test_ovrbench_content.py -q
"""

from __future__ import annotations

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ovrbench.content import mixing_layer

DIMS = (96, 64, 80)  # z, y, x
SEED = 3_000_000_017


class LargestFloat32(TorchDispatchMode):
    """Records the most elements of any float32 tensor an operation made."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.most = max(self.most, t.numel())
        return out


@pytest.fixture(scope="module")
def grids():
    return {s: mixing_layer.make(DIMS, torch.uint8, s, "cpu")
            for s in (SEED, 5)}


def test_mixing_layer_is_uint8_in_1_to_255_inside(grids):
    g = grids[SEED]
    assert g.dtype == torch.uint8 and tuple(g.shape) == DIMS
    nz, ny, nx = DIMS
    x = torch.linspace(0, 1, nx)[None, None, :]
    y = torch.linspace(0, 1, ny)[None, :, None]
    z = torch.linspace(0, 1, nz)[:, None, None]
    inside = torch.abs(z - mixing_layer.interface(x, y)) \
        < mixing_layer.HALF_WIDTH
    assert torch.equal(g != 0, inside)
    vals = g[inside]
    # the layer spans the whole range, down to its faint edge
    assert int(vals.min()) == 1 and int(vals.max()) == 255
    # both pure fluids are there, above and below the layer
    occupied = inside.any(2).any(1)
    assert not occupied[0] and not occupied[-1] and occupied[nz // 2]


def test_seed_moves_voxels_not_the_zero_set(grids):
    a, b = grids[SEED], grids[5]
    assert torch.equal(a != 0, b != 0)
    moved = a != b
    assert moved.any()
    # by one noise step each way at most: the field itself is fixed
    diff = a.to(torch.int16) - b.to(torch.int16)
    assert int(diff.abs().max()) <= 2
    assert torch.equal(mixing_layer.make(DIMS, torch.uint8, SEED, "cpu"), a)


def test_no_float32_beyond_one_slab():
    nz, ny, nx = DIMS
    with LargestFloat32() as seen:
        mixing_layer.make(DIMS, torch.uint8, SEED, "cpu")
    assert 0 < seen.most <= mixing_layer.SLAB * ny * nx < nz * ny * nx


def test_other_storage_refused():
    with pytest.raises(ValueError):
        mixing_layer.make(DIMS, torch.float32, SEED, "cpu")
