"""Neural scalar-field volume: hash-grid encoding + MLP head.

Port of `ovr_tpu.neural.field`. The field maps object-space positions p
in [0,1]^3 to a scalar sample in [0,1] (sigmoid head), a drop-in for the
trilinear grid sample: the same TF classification, opacity correction
and compositing apply, and pixel gradients reach the hash tables and the
MLP weights through the render path.

`NeuralFieldVolume` is an `nn.Module`: the tables are a parameter
(L, T, F), the MLP a `ParameterList` of (W (din, dout), b) pairs in the
JAX package's layout, the world box and `data_range` buffers. Its
parameters require grad, as a module's do; render under
`torch.no_grad()` when no gradient is wanted (a differentiable bake of a
512^3 proxy keeps the activations of 134 M points).

Under `compute_dtype=torch.bfloat16` each product takes bf16-rounded
operands and sums in f32 (JAX's `preferred_element_type=float32`): the
operands are rounded to bf16 and multiplied as f32, since a bf16 matmul
would round its result too.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from ovr_tpu_torch.core.sampling import axis_constants, sample_volume
from ovr_tpu_torch.neural.hashgrid import (HashGridConfig, encode,
                                           init_hashgrid)


class NeuralFieldVolume(nn.Module):
    """Hash tables + MLP + world box: a volume the renderer samples in
    place of a dense grid."""

    def __init__(self, tables, weights, world_lo, world_hi, data_range,
                 grid_cfg: HashGridConfig = HashGridConfig(),
                 compute_dtype=torch.float32):
        super().__init__()
        self.tables = nn.Parameter(tables)
        self.layers = nn.ParameterList([x for w, b in weights
                                        for x in (w, b)])
        self.register_buffer("world_lo", world_lo)
        self.register_buffer("world_hi", world_hi)
        self.register_buffer("data_range", data_range)
        self.grid_cfg = grid_cfg
        self.compute_dtype = compute_dtype

    @property
    def weights(self) -> tuple:
        """The MLP's (W (din, dout), b) pairs."""
        n = len(self.layers) // 2
        return tuple((self.layers[2 * i], self.layers[2 * i + 1])
                     for i in range(n))


def init_field(generator, grid_cfg: HashGridConfig = HashGridConfig(),
               hidden: int = 64, n_hidden: int = 2,
               compute_dtype=torch.float32, device="cuda"
               ) -> NeuralFieldVolume:
    """A field with ngp-initialised tables and He-normal weights (zero
    biases), drawn in that order from `generator` (a `torch.Generator`,
    or an int seeding one on the CPU) and placed on `device`."""
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)
    tables = init_hashgrid(generator, grid_cfg, device)
    dims = [grid_cfg.out_dim] + [hidden] * n_hidden + [1]
    weights = []
    for din, dout in zip(dims[:-1], dims[1:]):
        w = torch.randn((din, dout), generator=generator,
                        device=generator.device) * (2.0 / din) ** 0.5
        weights.append((w.to(device), torch.zeros(dout, device=device)))

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return NeuralFieldVolume(tables, weights, f32([0.0] * 3), f32([1.0] * 3),
                             f32([0.0, 1.0]), grid_cfg, compute_dtype)


def apply_field(tables, weights, grid_cfg: HashGridConfig, compute_dtype,
                p: torch.Tensor) -> torch.Tensor:
    """The field of these tables and (W, b) pairs at p (..., 3) in
    [0,1]^3 -> scalar (...)."""
    h = encode(tables, grid_cfg, p)
    rounded = compute_dtype != torch.float32
    if rounded:
        h = h.to(compute_dtype)
    for i, (w, b) in enumerate(weights):
        if rounded:
            h = h.float() @ w.to(compute_dtype).float() + b
        else:
            h = h @ w.to(h.dtype) + b
        if i + 1 < len(weights):
            h = torch.relu(h)
            if rounded:
                h = h.to(compute_dtype)
    return torch.sigmoid(h[..., 0].float())


def field_sample(field: NeuralFieldVolume, p: torch.Tensor) -> torch.Tensor:
    """Evaluate the field at p (..., 3) in [0,1]^3 -> scalar (...)."""
    return apply_field(field.tables, field.weights, field.grid_cfg,
                       field.compute_dtype, p)


def is_field(volume) -> bool:
    return isinstance(volume, NeuralFieldVolume)


def volume_repr(volume):
    """What the renderer samples: a dense volume's grid, or the field
    itself."""
    return volume if is_field(volume) else volume.grid


def sample_any_volume(volume_repr, p: torch.Tensor) -> torch.Tensor:
    """Sample either a dense (Z, Y, X) grid or a NeuralFieldVolume."""
    if is_field(volume_repr):
        return field_sample(volume_repr, p)
    return sample_volume(volume_repr, p)


def volume_rdim(volume_repr, dtype, device) -> torch.Tensor:
    """The forward-difference gradient step per axis: one voxel of a
    dense grid, one finest-level cell (1 / max_resolution) of a field."""
    if is_field(volume_repr):
        return _field_rdim(volume_repr.grid_cfg.max_resolution, dtype,
                           device)
    zd, yd, xd = volume_repr.shape
    return axis_constants(xd, yd, zd, dtype, device)[2]


@functools.lru_cache(maxsize=16)
def _field_rdim(r: int, dtype, device) -> torch.Tensor:
    return torch.full((3,), 1.0 / float(r), dtype=dtype, device=device)
