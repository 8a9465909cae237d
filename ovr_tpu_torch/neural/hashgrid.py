"""Multi-resolution hash-grid encoding (instant-ngp style).

Port of `ovr_tpu.neural.hashgrid`: per level, the 8 lattice corners
around a point are hashed into that level's feature table and
trilinearly blended; the levels' features are concatenated.

The hash multiplies uint32 corner indices by primes above 2^31 with
wraparound, then reduces modulo the table size. Here it is formed in
int64 and masked with `table_size - 1`: the table size is a power of two,
so the low bits of the 64-bit product are those of the wrapped 32-bit
one. Plain PyTorch (the JAX package's gathers are XLA); a level's 8
corners are one gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ovr_tpu_torch.core.sampling import clip

# instant-ngp spatial hashing primes
_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 12
    features_per_level: int = 2
    log2_table_size: int = 17
    base_resolution: int = 16
    max_resolution: int = 512

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.features_per_level

    def level_resolutions(self) -> np.ndarray:
        if self.n_levels == 1:
            return np.array([self.base_resolution])
        growth = np.exp(
            (np.log(self.max_resolution) - np.log(self.base_resolution))
            / (self.n_levels - 1))
        return np.floor(
            self.base_resolution * growth ** np.arange(self.n_levels)
        ).astype(np.int64)


def init_hashgrid(generator: torch.Generator, cfg: HashGridConfig,
                  device="cuda") -> torch.Tensor:
    """Feature tables (L, T, F), uniform in [-1e-4, 1e-4] (ngp init),
    drawn from `generator` (on its device) and placed on `device`."""
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.features_per_level),
                   generator=generator, device=generator.device)
    return (u * 2e-4 - 1e-4).to(device)


def hash_corners(i0: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """Table indices (..., 8) of the 8 corners above the lower corners i0
    (..., 3) (int64), in the order 000, 100, 010, 110, 001, 101, 011, 111
    (x fastest): [z][y][x] of a broadcast xor of the per-axis terms."""
    one = torch.arange(2, dtype=i0.dtype, device=i0.device)
    hx, hy, hz = (i0[..., a, None] + one for a in range(3))
    h = (hx[..., None, None, :] ^ (hy * _PRIMES[1])[..., None, :, None]
         ^ (hz * _PRIMES[2])[..., :, None, None])
    return h.reshape(h.shape[:-3] + (8,)) & (cfg.table_size - 1)


def encode(tables: torch.Tensor, cfg: HashGridConfig,
           p: torch.Tensor) -> torch.Tensor:
    """Encode positions p (..., 3) in [0,1]^3 -> features (..., L*F)."""
    resolutions = cfg.level_resolutions()
    p = clip(p, 0.0, 1.0)
    feats = []
    for li in range(cfg.n_levels):
        r = int(resolutions[li])
        c = p * r  # corner lattice: r+1 corners per axis
        i0 = clip(torch.floor(c), 0.0, float(r - 1)).long()
        f = c - i0.to(p.dtype)
        cs = tables[li][hash_corners(i0, cfg)]  # (..., 8, F)
        fx, fy, fz = (t[..., None, None] for t in f.unbind(-1))
        cx = cs[..., 0::2, :] * (1 - fx) + cs[..., 1::2, :] * fx
        cy = cx[..., 0::2, :] * (1 - fy) + cx[..., 1::2, :] * fy
        feats.append(cy[..., 0, :] * (1 - fz[..., 0, :])
                     + cy[..., 1, :] * fz[..., 0, :])
    return torch.cat(feats, dim=-1)
