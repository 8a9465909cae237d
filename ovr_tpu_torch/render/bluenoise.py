"""Spatio-temporal blue noise for sparse-sampling masks (port of
`ovr_tpu.render.bluenoise`, which is numpy already; this package keeps
its own copy, since importing the JAX package's module loads JAX).

- `void_and_cluster(n)` generates a blue-noise threshold matrix (a rank
  in [0, 1) per pixel such that thresholding at any level gives a
  well-spaced point set) with Ulichney's void-and-cluster algorithm and
  incremental toroidal-Gaussian energy updates, cached to
  `~/.cache/ovr_tpu_torch/bluenoise_<n>_<seed>.npy` after first use.
- `_R2`, the R2 low-discrepancy sequence's step, drives the temporal
  dimension (`render.sparse`): the spatial pattern shifted toroidally
  along it, so consecutive sparse frames select stable, complementary,
  well-spaced pixel sets. `stbn_offsets` gives a frame's shift as host
  integers.
"""

from __future__ import annotations

import os

import numpy as np

# R2 low-discrepancy sequence (generalized golden ratio, d=2)
_PLASTIC = 1.32471795724474602596
_R2 = (1.0 / _PLASTIC, 1.0 / _PLASTIC ** 2)


def _toroidal_gaussian(n: int, sigma: float) -> np.ndarray:
    """Wrapped 2D Gaussian energy kernel, peak at (0, 0)."""
    ax = np.arange(n, dtype=np.float64)
    d = np.minimum(ax, n - ax)  # toroidal axis distance
    d2 = d[:, None] ** 2 + d[None, :] ** 2
    return np.exp(-d2 / (2.0 * sigma * sigma))


def void_and_cluster(n: int = 64, sigma: float = 1.9, seed: int = 0,
                     cache: bool = True) -> np.ndarray:
    """Blue-noise threshold matrix (n, n) float32 with values (rank+0.5)/n^2.

    Ulichney's algorithm: seed ~10% random minority pixels, relax by moving
    the tightest cluster into the largest void until stable, then assign
    ranks by repeatedly removing the tightest cluster (downward) and filling
    the largest void (upward).
    """
    cache_path = os.path.join(
        os.path.expanduser("~"), ".cache", "ovr_tpu_torch",
        f"bluenoise_{n}_{seed}.npy")
    if cache and os.path.exists(cache_path):
        return np.load(cache_path)

    rng = np.random.default_rng(seed)
    kernel = _toroidal_gaussian(n, sigma)
    total = n * n
    m = max(total // 10, 1)

    pattern = np.zeros((n, n), dtype=bool)
    idx = rng.choice(total, size=m, replace=False)
    pattern.flat[idx] = True

    # energy field = sum of kernels at minority pixels (incremental updates)
    energy = np.zeros((n, n), np.float64)
    for flat in np.flatnonzero(pattern.reshape(-1)):
        energy += np.roll(kernel, (flat // n, flat % n), axis=(0, 1))

    def shifted(flat):
        return np.roll(kernel, (flat // n, flat % n), axis=(0, 1))

    neg_inf = -np.inf

    # phase 0: relax the initial pattern
    for _ in range(total):
        e1 = np.where(pattern, energy, neg_inf)
        cluster = int(e1.argmax())
        pattern.flat[cluster] = False
        energy -= shifted(cluster)
        e0 = np.where(pattern, np.inf, energy)
        void = int(e0.argmin())
        pattern.flat[void] = True
        energy += shifted(void)
        if void == cluster:
            break

    rank = np.zeros(total, np.int64)

    # phase 1: remove tightest cluster, ranks m-1 .. 0
    pat = pattern.copy()
    e = energy.copy()
    for r in range(m - 1, -1, -1):
        e1 = np.where(pat, e, neg_inf)
        cluster = int(e1.argmax())
        pat.flat[cluster] = False
        e -= shifted(cluster)
        rank[cluster] = r

    # phase 2: fill largest void, ranks m .. total-1
    pat = pattern.copy()
    e = energy.copy()
    for r in range(m, total):
        e0 = np.where(pat, np.inf, e)
        void = int(e0.argmin())
        pat.flat[void] = True
        e += shifted(void)
        rank[void] = r

    out = ((rank.reshape(n, n) + 0.5) / total).astype(np.float32)
    if cache:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        np.save(cache_path, out)
    return out


def stbn_offsets(frame_index: int, n: int) -> tuple[int, int]:
    """R2 low-discrepancy toroidal shift for a frame (host-side ints)."""
    fx = (frame_index * _R2[0]) % 1.0
    fy = (frame_index * _R2[1]) % 1.0
    return int(fx * n), int(fy * n)
