"""Named colormaps; the port's own copy of `ovr_tpu.io.colormaps`
(numpy only; the port imports nothing of the JAX package). Reference:
`CreateColorMap`, `ovr/scene.cpp:164-179`, backed by ~180 tables
embedded in `extern/tfn/colormaps/`.

We synthesize tables procedurally: a set of built-in scientific-visualization
maps (including the reference widget's default rainbow,
`extern/tfn/core.h:636-650`) plus every matplotlib colormap when matplotlib
is importable.
"""

from __future__ import annotations

import numpy as np

# The tfn widget's default "rainbow" control points (core.h fromRainbowMap).
_RAINBOW = [
    (0 / 6, (0.0, 0.364706, 1.0)),
    (1 / 6, (0.0, 1.0, 0.976471)),
    (2 / 6, (0.0, 1.0, 0.105882)),
    (3 / 6, (0.968627, 1.0, 0.0)),
    (4 / 6, (1.0, 0.490196, 0.0)),
    (5 / 6, (1.0, 0.0, 0.0)),
    (6 / 6, (0.662745, 0.0, 1.0)),
]

_BUILTIN = {
    "rainbow": _RAINBOW,
    "grayscale": [(0.0, (0.0, 0.0, 0.0)), (1.0, (1.0, 1.0, 1.0))],
    "coolwarm": [
        (0.0, (0.2298, 0.2987, 0.7537)),
        (0.5, (0.8654, 0.8654, 0.8654)),
        (1.0, (0.7057, 0.0156, 0.1498)),
    ],
    "blackbody": [
        (0.0, (0.0, 0.0, 0.0)),
        (0.33, (0.9, 0.0, 0.0)),
        (0.66, (0.9, 0.9, 0.0)),
        (1.0, (1.0, 1.0, 1.0)),
    ],
    "ice_fire": [
        (0.0, (0.0, 0.0, 1.0)),
        (0.5, (1.0, 1.0, 1.0)),
        (1.0, (1.0, 0.0, 0.0)),
    ],
}


# The reference's embedded colormap keys (extern/tfn/colormaps/colormap.h,
# "available colormap keys") are namespaced matplotlib maps,
# e.g. "diverging/BrBG", "perceptual/viridis", "sequential2/hot". All 50 are
# regenerated from matplotlib at the same key.
_REFERENCE_KEYS = {
    "diverging": ["BrBG", "RdYlGn", "RdBu", "RdYlBu", "bwr", "Spectral",
                  "RdGy", "seismic", "coolwarm", "PRGn", "PuOr", "PiYG"],
    "perceptual": ["magma", "inferno", "viridis", "plasma"],
    "sequential": ["Purples", "PuBuGn", "Oranges", "Blues", "YlGn", "PuBu",
                   "GnBu", "Greens", "PuRd", "BuPu", "Greys", "YlOrBr",
                   "RdPu", "YlOrRd", "Reds", "YlGnBu", "BuGn", "OrRd"],
    "sequential2": ["hot", "Wistia", "gist_gray", "bone", "winter", "pink",
                    "binary", "autumn", "spring", "gist_yarg", "copper",
                    "gray", "afmhot", "cool", "gist_heat", "summer"],
}


_frozen_cache = None


def _frozen_tables():
    """The 50 reference keys' tables, frozen into the package
    (colormap_tables.npz, 64 samples each) so no matplotlib is needed at
    runtime; regenerate with matplotlib if the palette set changes."""
    global _frozen_cache
    if _frozen_cache is None:
        import os
        path = os.path.join(os.path.dirname(__file__),
                            "colormap_tables.npz")
        try:
            _frozen_cache = dict(np.load(path))
        except Exception:
            _frozen_cache = {}
    return _frozen_cache


def create_colormap(name: str, resolution: int = 256) -> np.ndarray:
    """Return a (resolution, 3) float32 RGB table for the named colormap."""
    frozen = _frozen_tables()
    tab = frozen.get(name)
    if tab is None and "/" not in name:  # bare matplotlib-style name
        for ns in _REFERENCE_KEYS:
            tab = frozen.get(f"{ns}/{name}")
            if tab is not None:
                break
    if tab is not None:
        x = np.linspace(0.0, 1.0, resolution, dtype=np.float32)
        src = np.linspace(0.0, 1.0, tab.shape[0], dtype=np.float32)
        return np.stack([np.interp(x, src, tab[:, i]) for i in range(3)],
                        -1).astype(np.float32)
    if "/" in name:  # namespaced reference key -> matplotlib name
        name = name.split("/", 1)[1]
    if name in _BUILTIN:
        controls = _BUILTIN[name]
        pos = np.array([c[0] for c in controls], np.float32)
        rgb = np.array([c[1] for c in controls], np.float32)
        x = np.linspace(0.0, 1.0, resolution, dtype=np.float32)
        out = np.stack([np.interp(x, pos, rgb[:, i]) for i in range(3)], -1)
        return out.astype(np.float32)
    try:
        import matplotlib.pyplot as plt

        cmap = plt.get_cmap(name)
        x = np.linspace(0.0, 1.0, resolution)
        return cmap(x)[:, :3].astype(np.float32)
    except Exception as e:
        raise KeyError(f"unknown colormap: {name}") from e


def available_colormaps() -> list[str]:
    names = sorted(_BUILTIN)
    names += [f"{ns}/{n}" for ns, maps in sorted(_REFERENCE_KEYS.items())
              for n in maps]
    try:
        import matplotlib.pyplot as plt

        names += sorted(plt.colormaps())
    except Exception:
        pass
    return names
