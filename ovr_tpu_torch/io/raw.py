"""Raw-binary structured-volume loader (the port's copy of
`ovr_tpu.io.raw`, numpy only).

Equivalent of `CreateArray3DScalarFromFile` (`ovr/scene.cpp:181-245`): typed
raw file with dims (x, y, z), optional byte offset, optional big-endian
byte order. Returns a (Z, Y, X) host array plus the raw value range in
normalized units; `io.vidi3d` moves it to the device.

Uses the native loader extension (`ovr_tpu_torch.native`) when it
builds — mmap + parallel endian-swap/convert — and numpy otherwise.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from ovr_tpu_torch.core.types import ValueType, normalize_array


def _read(path, count, vtype: ValueType, offset, big_endian) -> np.ndarray:
    """The file's values in their own type, in native byte order."""
    dt = vtype.dtype
    if big_endian and vtype.size > 1:
        dt = dt.newbyteorder(">")
    data = np.fromfile(path, dtype=dt, count=count, offset=offset)
    if big_endian and vtype.size > 1:
        data = data.astype(vtype.dtype)
    return data


def load_raw_volume(
    path: str,
    dims: tuple[int, int, int],
    vtype: ValueType | str,
    offset: int = 0,
    big_endian: bool = False,
    native_dtype: bool = True,
) -> tuple[np.ndarray, tuple[float, float]]:
    """Load a raw volume file.

    `dims` is (X, Y, Z) like the reference; the returned array has shape
    (Z, Y, X) in C order (x fastest, matching the file layout).

    `native_dtype`: unsigned 8/16-bit volumes stay in their file dtype —
    the renderer samples them as normalized integers (raw / int_max, the
    slice kernel and `core.sampling.sample_volume` alike), so a u8 volume
    occupies 1 byte/voxel on the card instead of 4. The returned value
    range is always in normalized units. Signed/32-bit/float types expand
    to float32 (`core.types.normalize_array`).
    """
    if isinstance(vtype, str):
        vtype = ValueType(vtype)
    x, y, z = (int(d) for d in dims)
    count = x * y * z
    nbytes = count * vtype.size
    fsize = os.path.getsize(path)
    if fsize < offset + nbytes:
        raise ValueError(
            f"File size {fsize} < offset {offset} + data size {nbytes}: {path}"
        )

    if native_dtype and vtype in (ValueType.UINT8, ValueType.UINT16):
        grid = _read(path, count, vtype, offset, big_endian).reshape(z, y, x)
        s = 1.0 / float(np.iinfo(vtype.dtype).max)
        return grid, (float(grid.min()) * s, float(grid.max()) * s)

    data = _load_native(path, count, vtype, offset, big_endian)
    if data is None:
        data = normalize_array(_read(path, count, vtype, offset, big_endian),
                               vtype)
    grid = data.reshape(z, y, x)
    return grid, (float(grid.min()), float(grid.max()))


def sequence_paths(spec: str, start: int = 0, limit: int = 100000
                   ) -> list[str]:
    """Resolve a time-varying volume sequence.

    `spec` with a %-style index (`vorts_%04d.raw`) expands consecutive
    indices from `start` until a file is missing; otherwise it is a glob
    pattern (`vorts_*.raw`), sorted. Raises if nothing matches.
    """
    if "%" in spec:
        out = []
        i = start
        while i < start + limit:
            p = spec % i
            if not os.path.exists(p):
                break
            out.append(p)
            i += 1
    else:
        out = sorted(glob.glob(spec))
    if not out:
        raise FileNotFoundError(f"no sequence files match: {spec}")
    return out


def load_raw_sequence(spec: str, dims, vtype, offset: int = 0,
                      big_endian: bool = False):
    """Generator over a raw-file sequence: yields (path, grid (Z, Y, X)).
    Per-timestep params match `load_raw_volume`."""
    for p in sequence_paths(spec):
        grid, _ = load_raw_volume(p, dims, vtype, offset, big_endian)
        yield p, grid


def _load_native(path, count, vtype, offset, big_endian) -> Optional[np.ndarray]:
    """Native fast path; returns None when the extension isn't built."""
    from ovr_tpu_torch.native import loader as _native
    try:
        return _native.load_raw(path, count, vtype.dtype.char, offset,
                                big_endian)
    except Exception:
        return None
