"""Scalar value types and normalization rules for volume data.

Mirrors the capability of the reference's `ovr/scene.h:32-74` (ValueType enum +
sizes) and `ovr/devices/optix7/array.h:68-106` (OpenGL-style normalized-integer
reads): 8/16-bit integer volumes are read as normalized floats in [0,1] (or
[-1,1] for signed), 32-bit integers and doubles are converted to float32.
"""

from __future__ import annotations

import enum

import numpy as np


class ValueType(enum.Enum):
    """Scalar type of a raw volume file (names match the VIDI3D JSON values)."""

    INT8 = "BYTE"
    UINT8 = "UNSIGNED_BYTE"
    INT16 = "SHORT"
    UINT16 = "UNSIGNED_SHORT"
    INT32 = "INT"
    UINT32 = "UNSIGNED_INT"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(_NUMPY_DTYPES[self])

    @property
    def size(self) -> int:
        return self.dtype.itemsize

    @property
    def is_integer(self) -> bool:
        return self not in (ValueType.FLOAT, ValueType.DOUBLE)


_NUMPY_DTYPES = {
    ValueType.INT8: np.int8,
    ValueType.UINT8: np.uint8,
    ValueType.INT16: np.int16,
    ValueType.UINT16: np.uint16,
    ValueType.INT32: np.int32,
    ValueType.UINT32: np.uint32,
    ValueType.FLOAT: np.float32,
    ValueType.DOUBLE: np.float64,
}


def integer_normalize(value: float, vtype: ValueType) -> float:
    """Normalize a raw scalar the way a GPU normalized-integer texture read would.

    Unsigned ints map to [0,1] by dividing by the type max; signed ints map to
    [-1,1] (clamped at -1); floats/doubles pass through. Reference semantics:
    `ovr/devices/optix7/array.h:68-106`.
    """
    if vtype in (ValueType.FLOAT, ValueType.DOUBLE):
        return float(value)
    info = np.iinfo(vtype.dtype)
    norm = float(value) / float(info.max)
    if info.min < 0:
        norm = max(norm, -1.0)
    return norm


def normalize_array(data: np.ndarray, vtype: ValueType) -> np.ndarray:
    """Convert a raw typed array to the float32 array the renderer samples.

    8/16-bit integers are normalized (matching CUDA's
    `cudaReadModeNormalizedFloat`); 32-bit integers and float64 are cast to
    float32 unscaled (matching `convert_array1d`,
    `ovr/devices/optix7/array.cpp:68-82`).
    """
    if vtype in (ValueType.FLOAT, ValueType.DOUBLE):
        return data.astype(np.float32)
    info = np.iinfo(vtype.dtype)
    if vtype in (ValueType.INT8, ValueType.UINT8, ValueType.INT16, ValueType.UINT16):
        out = data.astype(np.float32) / np.float32(info.max)
        if info.min < 0:
            out = np.maximum(out, np.float32(-1.0))
        return out
    # 32-bit integers: plain conversion, value range handled downstream.
    return data.astype(np.float32)


def normalized_range(vtype: ValueType, lo: float, hi: float) -> tuple[float, float]:
    """Map a raw-unit value range to normalized (sampled) units."""
    return integer_normalize(lo, vtype), integer_normalize(hi, vtype)
