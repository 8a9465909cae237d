"""Python wrapper for the native raw-volume loader, with on-demand build
(the port's copy of `ovr_tpu.native.loader`).

The extension is compiled once from `loader.c` (cc -O3 -shared -fPIC
-pthread) into the package's `_build/` directory (git-ignored), under a
name keyed on a hash of the source and the flags; later imports load the
cached library. If no compiler is available the caller (`io.raw`) reads
the file with numpy instead.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.c"
_BUILD_DIR = _SRC.parent.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_NATIVE = None
_TRIED = False


def _build_and_import():
    """The extension module, built at first use; None without a compiler."""
    global _NATIVE, _TRIED
    if _NATIVE is not None or _TRIED:
        return _NATIVE
    _TRIED = True
    cc = os.environ.get("CC", "cc")
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(
        (cc,) + _FLAGS).encode()).hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    so_path = _BUILD_DIR / f"_ovr_native_{key}{suffix}"
    if not so_path.exists():
        include = sysconfig.get_paths()["include"]
        tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
        try:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run([cc, *_FLAGS, f"-I{include}", str(_SRC), "-o",
                            str(tmp)], check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, so_path)
        except Exception:
            return None
    try:
        spec = importlib.util.spec_from_file_location("_ovr_native",
                                                      so_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _NATIVE = mod
    except Exception:
        _NATIVE = None
    return _NATIVE


def load_raw(path: str, count: int, dtype_char: str, offset: int,
             big_endian: bool, nthreads: int | None = None) -> np.ndarray:
    """Load + normalize to float32 via the native extension.

    Raises ImportError when the extension can't be built (callers fall
    back to numpy)."""
    mod = _build_and_import()
    if mod is None:
        raise ImportError("native loader unavailable")
    if nthreads is None:
        nthreads = min(os.cpu_count() or 1, 16)
    buf = mod.load_raw_f32(path, int(count), dtype_char, int(offset),
                           bool(big_endian), int(nthreads))
    return np.frombuffer(buf, dtype=np.float32)
