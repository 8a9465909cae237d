"""Build the port's CUDA sources into shared libraries and load them.

Each `csrc/<name>.cu` exposes a plain `extern "C"` interface. At first
use it is compiled with nvcc for Hopper (sm_90a) into `_build/` inside
the package (listed in .gitignore), under a name keyed on a hash of the
source and the flags, and loaded with ctypes. Later calls in the process
and later processes reuse the library. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# IEEE arithmetic, op by op as the plain PyTorch versions do it: no
# --use_fast_math (expf/log1pf stay exact) and no contraction of a*b + c
# into fma. Shading divides sample differences by the fan spacing, and
# on quantized (u8) volumes those differences are often rounding noise:
# the normal of a noise-level gradient only agrees with the plain
# version when both round alike. --split-compile=0: optimize and
# assemble a source's kernel variants in parallel, on every core.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "--split-compile=0")


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time in this process (0 when reused)
    log: str  # nvcc / ptxas output of the build


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@functools.cache
def load(name: str, defines: tuple = ()) -> Built:
    """Compile `csrc/<name>.cu` with the macros `defines` ("NAME=VALUE")
    if no library for its current source exists, then load it."""
    src = CSRC_DIR / f"{name}.cu"
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{key}.so"
    log_path = out.with_suffix(".log")
    t0 = time.perf_counter()
    compiled = False
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
        compiled = True
    seconds = time.perf_counter() - t0 if compiled else 0.0
    log = log_path.read_text() if log_path.exists() else ""
    return Built(ctypes.CDLL(str(out)), out, seconds, log)
