"""What the benchmark's files may import, read from their syntax trees.

- Nothing under ovrbench/ imports the repository's bench program,
  `chip_smoke` or `kernel_times`: the benchmark keeps its own frozen
  copies of what it took from them.
- Nothing imports `jax`, `jaxlib`, `flax` or the JAX package `ovr_tpu`
  (top-level names compared whole: `ovr_tpu_torch` is not `ovr_tpu`).
- Only the harness's entry (`run.py`) and the tests import the program,
  `ovr_tpu_torch`: the reference, `work.py`, the comparison, the traffic
  generator, the content generators and the metric readers import none
  of it.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)
MAY_IMPORT_PROGRAM = {PKG / "run.py"} | set((PKG / "tests").glob("*.py"))


def imported(path: Path) -> set:
    """Full names of the modules a file imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def top(name: str) -> str:
    return name.split(".")[0]


def ids(paths):
    return [str(p.relative_to(PKG)) for p in paths]


@pytest.mark.parametrize("path", FILES, ids=ids(FILES))
def test_no_bench_program_copies_imported(path):
    bad = {n for n in imported(path)
           if n == "ovr_tpu_torch.bench" or n.startswith("ovr_tpu_torch.bench.")
           or top(n) in ("chip_smoke", "kernel_times", "bench")}
    assert not bad, bad


@pytest.mark.parametrize("path", FILES, ids=ids(FILES))
def test_no_jax_imported(path):
    bad = {n for n in imported(path)
           if top(n) in ("jax", "jaxlib", "flax", "ovr_tpu")}
    assert not bad, bad


@pytest.mark.parametrize("path", [p for p in FILES
                                  if p not in MAY_IMPORT_PROGRAM],
                         ids=ids([p for p in FILES
                                  if p not in MAY_IMPORT_PROGRAM]))
def test_yardstick_imports_no_program(path):
    bad = {n for n in imported(path) if top(n) == "ovr_tpu_torch"}
    assert not bad, bad


def test_the_scan_sees_imports(tmp_path):
    """The scan finds what the rules forbid."""
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom ovr_tpu_torch.bench import "
                 "field_on_device\nfrom ovr_tpu import api\n")
    got = {top(n) for n in imported(f)}
    assert {"jax", "ovr_tpu_torch", "ovr_tpu"} <= got
    assert "ovr_tpu_torch.bench" in imported(f)
