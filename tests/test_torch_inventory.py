"""The port's counterpart inventory: every public function, class and
method of the JAX package, of its programs (`apps/`), its examples and
`bench.py` is defined, under the same name, in the port's module at the
same path (`ovr_tpu/x/y.py` -> `ovr_tpu_torch/x/y.py`, `apps/*.py` ->
`ovr_tpu_torch/apps/`, `examples/*.py` -> `ovr_tpu_torch/examples/`,
`bench.py` -> `ovr_tpu_torch/bench.py`), or it stands in EXEMPT with its
counterpart or the reason it has none.

Public: a top-level `def` or `class` whose name does not start with an
underscore, and such a `def` directly in the body of a public class
(`Class.method`). Functions nested in functions (loop bodies, closures)
are not counted. The sources are read with `ast`; nothing is imported.

    python -m pytest tests/test_torch_inventory.py
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ovr_tpu_torch"

_BANDS = ("a NamedSharding spec; torch.distributed has no sharded arrays, "
          "so the port places rows by rank (parallel/tiles.bands)")

# "reference path:name" -> its counterpart in the port, or why it has none
EXEMPT = {
    "ovr_tpu/ops/swslice.py:slice_composite_pallas":
        "slice_composite: the CUDA kernel for card tensors, "
        "slice_composite_plain for CPU tensors",
    "ovr_tpu/parallel/mesh.py:replicated": _BANDS,
    "ovr_tpu/parallel/mesh.py:row_sharded": _BANDS,
    "ovr_tpu/parallel/bricks.py:BrickedVolume.n_bricks":
        "a rank's BrickedVolume holds one brick (`index` set) and cannot "
        "know the count B; callers read it from the mesh (Mesh.n_bricks)",
}

# a name the scan must find in each group of sources, in the reference
# and in the port: an empty scan cannot pass
KNOWN = {
    "ovr_tpu/api.py": "Renderer.render",
    "apps/viewer.py": "RenderSession",
    "examples/mini_renderer.py": "make_volume",
    "bench.py": "build_scene",
}


def public_names(path: Path) -> set:
    """Public top-level functions and classes of a source file, and the
    public methods defined directly in such a class."""
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names.update(f"{node.name}.{sub.name}" for sub in node.body
                         if isinstance(sub, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                         and not sub.name.startswith("_"))
    return names


def counterpart_map() -> dict:
    """Reference source (relative to the repository) -> the port's."""
    pairs = {str(p.relative_to(ROOT)): PORT / p.relative_to(ROOT / "ovr_tpu")
             for p in sorted((ROOT / "ovr_tpu").rglob("*.py"))}
    for group in ("apps", "examples"):
        pairs.update({str(p.relative_to(ROOT)): PORT / group / p.name
                      for p in sorted((ROOT / group).glob("*.py"))})
    pairs["bench.py"] = PORT / "bench.py"
    return pairs


PAIRS = counterpart_map()


@pytest.mark.parametrize("ref", sorted(PAIRS))
def test_port_defines_every_public_name(ref):
    port = PAIRS[ref]
    assert port.is_file(), f"{ref} has no counterpart module {port}"
    missing = {name for name in public_names(ROOT / ref)
               - public_names(port) if f"{ref}:{name}" not in EXEMPT}
    assert not missing, (f"{port.relative_to(ROOT)} lacks {sorted(missing)} "
                         f"of {ref}")


def test_exemptions_name_real_gaps():
    """Each EXEMPT entry names a public name of its reference module that
    the port's module lacks, and gives a counterpart or a reason."""
    for key, why in EXEMPT.items():
        ref, name = key.split(":")
        assert name in public_names(ROOT / ref), key
        assert name not in public_names(PAIRS[ref]), f"{key} is ported"
        assert len(why) > 20, key


def test_scan_finds_known_names():
    """The scan reads every group of sources (the package, apps,
    examples, bench.py) on both sides, counts methods, and skips nested
    functions and private names."""
    for ref, name in KNOWN.items():
        assert ref in PAIRS
        assert name in public_names(ROOT / ref), ref
        assert name in public_names(PAIRS[ref]), ref
    total = sum(len(public_names(ROOT / ref)) for ref in PAIRS)
    assert total > 200
    names = public_names(ROOT / "ovr_tpu/api.py")
    assert "RenderConfig.resolved" in names  # a method
    assert "ray_batch" not in names and "Renderer.__init__" not in names
