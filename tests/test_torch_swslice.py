"""The port's fused slice loop (ovr_tpu_torch.ops.swslice) against the
JAX package's Pallas kernel.

Inputs are captured from the port's own renderer (the arrays it hands
`slice_composite`), then fed to both `slice_composite_plain` and
`ovr_tpu.ops.swslice.slice_composite_pallas(..., interpret=True)` — the
persistent kernel (K1) and the BlockSpec kernel (K2). Tolerances are the
JAX suite's kernel-vs-XLA ones: rgba and normals 5e-5, depth 2e-4,
early termination 5e-4. The CUDA kernel itself is held against the
plain version by tests/test_torch_cuda.py, which runs only on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu.ops import swslice as jsw
from ovr_tpu_torch.ops import swslice
from tests.test_torch_cuda import (_scene, assert_out_close, capture,
                                    run_plain)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and a torch thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnp(t):
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.contiguous().numpy())


def run_pallas(args, kw, persistent, term):
    grid_v, tab, sc, pg, qg, k0, n_slices = args
    maj = kw.get("majorant_v")
    if kw.get("axial_flip"):  # the Pallas kernel takes traversal order
        grid_v = grid_v.flip(0)
        maj = None if maj is None else maj.flip(0)
    out = jsw.slice_composite_pallas(
        _jnp(grid_v), _jnp(tab), _jnp(sc), _jnp(pg), _jnp(qg), _jnp(k0),
        n_slices, mode=kw["mode"], lgrid=_jnp(kw.get("lgrid")),
        k0l=_jnp(kw.get("k0l")), interpret=True,
        n_extra=kw.get("n_extra", 0),
        majorant_v=_jnp(maj), term=term, fd=kw["fd"], persistent=persistent)
    return np.asarray(out)


# (shading, fd, persistent, skip, dtype, camera, extra lights)
CASES = [
    ("none", True, True, False, "f32", "persp", 0),
    ("none", True, False, True, "u8", "persp", 0),
    ("diffuse", True, True, False, "f32", "persp", 0),
    ("diffuse", False, False, True, "bf16", "persp", 0),
    ("diffuse", True, False, False, "u8", "ortho", 4),
    ("shadow", True, True, False, "f32", "persp", 0),
    ("shadow", False, True, True, "f32", "ortho", 2),
    ("shadow", True, False, True, "bf16", "back", 1),
]


@pytest.mark.parametrize("shading,fd,persistent,skip,dtype,cam,n_lights",
                         CASES)
def test_plain_matches_pallas(shading, fd, persistent, skip, dtype, cam,
                              n_lights):
    kind = "sparse" if skip else "smooth"
    scene = _scene(kind, dtype, cam, n_lights=n_lights)
    args, kw = capture(scene, shading, fd=fd, skip=skip)
    assert kw["mode"] == {"none": 0, "diffuse": 1, "shadow": 2}[shading]
    assert kw.get("n_extra", 0) == (n_lights if shading != "none" else 0)
    assert (kw["majorant_v"] is not None) == skip
    assert kw["axial_flip"] == (cam == "back")
    out = run_plain(args, kw, term=False)
    ref = run_pallas(args, kw, persistent=persistent, term=False)
    assert float(ref[7].max()) > 0.05  # the volume is in view
    assert_out_close(out, ref)


@pytest.mark.parametrize("shading", ["none", "diffuse"])
def test_termination_matches_pallas(shading):
    """Per-block termination stays within 5e-4 of the Pallas kernel's
    per-tile termination and of the untruncated loop."""
    scene = _scene(n=32, opaque=True)
    args, kw = capture(scene, shading, fd=True, base_rate=8.0)
    out = run_plain(args, kw, term=True)
    full = run_plain(args, kw, term=False)
    ref = run_pallas(args, kw, persistent=True, term=True)
    assert float(out[7].max()) > 0.999  # rays do saturate
    assert_out_close(out, ref, rgb=5e-4, depth=5e-3)
    assert_out_close(out, full, rgb=5e-4, depth=5e-3)


def test_termination_stops_blocks():
    """Saturated blocks composite fewer planes than the schedule."""
    scene = _scene(n=32, opaque=True)
    args, kw = capture(scene, "none", base_rate=8.0)
    n_blocks = (-(-args[4].shape[0] // swslice.BLOCK_ROWS)
                * -(-args[3].shape[0] // swslice.BLOCK_COLS))
    planes = torch.zeros(n_blocks, dtype=torch.int32)
    swslice.slice_composite(*args, **dict(kw, term=True,
                                          block_planes=planes))
    assert int(planes.min()) < args[6] // 2
    assert int(planes.max()) <= args[6]


@pytest.mark.parametrize("shading", ["none", "diffuse", "shadow"])
def test_skip_is_exact(shading):
    """Block-footprint skipping composites fewer planes and changes no
    pixel beyond fp noise: skipped planes have zero opacity."""
    scene = _scene("sparse")
    args, kw = capture(scene, shading, skip=True)
    n_blocks = (-(-args[4].shape[0] // swslice.BLOCK_ROWS)
                * -(-args[3].shape[0] // swslice.BLOCK_COLS))
    planes = torch.zeros(n_blocks, dtype=torch.int32)
    out = swslice.slice_composite(*args, **dict(kw, term=False,
                                                block_planes=planes))
    full = swslice.slice_composite(*args, **dict(kw, term=False,
                                                 majorant_v=None))
    assert int(planes.sum()) < 0.6 * n_blocks * args[6]
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=1e-6)


def test_axial_flip_matches_flipped_copy():
    """A storage-ordered volume walked backward == its flipped copy."""
    scene = _scene("sparse", cam="back")
    args, kw = capture(scene, "diffuse", skip=True)
    assert kw["axial_flip"]
    out = swslice.slice_composite(*args, **dict(kw, term=False))
    flipped = (args[0].flip(0),) + args[1:]
    ref = swslice.slice_composite(*flipped, **dict(
        kw, term=False, axial_flip=False, majorant_v=None))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)


def test_requires_grad_raises():
    args, kw = capture(_scene(n=24), "none")
    grid = args[0].float().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        swslice.slice_composite(grid, *args[1:], **kw)
