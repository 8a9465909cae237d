"""The port's fused slice loop (ovr_tpu_torch.ops.swslice) against the
JAX package's Pallas kernel.

Inputs are captured from the port's own renderer (the arrays it hands
`slice_composite`), then fed to both `slice_composite_plain` and
`ovr_tpu.ops.swslice.slice_composite_pallas(..., interpret=True)` — the
persistent kernel (K1) and the BlockSpec kernel (K2), each also in its
`bf16=True` variant. Tolerances are the JAX suite's kernel-vs-XLA ones:
rgba and normals 5e-5, depth 2e-4, early termination 5e-4; the bf16
variant is held at 2e-5 (rgba and normals) and 2e-4 (depth). The CUDA
kernel itself is held against the plain version by
tests/test_torch_cuda.py, which runs only on a card.
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
    """The JAX kernel on the port's inputs. Its scalars carry up to 4
    extra directional lights in slots S_EL0.. where the port passes a
    light table."""
    grid_v, tab, sc, pg, qg, k0, n_slices = args
    lights, n_extra = kw.get("lights"), 0
    if kw["mode"] >= 1 and lights is not None:
        n_extra = kw["n_dir"]
        assert n_extra == lights.shape[0] <= 4  # the JAX kernel's slots
        sc = sc.clone()
        sc[jsw.S_EL0:jsw.S_EL0 + 4 * n_extra] = lights.reshape(-1)
    maj = kw.get("majorant_v")
    if kw.get("axial_flip"):  # the Pallas kernel takes traversal order
        grid_v = grid_v.flip(0)
        maj = None if maj is None else maj.flip(0)
    out = jsw.slice_composite_pallas(
        _jnp(grid_v), _jnp(tab), _jnp(sc), _jnp(pg), _jnp(qg), _jnp(k0),
        n_slices, mode=kw["mode"], lgrid=_jnp(kw.get("lgrid")),
        k0l=_jnp(kw.get("k0l")), interpret=True, n_extra=n_extra,
        bf16=kw["bf16"], majorant_v=_jnp(maj), term=term, fd=kw["fd"],
        persistent=persistent)
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
    # 16-bit storage: modes 0/1/2, FD on and off, skip on and off, light
    # tables up to the JAX kernel's 4 slots, the back camera (axial_flip)
    ("none", True, True, False, "u16", "persp", 0),
    ("diffuse", True, False, True, "u16", "ortho", 2),
    ("diffuse", False, True, False, "u16", "back", 4),
    ("shadow", True, True, True, "u16", "back", 1),
    ("shadow", False, False, False, "u16", "persp", 0),
]


@pytest.mark.parametrize("shading,fd,persistent,skip,dtype,cam,n_lights",
                         CASES)
def test_plain_matches_pallas(shading, fd, persistent, skip, dtype, cam,
                              n_lights):
    kind = "sparse" if skip else "smooth"
    scene = _scene(kind, dtype, cam, n_lights=n_lights)
    args, kw = capture(scene, shading, fd=fd, skip=skip)
    assert kw["mode"] == {"none": 0, "diffuse": 1, "shadow": 2}[shading]
    lights = kw.get("lights")
    assert (0 if lights is None else lights.shape[0]) == n_lights
    assert kw.get("n_dir", 0) == n_lights
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


@pytest.mark.parametrize("shading", ["none", "diffuse"])
@pytest.mark.parametrize("cam", ["persp", "ortho", "back"])
def test_pixel_samples_ignore_skip_and_term(cam, shading):
    """The per-pixel count of needed samples (the bound's rule in
    chip_smoke.py) is the same with skipping and termination on or off:
    it depends on each pixel's own samples, not on its block's decisions,
    so it is the same for any tile. No pixel counts more samples than its
    block composited planes, or twice that in a shaded mode."""
    scene = _scene("sparse", cam=cam, opaque=True)
    args, kw = capture(scene, shading, skip=True, base_rate=8.0)
    assert kw["axial_flip"] == (cam == "back")
    hi, wi = args[4].shape[0], args[3].shape[0]
    nbr = -(-hi // swslice.BLOCK_ROWS)
    counts = []
    for skip in (False, True):
        for term in (False, True):
            ps = torch.zeros((hi, wi), dtype=torch.int32)
            bp = torch.zeros(nbr * -(-wi // swslice.BLOCK_COLS),
                             dtype=torch.int32)
            swslice.slice_composite(*args, **dict(
                kw, term=term, majorant_v=kw["majorant_v"] if skip else None,
                pixel_samples=ps, block_planes=bp))
            counts.append(ps)
            if skip and term:
                planes = swslice._to_pixels(bp.view(nbr, -1), hi, wi)
                assert int(planes.sum()) < hi * wi * args[6]  # work avoided
    for c in counts[1:]:
        assert torch.equal(c, counts[0])
    assert int(counts[0].sum()) > 0
    assert bool((counts[0] <= planes * (2 if shading != "none" else 1)
                 ).all())


def test_stage_counts_need_the_kernel():
    """`stage_counts` describes a kernel launch: CPU tensors refuse it."""
    args, kw = capture(_scene(n=24), "none")
    with pytest.raises(ValueError, match="kernel launch"):
        swslice.slice_composite(*args, **kw,
                                stage_counts=torch.zeros(2, dtype=torch.int32))


def _launch_args(cam, n=256, width=480, height=270):
    """The slice kernel's arguments for a frame of a shape-only n^3 grid
    (nothing rendered: the renderer is stopped at the launch)."""
    from ovr_tpu_torch import api
    from ovr_tpu_torch.core.scene import Camera, simple_scene
    from tests.test_torch_cuda import CAMERAS
    scene = simple_scene(torch.zeros(()).expand(n, n, n), value_range=(0, 1),
                         device="cpu",
                         camera=Camera.create(**CAMERAS[cam], device="cpu"))
    cfg = api.RenderConfig(width=width, height=height,
                           sampling_rate=float(n), shading="diffuse",
                           method="shearwarp").resolved(scene)
    seen = {}

    class Stop(Exception):
        pass

    def spy(*args, **kw):
        seen.update(args=args, kw=kw)
        raise Stop

    orig, swslice.slice_composite = swslice.slice_composite, spy
    try:
        api.render(scene, cfg)
    except Stop:
        pass
    finally:
        swslice.slice_composite = orig
    return cfg.sw, seen["args"], seen["kw"]


def _kernel_run_footprints(args, kw, fd):
    """For each block and plane of a principal-x launch, the voxels (rows
    x columns) that the kernel's buffer for the run of the plane's first
    slab holds (its footprints on every plane that reads the run, joined
    as csrc/swslice.cu joins them), over the planes where the block's
    centre lies inside the grid's section."""
    grid_v, _, sc, pg, qg, k0, n = args
    na, nr, nc = grid_v.shape
    rp = swslice.RUN_BYTES // grid_v.element_size()
    sc = swslice._prepared_scalars(sc, grid_v.dtype, pg, qg).double()
    S = sc.numpy()
    pg, qg, k0 = pg.double().numpy(), qg.double().numpy(), k0.numpy()
    hi, wi = qg.shape[0], pg.shape[0]
    ortho = S[swslice.S_ORTHO] > 0.5
    lam = (((np.arange(n) + S[swslice.S_OFF]) * S[swslice.S_DZ])
           * S[swslice.S_DLAM] + S[swslice.S_LAM0])
    by, bx = np.meshgrid(np.arange(-(-hi // 8)), np.arange(-(-wi // 32)),
                         indexing="ij")
    by, bx = by.ravel(), bx.ravel()
    halo = 1 if fd else 0
    r0, r1 = by * 8 - halo, np.minimum(by * 8 + 8, hi) - 1 + halo
    q_a = S[swslice.S_QLO] + r0 * S[swslice.S_DQ]
    q_b = S[swslice.S_QLO] + r1 * S[swslice.S_DQ]
    c0 = np.maximum(bx * 32 - halo, 0)
    c1 = np.minimum(np.minimum(bx * 32 + 32, wi) - 1 + halo, wi - 1)
    p_a, p_b = pg[c0], pg[c1]

    def texel(x, o, d_, lo, ext, n_):
        pos = x[:, None] + d_ * lam if ortho else o + x[:, None] * lam
        return (pos - lo) / ext * n_ - 0.5

    rows = [texel(q, S[swslice.S_EW2], S[swslice.S_DW2], S[swslice.S_LO2],
                  S[swslice.S_EX2], nr) for q in (q_a, q_b, (q_a + q_b) / 2)]
    cols = [texel(p, S[swslice.S_EW1], S[swslice.S_DW1], S[swslice.S_LO1],
                  S[swslice.S_EX1], nc) for p in (p_a, p_b, (p_a + p_b) / 2)]

    def span(t, n_):
        a, b = np.clip(t[0], 0, n_ - 1), np.clip(t[1], 0, n_ - 1)
        return (np.floor(np.minimum(a, b)),
                np.minimum(np.floor(np.maximum(a, b)) + 1, n_ - 1))

    (r_lo, r_hi), (c_lo, c_hi) = span(rows, nr), span(cols, nc)
    inside = ((rows[2] >= 0) & (rows[2] <= nr - 1) & (cols[2] >= 0)
              & (cols[2] <= nc - 1))
    n_runs = na // rp
    ext = np.zeros((len(by), n_runs, 4))
    ext[..., 0::2], ext[..., 1::2] = np.inf, -np.inf
    blocks = np.arange(len(by))[:, None]
    slab = [(na - 1 - (k0 + s)) // rp if kw["axial_flip"] else (k0 + s) // rp
            for s in (0, 1)]
    for run in slab:
        for i, (v, f) in enumerate(((r_lo, np.minimum), (r_hi, np.maximum),
                                    (c_lo, np.minimum), (c_hi, np.maximum))):
            e = ext[..., i].copy()
            f.at(e, (blocks, run[None, :]), v)
            ext[..., i] = e
    area = (ext[..., 1] - ext[..., 0] + 1) * (ext[..., 3] - ext[..., 2] + 1)
    return area[blocks, slab[0][None, :]][inside]


@pytest.mark.parametrize("cam", ["side", "side-back", "side-ortho"])
def test_run_footprint_follows_the_kernel_geometry(cam):
    """The plan's run footprint (`shearwarp._run_footprint`, from the
    camera on the host) against the footprints the kernel's run staging
    would hold for the same launch: its median and 90th percentile within
    a quarter of theirs; a view along z has none."""
    sw, args, kw = _launch_args(cam)
    assert sw.axis == 0 and kw["run_footprint"] == sw.run_footprint
    want = np.quantile(_kernel_run_footprints(args, kw, kw["fd"]),
                       (0.5, 0.9))
    got = np.array(sw.run_footprint)
    assert np.all((got > 0.75 * want) & (got < 1.25 * want)), (got, want)
    assert _launch_args("persp", n=32, width=64, height=48)[0].run_footprint \
        == (0, 0)


def test_requires_grad_gives_a_gradient():
    """The call that raised before the backward existed now returns a
    finite grid gradient, through the plain version (no launch)."""
    args, kw = capture(_scene(n=24), "none")
    grid = args[0].float().requires_grad_(True)
    before = swslice.LAUNCHES
    out = swslice.slice_composite(grid, *args[1:], **kw)
    (out[0:3] ** 2).sum().backward()
    assert swslice.LAUNCHES == before
    assert grid.grad.shape == grid.shape
    assert torch.isfinite(grid.grad).all() and grid.grad.abs().max() > 0


def assert_bf16_close(out, ref, frac=0.02, atol=2e-5, depth=2e-4,
                      worst=4e-3):
    """The bf16 variant against the JAX kernel's: every value within
    `worst`, and all but `frac` of them within `atol` (rgba and normals)
    or `depth`. Where the two loops reach a bf16 rounding tie by f32
    arithmetic that differs in its last bit, they round it apart: the
    JAX kernel on the CPU forms its f32 positions with fused
    multiply-adds (XLA contracts x = e + q * lam so), the port with a
    product and a sum. A row or column weight of a plane then differs by
    one bf16 ulp (2^-9 of it), the sample by up to that share of its
    neighbours' difference, and the change carries along the ray (the
    transmittance) and, with the FD gradient, into the neighbours'
    shading. On these scenes that touches at most 1.3% of the values
    beyond 2e-5, by at most 1.8e-3 (99th percentile 2.6e-5); the cases
    without such a tie agree within 1.2e-7."""
    d = np.abs(out - ref)
    vals = np.concatenate([d[0:6].ravel(), d[7].ravel()])
    assert float(vals.max()) <= worst and float(d[6].max()) <= worst
    assert float((vals > atol).mean()) <= frac
    assert float((d[6] > depth).mean()) <= frac


# (shading, fd, persistent, skip, dtype, camera, extra lights, grid edge):
# f32 grids of 32 rows are read as bf16, of 24 rows as f32
BF16_CASES = [
    ("none", True, True, False, "f32", "persp", 0, 32),
    ("none", True, False, True, "f32", "ortho", 0, 24),
    ("diffuse", True, True, False, "u8", "back", 1, 32),
    ("diffuse", False, False, True, "bf16", "ortho", 2, 48),
    ("diffuse", False, True, False, "f32", "persp", 0, 24),
    ("shadow", True, True, False, "bf16", "persp", 0, 32),
    ("shadow", False, False, True, "f32", "back", 3, 24),
    ("shadow", True, False, True, "u8", "ortho", 4, 48),
    # u16 of 32 rows streams as u16 in the JAX kernel, of 24 rows as f32
    ("diffuse", True, True, True, "u16", "persp", 2, 32),
    ("shadow", True, False, True, "u16", "ortho", 1, 24),
]


@pytest.mark.parametrize("shading,fd,persistent,skip,dtype,cam,n_lights,n",
                         BF16_CASES)
def test_plain_bf16_matches_pallas(shading, fd, persistent, skip, dtype, cam,
                                   n_lights, n):
    """The bf16 variant (sw_bf16) against the JAX kernels' `bf16=True`."""
    kind = "sparse" if skip else "smooth"
    scene = _scene(kind, dtype, cam, n=n, n_lights=n_lights)
    args, kw = capture(scene, shading, fd=fd, skip=skip)
    kw = dict(kw, bf16=True)
    out = run_plain(args, kw, term=False)
    ref = run_pallas(args, kw, persistent=persistent, term=False)
    assert float(ref[7].max()) > 0.05
    # bf16 operands do change the frame
    assert np.abs(out - run_plain(args, dict(kw, bf16=False),
                                  term=False)).max() > 1e-4
    assert_bf16_close(out, ref)


@pytest.mark.parametrize("shading", ["none", "diffuse"])
def test_bf16_termination_matches_pallas(shading):
    """Termination in the bf16 variant: within 5e-4 of the JAX kernel's
    and of the untruncated loop, as in f32."""
    scene = _scene(n=24, opaque=True)
    args, kw = capture(scene, shading, fd=True, base_rate=8.0)
    kw = dict(kw, bf16=True)
    out = run_plain(args, kw, term=True)
    assert float(out[7].max()) > 0.999
    assert_out_close(out, run_pallas(args, kw, persistent=True, term=True),
                     rgb=5e-4, depth=5e-3)
    assert_out_close(out, run_plain(args, kw, term=False), rgb=5e-4,
                     depth=5e-3)


@pytest.mark.parametrize("n", [32, 24])
def test_bf16_reads_f32_grid_as_bf16_by_rows(n):
    """Under bf16 an f32 grid whose view has a multiple of 16 rows is read
    as bf16 (the JAX kernel's `_storage_plan`), one of 24 rows as f32."""
    scene = _scene(n=n)
    args, kw = capture(scene, "diffuse")
    kw = dict(kw, bf16=True)
    assert args[0].dtype == torch.float32 and args[0].shape[1] == n
    out = run_plain(args, kw, term=False)
    cast = run_plain((args[0].to(torch.bfloat16),) + args[1:], kw,
                     term=False)
    assert swslice._streamed(args[0], True).dtype == (
        torch.bfloat16 if n % 16 == 0 else torch.float32)
    assert swslice._streamed(args[0], False).dtype == torch.float32
    if n % 16 == 0:
        np.testing.assert_array_equal(out, cast)
    else:
        assert np.abs(out - cast).max() > 1e-4


@pytest.mark.parametrize("n", [32, 24])
def test_bf16_reads_u16_grid_as_it_is(n):
    """Under bf16 a u16 grid is read as u16 whatever its row count; the
    JAX kernel streams it as u16 (16k rows) or as f32 (`_storage_plan`),
    and both hold the same values, so BF16_CASES holds the port against
    each."""
    scene = _scene(dtype="u16", n=n)
    args, kw = capture(scene, "diffuse", bf16=True)
    assert kw["bf16"] and args[0].dtype == torch.uint16
    assert args[0].shape[1] == n
    assert swslice._streamed(args[0], True) is args[0]
    assert jsw._storage_plan(_jnp(args[0]), n, args[0].shape[2], True,
                             0)[0] == (jnp.uint16 if n % 16 == 0
                                       else jnp.float32)


def test_light_table_orders_and_counts():
    """The light table's rows shade in order: swapping two directional
    rows changes nothing beyond rounding, a point light's row read as a
    directional one changes the frame, and mode 0 ignores the table."""
    scene = _scene(n=24, n_lights=2)
    args, kw = capture(scene, "diffuse")
    lights = kw["lights"]
    assert kw["n_dir"] == 2 and lights.shape == (2, 4)
    out = run_plain(args, kw, term=False)
    swapped = run_plain(args, dict(kw, lights=lights.flip(0)), term=False)
    np.testing.assert_allclose(swapped, out, atol=1e-6)
    as_point = run_plain(args, dict(kw, n_dir=1), term=False)
    assert np.abs(as_point - out).max() > 1e-3
    args0, kw0 = capture(scene, "none")
    assert kw0.get("lights") is None
    np.testing.assert_array_equal(
        run_plain(args0, dict(kw0, lights=lights, n_dir=2), term=False),
        run_plain(args0, kw0, term=False))


@pytest.mark.parametrize("shading", ["none", "diffuse", "shadow"])
def test_exit_map_absent_or_far_is_bit_identical(shading):
    """The exit map that a surface gives the slice loop: one that clamps
    nothing (3.4e38 everywhere) gives the bits of no map; the sphere's
    map changes the result."""
    from tests.test_torch_geometry import _scenes
    _, ts = _scenes(("mesh",))
    args, kw = capture(ts, shading, width=48, height=40, rate=32.0)
    ex = kw.pop("exit_map")
    assert int((ex < 1e38).sum()) > 100
    none = swslice.slice_composite_plain(*args, **kw)
    far = swslice.slice_composite_plain(*args, **kw,
                                        exit_map=torch.full_like(ex, 3.4e38))
    assert torch.equal(none, far)
    assert float((swslice.slice_composite_plain(*args, **kw, exit_map=ex)
                  - none).abs().max()) > 1e-2


@pytest.mark.parametrize("shading", ["none", "diffuse"])
def test_plain_with_exit_map_matches_jax_xla_loop(shading):
    """The plain slice loop with the exit map against JAX's XLA slice
    loop with the same surface, in the fan (before the warp, the surface
    composited behind): rgba and normals 5e-5, depth 2e-4. Interpret-mode
    K1 is no oracle here: the TPU kernels take no per-pixel interval and
    composite the volume behind the surface."""
    from ovr_tpu import api as japi
    from ovr_tpu.render import shearwarp as jshearwarp
    from ovr_tpu_torch import api
    from ovr_tpu_torch.render import shearwarp as tshearwarp
    from tests.test_torch_geometry import _scenes
    js, ts = _scenes(("mesh", "iso"))
    kw = dict(width=48, height=40, sampling_rate=32.0, shading=shading,
              method="shearwarp")
    jc = japi.RenderConfig(**kw).resolved(js)
    assert jc.sw.pallas is False
    want = jshearwarp.render_shearwarp(js, jc, js.camera, fan_only=True)[:4]
    seen = {}
    orig = tshearwarp._sw_warp_out

    def spy(*a, **k):
        seen["fan"] = a[:4]
        return orig(*a, **k)

    tshearwarp._sw_warp_out = spy
    try:
        api.render(ts, api.RenderConfig(**kw).resolved(ts))
    finally:
        tshearwarp._sw_warp_out = orig
    for got, ref, tol in zip(seen["fan"], want, (5e-5, 5e-5, 2e-4, 5e-5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol)
    assert float(seen["fan"][3].max()) == 1.0  # the opaque surface


# (view, shading, hooks): a brick (brick 1 of 4, with a band of rows 4-11
# of 16) or a band alone (rows 8-15 of 16, its own fan); as
# tests/test_bricks.py, the view's principal axis is the brick axis
# (ascending, descending) or x (transverse)
HOOK_CASES = [
    ("asc", "none", "brick"),
    ("desc", "diffuse", "brick"),
    ("transverse", "shadow", "brick"),
    ("asc", "diffuse", "band"),
]


@pytest.mark.parametrize("kernel", [False, True], ids=["xla", "kernel"])
@pytest.mark.parametrize("view,shading,part", HOOK_CASES,
                         ids=[f"{v}-{s}-{p}" for v, s, p in HOOK_CASES])
def test_render_hooks_match_jax(view, shading, part, kernel):
    """`render_shearwarp` with the multi-device hooks (row0/n_rows, the
    brick's sample and clip boxes, its plane range, fan_only) against
    JAX's with the same hooks, through its XLA loop and interpret-mode
    K1: the fan's partials and the warped band at 5e-5 (rgba, normals)
    and 2e-4 (depth). The port's plain loop reads the hooks from the
    kernel's scalars, so the CUDA kernel sees them the same way."""
    import dataclasses

    from ovr_tpu import api as japi
    from ovr_tpu.parallel import bricks as jbricks
    from ovr_tpu.render import shearwarp as jshearwarp
    from ovr_tpu_torch import api
    from ovr_tpu_torch.convert import (arrays_from_fields, arrays_from_scene,
                                       bricked_from_arrays, scene_from_arrays)
    from ovr_tpu_torch.parallel import bricks
    from ovr_tpu_torch.parallel.tiles import band_cfg
    from ovr_tpu_torch.render import shearwarp as tshearwarp
    from tests.test_torch_bricks import VIEWS, sw_cfg
    from tests.test_torch_parallel import jscene

    n_b, b = 4, 1
    js = jscene(VIEWS[view])
    ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    kw = sw_cfg(shading, n_b)
    jc = japi.RenderConfig(**kw).resolved(js)
    tc = api.RenderConfig(**kw).resolved(ts)
    jc = dataclasses.replace(jc, sw=dataclasses.replace(jc.sw, pallas=kernel))
    jkw, tkw = {}, {}
    if shading == "shadow":
        lg = japi.build_light_grid(js, jc)
        jkw["light_grid"], tkw["light_grid"] = lg, torch.tensor(np.asarray(lg))
    if part == "band":
        jc = dataclasses.replace(jc, sw=dataclasses.replace(
            jc.sw, inter_h=band_cfg(tc, 2).sw.inter_h))
        tc = band_cfg(tc, 2)
        assert tc.sw.inter_h == jc.sw.inter_h < 2 * 64  # the fan shrank
        rows = dict(row0=8, n_rows=8)
    else:
        jbv = jbricks.brick_volume(js.volume, n_b)
        tbv = bricked_from_arrays(arrays_from_fields(jbv), device="cpu")
        sw = tc.sw
        tkw.update(bricks.brick_hooks(sw, tbv.local(b), n_b))
        rows = dict(row0=4, n_rows=8, slice0=tkw.pop("slice0"),
                    n_slices_loc=tkw.pop("n_slices_loc"))
        jkw.update(sample_box=(jbv.brick_lo[b], jbv.brick_hi[b]),
                   clip_box=(jbv.own_lo[b], jbv.own_hi[b]))
        js = dataclasses.replace(js, volume=dataclasses.replace(
            js.volume, grid=jbv.bricks[b]))
        ts = dataclasses.replace(ts, volume=dataclasses.replace(
            ts.volume, grid=tbv.bricks[b]))
        assert (sw.axis == 2) == (view != "transverse")
        assert sw.sign == (-1 if view == "desc" else 1)
        assert rows["slice0"] == (2.0 if view == "desc" else 1.0) * (
            rows["n_slices_loc"] if sw.axis == 2 else 0)
    jrows = dict(rows)
    if "slice0" in jrows:
        jrows["slice0"] = jnp.asarray(jrows["slice0"], jnp.float32)
    want = jshearwarp.render_shearwarp(js, jc, js.camera, fan_only=True,
                                       **jrows, **jkw)
    before = swslice.LAUNCHES
    got = tshearwarp.render_shearwarp(ts, tc, ts.camera, fan_only=True,
                                      **rows, **tkw)
    assert swslice.LAUNCHES == before
    tols = (5e-5, 5e-5, 2e-4, 5e-5)
    for g, w, tol in zip(got[:4], want[:4], tols):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=0)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert float(got[3].max()) > 0.05  # the brick's segment holds volume
    for g, w, tol in zip(got[5](*got[:4]), want[5](*want[:4]), tols):
        assert g.shape[0] == 8 * 16  # the band's pixels
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=0)
