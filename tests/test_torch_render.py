"""The port's shear-warp frame (ovr_tpu_torch.api.render) against the JAX
package's, end to end on the CPU.

One JAX scene, built from numpy, crosses over through
`convert.arrays_from_scene`. The port's slice loop on CPU tensors is
`slice_composite_plain`; each case holds it against both forms of JAX's
slice loop: the XLA path ("xla") and the Pallas kernel in interpret mode
("kernel"). Tolerances: rgba and normals 5e-5, depth 2e-4 (the JAX
suite's kernel-vs-XLA parity), early termination 5e-4. The shadow
lattice is built once by the JAX package outside jit (its swept
builder) and handed to both renderers.

More than 4 extra directional lights and point lights run, in JAX, only
through its XLA loop; the port's one loop (the kernel's function) is
held against it. `sw_bf16` frames are held against JAX's kernel forward
(interpret mode) with its bf16 warp, and against its XLA loop, which
rounds the classifier too (the difference is stated in the test).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu import api as japi
from ovr_tpu.core.scene import Camera as JCamera
from ovr_tpu.core.scene import Light as JLight
from ovr_tpu.core.scene import simple_scene as jsimple
from ovr_tpu.render import accel as jaccel
from ovr_tpu_torch import api
from ovr_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from ovr_tpu_torch.ops import swslice
from ovr_tpu_torch.render import accel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and a torch thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CAMERAS = {
    "persp": dict(from_=(0.5, 0.5, -1.8), at=(0.5, 0.5, 0.5), fovy=45.0),
    "ortho": dict(from_=(0.5, 0.5, -2.0), at=(0.5, 0.5, 0.5), height=1.4,
                  kind="orthographic"),
    "rolled": dict(from_=(0.5, 0.5, -1.8), at=(0.5, 0.5, 0.5),
                   up=(1.0, 0.0, 0.0), fovy=45.0),
    "oblique": dict(from_=(1.2, 1.1, -1.5), at=(0.5, 0.5, 0.5), fovy=40.0),
    "x_neg": dict(from_=(2.3, 0.5, 0.4), at=(0.5, 0.5, 0.5), fovy=45.0),
    "inside": dict(from_=(0.45, 0.4, 0.25), at=(0.7, 0.3, 0.9), fovy=40.0),
}


def _field(n, kind="smooth"):
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    if kind == "sparse":
        return np.exp(-((x - 0.7) ** 2 + (y - 0.3) ** 2 + (z - 0.6) ** 2)
                      * 120).astype(np.float32)
    return (0.5 + 0.45 * np.sin(6 * x) * np.cos(5 * y)
            * np.sin(4 * z + 1.0)).astype(np.float32)


def _u16(g):
    """A field in [0, 1] as 16-bit counts."""
    return np.clip(np.round(g * 65535), 0, 65535).astype(np.uint16)


def _scenes(cam, n=24, kind="smooth", alpha=None, dtype="f32"):
    g = _field(n, kind)
    js = dataclasses.replace(jsimple(_u16(g) if dtype == "u16" else g),
                             camera=JCamera.create(**CAMERAS[cam]))
    if alpha is not None:
        js = dataclasses.replace(js, tfn=dataclasses.replace(
            js.tfn, alpha=jnp.asarray(alpha, jnp.float32)))
    return js, scene_from_arrays(arrays_from_scene(js), device="cpu")


def _forced(cfg):
    """JAX's plan with the Pallas kernel forced on (interpret mode)."""
    return dataclasses.replace(cfg, sw=dataclasses.replace(cfg.sw,
                                                           pallas=True))


def render_both(js, ts, shading, kernel, macrocells=False, fd=None, **kw):
    """(JAX frame, port frame) for one config; `kernel` picks JAX's
    slice-loop form, `fd` (if not None) the shading gradient of both."""
    kw = dict(dict(width=48, height=40, sampling_rate=32.0), **kw)
    jc = japi.RenderConfig(shading=shading, method="shearwarp",
                           **kw).resolved(js)
    tc = api.RenderConfig(shading=shading, method="shearwarp",
                          **kw).resolved(ts)
    assert jc.sw.pallas is False
    if fd is not None:
        jc = dataclasses.replace(jc, sw=dataclasses.replace(jc.sw,
                                                           fd_grad=fd))
        tc = dataclasses.replace(tc, sw=dataclasses.replace(tc.sw,
                                                           fd_grad=fd))
    if kernel:
        jc = _forced(jc)
    jkw, tkw = {}, {}
    if shading == "shadow":
        lg = japi.build_light_grid(js, jc)
        jkw["light_grid"] = lg
        tkw["light_grid"] = torch.from_numpy(np.asarray(lg))
    if macrocells:
        jkw["macrocells"] = jaccel.build_macrocells(
            js.volume.grid, js.tfn.alpha, js.tfn.value_range)
        tkw["macrocells"] = accel.build_macrocells(
            ts.volume.grid, ts.tfn.alpha, ts.tfn.value_range)
    before = swslice.LAUNCHES
    tf = api.render(ts, tc, **tkw)
    assert swslice.LAUNCHES == before
    return japi.render(js, jc, **jkw), tf, tc


def assert_frames_close(jf, tf, rgba=5e-5, depth=2e-4):
    np.testing.assert_allclose(tf.rgba.numpy(), np.asarray(jf.rgba),
                               atol=rgba)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf.grad),
                               atol=rgba)
    np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth),
                               atol=depth)
    assert float(tf.rgba[..., 3].max()) > 0.1  # the volume is in view


# (camera, shading, extra config)
CASES = [
    ("persp", "none", {}),
    ("persp", "diffuse", {}),
    ("persp", "shadow", {}),
    ("ortho", "diffuse", {}),
    ("rolled", "none", {}),
    ("oblique", "diffuse", {}),
    ("x_neg", "shadow", {}),
    ("inside", "diffuse", {}),
    ("persp", "none", {"spp": 2}),
]


@pytest.mark.parametrize("kernel", [False, True], ids=["xla", "kernel"])
@pytest.mark.parametrize("cam,shading,extra", CASES,
                         ids=[f"{c}-{s}{'-spp2' if e else ''}"
                              for c, s, e in CASES])
def test_render_matches_jax(cam, shading, extra, kernel):
    js, ts = _scenes(cam)
    jf, tf, tc = render_both(js, ts, shading, kernel, **extra)
    if cam == "rolled":
        assert tc.sw.swap
    if cam == "oblique":
        assert not tc.sw.separable
    if cam == "inside":
        assert tc.sw.slice0_static > 0
    assert_frames_close(jf, tf)


@pytest.mark.parametrize("cam,shading", [("persp", "diffuse"),
                                         ("x_neg", "shadow"),
                                         ("inside", "diffuse")])
def test_skip_matches_jax(cam, shading):
    """Macrocell skipping in both kernels (JAX per row tile, the port per
    CUDA block) leaves the frame as the unskipped one."""
    alpha = np.concatenate([np.zeros(10), np.linspace(0, 0.9, 22)])
    js, ts = _scenes(cam, n=32, kind="sparse", alpha=alpha)
    jf, tf, _ = render_both(js, ts, shading, kernel=True, macrocells=True,
                            sw_term=False)
    assert_frames_close(jf, tf)


def test_termination_matches_jax():
    alpha = np.linspace(0.5, 1.0, 16)
    js, ts = _scenes("persp", alpha=alpha)
    jf, tf, _ = render_both(js, ts, "diffuse", kernel=True, base_rate=8.0)
    assert float(tf.rgba[..., 3].max()) > 0.999
    assert_frames_close(jf, tf, rgba=5e-4, depth=5e-4)


@pytest.mark.parametrize("kernel", [False, True], ids=["xla", "kernel"])
def test_persp_shearwarp_golden(kernel):
    """The port reproduces the frozen `persp_sw_diffuse_rgba` golden
    (tests/goldens/gen.py: its scene, perspective camera, 96x80).

    Compared premultiplied, at the JAX suite's 2e-3 plus the golden's
    float16 storage rounding (5e-4). Straight color divides by alpha, and
    this scene's clipped plateaus (values exactly 1.0) give normals of
    rounding-noise gradients: at silhouette pixels (alpha ~0.01) the
    division amplifies their differences a hundredfold, so that even the
    JAX package's own Pallas kernel misses the straight golden there.

    "xla" composites every plane as JAX's XLA loop does (no termination,
    no skipping); "kernel" turns on the kernel's termination and
    macrocell skipping."""
    import os

    from tests.goldens.gen import cameras, golden_scene
    golden = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                  "goldens.npz"))["persp_sw_diffuse_rgba"]
    js = golden_scene()
    _, persp = cameras()
    ts = scene_from_arrays(arrays_from_scene(
        dataclasses.replace(js, camera=persp)), device="cpu")
    cfg = api.RenderConfig(width=96, height=80, spp=1, sampling_rate=64.0,
                           shading="diffuse", method="shearwarp",
                           sw_term=kernel).resolved(ts)
    mc = (accel.build_macrocells(ts.volume.grid, ts.tfn.alpha,
                                 ts.tfn.value_range) if kernel else None)
    rgba = api.render(ts, cfg, macrocells=mc).rgba.numpy()
    golden = golden.astype(np.float32)

    def premult(x):
        return np.concatenate([x[..., :3] * x[..., 3:], x[..., 3:]], -1)

    np.testing.assert_allclose(premult(rgba), premult(golden), atol=2.5e-3)


# ---------------------------------------------------------------------------
# 16-bit volumes: the grid stays uint16 and the slice loop scales it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [False, True], ids=["xla", "kernel"])
@pytest.mark.parametrize("shading", ["none", "diffuse", "shadow"])
def test_u16_render_matches_jax(shading, kernel):
    """A u16 grid (32 rows: the JAX kernel streams it as u16) through
    `api.render` in both packages, macrocells on, at the file's
    tolerances; the port keeps the grid in its type."""
    js, ts = _scenes("oblique", n=32, dtype="u16")
    assert js.volume.grid.dtype == jnp.uint16
    assert ts.volume.grid.dtype == torch.uint16
    jf, tf, _ = render_both(js, ts, shading, kernel, macrocells=True)
    assert_frames_close(jf, tf)


def test_u16_termination_matches_jax():
    alpha = np.linspace(0.5, 1.0, 16)
    js, ts = _scenes("persp", n=32, alpha=alpha, dtype="u16")
    jf, tf, _ = render_both(js, ts, "diffuse", kernel=True, base_rate=8.0)
    assert float(tf.rgba[..., 3].max()) > 0.999
    assert_frames_close(jf, tf, rgba=5e-4, depth=5e-4)


def test_u16_shadow_lattice_matches_jax():
    """The shadow lattice of a u16 grid: `api.build_light_grid` (the
    swept builder) against JAX's at 1e-5, and the storage scale applied
    (tests/test_swskip.py:296's rule against the f32 field's lattice);
    a shadow frame without `light_grid` (the lattice built inside
    `render`, JAX's per-point shadow march) against JAX's."""
    js, ts = _scenes("persp", n=32, dtype="u16")
    kw = dict(width=48, height=40, sampling_rate=32.0, shading="shadow")
    jc = japi.RenderConfig(**kw).resolved(js)
    tc = api.RenderConfig(**kw).resolved(ts)
    lg = api.build_light_grid(ts, tc)
    np.testing.assert_allclose(lg.numpy(), np.asarray(
        japi.build_light_grid(js, jc)), atol=1e-5)
    _, t32 = _scenes("persp", n=32)
    lg32 = api.build_light_grid(t32, api.RenderConfig(**kw).resolved(t32))
    assert float((lg - lg32).abs().mean()) < 2e-2
    assert float(lg.max()) > 0.1  # the volume does cast shadows
    assert_frames_close(japi.render(js, jc), api.render(ts, tc))


# ---------------------------------------------------------------------------
# extra lights beyond the JAX kernel's 4 slots, and point lights
# ---------------------------------------------------------------------------

RIGS = {
    # bench.py's BENCH_EXTRA_LIGHTS=6
    "six": lambda: tuple(JLight.create(direction=(0.4 * i - 0.6, 0.3, -1.0),
                                       intensity=0.5 + 0.1 * i)
                         for i in range(6)),
    "point": lambda: (JLight.create(position=(0.5, 1.8, 0.5), kind="point",
                                    intensity=1.2),),
    # tests/test_scene_features.py's rig: two directional, one point
    "rig": lambda: (JLight.create(direction=(0.3, -0.2, -1.0),
                                  intensity=0.7),
                    JLight.create(direction=(-1.0, 0.4, 0.1), intensity=0.5)
                    ) + RIGS["point"](),
}


def _lit_scenes(cam, rig, **kw):
    js, _ = _scenes(cam, **kw)
    js = dataclasses.replace(js, lights=RIGS[rig]())
    return js, scene_from_arrays(arrays_from_scene(js), device="cpu")


# (camera, shading, rig, FD gradient)
LIGHT_CASES = [("persp", "diffuse", "six", None),
               ("persp", "diffuse", "point", None),
               ("ortho", "diffuse", "point", True),
               ("ortho", "shadow", "rig", None),
               ("x_neg", "diffuse", "rig", True),
               ("oblique", "shadow", "six", None),
               ("inside", "diffuse", "rig", None)]


@pytest.mark.parametrize("cam,shading,rig,fd", LIGHT_CASES,
                         ids=[f"{c}-{s}-{r}{'-fd' if f else ''}"
                              for c, s, r, f in LIGHT_CASES])
def test_light_rigs_match_jax(cam, shading, rig, fd):
    """The port's loop with the light table against JAX's XLA loop (the
    only loop that runs these rigs there), termination off."""
    js, ts = _lit_scenes(cam, rig)
    jf, tf, _ = render_both(js, ts, shading, kernel=False, fd=fd,
                            sw_term=False)
    assert_frames_close(jf, tf)
    # the rig does shade: the frame without it differs
    js0, ts0 = _scenes(cam)
    _, tf0, _ = render_both(js0, ts0, shading, kernel=False, fd=fd,
                            sw_term=False)
    assert np.abs(tf.rgba.numpy() - tf0.rgba.numpy()).max() > 1e-2


def test_light_rig_skip_and_termination_match_jax():
    """Skipping and termination on a light rig: JAX's XLA loop does
    neither, so the frame is held at 5e-4 (the termination bound)."""
    alpha = np.linspace(0.5, 1.0, 16)
    js, ts = _lit_scenes("persp", "rig", alpha=alpha)
    jf, tf, _ = render_both(js, ts, "diffuse", kernel=False, macrocells=True,
                            base_rate=8.0)
    assert float(tf.rgba[..., 3].max()) > 0.999
    assert_frames_close(jf, tf, rgba=5e-4, depth=5e-4)


# ---------------------------------------------------------------------------
# sw_bf16
# ---------------------------------------------------------------------------

def test_bf16_warp_matches_jax():
    """`warp_rows` and `warp_separable` with bf16 operands against the
    JAX package's weight matmuls: the same bits but where an upper tap's
    weight 1 - |p - i| and the port's fraction f differ in their last f32
    bit at a bf16 tie (positions below 1)."""
    from ovr_tpu.render import shearwarp as jsw
    from ovr_tpu_torch.render import shearwarp as tsw
    rng = np.random.default_rng(0)
    img = rng.random((20, 28, 8), dtype=np.float32)
    pos = (rng.random((20, 33), dtype=np.float32) * 30 - 1).astype(np.float32)
    got = tsw.warp_rows(torch.from_numpy(img), torch.from_numpy(pos),
                        bf16=True).numpy()
    want = np.asarray(jsw.warp_rows(jnp.asarray(img), jnp.asarray(pos),
                                    bf16=True))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(got - tsw.warp_rows(torch.from_numpy(img),
                                      torch.from_numpy(pos)).numpy()
                  ).max() > 1e-3
    rp = (rng.random(17, dtype=np.float32) * 22 - 1).astype(np.float32)
    cp = (rng.random(31, dtype=np.float32) * 30 - 1).astype(np.float32)
    got = tsw.warp_separable(torch.from_numpy(img), torch.from_numpy(rp),
                             torch.from_numpy(cp), bf16=True).numpy()
    want = np.asarray(jsw.warp_separable(jnp.asarray(img), jnp.asarray(rp),
                                         jnp.asarray(cp), bf16=True))
    np.testing.assert_allclose(got, want, atol=1e-6)


def assert_bf16_frames_close(tf, jf):
    """sw_bf16 frames against JAX's with its kernel forward. The warp
    rounds its image to bf16 as well, so a slice-loop value that the two
    loops round apart (tests/test_torch_swslice.py's assert_bf16_close)
    reaches the screen as a whole bf16 ulp of the pixel: up to 3.9e-3
    for a colour or opacity in [0.5, 1), 1.6e-2 for a depth in [2, 4);
    and a normal turns further where a flipped tap sits in its gradient.
    Measured on these scenes: at most 1.5% of the values beyond 2e-5,
    rgba up to 6.9e-3, normals up to 1.63e-2 (a normal z of 0.12), depth
    up to 1.59e-2. Held: 2.5% beyond 2e-5, rgba 8e-3 (two ulps near 1),
    normals and depth 2e-2."""
    a, b = _channels(tf), _channels(jf)
    d = np.abs(a - b)
    assert float((d > 2e-5).mean()) <= 0.025
    assert float(d[[0, 1, 2, 7]].max()) <= 8e-3
    assert float(d[3:7].max()) <= 2e-2


# (camera, shading, grid edge): f32 grids of 32 rows are read as bf16
BF16_RENDER_CASES = [("persp", "none", 24), ("persp", "diffuse", 32),
                     ("ortho", "shadow", 24), ("rolled", "diffuse", 24),
                     ("oblique", "none", 32), ("x_neg", "shadow", 32)]


@pytest.mark.parametrize("cam,shading,n", BF16_RENDER_CASES)
def test_bf16_render_matches_jax_kernel(cam, shading, n):
    """`api.render` with sw_bf16 against JAX's with its kernel forced on
    (interpret mode), which rounds as the port's loop does, and its bf16
    warp."""
    js, ts = _scenes(cam, n=n)
    jf, tf, tc = render_both(js, ts, shading, kernel=True, sw_bf16=True,
                             sw_term=False)
    assert tc.sw.bf16
    assert_bf16_frames_close(tf, jf)
    assert float(tf.rgba[..., 3].max()) > 0.1
    # bf16 operands change the frame
    _, t32, _ = render_both(js, ts, shading, kernel=True, sw_term=False)
    assert np.abs(tf.rgba.numpy() - t32.rgba.numpy()).max() > 1e-3


def _channels(frame):
    """A frame as (8, H, W): rgb, normals, depth, alpha (the slice loop's
    channel order)."""
    rgba, grad, depth = (np.asarray(x) for x in (frame.rgba, frame.grad,
                                                 frame.depth))
    return np.concatenate([np.moveaxis(rgba[..., :3], -1, 0),
                           np.moveaxis(grad, -1, 0), depth[None],
                           rgba[None, ..., 3]])


@pytest.mark.parametrize("cam,shading", [("persp", "diffuse"),
                                         ("ortho", "none"),
                                         ("x_neg", "shadow")])
def test_bf16_render_against_jax_xla_loop(cam, shading):
    """Against JAX's XLA loop under sw_bf16, which also rounds the
    classifier's two weights and its table to bf16 (`_classify_impl`):
    an opacity near 1 rounded so changes 1 - a by much more than 2^-9
    (0.999 becomes 0.99609375), and the change compounds along the ray.
    JAX's own kernel differs from its XLA loop by the same amount as the
    port does (measured on these scenes, both: rgba up to 4.60e-2, mean
    up to 7.5e-4; normals up to 8.0e-3; depth up to 2.29e-2, mean up to
    2.9e-3)."""
    js, ts = _scenes(cam)
    jf, tf, _ = render_both(js, ts, shading, kernel=False, sw_bf16=True,
                            sw_term=False)
    a, b = _channels(tf), _channels(jf)
    d = np.abs(a - b)
    rgba = d[[0, 1, 2, 7]]
    assert float(rgba.max()) <= 5e-2 and float(rgba.mean()) <= 1e-3
    assert float(d[3:6].max()) <= 1e-2
    assert float(d[6].max()) <= 3e-2 and float(d[6].mean()) <= 4e-3
