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
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu import api as japi
from ovr_tpu.core.scene import Camera as JCamera
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


def _scenes(cam, n=24, kind="smooth", alpha=None):
    js = dataclasses.replace(jsimple(_field(n, kind)),
                             camera=JCamera.create(**CAMERAS[cam]))
    if alpha is not None:
        js = dataclasses.replace(js, tfn=dataclasses.replace(
            js.tfn, alpha=jnp.asarray(alpha, jnp.float32)))
    return js, scene_from_arrays(arrays_from_scene(js), device="cpu")


def _forced(cfg):
    """JAX's plan with the Pallas kernel forced on (interpret mode)."""
    return dataclasses.replace(cfg, sw=dataclasses.replace(cfg.sw,
                                                           pallas=True))


def render_both(js, ts, shading, kernel, macrocells=False, **kw):
    """(JAX frame, port frame) for one config; `kernel` picks JAX's
    slice-loop form."""
    kw = dict(dict(width=48, height=40, sampling_rate=32.0), **kw)
    jc = japi.RenderConfig(shading=shading, method="shearwarp",
                           **kw).resolved(js)
    tc = api.RenderConfig(shading=shading, method="shearwarp",
                          **kw).resolved(ts)
    assert jc.sw.pallas is False
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
