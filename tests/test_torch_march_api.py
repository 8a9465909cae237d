"""The port's `api.render` on the march path, and its accumulation and
Renderer facade, against the JAX package's, on the CPU.

Cameras: perspective, orthographic, an eye inside the volume, and a
wide-FOV interior eye that `method="auto"` sends to the march. Scenes
cross over through `convert.arrays_from_scene`. Tolerances: rgba and
normals 5e-5, depth 2e-4, flow 1e-4; the frozen goldens as
tests/test_goldens.py holds them (rgba 2e-3, depth 4e-3, the TF-alpha
gradient normalised 1e-4); gradients within 2e-3 of JAX's largest
element, and against central differences as tests/test_gradients.py.
The port cannot reproduce JAX's random stream: frames with spp > 1 or
jitter are checked for determinism and statistics, and JAX's
`accumulate` is fed the port's frames.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu import api as japi
from ovr_tpu.core.scene import Camera as JCamera
from ovr_tpu.core.scene import Light as JLight
from ovr_tpu.core.scene import Scene as JScene
from ovr_tpu.core.scene import StructuredVolume as JVolume
from ovr_tpu.core.scene import TransferFunction as JTfn
from ovr_tpu.render import accel as jaccel
from ovr_tpu_torch import api
from ovr_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from ovr_tpu_torch.core.scene import Camera
from ovr_tpu_torch.render import accel, integrator
from tests.test_torch_render import CAMERAS, _scenes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and a torch thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAMERAS = dict(CAMERAS, wide=dict(from_=(0.5, 0.5, 0.5), at=(0.9, 0.75, 0.5),
                                  fovy=130.0))
SIZE = dict(width=48, height=40, sampling_rate=32.0)


def port(js):
    return scene_from_arrays(arrays_from_scene(js), device="cpu")


def both_cfgs(js, ts, **kw):
    kw = dict(SIZE, **kw)
    return (japi.RenderConfig(**kw).resolved(js),
            api.RenderConfig(**kw).resolved(ts))


def assert_frames_close(tf, jf, rgba=5e-5, depth=2e-4, in_view=True):
    np.testing.assert_allclose(tf.rgba.detach().numpy(), np.asarray(jf.rgba),
                               atol=rgba)
    np.testing.assert_allclose(tf.grad.detach().numpy(), np.asarray(jf.grad),
                               atol=rgba)
    np.testing.assert_allclose(tf.depth.detach().numpy(),
                               np.asarray(jf.depth), atol=depth)
    if in_view:
        assert float(tf.rgba[..., 3].max()) > 0.1


# ---------------------------------------------------------------------------
# the inline shadow lattice (the repair)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["shearwarp", "march"])
def test_inline_shadow_lattice_matches_jax(method):
    """Without `light_grid`, shadow shading builds the lattice as JAX's
    jitted render does (the per-point shadow march), on both paths."""
    js, ts = _scenes("persp")
    jc, tc = both_cfgs(js, ts, shading="shadow", method=method)
    assert (tc.sw is not None) == (method == "shearwarp")
    assert_frames_close(api.render(ts, tc), japi.render(js, jc))


# ---------------------------------------------------------------------------
# frames against JAX
# ---------------------------------------------------------------------------

def _lights(js):
    return dataclasses.replace(js, lights=(
        JLight.create(direction=(-0.6, 0.3, -1.0), intensity=0.6),
        JLight.create(direction=(0.5, -0.2, -0.8), intensity=0.4),
        JLight.create(kind="point", position=(1.4, 1.2, -0.4),
                      intensity=0.7)))


# (camera, shading, method, extra config, lights, macrocells)
FRAME_CASES = [
    ("persp", "none", "march", {}, False, False),
    ("ortho", "diffuse", "march", {"use_macrocells": True}, True, True),
    ("inside", "none", "march", {}, False, False),
    ("persp", "shadow", "march", {"shadow_grid": False}, True, False),
    ("wide", "diffuse", "auto", {}, True, False),
    ("persp", "ssh", "march", {"use_macrocells": True,
                               "adaptive_scale": 4.0}, False, True),
    ("oblique", "diffuse", "march", {"fast_math": True, "ray_chunk": 700},
     False, True),
]


@pytest.mark.parametrize(
    "cam,shading,method,extra,lights,mc", FRAME_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in FRAME_CASES])
def test_march_frame_matches_jax(cam, shading, method, extra, lights, mc):
    kind = "sparse" if mc else "smooth"
    alpha = (np.concatenate([np.zeros(10), np.linspace(0, 0.9, 22)])
             if mc else None)
    js, _ = _scenes("persp", kind=kind, alpha=alpha)
    js = dataclasses.replace(js, camera=JCamera.create(**CAMERAS[cam]))
    if lights:
        js = _lights(js)
    ts = port(js)
    jc, tc = both_cfgs(js, ts, shading=shading, method=method, **extra)
    assert tc.sw is None and jc.sw is None
    jkw, tkw = {}, {}
    if mc:
        jkw["macrocells"] = jaccel.build_macrocells(
            js.volume.grid, js.tfn.alpha, js.tfn.value_range)
        tkw["macrocells"] = accel.build_macrocells(
            ts.volume.grid, ts.tfn.alpha, ts.tfn.value_range)
    assert_frames_close(api.render(ts, tc, **tkw),
                        japi.render(js, jc, **jkw), in_view=not mc)


def test_inside_normals_match_jax_step_by_step():
    """The inside view's shaded normals against JAX's march step run
    eagerly, step by step, on the same rays. (JAX's jitted render
    differs from its own eager steps by 5.4e-5 at pixel (14, 18) of this
    frame, where the gradient is ill-conditioned; the port's normals
    equal the eager steps' there.)"""
    from ovr_tpu.render import integrator as jig
    from ovr_tpu.render.camera import generate_rays, pixel_screen_coords
    js, ts = _scenes("inside")
    jc, tc = both_cfgs(js, ts, shading="diffuse", method="march")
    tf = api.render(ts, tc)
    sc = pixel_screen_coords(jc.width, jc.height).reshape(-1, 2)
    org, d = generate_rays(js.camera, sc, jc.width, jc.height)
    leaves = (js.volume.grid, js.tfn.color, js.tfn.alpha,
              js.tfn.value_range, jnp.ones((), jnp.float32))
    ctx = japi._shade_ctx(js, js.camera, jc)
    mcfg = jig.MarchConfig(max_steps=jc.max_steps, shading="diffuse")
    step = jnp.float32(1.0 / jc.sampling_rate)
    carry, t1 = jig._init_carry(org, d, leaves, ctx, step)
    for _ in range(jc.max_steps):
        carry = jig._march_step(carry, leaves, ctx, mcfg, org, d, step, t1)
    c, g, dep, a = jig.finalize(*carry[2:])
    n = jc.width * jc.height
    np.testing.assert_allclose(tf.grad.numpy().reshape(n, 3), np.asarray(g),
                               atol=5e-5)
    np.testing.assert_allclose(tf.rgba.numpy().reshape(n, 4)[:, :3],
                               np.asarray(c), atol=5e-5)
    np.testing.assert_allclose(tf.depth.numpy().reshape(n), np.asarray(dep),
                               atol=2e-4)


def test_default_config_renders_the_march():
    js, ts = _scenes("persp")
    tc = api.RenderConfig(width=32, height=24).resolved(ts)
    jc = japi.RenderConfig(width=32, height=24).resolved(js)
    assert tc.method == "march" and tc.shading == "shadow" and tc.sw is None
    assert_frames_close(api.render(ts, tc), japi.render(js, jc))


@pytest.mark.parametrize("method", ["shearwarp", "march"])
def test_flow_matches_jax(method):
    js, ts = _scenes("persp")
    last = dict(CAMERAS["persp"], from_=(0.6, 0.45, -1.75))
    jc, tc = both_cfgs(js, ts, shading="diffuse", method=method)
    jf = japi.render(js, jc, last_camera=JCamera.create(**last))
    tf = api.render(ts, tc, last_camera=Camera.create(**last, device="cpu"))
    assert_frames_close(tf, jf)
    assert tuple(tf.flow.shape) == (SIZE["height"], SIZE["width"], 2)
    assert float(tf.flow.abs().max()) > 1e-3
    # the flow is premultiplied until it is divided by alpha: held
    # premultiplied everywhere and straight where alpha > 1e-2 (on the
    # shear-warp path the slice loops' alphas differ by ~7e-7, which
    # the division amplifies at silhouettes of alpha ~5e-4)
    a_t, a_j = tf.rgba[..., 3:].numpy(), np.asarray(jf.rgba)[..., 3:]
    np.testing.assert_allclose(tf.flow.numpy() * a_t,
                               np.asarray(jf.flow) * a_j, atol=1e-4)
    seen = a_j[..., 0] > 1e-2
    np.testing.assert_allclose(tf.flow.numpy()[seen],
                               np.asarray(jf.flow)[seen], atol=1e-4)


def test_ray_chunk_gives_the_whole_frame():
    """Chunks give the whole frame's values: bit for bit on the card;
    here to an ulp or two, because the CPU's vectorised pow differs from
    its scalar loop over a chunk's tail."""
    _, ts = _scenes("oblique")
    cfg = api.RenderConfig(shading="diffuse", **SIZE).resolved(ts)
    whole = api.render(ts, cfg)
    for chunk in (640, 700):  # a divisor of 48*40 rays, and not
        part = api.render(ts, dataclasses.replace(cfg, ray_chunk=chunk))
        for k in ("rgba", "grad", "depth"):
            np.testing.assert_allclose(getattr(part, k).numpy(),
                                       getattr(whole, k).numpy(), atol=1e-6)


def test_fast_math_gives_the_full_march_and_refuses_grad():
    _, ts = _scenes("persp")
    cfg = api.RenderConfig(shading="diffuse", **SIZE).resolved(ts)
    full = api.render(ts, cfg)
    fast = api.render(ts, dataclasses.replace(cfg, fast_math=True))
    for k in ("rgba", "grad", "depth"):
        assert torch.equal(getattr(fast, k), getattr(full, k))
    grid = ts.volume.grid.clone().requires_grad_(True)
    scene = dataclasses.replace(ts, volume=dataclasses.replace(
        ts.volume, grid=grid))
    with pytest.raises(RuntimeError, match="forward-only"):
        api.render(scene, dataclasses.replace(cfg, fast_math=True))


# ---------------------------------------------------------------------------
# goldens (tests/goldens/gen.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    from tests.goldens.gen import cameras, golden_scene
    data = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "goldens.npz"))
    ortho, persp = cameras()
    scene = golden_scene()
    return data, {"ortho": port(dataclasses.replace(scene, camera=ortho)),
                  "persp": port(dataclasses.replace(scene, camera=persp))}


def golden_cfg(ts, shading, **kw):
    kw = dict(dict(width=96, height=80, spp=1, sampling_rate=64.0), **kw)
    return api.RenderConfig(shading=shading, method="march",
                            **kw).resolved(ts)


@pytest.mark.parametrize("shading", ["none", "diffuse"])
def test_ortho_march_golden(golden, shading):
    data, scenes = golden
    f = api.render(scenes["ortho"], golden_cfg(scenes["ortho"], shading))
    np.testing.assert_allclose(
        f.rgba.numpy(), data[f"ortho_march_{shading}_rgba"].astype(
            np.float32), atol=2e-3)
    np.testing.assert_allclose(
        f.depth.numpy(), data[f"ortho_march_{shading}_depth"].astype(
            np.float32), atol=4e-3)


def test_persp_march_golden(golden):
    data, scenes = golden
    f = api.render(scenes["persp"], golden_cfg(scenes["persp"], "diffuse"))
    np.testing.assert_allclose(
        f.rgba.numpy(), data["persp_march_diffuse_rgba"].astype(np.float32),
        atol=2e-3)


def _tf_loss(ts, cfg, alpha):
    tfn = dataclasses.replace(ts.tfn, alpha=alpha)
    f = api.render(dataclasses.replace(ts, tfn=tfn), cfg)
    return torch.sum(f.rgba[..., :3] ** 2) + torch.sum(f.rgba[..., 3])


def test_tf_grad_golden(golden):
    data, scenes = golden
    ts = scenes["persp"]
    cfg = golden_cfg(ts, "none", width=24, height=24, sampling_rate=32.0)
    alpha = ts.tfn.alpha.clone().requires_grad_(True)
    _tf_loss(ts, cfg, alpha).backward()
    ref = data["tf_alpha_grad"]
    scale = np.abs(ref).max() + 1e-9
    np.testing.assert_allclose(alpha.grad.numpy() / scale, ref / scale,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# tests/test_gradients.py's cases: JAX's gradients and central differences
# ---------------------------------------------------------------------------

def _tiny_scenes():
    """tests/test_gradients.py's scene, in both packages."""
    rng = np.random.default_rng(0)
    grid = rng.uniform(0.2, 0.8, size=(6, 6, 6)).astype(np.float32)
    color = np.stack([np.linspace(0.1, 0.9, 6)] * 3, -1).astype(np.float32)
    alpha = np.linspace(0.05, 0.6, 6).astype(np.float32)
    cam = JCamera.create(from_=(0.5, 0.5, -1.5), at=(0.5, 0.5, 0.5),
                         fovy=50.0)
    js = JScene.create(JVolume.create(grid), JTfn.create(color, alpha,
                                                         (0.0, 1.0)),
                       camera=cam, volume_sampling_rate=8.0)
    return js, port(js)


def _get(scene, name):
    return {"grid": scene.volume.grid, "alpha": scene.tfn.alpha,
            "color": scene.tfn.color, "from_": scene.camera.from_}[name]


def _put(scene, name, v):
    if name == "grid":
        return dataclasses.replace(scene, volume=dataclasses.replace(
            scene.volume, grid=v))
    if name == "from_":
        return dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera, from_=v))
    return dataclasses.replace(scene, tfn=dataclasses.replace(
        scene.tfn, **{name: v}))


@pytest.fixture(scope="module")
def tiny():
    js, ts = _tiny_scenes()
    out = {}
    for shading in ("none", "shadow"):
        jc = japi.RenderConfig(width=6, height=6, spp=1, sampling_rate=8.0,
                               shading=shading).resolved(js)
        tc = api.RenderConfig(width=6, height=6, spp=1, sampling_rate=8.0,
                              shading=shading).resolved(ts)
        out[shading] = (jc, tc)
    return js, ts, out


GRAD_CASES = [("grid", "none"), ("alpha", "none"), ("color", "none"),
              ("from_", "none"), ("grid", "shadow")]


@pytest.mark.parametrize("name,shading", GRAD_CASES,
                         ids=[f"{n}-{s}" for n, s in GRAD_CASES])
def test_gradient_matches_jax_and_differences(tiny, name, shading):
    js, ts, cfgs = tiny
    jc, tc = cfgs[shading]

    def loss(x):
        return torch.sum(api.render(_put(ts, name, x), tc).rgba ** 2)

    want = np.asarray(jax.grad(lambda x: jnp.sum(
        japi.render(_put(js, name, x), jc).rgba ** 2))(_get(js, name)))
    x = _get(ts, name).clone().requires_grad_(True)
    loss(x).backward()
    got = x.grad.numpy()
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-3)
    if shading == "shadow":
        return  # tests/test_gradients.py holds the shaded case to finite
    # central differences at the coordinates with the most signal
    x0 = _get(ts, name).double()
    flat = got.ravel()
    idx = np.argsort(-np.abs(flat))[:3] if name != "from_" else range(3)
    eps = 1e-3
    rtol, atol = (0.1, 5e-3) if name == "from_" else (0.08, 2e-3)
    with torch.no_grad():
        for i in idx:
            d = torch.zeros_like(x0).reshape(-1)
            d[i] = eps
            d = d.reshape(x0.shape)
            fd = (float(loss((x0 + d).float()))
                  - float(loss((x0 - d).float()))) / (2 * eps)
            np.testing.assert_allclose(flat[i], fd, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# randomness, accumulation, the Renderer
# ---------------------------------------------------------------------------

def _jitter_cfg(ts, **kw):
    return api.RenderConfig(width=16, height=12, sampling_rate=16.0,
                            shading="none", jitter_rays=True,
                            **kw).resolved(ts)


@pytest.mark.parametrize("method,spp", [("march", 1), ("march", 3),
                                        ("shearwarp", 2)])
def test_same_seed_gives_the_same_frame(method, spp):
    _, ts = _scenes("persp")
    cfg = _jitter_cfg(ts, method=method, spp=spp)

    def frame(seed):
        g = torch.Generator().manual_seed(seed)
        return api.render(ts, cfg, generator=g).rgba

    a, b, c = frame(3), frame(3), frame(4)
    assert torch.equal(a, b)
    assert float((a - c).abs().max()) > 1e-4
    assert torch.equal(api.render(ts, cfg, frame_index=5).rgba,
                       api.render(ts, cfg, frame_index=5).rgba)


def test_accumulate_and_variance_match_jax():
    """JAX's accumulate and variance_of on the port's jittered frames
    give the port's; the display is the running mean."""
    js, ts = _scenes("persp")
    last = Camera.create(**dict(CAMERAS["persp"], from_=(0.6, 0.5, -1.8)),
                         device="cpu")
    cfg = _jitter_cfg(ts, spp=2)
    acc = jacc = None
    frames = []
    for i in range(1, 5):
        f = api.render(ts, cfg, frame_index=i, last_camera=last)
        frames.append(f)
        disp, acc = api.accumulate(f, acc, i)
        jf = japi.Frame(*(jnp.asarray(x.numpy()) for x in (
            f.rgba, f.grad, f.depth, f.flow)))
        jdisp, jacc = japi.accumulate(jf, jacc, i)
        for k in ("rgba", "grad", "depth", "flow"):
            np.testing.assert_allclose(getattr(disp, k).numpy(),
                                       np.asarray(getattr(jdisp, k)),
                                       atol=1e-6)
        want = japi.variance_of(jacc, i)
        got = api.variance_of(acc, i)
        if i < 2:
            assert got == want == float("inf")
        else:
            assert got > 0
            np.testing.assert_allclose(got, want, rtol=1e-5)
    mean = torch.stack([f.rgba for f in frames]).mean(0)
    np.testing.assert_allclose(disp.rgba.numpy(), mean.numpy(), atol=1e-6)


def test_renderer_lifecycle_matches_jax():
    """tests/test_render.py's facade lifecycle, each frame held against
    the JAX Renderer's."""
    js, ts = _scenes("persp")
    kw = dict(width=8, height=8, spp=1, sampling_rate=16.0, shading="none")
    jr = japi.Renderer(js, japi.RenderConfig(**kw))
    r = api.Renderer(ts, api.RenderConfig(**kw))
    for x in (jr, r):
        x.set_camera(from_=(0.5, 0.5, -2.0), at=(0.5, 0.5, 0.5))
        x.commit()
        x.render()
    out = r.mapframe()
    assert out["rgba"].shape == (8, 8, 4)
    np.testing.assert_allclose(out["rgba"], jr.mapframe()["rgba"], atol=5e-5)
    for x in (jr, r):
        x.set_volume_sampling_rate(24.0)
        x.set_shading("shadow")
        x.set_frame_accumulation(True)
        x.render()
        x.render()
        x.swap()
    out = r.mapframe()
    assert np.all(np.isfinite(out["rgba"]))
    assert r._light_grid is not None and r._cfg.max_steps == jr._cfg.max_steps
    np.testing.assert_allclose(out["rgba"], jr.mapframe()["rgba"], atol=5e-5)
    assert r.variance == pytest.approx(jr.variance, abs=1e-7)
    assert r.render_time > 0


def test_march_steps_counter_counts_steps():
    _, ts = _scenes("persp")
    cfg = api.RenderConfig(shading="none", **SIZE).resolved(ts)
    n0 = integrator.STEPS
    api.render(ts, cfg)
    assert integrator.STEPS - n0 == cfg.max_steps
