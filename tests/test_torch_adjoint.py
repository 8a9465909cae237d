"""The port's backward (ovr_tpu_torch.ops.adjoint and the slice loop's
autograd) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed. The port's slice loop on CPU
tensors runs `slice_composite_plain` forward and the analytic adjoint
backward; JAX's `api.render` runs its XLA slice loop ("xla") or its
Pallas kernel in interpret mode ("kernel") forward and its own adjoint
backward. Tolerances: over_scan forward rtol 1e-5, gradients rtol 2e-4
and atol 2e-5 (tests/test_adjoint.py); frame gradients within 2e-3 of
the largest reference element (tests/test_shearwarp.py's), 5e-3 for a
bf16 grid; finite differences rtol 0.05.

The volume is a smooth field with no flat face: where a plane's samples
are exactly constant the shading normal is zero, and its gradient is
rounding noise times 1e6 (the rsqrt guard), in either package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu import api as japi
from ovr_tpu.core.scene import Camera as JCamera
from ovr_tpu.core.scene import simple_scene as jsimple
from ovr_tpu.ops import adjoint as jadjoint
from ovr_tpu.render import accel as jaccel
from ovr_tpu_torch import api
from ovr_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from ovr_tpu_torch.ops import adjoint, swslice
from ovr_tpu_torch.render import accel
from tests.test_torch_render import CAMERAS, _forced


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and a torch thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# over_scan
# ---------------------------------------------------------------------------

def _rng():
    return np.random.default_rng(0)


def test_over_scan_forward_matches_jax():
    n, m = 17, 9
    vs = _rng().random((m, n, 3), dtype=np.float32)
    al = (0.6 * _rng().random((m, n))).astype(np.float32)
    big_v, trans = adjoint.over_scan(  # values channel first
        lambda p, k: (p["v"][k].T, p["a"][k]), m,
        dict(v=torch.from_numpy(vs), a=torch.from_numpy(al)))
    jv, jt = jadjoint.over_scan(lambda p, k: (p[0][k], p[1][k]), m,
                                (jnp.asarray(vs), jnp.asarray(al)))
    np.testing.assert_allclose(big_v.T.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(trans.numpy(), np.asarray(jt), rtol=1e-5)


def test_over_scan_grad_matches_jax():
    n, m = 11, 7
    vs = _rng().random((m, n, 2), dtype=np.float32)
    al = (0.7 * _rng().random((m, n))).astype(np.float32)

    def jf(p, k):
        v, a = p
        return v[k] * jnp.tanh(a[k])[..., None], jnp.sin(a[k]) ** 2

    def jloss(p):
        big_v, trans = jadjoint.over_scan(jf, m, p)
        return jnp.sum(big_v ** 2) + jnp.sum((1 - trans) ** 3)

    def tf(p, k):
        return ((p["v"][k] * torch.tanh(p["a"][k])[..., None]).T,
                torch.sin(p["a"][k]) ** 2)

    tv = torch.from_numpy(vs).requires_grad_(True)
    ta = torch.from_numpy(al).requires_grad_(True)
    big_v, trans = adjoint.over_scan(tf, m, dict(v=tv, a=ta))
    (torch.sum(big_v ** 2) + torch.sum((1 - trans) ** 3)).backward()
    jv, ja = jax.grad(jloss)((jnp.asarray(vs), jnp.asarray(al)))
    for got, want in ((tv.grad, jv), (ta.grad, ja)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-5)


def test_over_scan_saturating_alpha():
    """alpha -> 1 (the early-exit regime) stays finite in the backward."""
    n, m = 5, 6
    v = torch.from_numpy(_rng().random((m, n, 1), dtype=np.float32))
    a = torch.ones((m, n), requires_grad=True)
    v.requires_grad_(True)
    big_v, _ = adjoint.over_scan(lambda p, k: (p["v"][k].T, p["a"][k]), m,
                                 dict(v=v, a=a))
    big_v.sum().backward()
    assert torch.isfinite(v.grad).all() and torch.isfinite(a.grad).all()


# ---------------------------------------------------------------------------
# frame gradients through api.render
# ---------------------------------------------------------------------------

def _field(n, kind="smooth"):
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    if kind == "sparse":
        return np.exp(-((x - 0.7) ** 2 + (y - 0.3) ** 2 + (z - 0.6) ** 2)
                      * 120).astype(np.float32)
    return (0.5 + 0.45 * np.sin(6 * x + 0.5) * np.cos(5 * y + 0.3)
            * np.sin(4 * z + 1.0)).astype(np.float32)


def _grid(g, dtype):
    if dtype == "u8":
        return np.clip(np.round(g * 255), 0, 255).astype(np.uint8)
    if dtype == "u16":
        return np.clip(np.round(g * 65535), 0, 65535).astype(np.uint16)
    if dtype == "bf16":
        return jnp.asarray(g, jnp.bfloat16)
    return g


def _scenes(cam, n=16, kind="smooth", dtype="f32", alpha=None):
    """The same scene in both packages."""
    js = dataclasses.replace(jsimple(_grid(_field(n, kind), dtype)),
                             camera=JCamera.create(**CAMERAS[cam]))
    if alpha is not None:
        js = dataclasses.replace(js, tfn=dataclasses.replace(
            js.tfn, alpha=jnp.asarray(alpha, jnp.float32)))
    return js, scene_from_arrays(arrays_from_scene(js), device="cpu")


def _configs(js, ts, shading, fd=None, **kw):
    kw = dict(dict(width=24, height=16, sampling_rate=16.0), **kw)
    jc = japi.RenderConfig(shading=shading, method="shearwarp",
                           **kw).resolved(js)
    tc = api.RenderConfig(shading=shading, method="shearwarp",
                          **kw).resolved(ts)
    if fd is not None:
        jc = dataclasses.replace(jc, sw=dataclasses.replace(jc.sw,
                                                           fd_grad=fd))
        tc = dataclasses.replace(tc, sw=dataclasses.replace(tc.sw,
                                                           fd_grad=fd))
    return jc, tc


# the differentiated inputs, by their place in the scene
WRT = ("grid", "alpha", "color", "value_range", "from_", "light_grid")


def _swap(scene, vals):
    """`scene` with the WRT entries in `vals` replaced."""
    vol, tfn, cam = scene.volume, scene.tfn, scene.camera
    if "grid" in vals:
        vol = dataclasses.replace(vol, grid=vals["grid"])
    tfn = dataclasses.replace(tfn, **{k: vals[k] for k in
                                      ("alpha", "color", "value_range")
                                      if k in vals})
    if "from_" in vals:
        cam = dataclasses.replace(cam, from_=vals["from_"])
    return dataclasses.replace(scene, volume=vol, tfn=tfn, camera=cam)


def _frame_loss(frame):
    return (frame.rgba ** 2).mean() + (frame.grad ** 2).mean()


def jax_grads(js, jc, light_grid, wrt, **kw):
    vals = {"grid": js.volume.grid, "alpha": js.tfn.alpha,
            "color": js.tfn.color, "value_range": js.tfn.value_range,
            "from_": js.camera.from_, "light_grid": light_grid}
    vals = {k: vals[k] for k in wrt}

    def loss(v):
        frame = japi.render(_swap(js, v), jc,
                            light_grid=v.get("light_grid", light_grid), **kw)
        return _frame_loss(frame)

    return {k: np.asarray(g).astype(np.float32)
            for k, g in jax.grad(loss)(vals).items()}


def port_grads(ts, tc, light_grid, wrt, **kw):
    vals = {"grid": ts.volume.grid, "alpha": ts.tfn.alpha,
            "color": ts.tfn.color, "value_range": ts.tfn.value_range,
            "from_": ts.camera.from_, "light_grid": light_grid}
    vals = {k: vals[k].clone().requires_grad_(True) for k in wrt}
    before = swslice.LAUNCHES
    frame = api.render(_swap(ts, vals), tc,
                       light_grid=vals.get("light_grid", light_grid), **kw)
    _frame_loss(frame).backward()
    assert swslice.LAUNCHES == before  # CPU tensors never launch
    return {k: v.grad for k, v in vals.items()}


def light_grids(js, jc, shading):
    if shading != "shadow":
        return None, None
    lg = japi.build_light_grid(js, jc)
    return lg, torch.from_numpy(np.array(lg))


def assert_grads_close(got, want, atol=2e-3):
    got = got.float().numpy()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


_CACHE = {}


def both_grads(cam, shading, kernel, fd=None):
    """(port, JAX) gradients of every WRT entry for one configuration,
    computed once per module run."""
    key = (cam, shading, kernel, fd)
    if key not in _CACHE:
        js, ts = _scenes(cam)
        jc, tc = _configs(js, ts, shading, fd=fd)
        if kernel:
            jc = _forced(jc)
        jlg, tlg = light_grids(js, jc, shading)
        wrt = WRT if shading == "shadow" else WRT[:-1]
        _CACHE[key] = (port_grads(ts, tc, tlg, wrt),
                       jax_grads(js, jc, jlg, wrt))
    return _CACHE[key]


# (camera, shading, FD gradient): principal axis z from the front (persp,
# ortho) and from inside the box (the schedule starts past plane 0), and
# principal axis x from its far side (the grid walked backward)
CASES = [("persp", "none", None), ("persp", "diffuse", None),
         ("persp", "shadow", None), ("ortho", "none", None),
         ("ortho", "diffuse", True), ("x_neg", "shadow", None),
         ("inside", "diffuse", None)]


@pytest.mark.parametrize("kernel", [False, True], ids=["xla", "kernel"])
@pytest.mark.parametrize("cam,shading,fd", CASES,
                         ids=[f"{c}-{s}{'-fd' if f else ''}"
                              for c, s, f in CASES])
def test_grid_and_alpha_grads_match_jax(cam, shading, fd, kernel):
    got, want = both_grads(cam, shading, kernel, fd)
    for k in ("grid", "alpha"):
        assert_grads_close(got[k], want[k])


@pytest.mark.parametrize("cam,shading", [("persp", "none"),
                                         ("persp", "diffuse"),
                                         ("persp", "shadow"),
                                         ("x_neg", "shadow")])
def test_color_range_camera_grads_match_jax(cam, shading):
    got, want = both_grads(cam, shading, False)
    for k in ("color", "value_range", "from_"):
        assert_grads_close(got[k], want[k])


@pytest.mark.parametrize("cam", ["persp", "x_neg"])
def test_light_grid_cotangent_matches_jax(cam):
    got, want = both_grads(cam, "shadow", False)
    assert_grads_close(got["light_grid"], want["light_grid"])


def test_u8_grid_alpha_grad_matches_jax():
    """A u8 grid has no cotangent; the TF's gradient still matches."""
    js, ts = _scenes("persp", dtype="u8")
    jc, tc = _configs(js, ts, "diffuse")
    got = port_grads(ts, tc, None, ("alpha",))
    assert ts.volume.grid.dtype == torch.uint8
    assert ts.volume.grid.grad is None
    assert_grads_close(got["alpha"], jax_grads(js, jc, None,
                                               ("alpha",))["alpha"])


def test_u16_grid_alpha_grad_matches_jax():
    """A u16 grid has no cotangent either; through the shadow lattice
    too, the TF's gradient matches."""
    js, ts = _scenes("persp", dtype="u16")
    jc, tc = _configs(js, ts, "shadow")
    lg = japi.build_light_grid(js, jc)
    got = port_grads(ts, tc, torch.from_numpy(np.array(lg)), ("alpha",))
    assert ts.volume.grid.dtype == torch.uint16
    assert ts.volume.grid.grad is None
    assert_grads_close(got["alpha"], jax_grads(js, jc, lg,
                                               ("alpha",))["alpha"])


def test_bf16_grid_grad_matches_jax():
    """Unshaded: bf16 rounding makes neighbouring voxels equal, and at such
    flat spots the shading normal's gradient is noise (module note)."""
    js, ts = _scenes("persp", dtype="bf16")
    jc, tc = _configs(js, ts, "none")
    got = port_grads(ts, tc, None, ("grid",))["grid"]
    assert got.dtype == torch.bfloat16
    assert_grads_close(got, jax_grads(js, jc, None, ("grid",))["grid"],
                       atol=5e-3)


@pytest.mark.parametrize("shading", ["none", "diffuse"])
def test_termination_leaves_the_gradient_unchanged(shading):
    """Under grad the forward runs without termination: on an opaque
    scene with macrocells, sw_term on gives exactly the sw_term off
    gradient, and both match the gradient without macrocells (atol 2e-5,
    tests/test_swskip.py's bound) and JAX's with its kernel, macrocells
    and termination on."""
    alpha = np.linspace(0.5, 1.0, 16)
    js, ts = _scenes("persp", n=24, alpha=alpha)
    mc = accel.build_macrocells(ts.volume.grid, ts.tfn.alpha,
                                ts.tfn.value_range)
    kw = dict(width=24, height=16, sampling_rate=16.0, base_rate=8.0)
    grads = []
    for term, macro in ((True, mc), (False, mc), (False, None)):
        _, tc = _configs(js, ts, shading, sw_term=term, **kw)
        with torch.no_grad():
            assert float(api.render(ts, tc).rgba[..., 3].max()) > 0.999
        grads.append(port_grads(ts, tc, None, ("grid", "alpha"),
                                macrocells=macro))
    jc, _ = _configs(js, ts, shading, sw_term=True, **kw)
    want = jax_grads(js, _forced(jc), None, ("grid", "alpha"),
                     macrocells=jaccel.build_macrocells(
                         js.volume.grid, js.tfn.alpha, js.tfn.value_range))
    for k in ("grid", "alpha"):
        assert torch.equal(grads[0][k], grads[1][k])
        np.testing.assert_allclose(grads[0][k].numpy(), grads[2][k].numpy(),
                                   atol=2e-5)
        assert_grads_close(grads[0][k], want[k])


@pytest.mark.parametrize("shading", ["none", "diffuse", "shadow"])
def test_skipped_planes_leave_the_gradient(shading):
    """On a mostly empty volume the forward skips most planes per block.
    The adjoint recomputes every plane, as JAX's does, so the gradient is
    the unskipped loop's (skipped planes have zero opacity) and matches
    JAX's with its kernel skipping too, for the TF nodes of zero opacity
    as well: their gradient comes from the samples the forward skipped."""
    alpha = np.concatenate([np.zeros(10), np.linspace(0, 0.9, 22)])
    js, ts = _scenes("persp", n=32, kind="sparse", alpha=alpha)
    jc, tc = _configs(js, ts, shading, width=48, height=40,
                      sampling_rate=32.0)
    jlg, tlg = light_grids(js, jc, shading)
    mc = accel.build_macrocells(ts.volume.grid, ts.tfn.alpha,
                                ts.tfn.value_range)
    skip = port_grads(ts, tc, tlg, ("grid", "alpha"), macrocells=mc)
    full = port_grads(ts, tc, tlg, ("grid", "alpha"))
    want = jax_grads(js, _forced(jc), jlg, ("grid", "alpha"),
                     macrocells=jaccel.build_macrocells(
                         js.volume.grid, js.tfn.alpha, js.tfn.value_range))
    for k in ("grid", "alpha"):
        assert_grads_close(skip[k], full[k].numpy(), atol=1e-6)
        assert_grads_close(skip[k], want[k])


def test_alpha_grad_matches_finite_differences():
    """tests/test_shearwarp.py's check, with node 0 (alpha exactly 0)
    among the nodes."""
    _, ts = _scenes("persp")
    cfg = api.RenderConfig(width=16, height=16, sampling_rate=16.0,
                           shading="none", method="shearwarp").resolved(ts)
    a0 = ts.tfn.alpha.clone()
    assert float(a0[0]) == 0.0

    def loss(alpha):
        tfn = dataclasses.replace(ts.tfn, alpha=alpha)
        frame = api.render(dataclasses.replace(ts, tfn=tfn), cfg)
        return (torch.sum(frame.rgba[..., :3] ** 2)
                + torch.sum(frame.rgba[..., 3]))

    a = a0.clone().requires_grad_(True)
    loss(a).backward()
    g = a.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    eps = 1e-3
    with torch.no_grad():
        for i in (0, 3, 8, 12):
            d = torch.zeros_like(a0)
            d[i] = eps
            fd = float(loss(a0 + d) - loss(a0 - d)) / (2 * eps)
            np.testing.assert_allclose(g[i], fd, rtol=0.05, atol=1e-4)


def test_lattice_built_in_render_carries_a_gradient():
    """A lattice `api.render` builds itself is made of the scene's own
    tensors: the grid's gradient through it adds to the one through the
    slice loop (a lattice built once under no_grad gives only the
    latter)."""
    _, ts = _scenes("persp")
    cfg = api.RenderConfig(width=24, height=16, sampling_rate=16.0,
                           shading="shadow", method="shearwarp").resolved(ts)
    with torch.no_grad():
        fixed = api.build_light_grid(ts, cfg)
    own = port_grads(ts, cfg, None, ("grid",))["grid"]
    once = port_grads(ts, cfg, fixed, ("grid",))["grid"]
    assert float((own - once).abs().max()) > 1e-3 * float(once.abs().max())


def _saved_bytes(rate):
    """Bytes the forward of one differentiated frame keeps for the
    backward."""
    _, ts = _scenes("persp")
    cfg = api.RenderConfig(width=24, height=16, sampling_rate=rate,
                           shading="diffuse",
                           method="shearwarp").resolved(ts)
    grid = ts.volume.grid.clone().requires_grad_(True)
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        frame = api.render(_swap(ts, {"grid": grid}), cfg)
    (frame.rgba ** 2).sum().backward()
    assert torch.isfinite(grid.grad).all()
    return total[0]


def test_backward_memory_is_bounded():
    """16x the planes must not grow what the forward keeps more than ~2x
    (tests/test_shearwarp.py's rule): the adjoint recomputes planes."""
    small, large = _saved_bytes(16.0), _saved_bytes(256.0)
    assert large <= 2 * small + (1 << 20), (small, large)


# ---------------------------------------------------------------------------
# sw_bf16 and light rigs beyond the JAX kernel's slots
# ---------------------------------------------------------------------------

def _grads_with(cam, shading, kernel, wrt, rig=None, n=16, fd=None, **cfg):
    """(port, JAX) gradients of `wrt` for one configuration, the scene
    optionally lit by one of tests/test_torch_render.py's RIGS."""
    from tests.test_torch_render import RIGS
    js, ts = _scenes(cam, n=n)
    if rig is not None:
        js = dataclasses.replace(js, lights=RIGS[rig]())
        ts = scene_from_arrays(arrays_from_scene(js), device="cpu")
    jc, tc = _configs(js, ts, shading, fd=fd, **cfg)
    if kernel:
        jc = _forced(jc)
    jlg, tlg = light_grids(js, jc, shading)
    return port_grads(ts, tc, tlg, wrt), jax_grads(js, jc, jlg, wrt)


# (camera, shading, grid edge, differentiated inputs). JAX's forward is
# its kernel (as on a TPU, where these frames run it); its backward and
# the port's recompute the planes as its XLA loop does. The grid's
# gradient is held unshaded only: shaded, bf16 rounding makes a plane's
# samples flat in places, where the normal's gradient is rounding noise
# times 1e6 in either package (module note; measured in diffuse: 13 of
# 4096 voxels beyond 2e-3 of JAX's largest element, a spike of 8.1e3
# against the port's 95.5, 99th percentile 2.4e-9).
BF16_GRAD_CASES = [
    ("persp", "none", 16, ("grid", "alpha", "color", "value_range")),
    ("persp", "diffuse", 16, ("alpha", "color", "value_range")),
    ("x_neg", "shadow", 16, ("alpha", "light_grid")),
    ("ortho", "diffuse", 32, ("alpha",)),  # an f32 grid read as bf16
]


@pytest.mark.parametrize("cam,shading,n,wrt", BF16_GRAD_CASES,
                         ids=[f"{c}-{s}-{n}" for c, s, n, _ in
                              BF16_GRAD_CASES])
def test_bf16_grads_match_jax(cam, shading, n, wrt):
    """The lattice's cotangent is rounded to bf16 per plane in both (the
    VJP of the rounding), and the two sum a plane's contributions in
    another order before it: where that straddles a rounding tie the two
    round apart by one bf16 ulp, 2^-8 of the value (2 of 4096 elements,
    3.5e-3 of the largest), so it is held at 4e-3."""
    got, want = _grads_with(cam, shading, True, wrt, n=n, sw_bf16=True)
    for k in wrt:
        assert_grads_close(got[k], want[k],
                           atol=4e-3 if k == "light_grid" else 2e-3)


# (camera, shading, rig, FD gradient, differentiated inputs): JAX runs
# these rigs through its XLA loop only
LIGHT_GRAD_CASES = [
    ("persp", "diffuse", "point", None,
     ("grid", "alpha", "color", "value_range")),
    ("x_neg", "shadow", "rig", None, ("grid", "alpha")),
    ("ortho", "diffuse", "six", True, ("grid", "alpha")),
]


@pytest.mark.parametrize("cam,shading,rig,fd,wrt", LIGHT_GRAD_CASES,
                         ids=[f"{c}-{s}-{r}" for c, s, r, _, _ in
                              LIGHT_GRAD_CASES])
def test_light_rig_grads_match_jax(cam, shading, rig, fd, wrt):
    got, want = _grads_with(cam, shading, False, wrt, rig=rig, fd=fd)
    for k in wrt:
        assert_grads_close(got[k], want[k])
