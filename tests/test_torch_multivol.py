"""Multi-volume scenes in the port (ovr_tpu_torch.render.multivol and
shear-warp's per-instance plans) against the JAX package, on the CPU.

A 24^3 volume in [0,1]^3 and a 16^3 instance beside it (placed by its
box, or by an affine `xfm`) with a second transfer function, the same
numpy arrays in both packages. Tolerances: frames rgba and normals
5e-5, depth 2e-4; gradients within 2e-3 of the largest element of
JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu import api as japi
from ovr_tpu.core import scene as jsc
from ovr_tpu_torch import api
from ovr_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from ovr_tpu_torch.ops import swslice
from ovr_tpu_torch.render import multivol


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(n, phase=0.3):
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    return (0.5 + 0.45 * np.sin(6 * x + phase) * np.cos(5 * y + phase)
            * np.sin(4 * z + 1.0)).astype(np.float32)


XFM = np.array([[0.8, -0.3, 0.0, 1.25], [0.3, 0.8, 0.0, -0.1],
                [0.0, 0.0, 0.9, 0.05]], np.float32)
CAMS = {
    "persp": dict(from_=(1.05, 0.5, -2.4), at=(1.05, 0.5, 0.5), fovy=50.0),
    # the instance in front of the primary volume along the view
    "oblique": dict(from_=(2.8, 0.6, -1.6), at=(0.5, 0.5, 0.5), fovy=40.0),
}


def _scenes(xfm=None, cam="persp", lo=(1.1, 0.0, 0.0), hi=(2.1, 1.0, 1.0)):
    vol = jsc.StructuredVolume.create(_field(16, 0.7), world_lo=lo,
                                      world_hi=hi)
    color = np.stack([np.linspace(0.2, 1.0, 16), np.linspace(1.0, 0.3, 16),
                      np.full(16, 0.4)], -1).astype(np.float32)
    tfn = jsc.TransferFunction.create(color, np.linspace(0, 0.8, 16) ** 2,
                                      vol.data_range)
    inst = jsc.VolumeInstance.create(vol, tfn, xfm=xfm)
    js = dataclasses.replace(jsc.simple_scene(_field(24)),
                             camera=jsc.Camera.create(**CAMS[cam]),
                             instances=(inst,))
    return js, scene_from_arrays(arrays_from_scene(js), device="cpu")


def _frames(js, ts, **kw):
    kw = dict(dict(width=48, height=32, sampling_rate=24.0), **kw)
    jc = japi.RenderConfig(**kw).resolved(js)
    tc = api.RenderConfig(**kw).resolved(ts)
    return japi.render(js, jc), api.render(ts, tc), jc, tc


def _close(jf, tf, rgba=5e-5, depth=2e-4):
    np.testing.assert_allclose(tf.rgba.numpy(), np.asarray(jf.rgba),
                               atol=rgba)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf.grad),
                               atol=rgba)
    np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth),
                               atol=depth)
    assert float(tf.rgba[..., 3].max()) > 0.1


@pytest.mark.parametrize("placed,shading,cam", [
    (False, "diffuse", "persp"), (True, "diffuse", "persp"),
    (True, "none", "oblique"), (False, "shadow", "oblique")])
def test_march_instances_matches_jax(placed, shading, cam):
    """The march of each volume (an instance placed by its box or by an
    affine, with its rays, light and camera rows in object space) and
    the depth-ordered composite."""
    js, ts = _scenes(XFM if placed else None, cam=cam)
    jf, tf, _, tc = _frames(js, ts, shading=shading, method="march")
    assert tc.sw is None
    _close(jf, tf)


@pytest.mark.parametrize("shading,cam", [("none", "persp"),
                                         ("diffuse", "persp"),
                                         ("diffuse", "oblique")])
def test_shearwarp_instances_match_jax(shading, cam):
    """A plan per volume (`resolved` gives a tuple), one slice loop per
    volume, the screen partials composited in depth order."""
    js, ts = _scenes(cam=cam)
    before = swslice.LAUNCHES
    jf, tf, jc, tc = _frames(js, ts, shading=shading, method="auto")
    assert swslice.LAUNCHES == before
    assert isinstance(tc.sw, tuple) and len(tc.sw) == 2
    assert isinstance(jc.sw, tuple)
    for a, b in zip(tc.sw, jc.sw):
        assert (a.axis, a.sign, a.n_slices, a.inter_h, a.inter_w) == (
            b.axis, b.sign, b.n_slices, b.inter_h, b.inter_w)
    _close(jf, tf)


@pytest.mark.parametrize("case", ["xfm", "shadow"])
def test_resolved_marches_what_shearwarp_cannot(case):
    """Placed instances and shadows (a lattice per instance) take the
    march under "auto", as in the JAX package, and "shearwarp" refuses."""
    _, ts = _scenes(XFM if case == "xfm" else None)
    shading = "shadow" if case == "shadow" else "diffuse"
    kw = dict(width=16, height=16, sampling_rate=8.0, shading=shading)
    assert api.RenderConfig(method="auto", **kw).resolved(ts).sw is None
    with pytest.raises(ValueError):
        api.RenderConfig(method="shearwarp", **kw).resolved(ts)


def test_depth_order_composites_front_first():
    """Partials reach the composite in order of entry distance, whatever
    order the volumes are listed in: swapping the inputs changes
    nothing, and the front partial's alpha hides the back one's."""
    n = 5
    rng = np.random.default_rng(0)

    def part(t_in, a):
        c = torch.from_numpy(rng.random((n, 3), dtype=np.float32)) * a
        return (c, torch.zeros(n, 3), torch.full((n,), 2.0) * a,
                torch.full((n,), a), torch.full((n,), t_in))

    near, far = part(1.0, 0.75), part(3.0, 0.5)
    a = multivol.depth_composite([near, far])
    b = multivol.depth_composite([far, near])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    np.testing.assert_allclose(a[3].numpy(), 0.75 + 0.25 * 0.5)
    np.testing.assert_allclose(a[0].numpy(),
                               (near[0] + 0.25 * far[0]).numpy())
    # a missed box (entry at inf) goes last
    miss = part(float("inf"), 0.0)
    c = multivol.depth_composite([miss, far, near])
    np.testing.assert_allclose(c[3].numpy(), a[3].numpy())


@pytest.mark.parametrize("method", ["auto", "march"])
def test_multivolume_gradients_match_jax(method):
    """Gradients of both grids and of both TF alphas."""
    js, ts = _scenes()
    kw = dict(width=24, height=16, sampling_rate=16.0, shading="diffuse",
              method=method)
    jc = japi.RenderConfig(**kw).resolved(js)
    tc = api.RenderConfig(**kw).resolved(ts)

    def jloss(g0, a0, g1, a1):
        i = js.instances[0]
        inst = dataclasses.replace(
            i, volume=dataclasses.replace(i.volume, grid=g1),
            tfn=dataclasses.replace(i.tfn, alpha=a1))
        s = dataclasses.replace(
            js, volume=dataclasses.replace(js.volume, grid=g0),
            tfn=dataclasses.replace(js.tfn, alpha=a0), instances=(inst,))
        f = japi.render(s, jc)
        return jnp.mean(f.rgba ** 2) + jnp.mean(f.grad ** 2)

    i = js.instances[0]
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        js.volume.grid, js.tfn.alpha, i.volume.grid, i.tfn.alpha)
    ti = ts.instances[0]
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        ts.volume.grid, ts.tfn.alpha, ti.volume.grid, ti.tfn.alpha)]
    inst = dataclasses.replace(
        ti, volume=dataclasses.replace(ti.volume, grid=leaves[2]),
        tfn=dataclasses.replace(ti.tfn, alpha=leaves[3]))
    s = dataclasses.replace(
        ts, volume=dataclasses.replace(ts.volume, grid=leaves[0]),
        tfn=dataclasses.replace(ts.tfn, alpha=leaves[1]), instances=(inst,))
    f = api.render(s, tc)
    loss = torch.mean(f.rgba ** 2) + torch.mean(f.grad ** 2)
    got = torch.autograd.grad(loss, leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert float(np.abs(w).max()) > 0
        assert float(np.abs(g.numpy() - w).max()) <= 2e-3 * float(
            np.abs(w).max())
