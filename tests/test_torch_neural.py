"""Neural-field volumes in the PyTorch port (ovr_tpu_torch.neural) against
the JAX package (ovr_tpu.neural) on the CPU.

The same field (JAX's `init_field` from a PRNG key, its tables scaled so
that the field varies over the volume) crosses over through
`convert.arrays_from_scene`. Sizes follow tests/test_neural.py: its small
hash grid (4 levels, 2^12 entries, resolutions 4-32), proxies of 8^3 to
48^3, frames of at most 32x24. Tolerances: hash indices exact; encode
1e-6 and the f32 field 1e-5; the bf16 field 1e-5 but for bf16 rounding
ties (counted and bounded); bakes 1e-6; `fit_to_grid` under JAX's
replayed draws loss by loss at rtol 1e-4; frames (proxy and exact march)
rgba 5e-5, depth 2e-4; gradients within 2e-3 of JAX's largest element;
`march_adjoint` as tests/test_adjoint.py holds it. The slice loop here
is its plain version: the tests assert that no kernel launched.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu import api as japi
from ovr_tpu.core.scene import Camera as JCamera
from ovr_tpu.core.scene import GeometryInstance as JGeometry
from ovr_tpu.core.scene import Isosurface as JIso
from ovr_tpu.core.scene import Scene as JScene
from ovr_tpu.core.scene import StructuredVolume as JVolume
from ovr_tpu.core.scene import TransferFunction as JTfn
from ovr_tpu.neural import field as jfield
from ovr_tpu.neural import hashgrid as jhash
from ovr_tpu.neural import losses as jlosses
from ovr_tpu.neural import train as jtrain
from ovr_tpu.ops import adjoint as jadjoint
from ovr_tpu.render import integrator as jig
from ovr_tpu.render.camera import generate_rays as jrays
from ovr_tpu.render.camera import pixel_screen_coords as jscreen
from ovr_tpu_torch import api, neural
from ovr_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from ovr_tpu_torch.neural import hashgrid, losses, train
from ovr_tpu_torch.ops import adjoint, swslice
from ovr_tpu_torch.render import integrator as ig
from ovr_tpu_torch.render import pathtracer
from tests.test_torch_march_api import assert_frames_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine,
    and a torch thread pool per worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_launch():
    n0 = swslice.LAUNCHES
    yield
    assert swslice.LAUNCHES == n0, "a CPU test launched the slice kernel"


CFG = jhash.HashGridConfig(n_levels=4, log2_table_size=12,
                           base_resolution=4, max_resolution=32)
TCFG = hashgrid.HashGridConfig(n_levels=4, log2_table_size=12,
                               base_resolution=4, max_resolution=32)
CAM = dict(from_=(0.5, 0.5, -1.8), at=(0.5, 0.5, 0.5), fovy=45.0)


def jax_field(seed=7, hidden=16, n_hidden=1, scale=1e4,
              compute_dtype=jnp.float32):
    """JAX's `init_field` with its tables scaled by `scale` (the ngp init
    of +-1e-4 gives a field constant to ~1e-4, whose shading normals are
    rounding noise)."""
    f = jfield.init_field(jax.random.PRNGKey(seed), CFG, hidden=hidden,
                          n_hidden=n_hidden, compute_dtype=compute_dtype)
    return dataclasses.replace(f, tables=f.tables * scale)


def jax_scene(field, rate=12.0):
    """tests/test_neural.py's neural scene."""
    tfn = JTfn.create(np.stack([np.linspace(0, 1, 8)] * 3, -1),
                      np.linspace(0, 0.8, 8), (0.0, 1.0))
    return JScene.create(field, tfn, camera=JCamera.create(**CAM),
                         volume_sampling_rate=rate)


def port(js):
    return scene_from_arrays(arrays_from_scene(js), device="cpu")


def port_field(jf):
    return port(jax_scene(jf)).volume


def points(n, seed=1, lo=0.0, hi=1.0):
    p = np.random.default_rng(seed).uniform(lo, hi, (n, 3))
    return p.astype(np.float32)


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# ---------------------------------------------------------------------------
# the encoding and the field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log2,res", [(12, 32), (17, 512), (19, 2048)])
def test_hash_indices_match_jax_exactly(log2, res):
    """int64 products masked to the table size give JAX's uint32
    wraparound modulo the table size."""
    rng = np.random.default_rng(log2)
    i0 = rng.integers(0, res, (4096, 3)).astype(np.int64)
    i0[:3] = [[0, 0, 0], [res - 1] * 3, [res - 1, 0, res - 1]]
    cfg = hashgrid.HashGridConfig(log2_table_size=log2, max_resolution=res)
    got = hashgrid.hash_corners(torch.from_numpy(i0), cfg).numpy()
    u = jnp.asarray(i0, jnp.uint32)
    for c in range(8):
        d = [(c >> a) & 1 for a in range(3)]
        want = jhash._hash_corner(u[:, 0] + d[0], u[:, 1] + d[1],
                                  u[:, 2] + d[2], cfg.table_size)
        np.testing.assert_array_equal(got[:, c], np.asarray(want))


@pytest.mark.parametrize("cfg_kw", [
    {}, dict(n_levels=12, log2_table_size=17, base_resolution=16,
             max_resolution=512)])
def test_encode_matches_jax(cfg_kw):
    """Points inside, on and outside the unit cube (the clip), including
    the upper face, where the corner cast keeps f = 1."""
    jc = jhash.HashGridConfig(**dict(dataclasses.asdict(CFG), **cfg_kw))
    tc = hashgrid.HashGridConfig(**dataclasses.asdict(jc))
    tables = np.random.default_rng(0).uniform(
        -1, 1, (jc.n_levels, jc.table_size, jc.features_per_level)
    ).astype(np.float32)
    p = points(2000, lo=-0.1, hi=1.1)
    p[:4] = [[0, 0, 0], [1, 1, 1], [1, 0.5, 0], [0.25, 0.5, 0.75]]
    want = jhash.encode(jnp.asarray(tables), jc, jnp.asarray(p))
    got = hashgrid.encode(torch.from_numpy(tables), tc, torch.from_numpy(p))
    assert got.shape == (2000, jc.out_dim)
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("hidden,n_hidden", [(16, 1), (64, 2)])
def test_field_sample_f32_matches_jax(hidden, n_hidden):
    jf = jax_field(hidden=hidden, n_hidden=n_hidden)
    tf = port_field(jf)
    assert isinstance(tf, neural.NeuralFieldVolume)
    p = points(3000)
    want = np.asarray(jfield.field_sample(jf, jnp.asarray(p)))
    got = np_(neural.field_sample(tf, torch.from_numpy(p)))
    assert want.std() > 0.05  # the field varies
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_field_sample_bf16_matches_jax():
    """bf16 operands, f32 sums: within 1e-5 but where the two sums round
    a hidden activation to different sides of a bf16 tie (a whole bf16
    ulp then reaches the output); those are rare and bounded."""
    jf = jax_field(hidden=64, n_hidden=2, compute_dtype=jnp.bfloat16)
    tf = port_field(jf)
    assert tf.compute_dtype == torch.bfloat16
    p = points(4000, seed=3)
    want = np.asarray(jfield.field_sample(jf, jnp.asarray(p)))
    got = np_(neural.field_sample(tf, torch.from_numpy(p)))
    err = np.abs(got - want)
    f32 = np_(neural.field_sample(port_field(dataclasses.replace(
        jf, compute_dtype=jnp.float32)), torch.from_numpy(p)))
    assert np.abs(got - f32).max() > 1e-4  # bf16 rounding is in effect
    assert (err > 1e-5).mean() <= 0.01, (err > 1e-5).mean()
    assert err.max() <= 2e-2, err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_field_gradients_match_jax(dtype):
    """Gradients of sum(field^2) to the tables (a scatter-add) and the
    weights."""
    jf = jax_field(hidden=16, n_hidden=2,
                   compute_dtype=getattr(jnp, dtype))
    tf = port_field(jf)
    p = points(500, seed=4)

    def jloss(tables, weights):
        f = dataclasses.replace(jf, tables=tables, weights=weights)
        return jnp.sum(jfield.field_sample(f, jnp.asarray(p)) ** 2)

    gt, gw = jax.grad(jloss, argnums=(0, 1))(jf.tables, jf.weights)
    (neural.field_sample(tf, torch.from_numpy(p)) ** 2).sum().backward()
    tol = 2e-3 if dtype == "bfloat16" else 1e-5
    pairs = [(tf.tables.grad, gt)] + [
        (tw.grad, jw) for (tw, tb), (jw, jb) in zip(
            tf.weights, gw) for tw, jw in ((tw, jw), (tb, jb))]
    for got, want in pairs:
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(np_(got) / scale,
                                   np.asarray(want) / scale, atol=tol)


def test_init_field_shapes_and_ranges():
    f = neural.init_field(0, TCFG, hidden=16, n_hidden=2, device="cpu")
    assert f.tables.shape == (4, 4096, 2)
    assert float(f.tables.detach().abs().max()) <= 1e-4
    assert [tuple(w.shape) for w, _ in f.weights] == [(8, 16), (16, 16),
                                                      (16, 1)]
    assert all(float(b.detach().abs().max()) == 0 for _, b in f.weights)
    assert {n for n, _ in f.named_buffers()} == {"world_lo", "world_hi",
                                                 "data_range"}
    g = neural.init_field(torch.Generator().manual_seed(0), TCFG, hidden=16,
                          n_hidden=2, device="cpu")
    assert torch.equal(f.tables, g.tables)


# ---------------------------------------------------------------------------
# losses, bakes, fitting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["l1", "l2", "relative_l2"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(5)
    a, b = rng.random(100, np.float32), rng.random(100, np.float32)
    want = float(jlosses.LOSSES[name](jnp.asarray(a), jnp.asarray(b)))
    got = float(losses.LOSSES[name](torch.from_numpy(a),
                                    torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# the ngp-initialised field (values within ~1e-4 of 0.5) and one of O(1)
# features, whose larger sums carry the f32 field's 1e-5
BAKE_FIELDS = [(1.0, 1e-6), (1e4, 1e-5)]


@pytest.mark.parametrize("scale,tol", BAKE_FIELDS)
@pytest.mark.parametrize("dims,chunk", [((8, 8, 8), 64),
                                        ((16, 12, 8), 100)])
def test_bake_grid_matches_jax(dims, chunk, scale, tol):
    jf = jax_field(seed=5, scale=scale)
    tf = port_field(jf)
    want = np.asarray(jtrain.bake_grid(jf, dims, chunk=chunk))
    got = train.bake_grid(tf, dims, chunk=chunk)
    assert got.shape == (dims[2], dims[1], dims[0])
    np.testing.assert_allclose(np_(got), want, atol=tol)


@pytest.mark.parametrize("scale,tol", BAKE_FIELDS)
@pytest.mark.parametrize("slab", [8 * 12 * 5, 8 * 12 * 16, 8 * 12 * 40])
def test_bake_grid_host_matches_jax_and_traced(slab, scale, tol):
    """Slabs of 5 planes (the last padded with clipped planes), one
    slab, and one slab padded to 40 planes."""
    jf = jax_field(seed=5, scale=scale)
    tf = port_field(jf)
    want = np.asarray(jtrain.bake_grid_host(jf, (8, 12, 16),
                                            max_slab_points=slab))
    got = train.bake_grid_host(tf, (8, 12, 16), max_slab_points=slab)
    assert not got.requires_grad
    np.testing.assert_allclose(np_(got), want, atol=tol)
    np.testing.assert_allclose(np_(got), np_(train.bake_grid(
        tf, (8, 12, 16))), atol=1e-6)


class _Replay(pathtracer.Draws):
    """`jax.random.uniform(keys[k], (batch, 3))` of JAX's `fit_to_grid`
    (keys = split(PRNGKey(0), steps)) at `fold_in(k)`."""

    def __init__(self, steps, batch, pts=None):
        if pts is None:
            pts = [np.asarray(jax.random.uniform(k, (batch, 3)))
                   for k in jax.random.split(jax.random.PRNGKey(0), steps)]
        self.pts = pts

    def fold_in(self, i):
        return _Replay(0, 0, self.pts[i])

    def uniform(self, shape, dtype=torch.float32, device=None):
        assert tuple(shape) == self.pts.shape
        return torch.from_numpy(np.array(self.pts)).to(dtype)


@pytest.mark.parametrize("loss", ["l2", "relative_l2"])
def test_fit_to_grid_matches_jax_loss_by_loss(small_grid, loss):
    """20 Adam steps at the default rate on JAX's own batches: the port's
    optimiser (torch's Adam, optax's defaults) gives JAX's losses step by
    step. Adam turns rounding-level differences of the gradients into
    differences of whole steps, so the gap grows with the step count
    (about 1e-7 after one step, up to ~5e-5 after 20)."""
    jf = jax_field(seed=0, hidden=32, n_hidden=2, scale=1.0)
    tf = port_field(jf)
    _, jl = jtrain.fit_to_grid(jf, jnp.asarray(small_grid), steps=20,
                               batch=1024, loss=loss)
    out, tl = train.fit_to_grid(tf, torch.from_numpy(small_grid), steps=20,
                                batch=1024, loss=loss,
                                draws=_Replay(20, 1024))
    assert out is tf
    np.testing.assert_allclose(np_(tl), np.asarray(jl), rtol=1e-4)
    assert float(tl[-1]) < 0.5 * float(tl[0])


def test_fit_to_grid_default_draws_fit(small_grid):
    """tests/test_neural.py's fitting check with the port's own draws."""
    tf = neural.init_field(0, TCFG, hidden=32, n_hidden=2, device="cpu")
    grid = torch.from_numpy(small_grid)
    _, tl = train.fit_to_grid(tf, grid, steps=60, batch=4096, lr=5e-3)
    assert float(tl[-1]) < 0.5 * float(tl[0])
    p = torch.rand((512, 3), generator=torch.Generator().manual_seed(2))
    from ovr_tpu_torch.core.sampling import sample_volume
    with torch.no_grad():
        err = (neural.field_sample(tf, p) - sample_volume(grid, p)).abs()
    assert float(err.mean()) < 0.15


# ---------------------------------------------------------------------------
# frames: the baked proxy through shear-warp, the exact march
# ---------------------------------------------------------------------------

FRAME = dict(width=32, height=24, sampling_rate=24.0)


def both_frames(js, ts, method, shading, **kw):
    kw = dict(FRAME, method=method, shading=shading, **kw)
    jc = japi.RenderConfig(**kw).resolved(js)
    tc = api.RenderConfig(**kw).resolved(ts)
    assert (jc.sw is None) == (tc.sw is None)
    with torch.no_grad():
        tf = api.render(ts, tc)
    return tf, japi.render(js, jc), tc


@pytest.mark.parametrize("shading", ["none", "diffuse", "shadow"])
def test_proxy_frame_matches_jax(shading):
    """method="auto" plans shear-warp over a 24^3 proxy shim and bakes
    the proxy inside `render` (the shadow lattice from the proxy)."""
    js = jax_scene(jax_field())
    ts = port(js)
    tf, jf, tc = both_frames(js, ts, "auto", shading, neural_proxy_res=24)
    assert tc.sw is not None
    assert_frames_close(tf, jf)


@pytest.mark.parametrize("shading", ["none", "diffuse", "shadow", "ssh"])
def test_field_march_matches_jax(shading):
    """The exact march samples the field at every step (with shading,
    the three forward differences one finest-level cell away); shadows
    from a 16^3 lattice of the field's shadow march."""
    js = jax_scene(jax_field())
    ts = port(js)
    tf, jf, tc = both_frames(js, ts, "march", shading, shadow_grid_res=16)
    assert tc.sw is None
    assert_frames_close(tf, jf)


def test_no_proxy_and_ineligible_views_march():
    """neural_proxy=False, and an eye inside the box, march the field."""
    js = jax_scene(jax_field())
    ts = port(js)
    tf, jf, tc = both_frames(js, ts, "auto", "diffuse", neural_proxy=False)
    assert tc.sw is None
    assert_frames_close(tf, jf)
    inside = dict(from_=(0.5, 0.5, 0.5), at=(0.9, 0.75, 0.5), fovy=130.0)
    js = dataclasses.replace(js, camera=JCamera.create(**inside))
    tf, jf, tc = both_frames(js, port(js), "auto", "none")
    assert tc.sw is None
    assert_frames_close(tf, jf, in_view=False)


def test_proxy_frame_approximates_the_march():
    """tests/test_neural.py's rule: the 48^3 proxy frame is within 0.05
    mean |rgba| of the exact march."""
    ts = port(jax_scene(jax_field(scale=1.0)))
    cfg = dict(FRAME, shading="none")
    with torch.no_grad():
        fast = api.render(ts, api.RenderConfig(
            method="auto", neural_proxy_res=48, **cfg).resolved(ts))
        ref = api.render(ts, api.RenderConfig(method="march",
                                              **cfg).resolved(ts))
    assert float((fast.rgba - ref.rgba).abs().mean()) < 0.05


def test_renderer_bakes_once_and_matches_jax():
    """`Renderer` caches a `bake_grid_host` proxy, a lattice from the
    field (8^3) and, with macrocells, a 32^3 bake's majorants; its
    frames match JAX's Renderer."""
    js = jax_scene(jax_field())
    ts = port(js)
    kw = dict(FRAME, method="auto", shading="shadow", neural_proxy_res=16,
              use_macrocells=True, shadow_grid_res=8)
    jr = japi.Renderer(js, japi.RenderConfig(**kw))
    tr = api.Renderer(ts, api.RenderConfig(**kw))
    jr.render()
    tr.render()
    assert tr._proxy_grid.shape == (16, 16, 16)
    assert tr._macrocells.vol_dims == (32, 32, 32)
    proxy = tr._proxy_grid
    tr.render()
    assert tr._proxy_grid is proxy
    np.testing.assert_allclose(np_(tr._proxy_grid),
                               np.asarray(jr._proxy_grid), atol=1e-6)
    for k, v in tr.mapframe().items():
        np.testing.assert_allclose(v, jr.mapframe()[k],
                                   atol=2e-4 if k == "depth" else 5e-5)


def test_sparse_frames_of_a_field_match_jax():
    """`Renderer`'s foveated sparse frames march the field: two frames,
    the second scattered into the first, against JAX's Renderer."""
    js = jax_scene(jax_field())
    ts = port(js)
    kw = dict(FRAME, shading="diffuse", fast_math=True, method="march")
    jr = japi.Renderer(js, japi.RenderConfig(**kw))
    tr = api.Renderer(ts, api.RenderConfig(**kw))
    for r in (jr, tr):
        r.set_sparse_sampling(True)
        r.set_focus((0.5, 0.5), 0.2, 0.1)
    for _ in range(2):
        jr.render()
        tr.render()
        got, want = tr.mapframe(), jr.mapframe()
        for k in ("rgba", "grad", "depth"):
            np.testing.assert_allclose(got[k], want[k],
                                       atol=2e-4 if k == "depth" else 5e-5)
    assert (got["rgba"][..., 3] > 0).mean() > 0.05


def test_isosurface_of_a_field_matches_jax():
    """An isosurface intersected on the field itself (march) and on the
    proxy (auto)."""
    js = jax_scene(jax_field())
    js = dataclasses.replace(js, geometries=(
        JGeometry.create(JIso.create([0.5])),))
    ts = port(js)
    for method in ("march", "auto"):
        tf, jf, _ = both_frames(js, ts, method, "diffuse",
                                neural_proxy_res=24, iso_steps=32)
        assert_frames_close(tf, jf)


def test_field_beside_a_dense_instance_matches_jax():
    """A field primary volume with a dense instance marches both."""
    from ovr_tpu.core.scene import VolumeInstance as JInstance
    g = np.random.default_rng(0).random((8, 8, 8)).astype(np.float32)
    js = jax_scene(jax_field())
    js = dataclasses.replace(js, instances=(
        JInstance.create(JVolume.create(g, world_lo=(0.2, 0.2, 0.2),
                                        world_hi=(0.7, 0.7, 0.7)), js.tfn),))
    ts = port(js)
    tf, jf, tc = both_frames(js, ts, "auto", "diffuse")
    assert tc.sw is None
    assert_frames_close(tf, jf)


def test_dense_path_tracer_on_a_field_matches_jax():
    """pt_dense over a field: the scatter lattices sampled from the
    field (128^3 cut to pt_lattice), gathered through the proxy's plan."""
    js = jax_scene(jax_field())
    ts = port(js)
    tf, jf, tc = both_frames(js, ts, "auto", "none", path_tracing=True,
                             pt_dense=True, pt_lattice=16, max_scatters=4,
                             pt_dirs=6, neural_proxy_res=16)
    assert tc.sw is not None
    np.testing.assert_allclose(np_(tf.rgba), np.asarray(jf.rgba), atol=1e-4)


def test_mc_path_tracer_on_a_field_matches_jax():
    """The delta tracker samples the field; JAX's draws replayed."""
    from tests.test_torch_pathtracer import JaxDraws
    js = jax_scene(jax_field())
    ts = port(js)
    kw = dict(width=8, height=6, sampling_rate=12.0, path_tracing=True,
              max_scatters=4)
    jc = japi.RenderConfig(**kw).resolved(js)
    tc = api.RenderConfig(**kw).resolved(ts)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    want = japi.render(js, jc)
    got = pathtracer.render_frame(ts, tc, ts.camera, JaxDraws(key))
    np.testing.assert_allclose(np_(got.rgba), np.asarray(want.rgba),
                               atol=1e-4)


def test_swept_builder_falls_back_to_the_shadow_march():
    """A field has no planes to sweep: `build_light_grid_swept` gives the
    shadow march at step 0.01, as JAX's does."""
    from ovr_tpu.render import lightgrid as jlg
    from ovr_tpu_torch.render import lightgrid
    js = jax_scene(jax_field())
    ts = port(js)
    jleaves = (js.volume, js.tfn.color, js.tfn.alpha, js.tfn.value_range,
               jnp.ones(()))
    mcfg = dict(max_steps=1, shadow_max_steps=12)
    want = jlg.build_light_grid_swept(
        jleaves, jnp.asarray([0.3, 0.8, -0.4]), js.volume.world_lo,
        js.volume.world_hi, jig.MarchConfig(**mcfg), (8, 8, 8))
    tleaves = (ts.volume, ts.tfn.color, ts.tfn.alpha, ts.tfn.value_range,
               torch.ones(()))
    with torch.no_grad():
        got = lightgrid.build_light_grid_swept(
            tleaves, torch.tensor([0.3, 0.8, -0.4]), ts.volume.world_lo,
            ts.volume.world_hi, (8, 8, 8), ig.MarchConfig(**mcfg))
    np.testing.assert_allclose(np_(got), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# gradients: the inverse-rendering step, the FD check, march_adjoint
# ---------------------------------------------------------------------------

def _close_grads(got, want, tol=2e-3):
    scale = float(np.abs(np.asarray(want)).max())
    assert scale > 0
    np.testing.assert_allclose(np_(got) / scale, np.asarray(want) / scale,
                               atol=tol)


def test_image_train_step_matches_jax(small_grid):
    """The train step's loss, and the gradients of the tables and
    weights it applies (through the slice loop's adjoint and the
    differentiable 16^3 bake), against jax.grad of JAX's objective;
    then two more steps' losses against JAX's train step."""
    js = jax_scene(jax_field(seed=9))
    ts = port(js)
    kw = dict(width=16, height=12, sampling_rate=12.0, shading="none",
              method="auto", neural_proxy_res=16)
    jc = japi.RenderConfig(**kw).resolved(js)
    tc = api.RenderConfig(**kw).resolved(ts)
    target = np.asarray(japi.render(dataclasses.replace(
        js, volume=JVolume.create(small_grid)), jc).rgba)
    jfld = js.volume

    def jobj(params):
        f = dataclasses.replace(jfld, tables=params[0], weights=params[1])
        frame = japi.render(dataclasses.replace(js, volume=f), jc)
        return jnp.mean((frame.rgba - target) ** 2)

    jloss, (gt, gw) = jax.value_and_grad(jobj)((jfld.tables, jfld.weights))
    step, state = train.make_image_train_step(ts, tc, lr=1e-2)
    state, loss = step(state, ts.camera, torch.from_numpy(target))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    tfld = ts.volume
    _close_grads(tfld.tables.grad, gt)
    for (tw, tb), (jw, jb) in zip(tfld.weights, gw):
        _close_grads(tw.grad, jw)
        _close_grads(tb.grad, jb)
    jstep, jstate = jtrain.make_image_train_step(js, jc, lr=1e-2)
    jl = []
    for _ in range(3):
        jstate, v = jstep(jstate, js.camera, jnp.asarray(target))
        jl.append(float(v))
    tl = [float(loss)]
    for _ in range(2):
        state, loss = step(state, ts.camera, torch.from_numpy(target))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


def test_proxy_gradients_match_finite_differences():
    """tests/test_neural.py's directional secant check, on the port: the
    tables' gradient through render -> proxy -> field."""
    jf = jfield.init_field(jax.random.PRNGKey(8), CFG, hidden=8, n_hidden=1)
    ts = port(jax_scene(jf, rate=8.0))
    cfg = api.RenderConfig(width=8, height=8, sampling_rate=8.0,
                           shading="none", method="auto",
                           neural_proxy_res=16).resolved(ts)
    assert cfg.sw is not None
    field = ts.volume
    (api.render(ts, cfg).rgba ** 2).mean().backward()
    gn = field.tables.grad.numpy()
    assert np.isfinite(gn).all() and np.abs(gn).max() > 0
    thresh = np.quantile(np.abs(gn), 0.999)
    v = torch.from_numpy(np.where(np.abs(gn) >= thresh, np.sign(gn),
                                  0.0).astype(np.float32))
    t0 = field.tables.detach().clone()
    eps = 1e-4

    def loss_at(t):
        with torch.no_grad():
            field.tables.copy_(t)
            return float((api.render(ts, cfg).rgba ** 2).mean())

    fd = (loss_at(t0 + eps * v) - loss_at(t0 - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float((gn * v.numpy()).sum()), fd, rtol=0.08,
                               atol=1e-7)


def _adjoint_setup(volume_j, n_rays, rate=24.0):
    """tests/test_adjoint.py's setup (16x16 rays from a perspective eye,
    shading 'none', rate 24), with `n_rays` rays that hit the volume."""
    cam = JCamera.create(**CAM)
    cfg = japi.RenderConfig(width=16, height=16, sampling_rate=rate,
                            shading="none")
    tfn = JTfn.create(np.stack([np.linspace(0, 1, 8)] * 3, -1),
                      np.linspace(0, 0.8, 8), (0.0, 1.0))
    js = JScene.create(volume_j, tfn, camera=cam)
    cfg = cfg.resolved(js)
    # rays from the middle rows (the first row misses the box)
    screen = jscreen(16, 16).reshape(-1, 2)[120:120 + n_rays]
    org, d = jrays(cam, screen, 16, 16)
    ts = port(js)
    return js, ts, cfg, org, d


@pytest.mark.parametrize("kind", ["grid", "field"])
def test_march_adjoint_matches_jax(kind, small_grid):
    """The port's `march_adjoint` against JAX's: the forward (rtol 1e-4,
    atol 1e-5) and the gradients of sum(c^2) + sum(a) to the volume
    (the grid, or the field's tables and weights), the TF alpha and the
    ray origins (2e-3 of the largest element)."""
    vol = JVolume.create(small_grid) if kind == "grid" else jax_field()
    js, ts, cfg, org, d = _adjoint_setup(vol, 17)
    jrepr = js.volume.grid if kind == "grid" else js.volume
    jleaves = (jrepr, js.tfn.color, js.tfn.alpha, js.tfn.value_range,
               jnp.ones(()))
    jctx = jig.ShadeContext(light_dir=jnp.array([0.0, 1.0, 0.0]),
                            wtc=jnp.eye(3), world_lo=js.volume.world_lo,
                            world_hi=js.volume.world_hi)
    step = jnp.asarray(1.0 / 24.0)

    def jloss(repr_, alpha, org_):
        lv = (repr_, jleaves[1], alpha, jleaves[3], jleaves[4])
        c, _, dep, a = jadjoint.march_adjoint(org_, d, lv, jctx, cfg, step)
        return jnp.sum(c ** 2) + jnp.sum(a), (c, dep, a)

    (_, (jc, jdep, ja)), grads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jrepr, js.tfn.alpha, org)
    trepr = ts.volume.grid if kind == "grid" else ts.volume
    if kind == "grid":
        trepr = trepr.clone().requires_grad_(True)
    alpha = ts.tfn.alpha.clone().requires_grad_(True)
    torg = torch.from_numpy(np.array(org)).requires_grad_(True)
    tctx = ig.ShadeContext(light_dir=torch.tensor([0.0, 1.0, 0.0]),
                           wtc=torch.eye(3), world_lo=ts.volume.world_lo,
                           world_hi=ts.volume.world_hi)
    tleaves = (trepr, ts.tfn.color, alpha, ts.tfn.value_range,
               torch.ones(()))
    c, g, dep, a = adjoint.march_adjoint(
        torg, torch.from_numpy(np.array(d)), tleaves, tctx, cfg,
        torch.tensor(1.0 / 24.0))
    assert float(g.abs().max()) == 0.0
    for got, want in ((c, jc), (dep, jdep), (a, ja)):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    ((c ** 2).sum() + a.sum()).backward()
    if kind == "grid":
        _close_grads(trepr.grad, grads[0])
    else:
        _close_grads(trepr.tables.grad, grads[0].tables)
        for (tw, tb), (jw, jb) in zip(trepr.weights, grads[0].weights):
            _close_grads(tw.grad, jw)
    _close_grads(alpha.grad, grads[1])
    _close_grads(torg.grad, grads[2])


def test_march_adjoint_matches_the_march():
    """Its forward equals the port's own march (shading 'none')."""
    js, ts, cfg, org, d = _adjoint_setup(jax_field(), 33)
    torg, td = torch.from_numpy(np.array(org)), torch.from_numpy(np.array(d))
    leaves = (ts.volume, ts.tfn.color, ts.tfn.alpha, ts.tfn.value_range,
              torch.ones(()))
    ctx = ig.ShadeContext(light_dir=torch.tensor([0.0, 1.0, 0.0]),
                          wtc=torch.eye(3), world_lo=ts.volume.world_lo,
                          world_hi=ts.volume.world_hi)
    step = torch.tensor(1.0 / 24.0)
    with torch.no_grad():
        ref = ig.march(torg, td, leaves, ctx, ig.MarchConfig(
            max_steps=cfg.max_steps, shading="none"), step)
        got = adjoint.march_adjoint(torg, td, leaves, ctx, cfg, step)
    for x, y in zip(got, ref):
        np.testing.assert_allclose(np_(x), np_(y), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# carrying a field across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_a_field_both_ways(dtype):
    jf = jax_field(hidden=16, n_hidden=2, compute_dtype=getattr(jnp, dtype))
    js = jax_scene(jf)
    arrays = arrays_from_scene(js)
    ts = scene_from_arrays(arrays, device="cpu")
    tf = ts.volume
    assert tf.grid_cfg == TCFG
    assert tf.compute_dtype == getattr(torch, dtype)
    assert ts.device == torch.device("cpu")
    back = arrays_from_scene(ts)
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    assert np.array_equal(tf.tables.detach().numpy(), np.asarray(jf.tables))
    # and into a JAX field again
    jf2 = jfield.NeuralFieldVolume(
        tables=jnp.asarray(back["volume.tables"]),
        weights=tuple((jnp.asarray(back[f"volume.weights.{i}.w"]),
                       jnp.asarray(back[f"volume.weights.{i}.b"]))
                      for i in range(3)),
        world_lo=jnp.asarray(back["volume.world_lo"]),
        world_hi=jnp.asarray(back["volume.world_hi"]),
        data_range=jnp.asarray(back["volume.data_range"]),
        grid_cfg=jhash.HashGridConfig(**{
            f: int(back[f"volume.grid_cfg.{f}"])
            for f in dataclasses.asdict(CFG)}),
        compute_dtype=getattr(jnp, str(back["volume.compute_dtype"])))
    p = jnp.asarray(points(64))
    np.testing.assert_array_equal(np.asarray(jfield.field_sample(jf2, p)),
                                  np.asarray(jfield.field_sample(jf, p)))
