"""Foveated sparse sampling and image ops in the port
(ovr_tpu_torch.render.{bluenoise,sparse,imageops} and the Renderer's
sparse frames) against the JAX package, on the CPU.

Tolerances: the blue-noise matrix exact (both are numpy), the keep
probability 1e-6, the selected indices exact (the 128^2 tile repeats
across the frames here, so scores tie, and the port breaks ties by the
lower index as `jax.lax.top_k` does), frames rgba 5e-5, image ops 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovr_tpu import api as japi
from ovr_tpu.core import scene as jsc
from ovr_tpu.render import bluenoise as jbn
from ovr_tpu.render import imageops as jops
from ovr_tpu.render import sparse as jsp
from ovr_tpu_torch import api
from ovr_tpu_torch.convert import arrays_from_scene, scene_from_arrays
from ovr_tpu_torch.render import bluenoise as tbn
from ovr_tpu_torch.render import imageops as tops
from ovr_tpu_torch.render import sparse as tsp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,seed", [(16, 0), (24, 3)])
def test_void_and_cluster_equals_jax(n, seed):
    np.testing.assert_array_equal(
        tbn.void_and_cluster(n, seed=seed, cache=False),
        jbn.void_and_cluster(n, seed=seed, cache=False))


@pytest.mark.parametrize("n", [64, 128])
def test_stbn_offsets_equal_jax(n):
    """A frame's toroidal shift, host integers, for frames 0-255."""
    got = [tbn.stbn_offsets(f, n) for f in range(256)]
    assert got == [jbn.stbn_offsets(f, n) for f in range(256)]
    assert all(type(v) is int and 0 <= v < n for xy in got for v in xy)
    assert len(set(got)) > 200  # the walk moves from frame to frame


def test_bluenoise_caches_in_its_own_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    a = tbn.void_and_cluster(8, seed=1)
    path = tmp_path / ".cache" / "ovr_tpu_torch" / "bluenoise_8_1.npy"
    assert path.exists()
    np.testing.assert_array_equal(np.load(path), a)


FOCI = [((0.5, 0.5), 0.2, 0.1), ((0.3, 0.7), 0.05, 0.02)]


@pytest.mark.parametrize("focus", FOCI)
def test_keep_probability_matches_jax(focus):
    want = jsp.keep_probability(200, 150, jsp.FocusParams.create(*focus))
    got = tsp.keep_probability(200, 150, tsp.FocusParams.create(
        *focus, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("frame", [0, 1, 37])
def test_stbn_noise_matches_jax(frame):
    want = jsp.sample_noise(None, 300, 140, frame, "stbn")
    got = tsp.sample_noise(None, 300, 140, frame, "stbn", device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("focus", FOCI)
@pytest.mark.parametrize("frame", [1, 2])
def test_select_samples_matches_jax(focus, frame):
    """Frames wider and taller than the 128^2 tile: repeated noise, and a
    keep probability symmetric about a centred focus, tie scores."""
    w, h = 320, 200
    budget = w * h // 8
    want = np.asarray(jsp.select_samples(
        None, w, h, jsp.FocusParams.create(*focus), frame, budget))
    got = tsp.select_samples(None, w, h, tsp.FocusParams.create(
        *focus, device="cpu"), frame, budget)
    score = (tsp.sample_noise(None, w, h, frame, "stbn", device="cpu")
             / tsp.keep_probability(w, h, tsp.FocusParams.create(
                 *focus, device="cpu"))).reshape(-1)
    assert len(set(score[got].tolist())) < budget  # ties among the chosen
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_noise_draws_from_the_generator():
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a = tsp.sample_noise(g1, 40, 30, 0, "uniform", device="cpu")
    b = tsp.sample_noise(g2, 40, 30, 0, "uniform", device="cpu")
    assert torch.equal(a, b) and a.shape == (30, 40)
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0


def test_scatter_to_frame_matches_jax():
    rng = np.random.default_rng(0)
    prev = rng.random((6, 7, 4)).astype(np.float32)
    idx = rng.permutation(42)[:9]
    vals = rng.random((9, 4)).astype(np.float32)
    want = jsp.scatter_to_frame(jnp.asarray(prev), jnp.asarray(idx),
                                jnp.asarray(vals))
    got = tsp.scatter_to_frame(torch.from_numpy(prev), torch.from_numpy(idx),
                               torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _field(n=24):
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    return (0.5 + 0.45 * np.sin(6 * x + 0.3) * np.cos(5 * y)
            * np.sin(4 * z + 1.0)).astype(np.float32)


def _scenes():
    js = dataclasses.replace(
        jsc.simple_scene(_field()), camera=jsc.Camera.create(
            from_=(0.5, 0.5, -1.8), at=(0.5, 0.5, 0.5), fovy=45.0))
    return js, scene_from_arrays(arrays_from_scene(js), device="cpu")


def _close(jf, tf):
    for k in ("rgba", "grad", "depth"):
        np.testing.assert_allclose(getattr(tf, k).numpy(),
                                   np.asarray(getattr(jf, k)), atol=5e-5)


@pytest.mark.parametrize("shading,fast", [("diffuse", True),
                                          ("none", False)])
def test_render_sparse_matches_jax(shading, fast):
    """One sparse frame scattered into a previous one, and its indices."""
    js, ts = _scenes()
    kw = dict(width=160, height=96, sampling_rate=24.0, shading=shading,
              fast_math=fast, method="march")
    jc = japi.RenderConfig(**kw).resolved(js)
    tc = api.RenderConfig(**kw).resolved(ts)
    prev = np.random.default_rng(1).random((96, 160, 4)).astype(np.float32)
    jprev = japi.Frame(rgba=jnp.asarray(prev), grad=jnp.zeros((96, 160, 3)),
                       depth=None)
    tprev = api.Frame(rgba=torch.from_numpy(prev),
                      grad=torch.zeros((96, 160, 3)), depth=None)
    focus = ((0.4, 0.6), 0.15, 0.05)
    jf, ji = jsp.render_sparse(js, jc, focus=jsp.FocusParams.create(*focus),
                               frame_index=3, prev_frame=jprev)
    tf, ti = tsp.render_sparse(ts, tc, focus=tsp.FocusParams.create(
        *focus, device="cpu"), frame_index=3, prev_frame=tprev)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(jf, tf)
    assert float(tf.rgba[..., 3].max()) > 0.1


def test_renderer_sparse_frames_match_jax():
    """Renderer with sparse sampling and a focus: two frames, the second
    scattered into the first, against the JAX package's Renderer."""
    js, ts = _scenes()
    kw = dict(width=160, height=96, sampling_rate=24.0, shading="diffuse",
              fast_math=True, method="march")
    jr = japi.Renderer(js, japi.RenderConfig(**kw))
    tr = api.Renderer(ts, api.RenderConfig(**kw))
    for r in (jr, tr):
        r.set_sparse_sampling(True)
        r.set_focus((0.5, 0.5), 0.2, 0.1)
    for _ in range(2):
        jr.render()
        tr.render()
        a, b = tr.mapframe(), jr.mapframe()
        for k in ("rgba", "grad", "depth"):
            np.testing.assert_allclose(a[k], b[k], atol=5e-5)
    covered = (a["rgba"][..., 3] > 0).mean()
    assert 0.05 < covered < 0.5  # two budgets of W*H/8, partly the same
    tr.set_sparse_sampling(False)
    tr.render()
    assert (tr.mapframe()["rgba"][..., 3] > 0).mean() > covered


def _frame_pair():
    rng = np.random.default_rng(3)
    rgba = rng.uniform(-0.1, 2.5, (9, 11, 4)).astype(np.float32)
    rgba[..., 3] = rng.random((9, 11))
    grad = rng.random((9, 11, 3)).astype(np.float32)
    return (japi.Frame(rgba=jnp.asarray(rgba), grad=jnp.asarray(grad)),
            api.Frame(rgba=torch.from_numpy(rgba),
                      grad=torch.from_numpy(grad)))


@pytest.mark.parametrize("op", ["exposure", "reinhard", "aces", "gamma",
                                "background", "denoise", "chain"])
def test_imageops_match_jax(op):
    def ops(m):
        return {"exposure": m.exposure(1.5),
                "reinhard": m.reinhard_tonemap(),
                "aces": m.aces_tonemap(), "gamma": m.gamma(2.2),
                "background": m.composite_background((0.2, 0.3, 0.4)),
                "denoise": m.denoise(m.gamma(1.8)),
                "chain": m.chain(m.exposure(-0.5), m.aces_tonemap(),
                                 m.gamma(2.2),
                                 m.composite_background((1.0, 1.0, 1.0)))}
    jf, tf = _frame_pair()
    want, got = ops(jops)[op](jf), ops(tops)[op](tf)
    np.testing.assert_allclose(got.rgba.numpy(), np.asarray(want.rgba),
                               atol=1e-6)
    np.testing.assert_array_equal(got.grad.numpy(), np.asarray(want.grad))
