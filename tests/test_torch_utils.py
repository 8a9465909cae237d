"""Timers and checkpoints in the port (ovr_tpu_torch.utils) against the
JAX package's (ovr_tpu.utils), on the CPU.

Mirrors tests/test_sparse.py::test_utils_timers and the five cases of
tests/test_checkpoint.py, then crosses packages: `.npz` checkpoints of
a `TrainState`, a `NeuralFieldVolume` and a dict tree written by one
package load into the other equal to the last bit (the JAX package
writes its `.npz` when orbax does not import, which the tests force by
hiding the module). A resumed Adam step of the inverse-rendering train
step is bit-identical to an uninterrupted one, and JAX's optax Adam
state maps onto torch's Adam (one more step within 1e-6).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ovr_tpu.neural import field as jfield
from ovr_tpu.neural import hashgrid as jhash
from ovr_tpu.neural import train as jtrain
from ovr_tpu.parallel import tiles as jtiles
from ovr_tpu.utils import checkpoint as jck
from ovr_tpu_torch import api, convert
from ovr_tpu_torch.core.scene import Camera, simple_scene
from ovr_tpu_torch.neural import field as tfield
from ovr_tpu_torch.neural import train as ttrain
from ovr_tpu_torch.neural.hashgrid import HashGridConfig
from ovr_tpu_torch.utils import checkpoint as ck
from ovr_tpu_torch.utils import timers

SMALL = dict(n_levels=3, features_per_level=2, log2_table_size=8,
             base_resolution=4, max_resolution=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_orbax(monkeypatch):
    """The JAX package takes its `.npz` route when orbax does not
    import."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


# ---- timers ----------------------------------------------------------------

def test_utils_timers(tmp_path, monkeypatch):
    t = timers.Timer()
    t.start()
    x = torch.ones(8) * 2
    dt = t.stop(fence=x)
    assert dt >= 0 and t.milliseconds() >= 0
    c = timers.FPSCounter()
    for _ in range(3):
        c.frame()
    assert c.fps > 0
    monkeypatch.chdir(tmp_path)
    log = timers.CsvLogger(["frame", "ms"])
    log.log(1, 2.5)
    assert "benchmarks" in log.path
    text = open(log.path).read()
    assert "frame,ms" in text and "1,2.5" in text


def test_timer_family_accumulates(capsys):
    """Bandwidth accounting, the scoped timer's print, the history ring
    and a CPU device as a fence (no wait)."""
    b = timers.BandwidthTimer()
    for _ in range(2):
        b.start()
        b.add_bytes(1 << 20)
        b.stop(fence=torch.device("cpu"))
    assert b.nbytes == 2 << 20 and b.seconds() > 0 and b.gbps() > 0
    with timers.ScopedTimer("step", fence_fn=lambda: torch.zeros(2)) as s:
        pass
    assert s.timer.seconds() >= 0
    assert "[timer] step:" in capsys.readouterr().out
    h = timers.HistoryFPSCounter(window=2, history=3)
    for _ in range(5):
        h.frame()
    assert len(h.history) == 3 and h.fps > 0
    with pytest.raises(AssertionError):
        timers.Timer().stop()


# ---- checkpoints: tests/test_checkpoint.py's cases ---------------------------

def _state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.ones(3)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "step": torch.zeros_like(tree["step"])}


class TestPytreeSnapshots:
    def test_roundtrip(self, tmp_path):
        d = str(tmp_path / "ckpt")
        state = _state()
        ck.save_pytree(d, 7, state)
        assert ck.latest_step(d) == 7
        restored = ck.load_pytree(d, 7, _zeros_like(state))
        assert restored["step"].dtype == torch.int32
        for k in ("w", "b"):
            assert torch.equal(restored["params"][k], state["params"][k])
        assert int(restored["step"]) == 7

    def test_latest_of_many(self, tmp_path):
        d = str(tmp_path / "ckpt")
        for s in (1, 12, 5):
            ck.save_pytree(d, s, _state())
        assert ck.latest_step(d) == 12

    def test_latest_missing_dir(self, tmp_path):
        assert ck.latest_step(str(tmp_path / "nope")) is None


class TestFrameCheckpointer:
    def test_resume_skips_done(self, tmp_path):
        c = ck.FrameCheckpointer(str(tmp_path), "orbit_")
        assert not c.done(0)
        open(c.frame_path(0), "wb").write(b"png")
        c.commit(0, meta={"t": 0.0})
        assert c.done(0) and not c.done(1)
        c2 = ck.FrameCheckpointer(str(tmp_path), "orbit_")
        assert c2.done(0)
        assert c2.meta["0"]["t"] == 0.0

    def test_atomic_meta(self, tmp_path):
        c = ck.FrameCheckpointer(str(tmp_path), "f_")
        for i in range(3):
            open(c.frame_path(i), "wb").write(b"x")
            c.commit(i)
        c2 = ck.FrameCheckpointer(str(tmp_path), "f_")
        assert sorted(c2.meta) == ["0", "1", "2"]


def test_orbax_directory_is_refused_and_counted(tmp_path):
    """A `step_N/` directory only orbax wrote: `latest_step` sees it (JAX's
    regex), `load_pytree` says why it cannot read it."""
    d = tmp_path / "ckpt"
    (d / "step_00000003").mkdir(parents=True)
    ck.save_pytree(str(d), 2, _state())
    assert ck.latest_step(str(d)) == 3
    with pytest.raises(ValueError, match="orbax"):
        ck.load_pytree(str(d), 3, _state())


# ---- checkpoints across packages ---------------------------------------------

def _train_states(rng):
    """The same TrainState in both packages (shapes of a 6^3 scene)."""
    arrays = {f: rng.standard_normal(s).astype(np.float32) for f, s in (
        ("grid", (6, 6, 6)), ("tf_color", (8, 3)), ("tf_alpha", (8,)),
        ("m_grid", (6, 6, 6)), ("m_color", (8, 3)), ("m_alpha", (8,)))}
    js = jtiles.TrainState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return js, convert.train_state_from_arrays(arrays, device="cpu")


def _fields(rng):
    """The same neural field in both packages (tables scaled off the ngp
    init so that its values are not all near 1e-4)."""
    jf = jfield.init_field(jax.random.PRNGKey(3), jhash.HashGridConfig(
        **SMALL), hidden=8, n_hidden=2)
    jf = dataclasses.replace(jf, tables=jf.tables * 1e4)
    tf = convert._field(convert._field_arrays(jf, ""), "", "cpu")
    return jf, tf


def _zero_port(obj):
    if isinstance(obj, tfield.NeuralFieldVolume):
        for _, t in ck.field_arrays(obj):
            with torch.no_grad():
                t.zero_()
        return obj
    return dataclasses.replace(obj, **{
        f.name: torch.zeros_like(getattr(obj, f.name))
        for f in dataclasses.fields(obj)})


@pytest.mark.parametrize("kind", ["train_state", "field"])
def test_jax_checkpoint_loads_into_port(tmp_path, no_orbax, kind):
    rng = np.random.default_rng(0)
    jobj, tobj = (_train_states if kind == "train_state" else _fields)(rng)
    path = jck.save_pytree(str(tmp_path), 4, jobj)
    assert path.endswith(".npz")
    like = _zero_port(tobj)
    got = ck.load_pytree(str(tmp_path), 4, like)
    if kind == "field":
        assert got is like  # restored in place
    want = jck._flatten(jobj)
    have = ck.flatten(got)
    assert sorted(have) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["train_state", "field", "dict"])
def test_port_checkpoint_loads_into_jax(tmp_path, kind):
    rng = np.random.default_rng(1)
    if kind == "dict":
        tobj = _state()
        jobj = {"params": {"w": jnp.zeros((2, 3)), "b": jnp.zeros(3)},
                "step": jnp.int32(0)}
    else:
        jobj, tobj = (_train_states if kind == "train_state"
                      else _fields)(rng)
    ck.save_pytree(str(tmp_path), 9, tobj)
    assert jck.latest_step(str(tmp_path)) == 9
    got = jck.load_pytree(str(tmp_path), 9,
                          jax.tree_util.tree_map(jnp.zeros_like, jobj))
    want = ck.flatten(tobj)
    have = jck._flatten(got)
    assert sorted(have) == sorted(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


# ---- the Adam state --------------------------------------------------------

def _neural_scene(seed):
    field = tfield.init_field(seed, HashGridConfig(**SMALL), hidden=8,
                              n_hidden=1, device="cpu")
    with torch.no_grad():
        field.tables.mul_(1e4)
    template = simple_scene(np.zeros((8, 8, 8), np.float32), device="cpu",
                            value_range=(0.0, 1.0))
    return dataclasses.replace(
        template, volume=field,
        camera=Camera.create(from_=(0.5, 0.4, -1.5), at=(0.5, 0.5, 0.5),
                             fovy=45.0, device="cpu"))


def test_adam_resume_is_bit_identical(tmp_path):
    """Three inverse-rendering steps in one go against one step, a
    checkpoint of (parameters, Adam), a fresh field and optimizer loaded
    from it, and two more steps: the same losses and parameters, bit for
    bit (exp_avg, exp_avg_sq and step survive)."""
    cfg_kw = dict(width=16, height=12, sampling_rate=8.0, shading="none",
                  method="auto", neural_proxy_res=8)
    target = torch.full((12, 16, 4), 0.25)

    def run(scene, n, state=None):
        cfg = api.RenderConfig(**cfg_kw).resolved(scene)
        step, state0 = ttrain.make_image_train_step(scene, cfg, lr=1e-2)
        state = state0 if state is None else state
        losses = []
        for _ in range(n):
            state, loss = step(state, scene.camera, target)
            losses.append(loss)
        return state, losses

    whole = _neural_scene(5)
    _, want = run(whole, 3)
    first = _neural_scene(5)
    state, got = run(first, 1)
    ck.save_pytree(str(tmp_path), 1, state)
    resumed = _neural_scene(11)  # other weights: all come from the file
    cfg = api.RenderConfig(**cfg_kw).resolved(resumed)
    _, fresh = ttrain.make_image_train_step(resumed, cfg, lr=1e-2)
    loaded = ck.load_pytree(str(tmp_path), 1, fresh)
    assert loaded[1] is fresh[1]
    assert all(len(s) == 3 for s in fresh[1].state.values())
    _, more = run(resumed, 2, loaded)
    got += more
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for p, q in zip(resumed.volume.parameters(), whole.volume.parameters()):
        assert torch.equal(p, q)


def test_jax_adam_state_maps_onto_torch_adam(tmp_path, no_orbax):
    """JAX's image-train-step state ((tables, weights), optax Adam after
    two updates) saved as `.npz`, mapped into the port's (parameters,
    Adam) by `convert.image_train_state_from_arrays`; one more update
    from the same gradients agrees within 1e-6."""
    jf = jfield.init_field(jax.random.PRNGKey(2), jhash.HashGridConfig(
        **SMALL), hidden=8, n_hidden=2)
    params = jtrain._params(jf)
    opt = optax.adam(1e-2)
    ost = opt.init(params)
    rng = np.random.default_rng(4)

    def grads_like(tree):
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape)
                                  .astype(np.float32)), tree)

    for _ in range(2):
        upd, ost = opt.update(grads_like(params), ost)
        params = optax.apply_updates(params, upd)
    jck.save_pytree(str(tmp_path), 2, (params, ost))
    with np.load(tmp_path / "step_00000002.npz") as npz:
        arrays = {k: npz[k] for k in npz.files}

    tf = tfield.init_field(0, HashGridConfig(**SMALL), hidden=8, n_hidden=2,
                           device="cpu")
    tparams = tuple(tf.parameters())
    state = (tparams, torch.optim.Adam(tparams, lr=1e-2))
    convert.image_train_state_from_arrays(arrays, state)
    g = grads_like(params)
    upd, ost = opt.update(g, ost)
    params = optax.apply_updates(params, upd)
    gl = jax.tree_util.tree_leaves(g)
    for p, x in zip(tparams, gl):
        p.grad = torch.from_numpy(np.array(x))
    state[1].step()
    for p, x in zip(tparams, jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(x),
                                   atol=1e-6)
