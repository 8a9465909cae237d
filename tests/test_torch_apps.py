"""The port's programs (ovr_tpu_torch.apps) against the JAX package's
(apps.render_batch, apps.viewer), run in process on the CPU.

`render_batch` in its four modes on tests/fixtures/scene_tiny.json (16^3,
`--fbsize 48 32 --sampling-rate 2`): single-frame, orbit and sequence
PNGs within 1/255 of JAX's, with the same `camera pos` lines (1e-6);
`--resume` renders only the frames not yet written; `--ab` EXRs within
rgba 5e-5 and the PSNR within 0.01 dB of JAX's. The viewer's render
session after the same settings within rgba 5e-5 of JAX's, its HTTP
routes, and its error count.
"""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from apps import render_batch as jbatch
from apps import viewer as jviewer
from ovr_tpu import api as japi
from ovr_tpu.io import vidi3d as jvidi
from ovr_tpu_torch import api, io
from ovr_tpu_torch.apps import render_batch, viewer
from ovr_tpu_torch.io.image import load_exr
from ovr_tpu_torch.ops import swslice

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "scene_tiny.json")
RAW = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_vorts.raw")
BASE = ["--scene", FIXTURE, "--fbsize", "48", "32", "--sampling-rate", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def png(path) -> np.ndarray:
    return np.asarray(Image.open(path)).astype(np.int16)


def assert_png_close(a, b):
    x, y = png(a), png(b)
    assert x.shape == y.shape
    assert int(np.abs(x - y).max()) <= 1, (a, b)


def both(tmp_path, argv, capsys):
    """Run JAX's and the port's render_batch on `argv` with outputs under
    tmp_path/jax and tmp_path/port; returns (JAX's stdout, the port's
    stdout, the port's result)."""
    out = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        args = [a.replace("@", str(d) + os.sep) for a in argv]
        capsys.readouterr()
        before = swslice.LAUNCHES
        if name == "jax":
            jbatch.main(args)
        else:
            res = render_batch.main(args + ["--device", "cpu"])
            assert swslice.LAUNCHES == before  # the CPU runs no kernel
        out[name] = capsys.readouterr().out
    return out["jax"], out["port"], res


def test_single_frame_matches_jax(tmp_path, capsys):
    jout, tout, res = both(tmp_path, BASE + [
        "--warmup", "1", "--timed", "2", "--exp", "@f_"], capsys)
    for o in (jout, tout):
        assert re.search(r"^fps = \d", o, re.M)
        assert re.search(r"^rays/s = \d", o, re.M)
    assert res["mode"] == "single" and res["fps"] > 0
    assert res["frame"].rgba.shape == (32, 48, 4)
    assert_png_close(tmp_path / "jax" / "f_00000.png",
                     tmp_path / "port" / "f_00000.png")


def _positions(out):
    return [tuple(map(float, m)) for m in re.findall(
        r"^camera pos \(([-\d.]+),([-\d.]+),([-\d.]+)\)$", out, re.M)]


def test_orbit_matches_jax_and_resumes(tmp_path, capsys):
    """Four orbit frames. (With three, the second camera, (7.5, 17.918694,
    -15.774467), puts a fan row exactly on a voxel boundary of the 16^3
    fixture: the analytic gradient's slope there is either cell's at an
    f32-ulp tie, and the diffuse frames differ by 0.014 on that row alone;
    moved by 1e-3 they agree to 1.9e-5.)"""
    jout, tout, res = both(tmp_path, BASE + [
        "--num-frames", "4", "--shading", "diffuse", "--exp", "@orbit_"],
        capsys)
    jp, tp = _positions(jout), _positions(tout)
    assert len(jp) == 4 and res["rendered"] == [0, 1, 2, 3]
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    np.testing.assert_allclose(res["camera_pos"], jp, atol=1e-6)
    for i in range(4):
        assert_png_close(tmp_path / "jax" / f"orbit_{i:05d}.png",
                         tmp_path / "port" / f"orbit_{i:05d}.png")
    meta = json.loads((tmp_path / "port" / "orbit_progress.json")
                      .read_text())
    assert sorted(meta) == ["0", "1", "2", "3"]
    # frame 1 lost: --resume renders it alone, the same picture
    os.remove(tmp_path / "port" / "orbit_00001.png")
    res = render_batch.main(BASE + [
        "--num-frames", "4", "--shading", "diffuse", "--device", "cpu",
        "--exp", str(tmp_path / "port" / "orbit_"), "--resume"])
    assert res["rendered"] == [1]
    assert _positions(capsys.readouterr().out) == [tp[1]]
    assert_png_close(tmp_path / "jax" / "orbit_00001.png",
                     tmp_path / "port" / "orbit_00001.png")


def test_ab_matches_jax(tmp_path, capsys):
    jout, tout, res = both(tmp_path, BASE + [
        "--shading", "diffuse", "--ab", "--exp", "@ab_"], capsys)
    assert "psnr = " in jout and "psnr = " in tout
    psnr = {}
    for name in ("jax", "port"):
        a = load_exr(str(tmp_path / name / "ab_march.exr"))
        b = load_exr(str(tmp_path / name / "ab_shearwarp.exr"))
        pa, pb = a[..., :3] * a[..., 3:], b[..., :3] * b[..., 3:]
        psnr[name] = 10 * np.log10(1 / max(np.mean((pa - pb) ** 2), 1e-12))
    for meth in ("march", "shearwarp"):
        np.testing.assert_allclose(
            load_exr(str(tmp_path / "port" / f"ab_{meth}.exr")),
            load_exr(str(tmp_path / "jax" / f"ab_{meth}.exr")), atol=5e-5)
    assert abs(res["psnr"] - psnr["jax"]) <= 0.01
    assert abs(psnr["port"] - psnr["jax"]) <= 0.01
    assert res["psnr"] > 35 and set(res["seconds"]) == {"march",
                                                         "shearwarp"}


def test_sequence_matches_jax(tmp_path, capsys):
    """Four timesteps (the fixture's big-endian floats scaled by 1 +
    k / 4): the streamed frames are JAX's, and each render sees its own
    timestep's voxels (the prefetch never hands a render another
    timestep). (A scale of 1.15 puts a few samples at a tie of the
    piecewise-linear shading: 0.032 at 7 pixels; at 1.151 the packages
    agree to 3.5e-6.)"""
    base = np.fromfile(RAW, ">f4")
    for k in range(4):
        (base * (1.0 + 0.25 * k)).astype(">f4").tofile(
            tmp_path / f"v_{k:04d}.raw")
    seq = ["--sequence", str(tmp_path / "v_%04d.raw"),
           "--sequence-endian", "BIG", "--shading", "diffuse"]
    jout, tout, res = both(tmp_path, BASE + seq + ["--exp", "@s_"], capsys)
    assert "streaming fps" in jout and "streaming fps" in tout
    assert res["timesteps"] == 4 and res["streaming_fps"] > 0
    pics = [png(tmp_path / "port" / f"s_t{k:05d}.png") for k in range(4)]
    for k in range(4):
        assert_png_close(tmp_path / "jax" / f"s_t{k:05d}.png",
                         tmp_path / "port" / f"s_t{k:05d}.png")
    assert all(np.any(pics[k] != pics[k + 1]) for k in range(3))
    seen = []
    render_batch.main(BASE + seq + ["--device", "cpu", "--no-save"],
                      on_frame=lambda i, r: seen.append(
                          (i, r.scene.volume.grid.clone())))
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    for k, g in seen:
        want = torch.from_numpy((base * (1.0 + 0.25 * k)).astype(
            np.float32).reshape(16, 16, 16))
        assert torch.equal(g, want)


# ---- the viewer ------------------------------------------------------------

SETTINGS = {"camera": {"from": [30.0, 9.0, 4.0], "at": [7.5, 7.5, 7.5]},
            "tfn": {"alphas": [[0, 0], [0.4, 0.1], [1, 0.9]],
                    "colors": [[0, 1, 0, 0], [0.5, 0.2, 0.8, 0.1],
                               [1, 0, 0, 1]]},
            "shading": "diffuse"}


def wait_frames(sess, n, deadline=120.0):
    t0 = time.perf_counter()
    while sess._frame_id < n:  # both packages keep the count there
        assert time.perf_counter() - t0 < deadline, "no frame in time"
        time.sleep(0.02)


def test_viewer_session_matches_jax():
    """Settings queued before each session starts, so the first frame
    sees them all."""
    frames = {}
    for name, mod, scene, cfg in (
            ("jax", jviewer, jvidi.create_scene(FIXTURE),
             japi.RenderConfig(width=48, height=32, sampling_rate=2.0,
                               shading="shadow", fast_math=True,
                               method="auto")),
            ("port", viewer, io.create_scene(FIXTURE, device="cpu"),
             api.RenderConfig(width=48, height=32, sampling_rate=2.0,
                              shading="shadow", fast_math=True,
                              method="auto"))):
        sess = mod.RenderSession(scene, cfg)
        mod.apply_settings(sess, SETTINGS)
        sess.start()
        try:
            wait_frames(sess, 1)
        finally:
            sess.stop()
        frames[name] = sess.renderer.mapframe()["rgba"]
        if name == "port":
            assert sess.errors == 0 and not sess._thread.is_alive()
            st = sess.stats()
            assert st["camera"]["from"] == [30.0, 9.0, 4.0]
            assert st["tf"] == SETTINGS["tfn"]
    np.testing.assert_allclose(frames["port"], frames["jax"], atol=5e-5)


def test_viewer_http_routes(tmp_path, monkeypatch):
    """The port's server on 127.0.0.1:0: /, /frame.png, /stats,
    /colormaps, /colormap?name=, /screenshot, POST /set (one frame for
    the whole message), 404s; a setter that makes the render raise is
    counted and the last good frame stays published."""
    monkeypatch.chdir(tmp_path)
    scene = io.create_scene(FIXTURE, device="cpu")
    sess = viewer.RenderSession(scene, api.RenderConfig(
        width=48, height=32, sampling_rate=2.0, shading="none",
        fast_math=True, method="auto"))
    sess.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), viewer.make_handler(sess))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.read()

    def post(path, msg):
        req = urllib.request.Request(url + path, method="POST",
                                     data=json.dumps(msg).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.read()

    try:
        wait_frames(sess, 1)
        assert b"ovr_tpu_torch viewer" in get("/")
        assert json.loads(get("/stats"))["frame"] == 1
        assert "viridis" in json.loads(get("/colormaps"))
        assert len(json.loads(get("/colormap?name=viridis"))) == 32
        assert post("/set", SETTINGS) == b"{}"
        wait_frames(sess, 2)
        time.sleep(0.3)  # parked: one transaction, one frame
        st = json.loads(get("/stats"))
        assert st["frame"] == 2 and st["errors"] == 0
        direct = api.Renderer(io.create_scene(FIXTURE, device="cpu"),
                              sess.renderer._cfg)
        viewer.apply_settings(_Direct(direct), SETTINGS)
        direct.render()
        assert torch.equal(direct._frame.rgba, sess.renderer._frame.rgba)
        img = Image.open(__import__("io").BytesIO(get("/frame.png")))
        assert img.size == (48, 32) and img.mode == "RGBA"
        saved = json.loads(get("/screenshot"))["saved"]
        assert os.path.exists(saved)
        with pytest.raises(urllib.error.HTTPError):
            get("/nothing")
        png_before = sess.frame_png()[0]
        post("/set", {"spp": 0})  # a frame of no samples raises
        t0 = time.perf_counter()
        while sess.errors == 0:
            assert time.perf_counter() - t0 < 60
            time.sleep(0.02)
        assert sess.frame_png()[0] == png_before
    finally:
        srv.shutdown()
        srv.server_close()
        sess.stop()
    assert not sess._thread.is_alive()


class _Direct:
    """A stand-in session whose queued setters run at once on a
    renderer."""

    def __init__(self, renderer):
        self.renderer = renderer

    def submit(self, ops):
        for name, args in ops:
            getattr(self.renderer, name)(*args)
