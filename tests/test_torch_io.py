"""Scene I/O in the port (ovr_tpu_torch.io, ovr_tpu_torch.native) against
the JAX package's parsers (ovr_tpu.io, ovr_tpu.native), on the CPU.

The same files go through both packages. Parsers are held exactly:
every array of a loaded scene (`convert.arrays_from_scene`) equal, raw
grids equal in value and dtype. The frame of the checked-in VIDI3D
fixture (and of a u8 scene) from both packages within rgba 5e-5 and
depth 2e-4.
"""

import base64
import json
import os

import numpy as np
import pytest
import torch

from ovr_tpu import api as japi
from ovr_tpu.io import colormaps as jcm
from ovr_tpu.io import image as jimage
from ovr_tpu.io import raw as jraw
from ovr_tpu.io import tfn as jtfn
from ovr_tpu.io import usda as jusda
from ovr_tpu.io import vidi3d as jvidi
from ovr_tpu_torch import api, io
from ovr_tpu_torch.convert import arrays_from_scene
from ovr_tpu_torch.core.types import ValueType, normalize_array
from ovr_tpu_torch.io import colormaps, image, raw, tfn, usda, vidi3d
from ovr_tpu_torch.native import loader as native_loader
from ovr_tpu_torch.ops import swslice

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "scene_tiny.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_scene(js, ts):
    """Every array of the two scenes equal (dtype too, but mesh faces:
    the port's TriangleMesh indexes in int64), every kind the same; the
    port's tensors on the CPU."""
    ja, ta = arrays_from_scene(js), arrays_from_scene(ts)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        a, b = np.asarray(ja[k]), np.asarray(ta[k])
        if k.endswith("geometry.faces"):
            assert b.dtype == np.int64, k
        else:
            assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert ts.device == torch.device("cpu")


# ---- raw volumes ----------------------------------------------------------

def _raw_case(kind, rng, path):
    """(file written, dims (X, Y, Z), type, offset, big-endian) per case."""
    if kind == "f32":
        data = rng.uniform(-2, 3, size=(4, 5, 6)).astype(np.float32)
        data.tofile(path)
        return (6, 5, 4), ValueType.FLOAT, 0, False
    if kind == "u8":
        rng.integers(0, 256, size=(3, 4, 5), dtype=np.uint8).tofile(path)
        return (5, 4, 3), ValueType.UINT8, 0, False
    if kind == "u16":
        rng.integers(0, 65536, size=(3, 4, 5), dtype=np.uint16).tofile(path)
        return (5, 4, 3), "UNSIGNED_SHORT", 0, False
    data = rng.integers(-32768, 32768, size=(2, 3, 4)).astype(">i2")
    with open(path, "wb") as f:
        f.write(b"HEADER")  # a 6-byte header
        f.write(data.tobytes())
    return (4, 3, 2), ValueType.INT16, 6, True


@pytest.mark.parametrize("kind", ["f32", "u8", "u16", "i16_be_offset"])
def test_raw_volume_matches_jax(tmp_path, rng, kind):
    path = str(tmp_path / "v.raw")
    dims, vtype, offset, be = _raw_case(kind, rng, path)
    grid, vr = raw.load_raw_volume(path, dims, vtype, offset, be)
    jvt = vtype if isinstance(vtype, str) else vtype.value
    jgrid, jvr = jraw.load_raw_volume(path, dims, jvt, offset, be)
    assert grid.dtype == jgrid.dtype  # u8/u16 stay in their file type
    assert grid.shape == (dims[2], dims[1], dims[0])
    np.testing.assert_array_equal(grid, jgrid)
    assert vr == jvr
    if kind in ("u8", "u16"):  # opt-out: f32 normalization, as JAX's
        g32, _ = raw.load_raw_volume(path, dims, vtype, native_dtype=False)
        j32, _ = jraw.load_raw_volume(path, dims, jvt, native_dtype=False)
        assert g32.dtype == np.float32
        np.testing.assert_array_equal(g32, j32)


def test_raw_size_mismatch_raises(tmp_path):
    path = tmp_path / "v.raw"
    np.zeros(7, np.float32).tofile(path)
    for mod in (raw, jraw):
        with pytest.raises(ValueError, match="File size"):
            mod.load_raw_volume(str(path), (2, 2, 2), ValueType.FLOAT.value)


def test_raw_sequence_matches_jax(tmp_path, rng):
    for i in range(3):
        rng.uniform(size=(2, 2, 3)).astype(np.float32).tofile(
            tmp_path / f"v_{i:04d}.raw")
    for spec in (str(tmp_path / "v_%04d.raw"), str(tmp_path / "v_*.raw")):
        assert raw.sequence_paths(spec) == jraw.sequence_paths(spec)
        ours = list(raw.load_raw_sequence(spec, (3, 2, 2), "FLOAT"))
        theirs = list(jraw.load_raw_sequence(spec, (3, 2, 2), "FLOAT"))
        assert [p for p, _ in ours] == [p for p, _ in theirs]
        for (_, a), (_, b) in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        raw.sequence_paths(str(tmp_path / "w_%04d.raw"))


def _native_available():
    return native_loader._build_and_import() is not None


@pytest.mark.skipif(not _native_available(),
                    reason="native extension unavailable (no C compiler)")
@pytest.mark.parametrize("vtype,arr", [
    (ValueType.UINT8, np.array([0, 128, 255], np.uint8)),
    (ValueType.INT8, np.array([-128, -127, 0, 127], np.int8)),
    (ValueType.UINT16, np.array([0, 40000, 65535], np.uint16)),
    (ValueType.INT16, np.array([-32768, -1, 32767], np.int16)),
    (ValueType.UINT32, np.array([0, 7, 4000000000], np.uint32)),
    (ValueType.INT32, np.array([-5, 0, 2000000000], np.int32)),
    (ValueType.FLOAT, np.array([-1.5, 0.25, 3e7], np.float32)),
    (ValueType.DOUBLE, np.array([-1.5, 0.25, 3e7], np.float64)),
])
def test_native_loader_matches_numpy(tmp_path, vtype, arr):
    """The native loader, built into ovr_tpu_torch/_build/, against the
    numpy route; big-endian at an offset too; writable output."""
    path = tmp_path / "v.raw"
    arr.tofile(path)
    got = native_loader.load_raw(str(path), arr.size, vtype.dtype.char, 0,
                                 False)
    np.testing.assert_array_equal(got, normalize_array(arr, vtype))
    assert got.flags.writeable
    with open(path, "wb") as f:
        f.write(b"abc")
        f.write(arr.astype(arr.dtype.newbyteorder(">")).tobytes())
    got = native_loader.load_raw(str(path), arr.size, vtype.dtype.char, 3,
                                 True)
    np.testing.assert_array_equal(got, normalize_array(arr, vtype))
    assert "_build" in native_loader._NATIVE.__file__


# ---- transfer functions, colormaps, images --------------------------------

def test_tfn_base64_roundtrip_matches_jax(rng):
    color = rng.uniform(size=(9, 3)).astype(np.float32)
    alpha = rng.uniform(size=128).astype(np.float32)
    js = tfn.save_tfn_json(color, alpha)
    assert json.dumps(js) == json.dumps(jtfn.save_tfn_json(color, alpha))
    ours = tfn.load_tfn_json(js).rasterize()
    theirs = jtfn.load_tfn_json(js).rasterize()
    np.testing.assert_array_equal(ours[1], alpha)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_tfn_controls_rasterize_as_jax(tmp_path):
    js = {"resolution": 96,
          "colorControls": [
              {"position": 0.8, "color": {"r": 1, "g": 0, "b": 0}},
              {"position": 0.1, "color": {"r": 0, "g": 0.5, "b": 1}},
              {"position": 0.4},  # incomplete: skipped
          ],
          "opacityControl": [{"position": {"x": 0.0, "y": 0.2}},
                             {"position": {"x": 1.0, "y": 0.6}}],
          "gaussianObjects": [{"mean": 0.5, "sigma": 0.1,
                               "heightFactor": 0.1},
                              {"mean": 0.2}]}
    ours = tfn.load_tfn_json(js).rasterize()
    theirs = jtfn.load_tfn_json(js).rasterize()
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    # the widget's file layouts
    for root in ({"view": {"volume": {"transferFunction": js}}},
                 {"transferFunction": js}, js):
        p = tmp_path / "tf.json"
        p.write_text(json.dumps(root))
        np.testing.assert_array_equal(
            tfn.load_tfn_file(str(p)).rasterize()[1],
            jtfn.load_tfn_file(str(p)).rasterize()[1])


def test_every_colormap_key_matches_jax():
    names = colormaps.available_colormaps()
    assert names == jcm.available_colormaps()
    for name in names:
        np.testing.assert_array_equal(colormaps.create_colormap(name, 40),
                                      jcm.create_colormap(name, 40),
                                      err_msg=name)
    with pytest.raises(KeyError):
        colormaps.create_colormap("no/such_map")


def test_png_and_exr_roundtrips(tmp_path, rng):
    from PIL import Image
    img = rng.uniform(size=(8, 10, 4)).astype(np.float32)
    image.save_image(str(tmp_path / "a.png"), img)
    jimage.save_image(str(tmp_path / "b.png"), img)
    a = np.asarray(Image.open(tmp_path / "a.png"))
    np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path
                                                            / "b.png")))
    np.testing.assert_allclose(a[::-1], image.to_uint8(img), atol=1)
    for c in (1, 3, 4):
        hdr = rng.normal(size=(6, 7, c)).astype(np.float32)
        image.save_exr(str(tmp_path / "a.exr"), hdr)
        back = image.load_exr(str(tmp_path / "a.exr"))
        np.testing.assert_array_equal(back, hdr[::-1])
        np.testing.assert_array_equal(jimage.load_exr(str(tmp_path
                                                          / "a.exr")), back)
        assert (tmp_path / "a.exr").read_bytes() == _jax_exr(tmp_path, hdr)


def _jax_exr(tmp_path, img):
    jimage.save_exr(str(tmp_path / "j.exr"), img)
    return (tmp_path / "j.exr").read_bytes()


# ---- scenes ---------------------------------------------------------------

def _frames(js, ts, **kw):
    kw = dict(dict(width=24, height=24, spp=1, shading="diffuse",
                   method="auto",
                   sampling_rate=float(js.volume_sampling_rate)), **kw)
    jc = japi.RenderConfig(**kw).resolved(js)
    tc = api.RenderConfig(**kw).resolved(ts)
    assert (jc.sw is None) == (tc.sw is None)
    return japi.render(js, jc), api.render(ts, tc)


def _close(jf, tf):
    np.testing.assert_allclose(tf.rgba.numpy(), np.asarray(jf.rgba),
                               atol=5e-5)
    np.testing.assert_allclose(tf.depth.numpy(), np.asarray(jf.depth),
                               atol=2e-4)
    assert float(tf.rgba[..., 3].max()) > 0.3


def test_fixture_scene_matches_jax():
    """The checked-in VIDI3D fixture (multi-candidate fileName,
    BIG_ENDIAN float raw, base64 alpha, colour controls, scalar mapping
    range, sampleDistance, a directional light): every array equal, and
    the frames of both packages (shear-warp, diffuse) within rgba 5e-5,
    depth 2e-4."""
    js = jvidi.create_scene(FIXTURE)
    ts = io.create_scene(FIXTURE, device="cpu")
    _assert_same_scene(js, ts)
    assert float(ts.volume.grid.max()) > 5.0  # endian decoded
    # VIDI3D's light position is the toward-light vector (vidi3d.py:127)
    np.testing.assert_array_equal(ts.light.direction.numpy(), [0, 0, 1])
    n0 = swslice.LAUNCHES
    jf, tf = _frames(js, ts)
    _close(jf, tf)
    assert swslice.LAUNCHES == n0  # CPU tensors run the plain version


def _vidi3d_js(files, vtype="UNSIGNED_BYTE", dims=(8, 8, 8), extra=()):
    alpha = np.linspace(0, 1, 32).astype("<f4") ** 1.5
    src = [{"format": "REGULAR_GRID_RAW_BINARY", "fileName": [f],
            "dimensions": dict(zip("xyz", dims)), "type": vtype,
            "offset": 0, "endian": "LITTLE_ENDIAN"} for f in files]
    for s, e in zip(src, extra):
        s.update(e)
    return {
        "version": "VIDI3D",
        "dataSource": src,
        "view": {
            "camera": {"eye": {"x": 4, "y": 4.5, "z": -14},
                       "center": {"x": 4, "y": 4, "z": 4},
                       "up": {"x": 0, "y": 1, "z": 0}, "fovy": 40},
            "volume": {
                "sampleDistance": 0.5,
                "scalarMappingRange": {"minimum": 0.1, "maximum": 0.9},
                "transferFunction": {
                    "alphaArray": {"encoding": "BASE64", "data":
                                   base64.b64encode(alpha.tobytes()
                                                    ).decode()},
                    "colorControls": [
                        {"position": 0, "color": {"r": 0, "g": 0.2,
                                                  "b": 1}},
                        {"position": 1, "color": {"r": 1, "g": 0.4,
                                                  "b": 0}}]}},
            "lightSource": {"type": "DIRECTIONAL_LIGHT",
                            "position": {"x": 1, "y": 2, "z": -3},
                            "diffuse": {"r": 1, "g": 0.9, "b": 0.8}},
            "additionalLightSources": [
                {"type": "POINT_LIGHT", "position": {"x": 4, "y": 9,
                                                      "z": -2},
                 "intensity": 0.5, "diffuse": {"r": 1, "g": 1, "b": 1}},
                {"type": "AMBIENT_LIGHT", "intensity": 0.3}],
        },
    }


def _smooth_u8(n):
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    g = 0.5 + 0.45 * np.sin(6 * x + 0.3) * np.cos(5 * y) * np.sin(4 * z + 1)
    return np.round(g * 255).astype(np.uint8)


def test_u8_vidi3d_scene_matches_jax(tmp_path):
    """A UNSIGNED_BYTE VIDI3D scene with a point and an ambient light:
    the grid stays uint8, the raw-unit mapping range becomes normalized,
    the ambient light is an extra light, every array equals JAX's; the
    frames (the u8 storage scale in the slice loop) within 5e-5."""
    _smooth_u8(8).tofile(tmp_path / "v.raw")
    (tmp_path / "s.json").write_text(json.dumps(_vidi3d_js(["v.raw"])))
    js = jvidi.create_scene(str(tmp_path / "s.json"))
    ts = io.create_scene(str(tmp_path / "s.json"), device="cpu")
    _assert_same_scene(js, ts)
    assert ts.volume.grid.dtype == torch.uint8
    np.testing.assert_allclose(ts.tfn.value_range.numpy(), [0.1, 0.9],
                               atol=1e-7)
    assert [lt.kind for lt in ts.lights] == ["point", "ambient"]
    assert float(ts.volume_sampling_rate) == 2.0
    jf, tf = _frames(js, ts, width=20, height=16, shading="none")
    _close(jf, tf)


def test_two_data_sources_give_an_instance(tmp_path):
    _smooth_u8(8).tofile(tmp_path / "a.raw")
    np.linspace(0, 1, 6 * 5 * 4, dtype=np.float32).tofile(tmp_path
                                                          / "b.raw")
    js_doc = _vidi3d_js(["a.raw", "b.raw"], extra=(
        {}, {"type": "FLOAT", "dimensions": {"x": 4, "y": 5, "z": 6},
             "scales": {"x": 0.5, "y": 0.5, "z": 0.5}}))
    (tmp_path / "s.json").write_text(json.dumps(js_doc))
    js = jvidi.create_scene(str(tmp_path / "s.json"))
    ts = io.create_scene(str(tmp_path / "s.json"), device="cpu")
    assert len(ts.instances) == 1
    _assert_same_scene(js, ts)
    inst = ts.instances[0]
    assert inst.volume.grid.shape == (6, 5, 4)
    np.testing.assert_array_equal(inst.volume.world_hi.numpy(), [2, 2.5, 3])
    assert inst.tfn is ts.tfn  # the view's TF, shared


def test_scene_format_dispatch_errors(tmp_path):
    (tmp_path / "d.json").write_text(json.dumps({"version": "DIVA"}))
    (tmp_path / "x.json").write_text(json.dumps({"version": "OTHER"}))
    for mod in (vidi3d, jvidi):
        with pytest.raises(NotImplementedError, match="DIVA"):
            mod.create_scene(str(tmp_path / "d.json"))
        with pytest.raises(ValueError, match="configuration format"):
            mod.create_scene(str(tmp_path / "x.json"))
        with pytest.raises(ValueError, match="unknown scene format"):
            mod.create_scene(str(tmp_path / "scene.obj"))


# tests/test_usda.py's settings document, a mesh prim added (below)
USDA_DOC = """#usda 1.0

def "scene" {
    def "rendering" {
        int use_dda = 2 # multi-layer DDA
        bool parallel_view = False
        bool simple_path_tracing = True
    }
    def "volume" {
        # string data_path = "ignored.json"
        string data_path = "base.json"
    }
    def "camera" {
        float3 from = (
            -10.0,
            20.5, -15.25
        )
        float3 at = (4, 4, 4)
        float3 up = (0, 1, 0)
    }
    def "light" {
        def "ambient" {
            def "first_light" {
                float  intensity = 0.25
                float3 color     = (1, 1, 1)
            }
        }
        def "directional" {
            def "first_light" {
                float  intensity = 2
                float3 direction = (0, -10, 0)
                float3 color     = (1, 0.5, 0.25)
            }
        }
    }
"""
USDA_MESH = """
    def Mesh "quad" {
        point3f[] points = [(0, 0, 4), (8, 0, 4), (8, 8, 4), (0, 8, 4)]
        int[] faceVertexIndices = [0, 1, 2, 0, 2, 3]
        texCoord2f[] primvars:st = [(0, 0), (1, 0), (1, 1), (0, 1)]
        color3f diffuseColor = (0.9, 0.5, 0.2)
        float opacity = 0.75
        string map_kd = "tex.npy"
    }
}
"""


def test_usda_matches_jax(tmp_path, rng):
    """tests/test_usda.py's settings file over a VIDI3D base scene, with
    a textured mesh prim added: rendering flags, camera and light
    overrides (USD's light direction negated into a toward-light vector,
    colour scaled by intensity, the ambient intensity) and the mesh, all
    equal to JAX's; `create_scene` dispatches .usda files."""
    rng.uniform(size=(8, 8, 8)).astype("<f4").tofile(tmp_path / "v.raw")
    doc = _vidi3d_js(["v.raw"], vtype="FLOAT")
    doc["view"].pop("additionalLightSources")
    (tmp_path / "base.json").write_text(json.dumps(doc))
    np.save(tmp_path / "tex.npy", rng.uniform(size=(4, 5, 3)))
    text = USDA_DOC + USDA_MESH
    (tmp_path / "scene.usda").write_text(text)
    path = str(tmp_path / "scene.usda")
    ts, flags = usda.create_scene_usda(path, device="cpu")
    js, jflags = jusda.create_scene_usda(path)
    assert flags == jflags == {"use_dda": 2, "parallel_view": False,
                               "simple_path_tracing": True}
    _assert_same_scene(js, ts)
    np.testing.assert_array_equal(ts.light.direction.numpy(), [0, 10, 0])
    np.testing.assert_array_equal(ts.light.color.numpy(), [2, 1, 0.5])
    assert float(ts.light.ambient) == 0.25
    (geo,) = ts.geometries
    assert geo.kind == "triangles" and geo.geometry.faces.shape == (2, 3)
    assert geo.material.map_kd.shape == (4, 5, 3)
    _assert_same_scene(jvidi.create_scene(path),
                       io.create_scene(path, device="cpu"))
    assert usda.parse_usda(text) == jusda.parse_usda(text)
