"""VIDI3D JSON scene reader (the port's copy of `ovr_tpu.io.vidi3d`).

Re-implements `ovr/serializer/serializer_diva.cpp` + `serializer_vidi3d.cpp`:
dispatch on the "version" key, dataSource (raw-binary volume with
dims/type/offset/endian and multi-candidate fileName arrays), view.camera
(eye/center/up/fovy), view.volume.transferFunction (base64 alpha array +
color control points), scalar-mapping-range normalization per voxel type,
lights, and sampleDistance -> sampling rate.

The produced `Scene`'s world box is [grid_origin, grid_origin +
grid_spacing * dims] — the instance transform the reference builds at
`ovr/devices/optix7/device_impl.cpp:283-300`
(translate(origin) * scale(spacing * dims) applied to the unit cube).
Every tensor of the scene lands on `device` (default "cuda").
"""

from __future__ import annotations

import json as jsonlib
import os

import numpy as np

from ovr_tpu_torch.core.scene import (Camera, Light, Scene, StructuredVolume,
                                      TransferFunction, VolumeInstance)
from ovr_tpu_torch.core.types import ValueType, normalized_range
from ovr_tpu_torch.io.raw import load_raw_volume
from ovr_tpu_torch.io.tfn import load_tfn_json

_INT_MAX = {
    ValueType.UINT8: 255.0,
    ValueType.INT8: 127.0,
    ValueType.UINT16: 65535.0,
    ValueType.INT16: 32767.0,
    ValueType.UINT32: 4294967295.0,
    ValueType.INT32: 2147483647.0,
}


def _vec3(js) -> tuple[float, float, float]:
    return (float(js["x"]), float(js["y"]), float(js["z"]))


def _rgb(js) -> tuple[float, float, float]:
    if not all(k in js for k in ("r", "g", "b")):
        return (0.0, 0.0, 0.0)
    return (float(js["r"]), float(js["g"]), float(js["b"]))


def _find_file(candidates, workdir: str) -> str:
    if isinstance(candidates, str):
        candidates = [candidates]
    for name in candidates:
        for path in (name, os.path.join(workdir, name)):
            if os.path.exists(path):
                return path
    raise FileNotFoundError(f"Cannot find volume file among: {candidates}")


def _load_volume(jsdata: dict, workdir: str, device):
    fmt = jsdata["format"]
    if fmt != "REGULAR_GRID_RAW_BINARY":
        raise NotImplementedError(f"data format unimplemented: {fmt}")
    path = _find_file(jsdata["fileName"], workdir)
    dims = _vec3(jsdata["dimensions"])
    dims = (int(dims[0]), int(dims[1]), int(dims[2]))
    vtype = ValueType(jsdata["type"])
    offset = int(jsdata.get("offset", 0))
    big_endian = jsdata.get("endian", "LITTLE_ENDIAN") == "BIG_ENDIAN"
    grid, data_range = load_raw_volume(path, dims, vtype, offset, big_endian)
    spacing = np.ones(3)
    if "scales" in jsdata:
        spacing = np.array(_vec3(jsdata["scales"]))
    origin = np.zeros(3)
    world_hi = origin + spacing * np.array(dims, np.float64)
    volume = StructuredVolume.create(
        grid, world_lo=origin, world_hi=world_hi, data_range=data_range,
        device=device)
    return volume, vtype


def _tfn_value_range(jsvolume: dict, vtype: ValueType) -> tuple[float, float]:
    """Raw-unit TF value range (`create_scene_tfn`,
    serializer_vidi3d.cpp:228-274)."""
    if "scalarMappingRangeUnnormalized" in jsvolume:
        r = jsvolume["scalarMappingRangeUnnormalized"]
        return float(r["minimum"]), float(r["maximum"])
    if "scalarMappingRange" in jsvolume:
        r = jsvolume["scalarMappingRange"]
        lo, hi = float(r["minimum"]), float(r["maximum"])
        if vtype in _INT_MAX:
            m = _INT_MAX[vtype]
            return lo * m, hi * m
        return lo, hi
    raise ValueError("unknown data range (no scalarMappingRange in scene)")


def _load_tfn(jsview: dict, vtype: ValueType, device) -> TransferFunction:
    jsvolume = jsview["volume"]
    tf = load_tfn_json(jsvolume["transferFunction"])
    color, alpha = tf.rasterize()
    # End-bin cleanup (serializer_vidi3d.cpp:222-223)
    if alpha[0] < 0.01:
        alpha[0] = 0.0
    if alpha[-1] < 0.01:
        alpha[-1] = 0.0
    raw_lo, raw_hi = _tfn_value_range(jsvolume, vtype)
    # Convert raw-unit range to normalized sample units
    # (StructuredRegularVolume::set_value_range, volume.cpp:131-154).
    vr = normalized_range(vtype, raw_lo, raw_hi)
    return TransferFunction.create(color, alpha, vr, device=device)


def _load_camera(jsview: dict, device) -> Camera:
    js = jsview["camera"]
    kind = ("orthographic"
            if js.get("projectionMode", "PERSPECTIVE") == "ORTHOGRAPHIC"
            else "perspective")
    return Camera.create(
        from_=_vec3(js["eye"]), at=_vec3(js["center"]), up=_vec3(js["up"]),
        fovy=float(js["fovy"]), height=float(js.get("height", 1.0)),
        kind=kind, device=device)


def _parse_light(js: dict, device) -> Light:
    kind = {"DIRECTIONAL_LIGHT": "directional", "POINT_LIGHT": "point",
            "AMBIENT_LIGHT": "ambient", "SUN_SKY_LIGHT": "sunsky"}.get(
        js.get("type", "DIRECTIONAL_LIGHT"), "directional")
    pos = _vec3(js.get("position", {"x": 1, "y": 1, "z": 1}))
    return Light.create(
        direction=pos,  # VIDI3D stores the toward-light vector as position
        position=pos,
        color=_rgb(js.get("diffuse", {})),
        intensity=float(js.get("intensity", 1.0)),
        kind=kind, device=device)


def _load_lights(jsview: dict, device) -> tuple[Light, tuple]:
    """(primary directional light, additional lights)."""
    lights = []
    if "lightSource" in jsview:
        lights.append(_parse_light(jsview["lightSource"], device))
    for js in jsview.get("additionalLightSources", []):
        lights.append(_parse_light(js, device))
    primary = next((l for l in lights
                    if l.kind in ("directional", "sunsky")), None)
    if primary is None:
        primary = Light.create(direction=(1.0, 1.0, 1.0), device=device)
    extras = tuple(l for l in lights if l is not primary)
    return primary, extras


def load_scene_vidi3d(root: dict, workdir: str, device="cuda") -> Scene:
    sources = root["dataSource"]
    if not isinstance(sources, list):
        sources = [sources]
    # Primary volume (parse_single_volume_scene, scene.h:413-426); further
    # dataSource entries become VolumeInstance models sharing the view's
    # transfer function (the OSPRay backend's multi-instance world,
    # ospray/device_impl.cpp:332-392).
    volume, vtype = _load_volume(sources[0], workdir, device)
    view = root["view"]
    tfn = _load_tfn(view, vtype, device)
    camera = _load_camera(view, device)
    light, extras = _load_lights(view, device)
    rate = 1.0 / float(view["volume"].get("sampleDistance", 1.0))
    instances = []
    for src in sources[1:]:
        vol_i, _ = _load_volume(src, workdir, device)
        instances.append(VolumeInstance.create(vol_i, tfn))
    return Scene.create(
        volume=volume, tfn=tfn, light=light, camera=camera,
        volume_sampling_rate=rate, lights=extras,
        instances=tuple(instances))


def create_scene(filename: str, device="cuda") -> Scene:
    """Load a scene file onto `device` (dispatch like `create_scene`,
    serializer_diva.cpp:13-50): VIDI3D JSON here, USDA settings files
    through `io.usda.create_scene_usda`."""
    ext = filename.rsplit(".", 1)[-1].lower()
    if ext in ("usda", "usd"):
        from ovr_tpu_torch.io.usda import create_scene_usda
        scene, _ = create_scene_usda(filename, device=device)
        return scene
    if ext != "json":
        raise ValueError(f"unknown scene format: {ext}")
    with open(filename) as f:
        root = jsonlib.load(f)
    workdir = os.path.dirname(filename) or "."
    version = root.get("version", "VIDI3D")
    if version == "VIDI3D":
        return load_scene_vidi3d(root, workdir, device)
    if version == "DIVA":
        raise NotImplementedError("DIVA scenes are unimplemented (as in the "
                                  "reference, serializer_diva.cpp:7-11)")
    raise ValueError(f"unknown JSON configuration format: {version}")
