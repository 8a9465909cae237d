"""Carry scene arrays between the JAX package and the port as numpy.

`arrays_from_scene` flattens any object with the attribute names of
`ovr_tpu`'s Scene (`volume.grid`, `tfn.color`, `camera.from_`,
`lights`, `geometries`, `instances`, ...) through `np.asarray`, so a JAX
scene crosses over without this module importing JAX.
`scene_from_arrays` builds the port's Scene from such a dict. Keys are
dotted attribute paths; extra lights are `lights.<i>.<field>`, geometry
instances `geometries.<i>.{kind,xfm,material.<field>,geometry.<field>}`
(a material without a texture has no `map_kd` key), volume instances
`instances.<i>.{volume,tfn}.<field>` and, where placed, `.xfm`;
`*.kind` entries hold strings. A neural-field volume (any object with a
`grid_cfg`, JAX's or the port's) is `volume.tables`,
`volume.weights.<i>.{w,b}`, the world box and `data_range`,
`volume.grid_cfg.<field>` and `volume.compute_dtype` (a dtype name).

`arrays_from_fields` flattens the multi-device modules' states (JAX's
`BrickedVolume` or `TrainState`, or the port's) by their field names;
`bricked_from_arrays` and `train_state_from_arrays` build the port's.

Checkpoints: `utils.checkpoint` spells its keys as the JAX package does,
so a `TrainState` or a `NeuralFieldVolume` loads across packages by key.
The inverse-rendering step's state is the one tree whose layout differs
(JAX: `((tables, weights), (ScaleByAdamState, EmptyState))`; the port:
`(parameters, torch.optim.Adam)`): `image_train_state_from_arrays`
maps it.
"""

from __future__ import annotations

import numpy as np
import torch

from ovr_tpu_torch.core.scene import (Camera, GeometryInstance, Isosurface,
                                      Light, Material, Scene,
                                      StructuredVolume, TransferFunction,
                                      TriangleMesh, VolumeInstance)
from ovr_tpu_torch.neural.field import NeuralFieldVolume
from ovr_tpu_torch.neural.hashgrid import HashGridConfig
from ovr_tpu_torch.parallel.bricks import BrickedVolume
from ovr_tpu_torch.parallel.tiles import TrainState

_VOLUME = ("grid", "world_lo", "world_hi", "data_range")
_TFN = ("color", "alpha", "value_range")
_CAMERA = ("from_", "at", "up", "fovy", "height")
_LIGHT = ("direction", "color", "ambient", "position", "intensity")
_MATERIAL = ("kd", "ks", "ns", "d")
_MESH = ("verts", "faces", "colors", "uvs")
_GRID_CFG = ("n_levels", "features_per_level", "log2_table_size",
             "base_resolution", "max_resolution")
_BRICKED = ("bricks", "brick_lo", "brick_hi", "own_lo", "own_hi")
_TRAIN_STATE = ("grid", "tf_color", "tf_alpha", "m_grid", "m_color",
                "m_alpha")


def _count(arrays: dict, prefix: str) -> int:
    """How many entries `prefix.<i>` (prefix may be dotted) there are."""
    n = len(prefix) + 1
    return len({k[n:].split(".")[0] for k in arrays
                if k.startswith(prefix + ".")})


def arrays_from_scene(obj) -> dict:
    """Flatten a Scene-shaped object into {dotted name: np.ndarray}."""
    out = _volume_arrays(obj.volume, obj.tfn, "")
    for f in _CAMERA:
        out[f"camera.{f}"] = np.asarray(getattr(obj.camera, f))
    out["camera.kind"] = np.asarray(obj.camera.kind)
    for prefix, lt in [("light", obj.light)] + [
            (f"lights.{i}", x) for i, x in enumerate(obj.lights)]:
        for f in _LIGHT:
            out[f"{prefix}.{f}"] = np.asarray(getattr(lt, f))
        out[f"{prefix}.kind"] = np.asarray(lt.kind)
    for i, g in enumerate(obj.geometries):
        pre = f"geometries.{i}"
        out[f"{pre}.kind"] = np.asarray(g.kind)
        out[f"{pre}.xfm"] = np.asarray(g.xfm)
        for f in _MATERIAL:
            out[f"{pre}.material.{f}"] = np.asarray(getattr(g.material, f))
        if getattr(g.material, "map_kd", None) is not None:
            out[f"{pre}.material.map_kd"] = np.asarray(g.material.map_kd)
        fields = ("isovalues",) if g.kind == "isosurface" else _MESH
        for f in fields:
            out[f"{pre}.geometry.{f}"] = np.asarray(getattr(g.geometry, f))
    for i, inst in enumerate(obj.instances):
        out.update(_volume_arrays(inst.volume, inst.tfn, f"instances.{i}."))
        if getattr(inst, "xfm", None) is not None:
            out[f"instances.{i}.xfm"] = np.asarray(inst.xfm)
    out["volume_sampling_rate"] = np.asarray(obj.volume_sampling_rate)
    out["density_scale"] = np.asarray(obj.density_scale)
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).split(".")[-1]
    return np.dtype(dt).name


def _field_arrays(volume, prefix: str) -> dict:
    out = {f"{prefix}volume.tables": _np(volume.tables),
           f"{prefix}volume.compute_dtype": np.asarray(
               _dtype_name(volume.compute_dtype))}
    for i, (w, b) in enumerate(volume.weights):
        out[f"{prefix}volume.weights.{i}.w"] = _np(w)
        out[f"{prefix}volume.weights.{i}.b"] = _np(b)
    for f in _VOLUME[1:]:
        out[f"{prefix}volume.{f}"] = _np(getattr(volume, f))
    for f in _GRID_CFG:
        out[f"{prefix}volume.grid_cfg.{f}"] = np.asarray(
            getattr(volume.grid_cfg, f))
    return out


def _volume_arrays(volume, tfn, prefix: str) -> dict:
    if hasattr(volume, "grid_cfg"):
        out = _field_arrays(volume, prefix)
    else:
        out = {f"{prefix}volume.{f}": np.asarray(getattr(volume, f))
               for f in _VOLUME}
    out.update({f"{prefix}tfn.{f}": np.asarray(getattr(tfn, f))
                for f in _TFN})
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; numpy's bfloat16 extension type (as JAX
    hands it out) crosses as its bits."""
    a = np.array(a)  # a writable copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _light(arrays: dict, prefix: str, device) -> Light:
    return Light.create(**{f: arrays[f"{prefix}.{f}"] for f in _LIGHT},
                        kind=str(arrays[f"{prefix}.kind"]), device=device)


def _field(arrays: dict, prefix: str, device) -> NeuralFieldVolume:
    pre = f"{prefix}volume."
    weights = [(_tensor(arrays[f"{pre}weights.{i}.w"]).to(device),
                _tensor(arrays[f"{pre}weights.{i}.b"]).to(device))
               for i in range(_count(arrays, f"{pre}weights"))]
    grid_cfg = HashGridConfig(**{f: int(arrays[f"{pre}grid_cfg.{f}"])
                                 for f in _GRID_CFG})
    return NeuralFieldVolume(
        _tensor(arrays[f"{pre}tables"]).to(device), weights,
        *(_tensor(arrays[f"{pre}{f}"]).to(device) for f in _VOLUME[1:]),
        grid_cfg=grid_cfg,
        compute_dtype=getattr(torch, str(arrays[f"{pre}compute_dtype"])))


def _volume(arrays: dict, prefix: str, device):
    if f"{prefix}volume.tables" in arrays:
        volume = _field(arrays, prefix, device)
    else:
        volume = StructuredVolume(
            grid=_tensor(arrays[f"{prefix}volume.grid"]).to(device),
            **{f: torch.as_tensor(np.array(arrays[f"{prefix}volume.{f}"],
                                           np.float32), device=device)
               for f in _VOLUME[1:]})
    tfn = TransferFunction.create(
        *(arrays[f"{prefix}tfn.{f}"] for f in _TFN), device=device)
    return volume, tfn


def _geometry(arrays: dict, prefix: str, device) -> GeometryInstance:
    mat = {f: arrays[f"{prefix}.material.{f}"] for f in _MATERIAL}
    material = Material.create(
        **mat, map_kd=arrays.get(f"{prefix}.material.map_kd"), device=device)
    if str(arrays[f"{prefix}.kind"]) == "isosurface":
        geom = Isosurface.create(arrays[f"{prefix}.geometry.isovalues"],
                                 device=device)
    else:
        geom = TriangleMesh.create(
            **{f: arrays[f"{prefix}.geometry.{f}"] for f in _MESH},
            device=device)
    return GeometryInstance.create(geom, material,
                                   xfm=arrays[f"{prefix}.xfm"], device=device)


def scene_from_arrays(arrays: dict, device="cuda") -> Scene:
    """Build the port's Scene from `arrays_from_scene`'s dict."""
    volume, tfn = _volume(arrays, "", device)
    camera = Camera.create(**{f: arrays[f"camera.{f}"] for f in _CAMERA},
                           kind=str(arrays["camera.kind"]), device=device)
    lights = tuple(_light(arrays, f"lights.{i}", device)
                   for i in range(_count(arrays, "lights")))
    geometries = tuple(_geometry(arrays, f"geometries.{i}", device)
                       for i in range(_count(arrays, "geometries")))
    instances = tuple(
        VolumeInstance.create(*_volume(arrays, f"instances.{i}.", device),
                              xfm=arrays.get(f"instances.{i}.xfm"))
        for i in range(_count(arrays, "instances")))
    return Scene.create(volume, tfn, light=_light(arrays, "light", device),
                        camera=camera,
                        volume_sampling_rate=arrays["volume_sampling_rate"],
                        density_scale=arrays["density_scale"], lights=lights,
                        geometries=geometries, instances=instances)


def arrays_from_fields(obj) -> dict:
    """A BrickedVolume's or TrainState's arrays {field: np.ndarray}."""
    names = _BRICKED if hasattr(obj, "bricks") else _TRAIN_STATE
    return {f: _np(getattr(obj, f)) for f in names}


def bricked_from_arrays(arrays: dict, device="cuda") -> BrickedVolume:
    """The port's BrickedVolume (all bricks) from `arrays_from_fields`."""
    return BrickedVolume(*(_tensor(arrays[f]).to(device) for f in _BRICKED))


def train_state_from_arrays(arrays: dict, device="cuda") -> TrainState:
    """The port's TrainState from `arrays_from_fields`."""
    return TrainState(*(_tensor(arrays[f]).to(device) for f in _TRAIN_STATE))


def image_train_state_from_arrays(arrays: dict, state) -> None:
    """Load a checkpoint of JAX's `make_image_train_step` state, as flat
    {key path: array} (`[0]...` the field's tables and (W, b) pairs,
    `[1][0].count`, `.mu...`, `.nu...` optax's Adam state), into the
    port's state (parameters, Adam) from `neural.train.
    make_image_train_step`, in place: the parameters are the field's
    tables and then W, b of each layer, in JAX's order."""
    params, opt = state
    paths = ["[0]"] + [f"[1][{i}][{j}]" for i in range((len(params) - 1) // 2)
                       for j in range(2)]
    step = float(np.asarray(arrays["[1][0].count"]))
    with torch.no_grad():
        for p, path in zip(params, paths):
            p.copy_(_tensor(arrays["[0]" + path]))
            opt.state[p] = {
                "step": torch.tensor(step),
                "exp_avg": _tensor(arrays["[1][0].mu" + path]).to(p),
                "exp_avg_sq": _tensor(arrays["[1][0].nu" + path]).to(p)}
