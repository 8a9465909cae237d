"""Carry scene arrays between the JAX package and the port as numpy.

`arrays_from_scene` flattens any object with the attribute names of
`ovr_tpu`'s Scene (`volume.grid`, `tfn.color`, `camera.from_`,
`lights`, ...) through `np.asarray`, so a JAX scene crosses over without
this module importing JAX. `scene_from_arrays` builds the port's Scene
from such a dict. Keys are dotted attribute paths; extra lights are
`lights.<i>.<field>`; `*.kind` entries hold strings.
"""

from __future__ import annotations

import numpy as np
import torch

from ovr_tpu_torch.core.scene import (Camera, Light, Scene, StructuredVolume,
                                      TransferFunction)

_VOLUME = ("grid", "world_lo", "world_hi", "data_range")
_TFN = ("color", "alpha", "value_range")
_CAMERA = ("from_", "at", "up", "fovy", "height")
_LIGHT = ("direction", "color", "ambient", "position", "intensity")


def arrays_from_scene(obj) -> dict:
    """Flatten a Scene-shaped object into {dotted name: np.ndarray}."""
    out = {}
    for f in _VOLUME:
        out[f"volume.{f}"] = np.asarray(getattr(obj.volume, f))
    for f in _TFN:
        out[f"tfn.{f}"] = np.asarray(getattr(obj.tfn, f))
    for f in _CAMERA:
        out[f"camera.{f}"] = np.asarray(getattr(obj.camera, f))
    out["camera.kind"] = np.asarray(obj.camera.kind)
    for prefix, lt in [("light", obj.light)] + [
            (f"lights.{i}", x) for i, x in enumerate(obj.lights)]:
        for f in _LIGHT:
            out[f"{prefix}.{f}"] = np.asarray(getattr(lt, f))
        out[f"{prefix}.kind"] = np.asarray(lt.kind)
    out["volume_sampling_rate"] = np.asarray(obj.volume_sampling_rate)
    out["density_scale"] = np.asarray(obj.density_scale)
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


def scene_from_arrays(arrays: dict, device="cuda") -> Scene:
    """Build the port's Scene from `arrays_from_scene`'s dict."""
    volume = StructuredVolume(
        grid=_tensor(arrays["volume.grid"]).to(device),
        **{f: torch.as_tensor(np.asarray(arrays[f"volume.{f}"], np.float32),
                              device=device) for f in _VOLUME[1:]})
    tfn = TransferFunction.create(arrays["tfn.color"], arrays["tfn.alpha"],
                                  arrays["tfn.value_range"], device=device)
    camera = Camera.create(**{f: arrays[f"camera.{f}"] for f in _CAMERA},
                           kind=str(arrays["camera.kind"]), device=device)
    n_extra = len({k.split(".")[1] for k in arrays
                   if k.startswith("lights.")})
    lights = tuple(_light(arrays, f"lights.{i}", device)
                   for i in range(n_extra))
    return Scene.create(volume, tfn, light=_light(arrays, "light", device),
                        camera=camera,
                        volume_sampling_rate=arrays["volume_sampling_rate"],
                        density_scale=arrays["density_scale"], lights=lights)
