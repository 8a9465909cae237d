"""Scene model as frozen dataclasses of torch tensors.

Port of `ovr_tpu.core.scene`: the same classes, fields and defaults, with
tensors in place of JAX arrays and an explicit `device` on every
constructor (default "cuda"; tests pass "cpu"). World convention: a
structured volume occupies the axis-aligned box [world_lo, world_hi];
sampling coordinates inside it are normalized to [0,1]^3 like a CUDA 3D
texture with clamp addressing.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

PERSPECTIVE = "perspective"
ORTHOGRAPHIC = "orthographic"

_NATIVE_INT = (torch.uint8, torch.uint16)


def volume_device(volume) -> torch.device:
    """The device of a structured volume's grid or of a neural field's
    tables."""
    grid = getattr(volume, "grid", None)
    return volume.tables.device if grid is None else grid.device


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Look-at camera. `fovy` is the vertical field of view in degrees
    (perspective); `height` is the world-space image-plane height
    (orthographic)."""

    from_: torch.Tensor  # (3,)
    at: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    fovy: torch.Tensor  # ()
    height: torch.Tensor  # ()
    kind: str = PERSPECTIVE

    @staticmethod
    def create(from_, at, up=(0.0, 1.0, 0.0), fovy=60.0, height=1.0,
               kind: str = PERSPECTIVE, device="cuda") -> "Camera":
        return Camera(from_=_f32(from_, device), at=_f32(at, device),
                      up=_f32(up, device), fovy=_f32(fovy, device),
                      height=_f32(height, device), kind=kind)


@dataclasses.dataclass(frozen=True)
class TransferFunction:
    """1D transfer function: color (Nc, 3) and opacity (Na,) nodal tables
    over `value_range` (2,), in normalized sample units."""

    color: torch.Tensor
    alpha: torch.Tensor
    value_range: torch.Tensor

    @staticmethod
    def create(color, alpha, value_range=(0.0, 1.0),
               device="cuda") -> "TransferFunction":
        color = _f32(color, device)
        if color.ndim == 2 and color.shape[1] == 4:
            color = color[:, :3]
        return TransferFunction(color=color, alpha=_f32(alpha, device),
                                value_range=_f32(value_range, device))

    @property
    def resolution(self) -> int:
        return self.alpha.shape[0]


@dataclasses.dataclass(frozen=True)
class StructuredVolume:
    """A structured-regular scalar grid (Z, Y, X) in a world-space box.

    float32 and bfloat16 grids stay as they are; uint8 and uint16 grids
    stay native and sample as normalized integers (raw / int_max).
    `data_range` is the grid's actual (min, max) in normalized units."""

    grid: torch.Tensor
    world_lo: torch.Tensor
    world_hi: torch.Tensor
    data_range: torch.Tensor

    @staticmethod
    def create(grid, world_lo=(0.0, 0.0, 0.0), world_hi=(1.0, 1.0, 1.0),
               data_range=None, device="cuda") -> "StructuredVolume":
        if not isinstance(grid, torch.Tensor):
            grid = torch.from_numpy(np.ascontiguousarray(grid))
        if grid.dtype in _NATIVE_INT:
            grid = grid.to(device)
            scale = 1.0 / float(torch.iinfo(grid.dtype).max)
        elif grid.dtype == torch.bfloat16:
            grid = grid.to(device)
            scale = 1.0
        else:
            grid = grid.to(device=device, dtype=torch.float32)
            scale = 1.0
        if data_range is None:
            # uint16 has no min/max kernels; float32 holds it exactly
            g = grid.float() if grid.dtype == torch.uint16 else grid
            data_range = (float(g.min()) * scale, float(g.max()) * scale)
        return StructuredVolume(grid=grid, world_lo=_f32(world_lo, device),
                                world_hi=_f32(world_hi, device),
                                data_range=_f32(data_range, device))

    @property
    def dims(self) -> tuple[int, int, int]:
        """(X, Y, Z) dims."""
        z, y, x = self.grid.shape
        return (x, y, z)


@dataclasses.dataclass(frozen=True)
class Material:
    """OBJ-style surface material: `kd` diffuse RGB, `ks` specular RGB,
    `ns` shininess, `d` opacity; `map_kd` an optional (H, W, 3) diffuse
    texture sampled at the mesh's per-vertex UVs (None: untextured)."""

    kd: torch.Tensor  # (3,)
    ks: torch.Tensor  # (3,)
    ns: torch.Tensor  # ()
    d: torch.Tensor  # ()
    map_kd: Any = None  # (H, W, 3) or None

    @staticmethod
    def create(kd=(0.8, 0.8, 0.8), ks=(0.0, 0.0, 0.0), ns=10.0, d=1.0,
               map_kd=None, device="cuda") -> "Material":
        return Material(kd=_f32(kd, device), ks=_f32(ks, device),
                        ns=_f32(ns, device), d=_f32(d, device),
                        map_kd=None if map_kd is None
                        else _f32(map_kd, device))


@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    """Indexed triangle mesh: verts (V, 3), faces (F, 3) int64, per-vertex
    colors (V, 3) (ones: the material's kd alone) and uvs (V, 2) (zeros:
    no texture coordinates)."""

    verts: torch.Tensor
    faces: torch.Tensor
    colors: torch.Tensor
    uvs: torch.Tensor

    @staticmethod
    def create(verts, faces, colors=None, uvs=None,
               device="cuda") -> "TriangleMesh":
        verts = _f32(verts, device)
        colors = (torch.ones_like(verts) if colors is None
                  else _f32(colors, device))
        if uvs is None:
            uvs = torch.zeros((verts.shape[0], 2), device=device)
        uvs = _f32(uvs, device)
        faces = (faces.to(device=device, dtype=torch.int64)
                 if isinstance(faces, torch.Tensor) else torch.as_tensor(
                     np.asarray(faces, np.int64), device=device))
        return TriangleMesh(verts=verts, faces=faces, colors=colors, uvs=uvs)


@dataclasses.dataclass(frozen=True)
class Isosurface:
    """Isosurfaces of the scene's volume at `isovalues` (K,), in
    normalized TF coordinates [0, 1]."""

    isovalues: torch.Tensor

    @staticmethod
    def create(isovalues, device="cuda") -> "Isosurface":
        iso = _f32(isovalues, device)
        return Isosurface(isovalues=iso.reshape(-1))


@dataclasses.dataclass(frozen=True)
class GeometryInstance:
    """A geometry and its material placed by `xfm`, a (3, 4) object-to-
    world affine [R | t]: rays go world -> object for the intersection,
    normals object -> world by R^-T. `kind` is "triangles" or
    "isosurface"."""

    geometry: Any  # TriangleMesh | Isosurface
    material: Material
    xfm: torch.Tensor  # (3, 4)
    kind: str = "triangles"

    @staticmethod
    def create(geometry, material=None, xfm=None,
               device="cuda") -> "GeometryInstance":
        if material is None:
            material = Material.create(device=device)
        if xfm is None:
            xfm = torch.cat([torch.eye(3, device=device),
                             torch.zeros((3, 1), device=device)], dim=1)
        xfm = _f32(xfm, device)
        kind = ("isosurface" if isinstance(geometry, Isosurface)
                else "triangles")
        return GeometryInstance(geometry=geometry, material=material,
                                xfm=xfm, kind=kind)


@dataclasses.dataclass(frozen=True)
class Light:
    """A scene light. `direction` points toward the light; `position` is
    used by point lights. The primary light shades with implicit
    intensity 2."""

    direction: torch.Tensor
    color: torch.Tensor
    ambient: torch.Tensor
    position: torch.Tensor
    intensity: torch.Tensor
    kind: str = "directional"  # directional | point | ambient | sunsky

    @staticmethod
    def create(direction=(-907.108, 2205.875, -400.0267),
               color=(1.0, 1.0, 1.0), ambient=1.0,
               position=(0.0, 0.0, 0.0), intensity=1.0,
               kind: str = "directional", device="cuda") -> "Light":
        return Light(direction=_f32(direction, device),
                     color=_f32(color, device),
                     ambient=_f32(ambient, device),
                     position=_f32(position, device),
                     intensity=_f32(intensity, device), kind=kind)


@dataclasses.dataclass(frozen=True)
class Scene:
    """One volume (structured, or a `neural.NeuralFieldVolume`), its
    transfer function, the primary light, extra lights and a default
    camera; `geometries` (GeometryInstance) are surfaces the volume
    composites over, `instances` (VolumeInstance) more volumes beside
    the primary one."""

    volume: StructuredVolume
    tfn: TransferFunction
    light: Light
    camera: Camera
    volume_sampling_rate: torch.Tensor
    density_scale: torch.Tensor
    geometries: tuple = ()
    lights: tuple = ()
    instances: tuple = ()

    @staticmethod
    def create(volume, tfn, light=None, camera=None,
               volume_sampling_rate=1.0, density_scale=1.0, geometries=(),
               lights=(), instances=()) -> "Scene":
        device = volume_device(volume)
        if light is None:
            light = Light.create(device=device)
        if camera is None:
            camera = Camera.create(from_=(0.0, 0.0, -2.0),
                                   at=(0.5, 0.5, 0.5), device=device)
        return Scene(volume=volume, tfn=tfn, light=light, camera=camera,
                     volume_sampling_rate=_f32(volume_sampling_rate, device),
                     density_scale=_f32(density_scale, device),
                     geometries=tuple(geometries), lights=tuple(lights),
                     instances=tuple(instances))

    @property
    def device(self) -> torch.device:
        return volume_device(self.volume)


@dataclasses.dataclass(frozen=True)
class VolumeInstance:
    """A structured volume and its transfer function placed in the world.
    `xfm`: an optional (3, 4) object-to-world affine [R | t] on top of
    the volume's own box (None: axis-aligned). Rays go world -> object
    with the direction left unnormalized, so t, step lengths and depth
    stay in world units."""

    volume: StructuredVolume
    tfn: TransferFunction
    xfm: Any = None  # (3, 4) or None

    @staticmethod
    def create(volume, tfn, xfm=None) -> "VolumeInstance":
        if xfm is not None:
            xfm = _f32(xfm, volume_device(volume))
        return VolumeInstance(volume=volume, tfn=tfn, xfm=xfm)


def simple_scene(grid, color=None, alpha=None, value_range=None,
                 device="cuda", **kw: Any) -> Scene:
    """Volume + default 16-node transfer function (tests and examples)."""
    volume = StructuredVolume.create(grid, device=device)
    if color is None:
        color = np.stack([np.linspace(0, 1, 16), 0.5 * np.ones(16),
                          np.linspace(1, 0, 16)], -1)
    if alpha is None:
        alpha = np.linspace(0.0, 1.0, 16)
    if value_range is None:
        value_range = volume.data_range
    tfn = TransferFunction.create(color, alpha, value_range,
                                  device=volume.grid.device)
    return Scene.create(volume, tfn, **kw)
