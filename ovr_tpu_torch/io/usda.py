"""USDA scene-settings reader (the port's copy of `ovr_tpu.io.usda`).

The reference's optional USD serializer (`ovr/serializer/serializer_usda.cpp`,
behind OVR_BUILD_SCENE_USD) reads a small USDA overlay like
`data/scene_setting.usda`: rendering flags, a `data_path` pointing at a JSON
scene, and camera/light overrides. This is a dependency-free parser for that
subset of the USDA text format (typed attributes `int/bool/float/float3/
string` inside nested `def "name" { ... }` scopes, `#` comments), plus
`create_scene_usda` which loads the referenced JSON scene and applies the
overrides.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any

import numpy as np

from ovr_tpu_torch.core.scene import (Camera, GeometryInstance, Light,
                                      Material, TriangleMesh)
from ovr_tpu_torch.io.image import load_exr

_TOKEN = re.compile(
    r'"(?:[^"\\]|\\.)*"'      # quoted string
    r"|[{}()=,]"              # punctuation
    r"|\[\]"                  # array-type suffix (kept attached below)
    r"|[\[\]]"                # array brackets
    r"|[^\s{}()=,\[\]\"]+"    # bare word / number
)


def _join_array_types(toks: list[str]) -> list[str]:
    """Re-attach `[]` to its preceding type keyword (`float3 []` ->
    `float3[]`) so the scope parser sees one token."""
    out: list[str] = []
    for t in toks:
        if t == "[]" and out and out[-1].rstrip("[]") in _TYPES:
            out[-1] = out[-1] + "[]"
        elif t == "[]":
            out.extend(["[", "]"])
        else:
            out.append(t)
    return out


def _tokenize(text: str) -> list[str]:
    out = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        out.extend(_TOKEN.findall(line))
    return _join_array_types(out)


def _parse_value(toks: list[str], i: int) -> tuple[Any, int]:
    t = toks[i]
    if t == "[":  # array of values (numbers or tuples)
        vals = []
        i += 1
        while toks[i] != "]":
            if toks[i] == ",":
                i += 1
                continue
            v, i = _parse_value(toks, i)
            vals.append(v)
        return vals, i + 1
    if t == "(":  # tuple of numbers
        vals = []
        i += 1
        while toks[i] != ")":
            if toks[i] == ",":
                i += 1
                continue
            vals.append(float(toks[i]))
            i += 1
        return tuple(vals), i + 1
    if t.startswith('"'):
        return t[1:-1], i + 1
    low = t.lower()
    if low in ("true", "false"):
        return low == "true", i + 1
    try:
        return int(t), i + 1
    except ValueError:
        try:
            return float(t), i + 1
        except ValueError:
            return t, i + 1


_TYPES = {"int", "bool", "float", "double", "float3", "double3", "string",
          "token", "int3", "float2", "point3f", "color3f", "normal3f",
          "texCoord2f", "asset"}


def _parse_scope(toks: list[str], i: int) -> tuple[dict, int]:
    """Parse `{ ... }` starting at the `{` token; returns (dict, next_i)."""
    assert toks[i] == "{", toks[i]
    i += 1
    scope: dict[str, Any] = {}
    while toks[i] != "}":
        if toks[i] == "def":
            # def [Type] "name" { ... }
            i += 1
            if not toks[i].startswith('"'):
                i += 1  # optional prim type
            name = toks[i][1:-1]
            i += 1
            sub, i = _parse_scope(toks, i)
            scope[name] = sub
        elif toks[i].rstrip("[]") in _TYPES:
            i += 1  # attribute type keyword (arrays: `float3[]` etc.)
            name = toks[i]
            i += 1
            assert toks[i] == "=", f"expected '=' after {name}"
            val, i = _parse_value(toks, i + 1)
            scope[name] = val
        else:  # untyped `name = value`
            name = toks[i]
            i += 1
            assert toks[i] == "=", f"unexpected token {name!r}"
            val, i = _parse_value(toks, i + 1)
            scope[name] = val
    return scope, i + 1


def parse_usda(text: str) -> dict:
    """Parse a USDA document (the settings subset) into nested dicts."""
    toks = _tokenize(text)
    if toks and toks[0] == "#usda":  # magic may survive comment stripping
        toks = toks[2:]
    root: dict[str, Any] = {}
    i = 0
    while i < len(toks):
        if toks[i] == "def":
            i += 1
            if not toks[i].startswith('"'):
                i += 1
            name = toks[i][1:-1]
            i += 1
            sub, i = _parse_scope(toks, i)
            root[name] = sub
        else:
            i += 1
    return root


def create_scene_usda(filename: str, device="cuda"):
    """Load a USDA settings file: resolve its volume.data_path JSON scene,
    then apply camera and light overrides (serializer_usda.cpp semantics).
    Every tensor lands on `device`.

    Returns (scene, settings_dict); settings_dict carries the `rendering`
    flags (use_dda, parallel_view, simple_path_tracing) for the caller.
    """
    from ovr_tpu_torch.io.vidi3d import create_scene

    with open(filename) as f:
        doc = parse_usda(f.read())
    sc = doc.get("scene", doc)
    vol = sc.get("volume", {})
    data_path = vol.get("data_path")
    if not data_path:
        raise ValueError(f"{filename}: no scene.volume.data_path")
    if not os.path.isabs(data_path):
        data_path = os.path.join(os.path.dirname(filename) or ".", data_path)
    scene = create_scene(data_path, device=device)

    cam = sc.get("camera")
    if cam and all(k in cam for k in ("from", "at", "up")):
        old = scene.camera
        scene = dataclasses.replace(scene, camera=Camera.create(
            from_=cam["from"], at=cam["at"], up=cam["up"],
            fovy=old.fovy, height=old.height, kind=old.kind, device=device))

    light = sc.get("light", {})
    directional = light.get("directional", {})
    ambient = light.get("ambient", {})
    first_dir = next(iter(directional.values()), None)
    first_amb = next(iter(ambient.values()), None)
    if first_dir or first_amb:
        direction = scene.light.direction
        color = scene.light.color
        amb = scene.light.ambient
        if first_dir:
            d = first_dir.get("direction")
            if d is not None:
                # USD lights point *along* `direction`; our Light.direction
                # points *toward* the light
                direction = tuple(-x for x in d)
            c = first_dir.get("color")
            k = float(first_dir.get("intensity", 1.0))
            if c is not None:
                color = tuple(x * k for x in c)
        if first_amb:
            amb = float(first_amb.get("intensity", 1.0))
        scene = dataclasses.replace(scene, light=Light.create(
            direction=direction, color=color, ambient=amb, device=device))

    geoms = _parse_meshes(sc, os.path.dirname(filename) or ".", device)
    if geoms:
        scene = dataclasses.replace(
            scene, geometries=tuple(scene.geometries) + tuple(geoms))

    return scene, sc.get("rendering", {})


def _load_texture(path: str):
    """Load a map_kd texture: .exr (dependency-free reader), .npy, or
    PNG/JPG via PIL when available. Returns (H, W, 3) float32 in [0,1]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        img = np.asarray(load_exr(path), np.float32)
    elif ext == ".npy":
        img = np.load(path).astype(np.float32)
    else:
        from PIL import Image  # PNG/JPG textures need PIL
        img = np.asarray(Image.open(path), np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


def _parse_meshes(sc: dict, base_dir: str, device="cuda"):
    """Collect Mesh prims (a USD Mesh subset: `points`,
    `faceVertexIndices` triangles, optional `primvars:st` texcoords, a
    sibling material's `diffuseColor`/`opacity` and `map_kd` texture path
    — the reference's OBJ material with a diffuse map,
    `ovr/scene.h:266-282`, `ovr/devices/ospray/device_impl.cpp:274-295`)
    as the port's `TriangleMesh` / `GeometryInstance` on `device`."""
    geoms = []
    for name, g in sc.items():
        if not (isinstance(g, dict) and "points" in g
                and "faceVertexIndices" in g):
            continue
        verts = np.asarray(g["points"], np.float32)
        faces = np.asarray(g["faceVertexIndices"], np.int32).reshape(-1, 3)
        uvs = None
        st = g.get("primvars:st", g.get("primvars_st", g.get("st")))
        if st is not None:
            uvs = np.asarray(st, np.float32)
        map_kd = None
        tex = g.get("map_kd")
        if tex:
            p = tex if os.path.isabs(tex) else os.path.join(base_dir, tex)
            map_kd = _load_texture(p)
        mat = Material.create(
            kd=tuple(g.get("diffuseColor", (0.8, 0.8, 0.8))),
            ks=tuple(g.get("specularColor", (0.0, 0.0, 0.0))),
            ns=float(g.get("shininess", 10.0)),
            d=float(g.get("opacity", 1.0)), map_kd=map_kd, device=device)
        mesh = TriangleMesh.create(verts, faces, uvs=uvs, device=device)
        geoms.append(GeometryInstance.create(mesh, mat, device=device))
    return geoms
