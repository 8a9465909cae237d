"""Renderer plugin registry (port of `ovr_tpu.registry`).

The reference's dlopen plugin loader (`ovr/common/dylink/Library.h:107-174`,
`ObjectFactory.h:36-69`, used by `create_renderer`,
`ovr/renderer.cpp:42-61`): out-of-tree renderer backends register a
factory under a name, and `create_renderer(name)` resolves it — falling
back to importing `ovr_tpu_torch_device_<name>` (the Python analogue of
loading the `device_<name>` shared library) and to `importlib.metadata`
entry points in the ``ovr_tpu_torch.renderers`` group (the
`OVR_REGISTER_OBJECT` macro analogue, `ObjectFactory.h:77-86`).

The registry, the module prefix and the group are the port's own, so a
plugin written for the JAX package (`ovr_tpu_device_<name>`, the
``ovr_tpu.renderers`` group) never loads into the port.

A factory is any callable ``(scene, cfg=...) -> renderer`` returning an
object with the `api.Renderer` surface (setters / commit / render /
mapframe).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_renderer(name: str, factory: Callable | None = None):
    """Register a renderer factory; usable as a decorator.

    >>> @register_renderer("myrenderer")
    ... def make(scene, **kw): ...
    """
    if factory is None:
        def deco(f):
            _REGISTRY[name] = f
            return f
        return deco
    _REGISTRY[name] = factory
    return factory


def available_renderers() -> list[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def _make(scene, cfg=None, **kw):
    from ovr_tpu_torch import api
    return api.Renderer(scene, cfg or api.RenderConfig(**kw))


def _make_pt(scene, cfg=None, **kw):
    from ovr_tpu_torch import api
    c = cfg or api.RenderConfig(**kw)
    return api.Renderer(scene, dataclasses.replace(c, path_tracing=True))


def _ensure_builtins() -> None:
    _REGISTRY.setdefault("raymarch", _make)
    _REGISTRY.setdefault("pathtracer", _make_pt)
    # reference device names map onto the native renderer
    # (renderer.cpp:42-61 accepts "optix7" / "ospray")
    _REGISTRY.setdefault("optix7", _make)
    _REGISTRY.setdefault("ospray", _make)


def create_renderer(name: str, scene, **kw):
    """Resolve `name` to a factory and build a renderer for `scene`.

    Resolution order mirrors `create_renderer` (`renderer.cpp:42-61`):
    built-ins, explicit registrations, the `ovr_tpu_torch_device_<name>`
    module convention, then entry points.
    """
    _ensure_builtins()
    if name in _REGISTRY:
        return _REGISTRY[name](scene, **kw)
    # "load device_<name>" analogue: import a module that registers itself
    try:
        importlib.import_module(f"ovr_tpu_torch_device_{name}")
    except ImportError:
        pass
    if name in _REGISTRY:
        return _REGISTRY[name](scene, **kw)
    from importlib.metadata import entry_points
    for ep in entry_points(group="ovr_tpu_torch.renderers"):
        if ep.name == name:
            _REGISTRY[name] = ep.load()
            return _REGISTRY[name](scene, **kw)
    raise KeyError(
        f"unknown renderer {name!r}; available: {available_renderers()}")
