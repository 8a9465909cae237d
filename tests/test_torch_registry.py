"""The port's renderer registry (ovr_tpu_torch.registry), on the CPU.

Mirrors tests/test_plugins.py::TestRegistry, and checks that the port
keeps a registry of its own: a JAX-style `ovr_tpu_device_<name>` module
or a registration in the JAX package's registry is never picked up,
while an `ovr_tpu_torch_device_<name>` module registers itself.
"""

import dataclasses
import sys
import types

import pytest

from ovr_tpu import registry as jregistry
from ovr_tpu_torch import api, registry
from ovr_tpu_torch.core.scene import Camera, simple_scene


@pytest.fixture
def scene(small_grid):
    s = simple_scene(small_grid, device="cpu")
    cam = Camera.create(from_=(0.5, 0.5, -1.8), at=(0.5, 0.5, 0.5),
                        device="cpu")
    return dataclasses.replace(s, camera=cam)


@pytest.fixture
def clean_registry(monkeypatch):
    """Registrations made by a test leave with it."""
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))


class TestRegistry:
    def test_builtins_present(self):
        names = registry.available_renderers()
        for n in ("raymarch", "pathtracer", "optix7", "ospray"):
            assert n in names

    def test_create_builtin(self, scene):
        cfg = api.RenderConfig(width=16, height=16, sampling_rate=8.0,
                               shading="none")
        r = registry.create_renderer("raymarch", scene, cfg=cfg)
        assert isinstance(r, api.Renderer)
        pt = registry.create_renderer("pathtracer", scene, cfg=cfg)
        assert pt._cfg.path_tracing and not r._cfg.path_tracing

    def test_register_and_resolve_custom(self, scene, clean_registry):
        calls = []

        @registry.register_renderer("testdev")
        def make(sc, **kw):
            calls.append(sc)
            return "sentinel"

        assert registry.create_renderer("testdev", scene) == "sentinel"
        assert calls == [scene]

    def test_unknown_raises(self, scene):
        with pytest.raises(KeyError):
            registry.create_renderer("no_such_device", scene)


def test_jax_plugins_never_load(scene, monkeypatch, clean_registry):
    """A JAX plugin module planted in sys.modules under the JAX package's
    prefix (its import registered its factory in the JAX package's
    registry) stays unseen: the port imports no `ovr_tpu_device_*`
    module and raises for the name."""
    import importlib
    plugin = types.ModuleType("ovr_tpu_device_jaxonly")
    monkeypatch.setitem(sys.modules, plugin.__name__, plugin)
    monkeypatch.setitem(jregistry._REGISTRY, "jaxonly", lambda s, **k: 1)
    asked = []
    real_import = importlib.import_module

    def spy(name, *a, **k):
        asked.append(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(importlib, "import_module", spy)
    with pytest.raises(KeyError):
        registry.create_renderer("jaxonly", scene)
    assert asked == ["ovr_tpu_torch_device_jaxonly"]
    assert "jaxonly" not in registry.available_renderers()


def test_port_plugin_module_registers_itself(scene, monkeypatch,
                                             clean_registry):
    """`create_renderer("mydev")` imports `ovr_tpu_torch_device_mydev`,
    whose import registers the factory (the device_<name> library
    load)."""
    mod = types.ModuleType("ovr_tpu_torch_device_mydev")
    loaded = []

    def load(name, *a, **k):
        if name == mod.__name__:
            registry.register_renderer("mydev", lambda s, **kw: ("mine", s))
            loaded.append(name)
            return mod
        return real_import(name, *a, **k)

    import importlib
    real_import = importlib.import_module
    monkeypatch.setattr(importlib, "import_module", load)
    assert registry.create_renderer("mydev", scene) == ("mine", scene)
    assert loaded == ["ovr_tpu_torch_device_mydev"]
