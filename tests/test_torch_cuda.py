"""The port's CUDA slice kernel against its plain PyTorch version, on a card.

Marked `cuda`: each test decides inside itself whether a CUDA device
exists and skips without one. The module imports neither JAX nor
`ovr_tpu`, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It also holds the scene and input-capture helpers that
tests/test_torch_swslice.py uses to hold the plain version against the
JAX package's Pallas kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ovr_tpu_torch import api
from ovr_tpu_torch.core.scene import Camera, Light, simple_scene
from ovr_tpu_torch.ops import swslice
from ovr_tpu_torch.render import accel


def _field(n, kind):
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    if kind == "sparse":
        return np.exp(-((x - 0.7) ** 2 + (y - 0.3) ** 2 + (z - 0.6) ** 2)
                      * 120).astype(np.float32)
    return (0.5 + 0.4 * np.sin(9 * x) * np.cos(7 * y) * np.sin(5 * z)
            ).astype(np.float32)


def _grid(g, dtype):
    if dtype == "u8":
        return np.clip(np.round(g * 255), 0, 255).astype(np.uint8)
    if dtype == "bf16":
        return torch.from_numpy(g).to(torch.bfloat16)
    return g


CAMERAS = {
    "persp": dict(from_=(0.5, 0.4, -1.5), at=(0.5, 0.5, 0.5), fovy=40.0),
    "ortho": dict(from_=(0.5, 0.5, -2.0), at=(0.5, 0.5, 0.5), height=1.3,
                  kind="orthographic"),
    "back": dict(from_=(0.45, 0.55, 2.4), at=(0.5, 0.5, 0.5), fovy=40.0),
}


def _scene(kind="smooth", dtype="f32", cam="persp", n=48, n_lights=0,
           device="cpu", opaque=False):
    scene = simple_scene(_grid(_field(n, kind), dtype), device=device)
    if kind == "sparse":
        alpha = np.concatenate([np.zeros(10), np.linspace(0, 0.9, 22)])
    elif opaque:
        alpha = np.linspace(0.5, 1.0, 16)
    else:
        alpha = None
    if alpha is not None:
        scene = dataclasses.replace(scene, tfn=dataclasses.replace(
            scene.tfn, alpha=torch.as_tensor(alpha, dtype=torch.float32,
                                             device=device)))
    lights = tuple(Light.create(direction=(0.4 * i - 0.6, 0.3, -1.0),
                                intensity=0.5 + 0.1 * i, device=device)
                   for i in range(n_lights))
    return dataclasses.replace(
        scene, camera=Camera.create(**CAMERAS[cam], device=device),
        lights=lights)


def capture(scene, shading, fd=True, skip=False, base_rate=1.0,
            width=72, height=56, rate=48.0):
    """The arguments the port's renderer passes to slice_composite."""
    cfg = api.RenderConfig(width=width, height=height, sampling_rate=rate,
                           shading=shading, method="shearwarp",
                           base_rate=base_rate).resolved(scene)
    cfg = dataclasses.replace(cfg, sw=dataclasses.replace(
        cfg.sw, fd_grad=fd))
    mc = (accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                 scene.tfn.value_range) if skip else None)
    seen = {}
    orig = swslice.slice_composite

    def spy(*args, **kw):
        seen.update(args=args, kw=kw)
        return orig(*args, **kw)

    swslice.slice_composite = spy
    try:
        api.render(scene, cfg, macrocells=mc)
    finally:
        swslice.slice_composite = orig
    return seen["args"], seen["kw"]


def run_plain(args, kw, term):
    kw = dict(kw, term=term)
    before = swslice.LAUNCHES
    out = swslice.slice_composite(*args, **kw).numpy()
    assert swslice.LAUNCHES == before  # CPU tensors never launch
    return out


def assert_out_close(a, b, rgb=5e-5, depth=2e-4):
    np.testing.assert_allclose(a[0:6], b[0:6], atol=rgb)
    np.testing.assert_allclose(a[6], b[6], atol=depth)
    np.testing.assert_allclose(a[7], b[7], atol=rgb)


@pytest.mark.cuda
@pytest.mark.parametrize("shading,fd,skip,dtype,cam,n_lights", [
    ("none", True, False, "f32", "persp", 0),
    ("none", True, True, "u8", "back", 0),
    ("diffuse", True, False, "bf16", "persp", 2),
    ("diffuse", False, True, "f32", "ortho", 0),
    ("shadow", True, True, "u8", "persp", 1),
    ("shadow", False, False, "bf16", "back", 0),
])
def test_kernel_matches_plain_on_card(shading, fd, skip, dtype, cam,
                                      n_lights):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = _scene("sparse" if skip else "smooth", dtype, cam,
                   n_lights=n_lights, device="cuda")
    args, kw = capture(scene, shading, fd=fd, skip=skip)
    for term in (False, True):
        before = swslice.LAUNCHES
        out = swslice.slice_composite(*args, **dict(kw, term=term))
        torch.cuda.synchronize()
        assert swslice.LAUNCHES == before + 1
        ref = swslice.slice_composite_plain(*args, **dict(kw, term=term))
        tol = 5e-4 if term else 1e-4
        assert_out_close(out.cpu().numpy(), ref.cpu().numpy(), rgb=tol,
                         depth=5e-4 if not term else 5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shading", ["none", "diffuse", "shadow"])
def test_render_on_card_matches_cpu(shading):
    """`api.render` on the card (the kernel) against the same scene on
    the CPU (the plain version), macrocells and termination on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames = []
    for device in ("cuda", "cpu"):
        scene = _scene("smooth", "f32", "persp", n=48, device=device)
        cfg = api.RenderConfig(width=72, height=56, sampling_rate=48.0,
                               shading=shading, method="auto"
                               ).resolved(scene)
        mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                    scene.tfn.value_range)
        before = swslice.LAUNCHES
        frames.append(api.render(scene, cfg, macrocells=mc))
        assert swslice.LAUNCHES == before + (device == "cuda")
    card, cpu = frames
    for name in ("rgba", "grad", "depth"):
        np.testing.assert_allclose(getattr(card, name).cpu().numpy(),
                                   getattr(cpu, name).numpy(), atol=1e-4)


@pytest.mark.cuda
def test_five_extra_lights_raise_on_card():
    """The kernel has slots for 4 extra directional lights: a shaded
    frame with 5 raises instead of rendering some other way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = _scene("smooth", "f32", "persp", n=16, device="cuda")
    scene = dataclasses.replace(scene, lights=tuple(
        Light.create(direction=(0.1 * i, 0.3, -1.0), device="cuda")
        for i in range(5)))
    cfg = api.RenderConfig(width=32, height=24, sampling_rate=16.0,
                           shading="diffuse", method="auto").resolved(scene)
    before = swslice.LAUNCHES
    with pytest.raises(NotImplementedError, match="slice"):
        api.render(scene, cfg)
    assert swslice.LAUNCHES == before
