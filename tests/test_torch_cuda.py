"""The port's CUDA slice kernel against its plain PyTorch version, and
the march on the card against the march on the CPU, on a card.

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

from chip_smoke import (HOOK_CASES, MARCH_CASES, PlainCalls,
                        bf16_frame_rule, capture_gather, field, hook_capture,
                        make_scene, march_scene, multivol_scene, with_iso,
                        with_sphere)
from ovr_tpu_torch import api
from ovr_tpu_torch.core.scene import Camera, Light, simple_scene
from ovr_tpu_torch.ops import adjoint, swslice
from ovr_tpu_torch.render import accel, ptdense, shearwarp


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
    if dtype == "u16":
        return np.clip(np.round(g * 65535), 0, 65535).astype(np.uint16)
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
           device="cpu", opaque=False, n_points=0):
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
    lights += tuple(Light.create(kind="point", position=(0.5 + i, 1.8, 0.4),
                                 intensity=1.2 - 0.3 * i, device=device)
                    for i in range(n_points))
    return dataclasses.replace(
        scene, camera=Camera.create(**CAMERAS[cam], device=device),
        lights=lights)


def capture(scene, shading, fd=True, skip=False, base_rate=1.0,
            width=72, height=56, rate=48.0, bf16=False):
    """The arguments the port's renderer passes to slice_composite."""
    cfg = api.RenderConfig(width=width, height=height, sampling_rate=rate,
                           shading=shading, method="shearwarp",
                           base_rate=base_rate, sw_bf16=bf16).resolved(scene)
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
    ("none", True, True, "u16", "persp", 0),
    ("diffuse", False, False, "u16", "back", 3),
    ("shadow", True, True, "u16", "ortho", 1),
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
        # the counting variant: the same result, planes per block and
        # samples per pixel as the plain version counts them
        got, want = _counts(args), _counts(args)
        stages = torch.zeros(2, dtype=torch.int32, device="cuda")
        out_c = swslice.slice_composite(*args, **dict(kw, term=term, **got),
                                        stage_counts=stages)
        swslice.slice_composite_plain(*args, **dict(kw, term=term, **want))
        assert torch.equal(out_c, out)
        for k in got:
            assert torch.equal(got[k], want[k])
        assert int(stages.sum()) >= int(got["block_planes"].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("shading,fd,dtype,cam,n,lights,bf16", [
    ("none", True, "f32", "persp", 32, (0, 0), True),
    ("diffuse", True, "f32", "back", 24, (6, 0), True),
    ("diffuse", False, "u8", "ortho", 48, (1, 2), True),
    ("shadow", True, "bf16", "persp", 48, (2, 1), True),
    ("diffuse", True, "f32", "persp", 48, (6, 1), False),
    ("shadow", False, "u8", "back", 48, (0, 2), False),
    ("diffuse", True, "u16", "persp", 32, (2, 1), True),
    ("shadow", False, "u16", "ortho", 24, (0, 0), True),
    ("diffuse", False, "u16", "back", 48, (1, 2), False),
])
def test_bf16_and_light_table_match_plain_on_card(shading, fd, dtype, cam, n,
                                                  lights, bf16):
    """The bf16 variant (an f32 grid of 32 rows read as bf16, of 24 rows
    as f32) and the light table, with termination on and off, against the
    plain version on the card: the same bits, the counting variant
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = _scene("smooth", dtype, cam, n=n, n_lights=lights[0],
                   n_points=lights[1], device="cuda")
    args, kw = capture(scene, shading, fd=fd, skip=True, bf16=bf16)
    assert kw["bf16"] == bf16
    for term in (False, True):
        before = swslice.LAUNCHES_BF16
        out = swslice.slice_composite(*args, **dict(kw, term=term))
        torch.cuda.synchronize()
        assert swslice.LAUNCHES_BF16 == before + bf16
        ref = swslice.slice_composite_plain(*args, **dict(kw, term=term))
        assert torch.equal(out, ref)
        got, want = _counts(args), _counts(args)
        out_c = swslice.slice_composite(*args, **dict(kw, term=term, **got))
        swslice.slice_composite_plain(*args, **dict(kw, term=term, **want))
        assert torch.equal(out_c, out)
        for k in got:
            assert torch.equal(got[k], want[k])


def _counts(args):
    """Zeroed block_planes and pixel_samples for slice_composite."""
    hi, wi = args[4].shape[0], args[3].shape[0]
    n_blocks = (-(-hi // swslice.BLOCK_ROWS)
                * -(-wi // swslice.BLOCK_COLS))
    z = dict(dtype=torch.int32, device=args[0].device)
    return dict(block_planes=torch.zeros(n_blocks, **z),
                pixel_samples=torch.zeros((hi, wi), **z))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16", "u8", "u16"])
def test_early_termination_leaves_no_error(dtype):
    """Blocks that stop early leave no copy in flight: an opaque frame
    whose blocks terminate synchronizes without an error, and every one
    of many launches gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = _scene("smooth", dtype, "persp", n=64, opaque=True,
                   device="cuda")
    args, kw = capture(scene, "diffuse", base_rate=32.0, width=240,
                       height=180, rate=64.0)
    kw = dict(kw, term=True)
    planes = _counts(args)["block_planes"]
    first = swslice.slice_composite(*args, **kw, block_planes=planes)
    torch.cuda.synchronize()
    assert int(planes.min()) < args[6] // 2  # blocks did stop early
    for _ in range(20):
        assert torch.equal(swslice.slice_composite(*args, **kw), first)
    torch.cuda.synchronize()
    ref = swslice.slice_composite_plain(*args, **kw)
    assert_out_close(first.cpu().numpy(), ref.cpu().numpy(), rgb=5e-4,
                     depth=5e-3)


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
@pytest.mark.parametrize("method", ["auto", "march"])
def test_u16_render_on_card_matches_cpu(method):
    """A u16 grid on the card: the shadow lattice `render` builds (the
    per-point shadow march, `sample_volume`), the slice kernel or the
    march, and the bricks of its volume, against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ovr_tpu_torch.parallel import bricks
    frames, split = [], []
    for device in ("cuda", "cpu"):
        scene = _scene("smooth", "u16", "persp", n=48, device=device)
        cfg = api.RenderConfig(width=72, height=56, sampling_rate=48.0,
                               shading="shadow", method=method
                               ).resolved(scene)
        before = swslice.LAUNCHES
        frames.append(api.render(scene, cfg))
        assert swslice.LAUNCHES == before + (device == "cuda"
                                             and method == "auto")
        split.append(bricks.brick_volume(scene.volume, 2).bricks)
    assert split[0].dtype == torch.uint16
    assert torch.equal(split[0].cpu().view(torch.int16),
                       split[1].view(torch.int16))
    for name in ("rgba", "grad", "depth"):
        np.testing.assert_allclose(getattr(frames[0], name).cpu().numpy(),
                                   getattr(frames[1], name).numpy(),
                                   atol=1e-4)


def frame_grads(scene, cfg, macrocells=None, light_grid=None):
    """Gradients of mean(rgba^2) + mean(grad^2) of one `api.render` frame
    with respect to the grid, the TF's alpha and colour and its value
    range."""
    vals = {k: getattr(scene.tfn, k).clone().requires_grad_(True)
            for k in ("alpha", "color", "value_range")}
    grid = scene.volume.grid.clone().requires_grad_(True)
    scene = dataclasses.replace(
        scene, volume=dataclasses.replace(scene.volume, grid=grid),
        tfn=dataclasses.replace(scene.tfn, **vals))
    frame = api.render(scene, cfg, macrocells=macrocells,
                       light_grid=light_grid)
    ((frame.rgba ** 2).mean() + (frame.grad ** 2).mean()).backward()
    return dict(grid=grid.grad, **{k: v.grad for k, v in vals.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("shading,cam", [("none", "persp"),
                                         ("diffuse", "ortho"),
                                         ("shadow", "persp")])
def test_backward_on_card_matches_cpu(shading, cam):
    """The frame's gradients with the kernel forward and the adjoint on
    the card against the same on the CPU (plain forward, same adjoint),
    macrocells on: within 1e-3 of the largest element. The kernel
    launches once per frame and the plain version never sees a CUDA
    tensor. (Seen from behind, +z, this scene's TF nodes of zero opacity
    have a gradient that moves by 1.6e-3 of its largest element when the
    eye moves by 3e-7 of its distance: the card's and the CPU's rounding
    of the camera basis differ by that much, so that view is left out.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    grads = []
    for device in ("cuda", "cpu"):
        scene = _scene("sparse", "f32", cam, n=48, device=device)
        cfg = api.RenderConfig(width=72, height=56, sampling_rate=48.0,
                               shading=shading, method="shearwarp"
                               ).resolved(scene)
        mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                    scene.tfn.value_range)
        before = swslice.LAUNCHES
        with PlainCalls() as plain:
            grads.append(frame_grads(scene, cfg, mc))
        assert swslice.LAUNCHES == before + (device == "cuda")
        assert plain.n == 0
    card, cpu = grads
    for k, want in cpu.items():
        got = card[k].cpu().float()
        scale = float(want.abs().max())
        assert scale > 0 and torch.isfinite(got).all()
        assert float((got - want.float()).abs().max()) <= 1e-3 * scale, k


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["five_lights", "point_light", "sw_bf16"])
def test_former_raises_render_on_card(what):
    """Five extra directional lights, a point light and sw_bf16, which
    raised until the light table and the bf16 variant were ported: the
    frame launches the kernel once on the card (its bf16 variant for
    sw_bf16), never the plain version, and matches the CPU's within
    1e-4. Under sw_bf16 the warp rounds the image to bf16, so a value
    that the card's and the CPU's torch ops put on either side of a
    rounding tie differs by a bf16 ulp on the screen: there at most 2.5%
    of the values may exceed 1e-4, none 2e-2 (one ulp of a depth in
    [2, 4) is 1.6e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = []
    for device in ("cuda", "cpu"):
        scene = _scene("smooth", "f32", "persp", n=32, device=device,
                       n_lights=5 if what == "five_lights" else 0,
                       n_points=int(what == "point_light"))
        cfg = api.RenderConfig(width=48, height=40, sampling_rate=32.0,
                               shading="diffuse", method="auto",
                               sw_bf16=what == "sw_bf16").resolved(scene)
        n0, b0 = swslice.LAUNCHES, swslice.LAUNCHES_BF16
        with PlainCalls() as plain:
            frames.append(api.render(scene, cfg))
        on_card = device == "cuda"
        assert swslice.LAUNCHES == n0 + on_card and plain.n == 0
        assert swslice.LAUNCHES_BF16 == b0 + (on_card and what == "sw_bf16")
    card, cpu = frames
    d = np.concatenate([np.abs(getattr(card, k).cpu().numpy()
                               - getattr(cpu, k).numpy()).ravel()
                        for k in ("rgba", "grad", "depth")])
    if what == "sw_bf16":
        assert (d > 1e-4).mean() <= 0.025 and d.max() <= 2e-2
    else:
        assert d.max() <= 1e-4


def _march_frame(kind, cam, shading, lattice, device, **kw):
    grid = field(48, kind, torch.device("cuda")).to(device)
    scene = march_scene(grid, kind, cam)
    cfg = api.RenderConfig(
        width=64, height=48, sampling_rate=48.0, shading=shading,
        method="auto" if cam == "wide" else "march", shadow_grid=lattice,
        use_macrocells=True, adaptive_scale=4.0, jitter_rays=True,
        **kw).resolved(scene)
    assert cfg.sw is None
    mc = accel.build_macrocells(grid, scene.tfn.alpha, scene.tfn.value_range)
    last = dataclasses.replace(scene.camera,
                               from_=scene.camera.from_ + 0.02)
    return api.render(scene, cfg, macrocells=mc, last_camera=last,
                      generator=torch.Generator().manual_seed(3))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cam,shading,lattice",
                         [MARCH_CASES[i] for i in (1, 3, 5, 6)])
def test_march_on_card_matches_cpu(kind, cam, shading, lattice):
    """The march on the card against the CPU (chip_smoke.py's phase (a)
    cases at 48^3); the frame stays on the card; chunked rays give the
    whole frame's bits there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = _march_frame(kind, cam, shading, lattice, "cuda")
    cpu = _march_frame(kind, cam, shading, lattice, "cpu")
    for name, tol in (("rgba", 1e-4), ("grad", 1e-4), ("depth", 5e-4),
                      ("flow", 5e-4)):
        assert getattr(card, name).is_cuda
        np.testing.assert_allclose(getattr(card, name).cpu().numpy(),
                                   getattr(cpu, name).numpy(), atol=tol)
    chunked = _march_frame(kind, cam, shading, lattice, "cuda",
                           ray_chunk=1000)
    for name in ("rgba", "grad", "depth", "flow"):
        assert torch.equal(getattr(chunked, name), getattr(card, name))


@pytest.mark.cuda
def test_march_while_raises_under_grad_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = _scene("smooth", "f32", "persp", n=16, device="cuda")
    grid = scene.volume.grid.clone().requires_grad_(True)
    scene = dataclasses.replace(scene, volume=dataclasses.replace(
        scene.volume, grid=grid))
    cfg = api.RenderConfig(width=16, height=12, sampling_rate=16.0,
                           shading="diffuse", fast_math=True).resolved(scene)
    with pytest.raises(RuntimeError, match="forward-only"):
        api.render(scene, cfg)
    with torch.no_grad():
        assert api.render(scene, cfg).rgba.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("shading,dtype,cam,bf16,lights", [
    ("none", "f32", "persp", False, (0, 0)),
    ("diffuse", "u8", "ortho", False, (2, 1)),
    ("shadow", "bf16", "back", False, (0, 0)),
    ("none", "f32", "persp", True, (0, 0)),
    ("diffuse", "f32", "persp", True, (0, 0)),
])
def test_exit_map_matches_plain_on_card(shading, dtype, cam, bf16, lights):
    """A surface that cuts the volume: the kernel reads the exit map and
    gives the plain version's bits, with termination on and off, the
    counting variant included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = with_sphere(_scene("smooth", dtype, cam, n=32, n_lights=lights[0],
                               n_points=lights[1], device="cuda"))
    args, kw = capture(scene, shading, skip=True, bf16=bf16)
    assert int((kw["exit_map"] < 1e38).sum()) > 100
    for term in (False, True):
        before = swslice.LAUNCHES
        out = swslice.slice_composite(*args, **dict(kw, term=term))
        torch.cuda.synchronize()
        assert swslice.LAUNCHES == before + 1
        ref = swslice.slice_composite_plain(*args, **dict(kw, term=term))
        assert torch.equal(out, ref)
        got, want = _counts(args), _counts(args)
        out_c = swslice.slice_composite(*args, **dict(kw, term=term, **got))
        swslice.slice_composite_plain(*args, **dict(kw, term=term, **want))
        assert torch.equal(out_c, out)
        for k in got:
            assert torch.equal(got[k], want[k])


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["sphere", "isosurface", "sphere-march",
                                  "instances", "instances-march"])
def test_surfaces_and_instances_render_on_card(what):
    """Frames with a surface (shear-warp through the kernel, or the march)
    and with a second volume, on the card against the CPU: rgba and
    normals 1e-4, depth 5e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames = []
    for dev in ("cuda", "cpu"):
        if what.startswith("instances"):
            scene = multivol_scene(field(32, "bench", dev),
                                   field(16, "bench", dev))
        else:
            base = _scene("smooth", "f32", "persp", n=32, device=dev)
            scene = (with_iso(base) if what == "isosurface"
                     else with_sphere(base))
        cfg = api.RenderConfig(
            width=64, height=48, sampling_rate=32.0, shading="diffuse",
            method="march" if what.endswith("march") else "auto"
        ).resolved(scene)
        assert (cfg.sw is None) == what.endswith("march")
        before = swslice.LAUNCHES
        with PlainCalls() as plain:
            frames.append(api.render(scene, cfg))
        if dev == "cuda":
            assert plain.n == 0
            n_vol = 2 if what == "instances" else 1
            assert swslice.LAUNCHES - before == (
                0 if what.endswith("march") else n_vol)
    a, b = frames
    np.testing.assert_allclose(a.rgba.cpu().numpy(), b.rgba.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(a.grad.cpu().numpy(), b.grad.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(a.depth.cpu().numpy(), b.depth.numpy(),
                               atol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["mc-global", "mc-dda", "dense",
                                  "dense-bf16"])
def test_path_tracing_on_card_matches_cpu(what):
    """Path-traced frames on the card against the CPU (32^3): the MC
    tracker with the same CPU generator's draws on both, rgba within
    1e-4 but for pixels whose path flips at an acceptance tie (at most
    0.5%); the dense solver rgba 1e-4 and depth 5e-4, under sw_bf16 by
    chip_smoke.py's `bf16_frame_rule` (the devices' positions an f32 ulp
    apart move bf16 rounding ties), and its gather on the card's own
    inputs run on the CPU within 1e-4. No frame launches the slice
    kernel or runs its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = field(32, "bench", "cuda")
    frames, gathers = [], []
    for grid in (g, g.cpu()):
        scene = dataclasses.replace(
            simple_scene(grid, device=grid.device),
            camera=Camera.create(**CAMERAS["persp"], device=grid.device))
        cfg = api.RenderConfig(
            width=48, height=32, spp=2, sampling_rate=32.0,
            path_tracing=True, pt_dense=what.startswith("dense"),
            pt_lattice=16, use_macrocells=what == "mc-dda", method="auto",
            sw_bf16=what == "dense-bf16").resolved(scene)
        assert (cfg.sw is None) == what.startswith("mc")
        mc = accel.build_macrocells(grid, scene.tfn.alpha,
                                    scene.tfn.value_range)
        before = swslice.LAUNCHES
        with PlainCalls() as plain:
            if what.startswith("dense"):
                frame, seen = capture_gather(
                    scene, cfg, ptdense.prepare(scene, cfg))
                gathers.append(seen)
            else:
                frame = api.render(scene, cfg, macrocells=mc,
                                   generator=torch.Generator().manual_seed(3))
            frames.append(frame)
        assert swslice.LAUNCHES == before and plain.n == 0
    a, b = frames
    d = (a.rgba.cpu() - b.rgba).abs().amax(-1)
    if what.startswith("mc"):
        assert float((d > 1e-4).float().mean()) <= 0.005
        assert float(b.rgba[..., :3].max()) > 0.05
    else:
        seen = gathers[0]
        host = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in seen["params"].items()}
        for x, y in zip(adjoint.over_scan(seen["f"], seen["n"],
                                          seen["params"]),
                        adjoint.over_scan(seen["f"], seen["n"], host)):
            assert float((x.cpu() - y).abs().max()) <= 1e-4
        if what == "dense-bf16":
            ok, stats = bf16_frame_rule(a, b)
            assert ok, stats
        else:
            assert float(d.max()) <= 1e-4
            assert float((a.depth.cpu() - b.depth).abs().max()) <= 5e-4


@pytest.mark.cuda
def test_scene_file_loads_onto_card():
    """io.create_scene puts every tensor of the VIDI3D fixture on the
    card, equal to the CPU load; its frame on the card matches the
    CPU's (rgba 1e-4, depth 5e-4) through one slice-kernel launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    from ovr_tpu_torch import io
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "scene_tiny.json")
    card, host = (io.create_scene(path, device=d) for d in ("cuda", "cpu"))
    for c, h in ((card.volume.grid, host.volume.grid),
                 (card.volume.world_hi, host.volume.world_hi),
                 (card.volume.data_range, host.volume.data_range),
                 (card.tfn.color, host.tfn.color),
                 (card.tfn.alpha, host.tfn.alpha),
                 (card.tfn.value_range, host.tfn.value_range),
                 (card.camera.from_, host.camera.from_),
                 (card.light.direction, host.light.direction),
                 (card.volume_sampling_rate, host.volume_sampling_rate)):
        assert c.is_cuda and torch.equal(c.cpu(), h)
    frames = []
    for scene in (card, host):
        cfg = api.RenderConfig(width=32, height=32, shading="diffuse",
                               method="auto", sampling_rate=float(
                                   scene.volume_sampling_rate)
                               ).resolved(scene)
        before = swslice.LAUNCHES
        frames.append(api.render(scene, cfg))
        assert swslice.LAUNCHES - before == int(scene is card)
    np.testing.assert_allclose(frames[0].rgba.cpu().numpy(),
                               frames[1].rgba.numpy(), atol=1e-4)
    np.testing.assert_allclose(frames[0].depth.cpu().numpy(),
                               frames[1].depth.numpy(), atol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("method,shading", [("auto", "none"),
                                            ("auto", "diffuse"),
                                            ("auto", "shadow"),
                                            ("march", "diffuse")])
def test_neural_field_renders_on_card_matches_cpu(method, shading):
    """A neural field on the card against the same field on the CPU: a
    24^3 proxy frame (one slice-kernel launch) or the exact field
    march, rgba 1e-4, depth 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import neural_small_scene
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = []
    for device in ("cuda", "cpu"):
        scene = neural_small_scene(device)
        cfg = api.RenderConfig(width=32, height=24, sampling_rate=24.0,
                               method=method, shading=shading,
                               neural_proxy_res=24).resolved(scene)
        before = swslice.LAUNCHES
        with torch.no_grad():
            frames.append(api.render(scene, cfg))
        assert swslice.LAUNCHES == before + (
            device == "cuda" and method == "auto")
    card, cpu = frames
    assert float(cpu.rgba[..., 3].max()) > 0.1
    np.testing.assert_allclose(card.rgba.cpu().numpy(), cpu.rgba.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(card.depth.cpu().numpy(), cpu.depth.numpy(),
                               atol=1e-3)


@pytest.mark.cuda
def test_neural_train_step_on_card_matches_cpu():
    """The inverse-rendering step's gradients of the tables and weights
    on the card within 1e-3 of the CPU's largest element (the tables'
    cotangent is a scatter-add: the summation order differs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chip_smoke import neural_small_scene
    from ovr_tpu_torch.neural import train
    torch.backends.cuda.matmul.allow_tf32 = False
    grads = []
    for device in ("cuda", "cpu"):
        scene = neural_small_scene(device)
        cfg = api.RenderConfig(width=32, height=24, sampling_rate=24.0,
                               method="auto", shading="diffuse",
                               neural_proxy_res=24).resolved(scene)
        step, state = train.make_image_train_step(scene, cfg)
        step(state, scene.camera, torch.zeros((24, 32, 4), device=device))
        grads.append([q.grad.cpu() for q in scene.volume.parameters()])
    for c, h in zip(*grads):
        scale = float(h.abs().max())
        assert float((c - h).abs().max()) <= 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in HOOK_CASES if c[0] == 64],
                         ids=lambda c: f"{c[1]}-{c[2]}-{c[3]}")
def test_kernel_matches_plain_on_brick_and_band_inputs(case):
    """The kernel on the inputs the multi-device paths give it (a brick's
    sample and clip boxes and plane range, a band's fan) against the
    plain version: the same bits, the counting variant included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, dt, shading, cam, fd, term, tl, br, w, h = case
    g = field(n, "bench", "cuda")
    g = {"f32": g, "bf16": g.to(torch.bfloat16),
         "u8": torch.clamp(torch.round(g * 255), 0, 255).to(torch.uint8)}[dt]
    scene = make_scene(g, "bench", cam)
    cfg = api.RenderConfig(width=w, height=h, sampling_rate=float(n),
                           shading=shading, method="shearwarp", sw_term=term,
                           sw_slice_align=4).resolved(scene)
    cfg = dataclasses.replace(cfg, sw=dataclasses.replace(cfg.sw,
                                                         fd_grad=fd))
    lg = api.build_light_grid(scene, cfg) if shading == "shadow" else None
    args, kw = hook_capture(scene, cfg, tl, br, lg)
    before = swslice.LAUNCHES
    out = swslice.slice_composite(*args, **kw)
    torch.cuda.synchronize()
    assert swslice.LAUNCHES == before + 1
    got, want = _counts(args), _counts(args)
    ref = swslice.slice_composite_plain(*args, **kw, **want)
    assert torch.equal(out, ref)
    assert torch.equal(swslice.slice_composite(*args, **kw, **got), out)
    for k in got:
        assert torch.equal(got[k], want[k])
    assert float(ref[7].max()) > 0.05


@pytest.mark.cuda
def test_one_rank_nccl_frames_are_api_render():
    """One rank over NCCL: the banded and the 1 x 1 bricked frame are
    `api.render`'s bits, one kernel launch each, no plain call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from ovr_tpu_torch.parallel import bricks, multihost, tiles
    from ovr_tpu_torch.parallel.mesh import make_mesh
    multihost.initialize(f"tcp://127.0.0.1:{multihost.free_port()}", 1, 0,
                         backend="nccl", timeout=120.0)
    try:
        mesh = make_mesh(1, 1, device="cuda", timeout=120.0)
        assert mesh.transport == "nccl"
        scene = make_scene(field(64, "bench", "cuda"), "bench", "persp")
        bv = bricks.brick_volume(scene.volume, 1)
        for shading in ("none", "diffuse"):
            cfg = api.RenderConfig(width=160, height=96, sampling_rate=64.0,
                                   shading=shading,
                                   method="shearwarp").resolved(scene)
            want = api.render(scene, cfg).rgba
            before = swslice.LAUNCHES
            with PlainCalls() as plain:
                band = tiles.render_sharded(scene, cfg, mesh)
                brick = bricks.render_bricked(scene, bv, cfg, mesh)
            assert swslice.LAUNCHES == before + 2 and plain.n == 0
            assert torch.equal(band, want) and torch.equal(brick, want)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_timer_fence_waits_for_the_frame():
    """`Timer.stop(fence=frame)` reads at least 0.9x the CUDA-event time of
    the frame it fences (256^3, 512x512, rate 256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ovr_tpu_torch.utils.timers import Timer
    scene = make_scene(field(256, "bench", "cuda"), "bench", "persp")
    cfg = api.RenderConfig(width=512, height=512, sampling_rate=256.0,
                           shading="diffuse",
                           method="auto").resolved(scene)
    api.render(scene, cfg)
    for _ in range(3):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = Timer()
        t.start()
        e0.record()
        frame = api.render(scene, cfg)
        e1.record()
        host_ms = t.stop(fence=frame.rgba) * 1e3
        torch.cuda.synchronize()
        assert host_ms >= 0.9 * e0.elapsed_time(e1)


@pytest.mark.cuda
def test_streamed_sequence_frames_are_the_serial_ones(tmp_path):
    """render_batch --sequence on the card (pinned buffers, side-stream
    uploads under the previous render) over four 64^3 u8 timesteps:
    every frame equals, bit for bit, a serial run's (a blocking upload,
    then the render), and every upload after the first is measured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    from chip_smoke import scene_files, sequence_files
    from ovr_tpu_torch import io
    from ovr_tpu_torch.apps import render_batch
    n = 64
    grid = torch.clamp(torch.round(field(n, "bench", "cuda") * 255), 0,
                       255).to(torch.uint8)
    _, js, _, _, _ = scene_files(grid, str(tmp_path))
    pattern, paths = sequence_files(n, 4, str(tmp_path), "cuda")
    doc = json.loads(open(js).read())
    vol = doc["view"]["volume"]
    del vol["scalarMappingRange"]
    vol["scalarMappingRangeUnnormalized"] = {"minimum": 0.0,
                                             "maximum": 65025.0}
    seq_js = str(tmp_path / "sequence.json")
    open(seq_js, "w").write(json.dumps(doc))
    argv = ["--scene", seq_js, "--fbsize", "160", "96", "--sampling-rate",
            "64", "--shading", "diffuse", "--use-macrocells", "--no-save",
            "--sequence", pattern, "--sequence-type", "UNSIGNED_BYTE"]
    frames = []
    before = swslice.LAUNCHES
    res = render_batch.main(argv, on_frame=lambda i, r: frames.append(
        r._frame.rgba.clone()))
    assert swslice.LAUNCHES - before == 4
    assert len(res["uploads"]) == 3
    assert all(u["ms"] > 0 for u in res["uploads"])
    scene = io.create_scene(seq_js, device="cuda")
    serial = render_batch.make_renderer(render_batch.parse_args(argv),
                                        scene, scene.camera)
    for k, p in enumerate(paths):
        serial.set_volume_data(torch.from_numpy(
            np.fromfile(p, np.uint8).reshape(n, n, n)).cuda())
        serial.render()
        assert torch.equal(serial._frame.rgba, frames[k])
    assert not torch.equal(frames[0], frames[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [{}, {"BENCH_BF16": "1"},
                                  {"BENCH_TIMEVAR": "3"},
                                  {"BENCH_BACKWARD": "1"}],
                         ids=["headline", "bf16", "timevar", "backward"])
def test_bench_launches_the_kernel_once_a_frame(mode, tmp_path):
    """The port's bench at a tiny headline on the card (64^3 bf16,
    160x96, rate 64; 1 warm-up and 3 timed frames): the slice kernel ran
    once a frame (the bf16 variant under BENCH_BF16), the plain version
    never, and the value is finite with the cuda key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import math
    from ovr_tpu_torch import bench
    env = dict(BENCH_GRID="64", BENCH_WIDTH="160", BENCH_HEIGHT="96",
               BENCH_FRAMES="3", BENCH_WARMUP="1", BENCH_STORE="bf16",
               **mode)
    res = bench.run(env, book=str(tmp_path / "book.json"))
    t = res["timing"]
    assert (t.launches, t.plain_calls) == (4, 0)
    assert t.launches_bf16 == (4 if mode.get("BENCH_BF16") else 0)
    assert res["key"].startswith("cuda-64-160x96-64.0-diffuse-auto")
    assert math.isfinite(res["line"]["value"]) and res["line"]["value"] > 0
    assert res["line"]["vs_baseline"] is None


@pytest.mark.cuda
@pytest.mark.parametrize("shading", ["none", "diffuse", "shadow"])
def test_shearwarp_frame_never_waits_for_the_card(shading):
    """A shear-warp frame on the card (macrocells, a passed-in lattice for
    shadow) is issued without one host-device synchronization: no value
    comes to the host and no Python number is copied to the card, so the
    host issues the next frame while the slice kernel runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ovr_tpu_torch.render import accel
    scene = _scene("smooth", "bf16", n=48, device="cuda")
    cfg = api.RenderConfig(width=96, height=64, sampling_rate=48.0,
                           shading=shading, method="auto").resolved(scene)
    assert cfg.sw is not None
    mc = accel.build_macrocells(scene.volume.grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    lg = (api.build_light_grid(scene, cfg) if shading == "shadow"
          else None)
    with torch.no_grad():
        api.render(scene, cfg, macrocells=mc, light_grid=lg)
        torch.cuda.synchronize()
        before = swslice.LAUNCHES
        torch.cuda.set_sync_debug_mode("error")
        try:
            frame = api.render(scene, cfg, macrocells=mc, light_grid=lg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert swslice.LAUNCHES == before + 1
    assert torch.isfinite(frame.rgba).all()
    # a Renderer's frame that captures its setup, then one that replays
    # it: another view of the plan
    cam = Camera.create(from_=(0.55, 0.42, -1.5), at=(0.5, 0.5, 0.5),
                        fovy=40.0, device="cuda")
    cfg2 = dataclasses.replace(cfg, sw=None).resolved(scene, cam)
    graphs = shearwarp.SetupGraphs()
    frames = []
    with torch.no_grad():
        before = (swslice.LAUNCHES, shearwarp.SETUP_CAPTURES,
                  shearwarp.SETUP_REPLAYS)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for c, kw in ((cfg, {}), (cfg2, dict(camera=cam))):
                frames.append(api.render(scene, c, macrocells=mc,
                                         light_grid=lg, _setup_graphs=graphs,
                                         **kw))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert (swslice.LAUNCHES, shearwarp.SETUP_CAPTURES,
            shearwarp.SETUP_REPLAYS) == (before[0] + 2, before[1] + 1,
                                         before[2] + 1)
    assert torch.equal(frames[0].rgba, frame.rgba)
    want = api.render(scene, cfg2, camera=cam, macrocells=mc, light_grid=lg)
    assert torch.equal(frames[1].rgba, want.rgba)


def _orbit_eye(deg, r=1.9):
    th = np.radians(deg)
    return (0.5 + r * np.sin(th), 0.5, 0.5 - r * np.cos(th))


def _plan_of(cfg):
    sw = cfg.sw
    return (sw.axis, sw.sign, sw.n_slices, sw.slice0_static, sw.inter_h,
            sw.inter_w)


# (grid, shading, traffic, spp, TF, camera and lights): an orbit through
# all four plans of axis and sign, its exactly axis-aligned views among
# them; a TF ramp at a fixed eye (with a 32-node alpha table, so the
# setup renodes the colours by a matrix product); shadow with its
# lattice; two samples a pixel; an orthographic orbit; two directional
# lights and a point light besides the headlight
REPLAY_CASES = [("u16", "diffuse", "orbit", 1, "smooth", "persp"),
                ("f32", "shadow", "orbit", 1, "smooth", "persp"),
                ("u8", "diffuse", "orbit", 2, "smooth", "persp"),
                ("f32", "diffuse", "tf-edit", 1, "sparse", "persp"),
                ("u16", "none", "orbit", 1, "smooth", "persp"),
                ("u8", "diffuse", "orbit", 1, "smooth", "ortho"),
                ("f32", "shadow", "orbit", 1, "smooth", "lights")]
ORBIT = [0, 30, 45, 90, 120, 180, 200, 270, 300, 360, 15, 90, 135]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shading,traffic,spp,kind,view",
                         REPLAY_CASES)
def test_renderer_replayed_setup_is_the_eager_frame(dtype, shading, traffic,
                                                     spp, kind, view):
    """Each Renderer frame equals `api.render` (eager setup) on the same
    scene, config, camera, macrocells and lattice, bit for bit. The first
    frame of each plan captures its setup and every later one replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_lights = 2 if view == "lights" else 0
    scene = _scene(kind, dtype, n=64, device="cuda", n_lights=n_lights,
                   n_points=n_lights // 2)
    lens = (dict(height=1.3, kind="orthographic") if view == "ortho"
            else dict(fovy=40.0))
    scene = dataclasses.replace(scene, camera=Camera.create(
        from_=_orbit_eye(0), at=(0.5, 0.5, 0.5), device="cuda", **lens))
    r = api.Renderer(scene, api.RenderConfig(
        width=160, height=96, sampling_rate=64.0, method="auto",
        shading=shading, spp=spp, use_macrocells=True))
    color = scene.tfn.color.cpu().numpy()
    alpha = scene.tfn.alpha.cpu().numpy()
    steps = (ORBIT if traffic == "orbit"
             else [0.1 * i for i in range(6)] + [0.2, 0.0])
    plans, got = set(), np.zeros(3, np.int64)
    for step in steps:
        if traffic == "orbit":
            r.set_camera(from_=_orbit_eye(step), at=(0.5, 0.5, 0.5))
        else:
            x = np.linspace(0.0, 1.0, len(alpha))
            r.set_transfer_function(
                color, np.clip((x - step) / (1.0 - step), 0.0, 1.0)
                * alpha.max(), scene.tfn.value_range.cpu().numpy())
        r.commit()
        c0 = np.array([shearwarp.SETUP_REPLAYS, shearwarp.SETUP_CAPTURES,
                       shearwarp.SETUP_EAGER])
        r.render()
        got += np.array([shearwarp.SETUP_REPLAYS, shearwarp.SETUP_CAPTURES,
                         shearwarp.SETUP_EAGER]) - c0
        plans.add(_plan_of(r._cfg))
        with torch.no_grad():
            want = api.render(r.scene, r._cfg, camera=r._camera,
                              frame_index=r._frame_index,
                              macrocells=r._macrocells,
                              light_grid=r._light_grid)
        for a, b in ((r._frame.rgba, want.rgba), (r._frame.grad, want.grad),
                     (r._frame.depth, want.depth)):
            assert torch.equal(a, b), step
    if traffic == "orbit":
        assert {p[:2] for p in plans} == {(0, 1), (0, -1), (2, 1), (2, -1)}
    assert tuple(got) == (len(steps) * spp - len(plans), len(plans), 0)


@pytest.mark.cuda
def test_renderer_captures_again_after_a_new_frame_size():
    """A new frame size drops every graph of the Renderer with its screen
    buffers; the next frames capture and replay in a new memory pool,
    each equal to `api.render`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = _scene("smooth", "u16", n=64, device="cuda")
    r = api.Renderer(scene, api.RenderConfig(
        width=160, height=96, sampling_rate=64.0, method="auto",
        shading="diffuse", use_macrocells=True))
    c0 = np.array([shearwarp.SETUP_REPLAYS, shearwarp.SETUP_CAPTURES])
    for size in ((160, 96), (160, 96), (128, 80), (128, 80), (160, 96)):
        if (r._cfg.width, r._cfg.height) != size:
            r.set_fbsize(size)
        r.commit()
        r.render()
        with torch.no_grad():
            want = api.render(r.scene, r._cfg, camera=r._camera,
                              frame_index=r._frame_index,
                              macrocells=r._macrocells)
        assert torch.equal(r._frame.rgba, want.rgba), size
    assert tuple(np.array([shearwarp.SETUP_REPLAYS,
                           shearwarp.SETUP_CAPTURES]) - c0) == (2, 3)


def _pool_bytes(graphs):
    """The reserved and allocated bytes of each segment of the graphs'
    memory pool."""
    pool = tuple(graphs._pool)
    return [(g["total_size"], g["allocated_size"])
            for g in torch.cuda.memory_snapshot()
            if tuple(g["segment_pool_id"]) == pool]


@pytest.mark.cuda
def test_renderer_setup_graphs_add_no_memory():
    """The peak of an eight-view orbit through the Renderer (captures
    included) is within 1% of the same views' eager frames, beside the
    shared denominator and mask (`shearwarp.screen_buffers`), counted
    apart. The graphs' pool, whose free blocks `max_memory_allocated`
    does not see, holds no screen-sized block: its segments are the
    allocator's small ones, 4 MiB at most."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = _scene("smooth", "u16", n=128, device="cuda")
    cfg = api.RenderConfig(width=960, height=540, sampling_rate=128.0,
                           method="auto", shading="diffuse",
                           use_macrocells=True)
    small = 2 << 20

    def peak(replay):
        r = api.Renderer(scene, cfg)
        r.commit()
        last = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            for deg in range(0, 360, 45):
                r.set_camera(from_=_orbit_eye(deg), at=(0.5, 0.5, 0.5))
                r.commit()
                if replay:
                    r.render()
                else:
                    last = api.render(r.scene, r._cfg, camera=r._camera,
                                      macrocells=r._macrocells)
        torch.cuda.synchronize()
        segs = _pool_bytes(r._setup_graphs) if replay else []
        shared = (sum(b.nbytes for b in r._setup_graphs._screen[2:])
                  if replay else 0)
        del r, last
        return torch.cuda.max_memory_allocated(), shared, segs

    eager, _, _ = peak(False)
    c0 = shearwarp.SETUP_CAPTURES
    graphed, shared, segs = peak(True)
    assert shearwarp.SETUP_CAPTURES - c0 == 4
    assert segs and all(total <= small for total, _ in segs), segs
    free = sum(total - used for total, used in segs)
    assert sum(total for total, _ in segs) <= 2 * small, segs
    assert abs(graphed - shared - eager) <= 0.01 * eager, (
        graphed, shared, eager, free)


def _plain_windows(v, dim, reduce, neutral):
    """`reduce` over each 18-voxel window at stride 16 along `dim`, one
    voxel in front of the axis; voxels outside the axis count as
    `neutral`."""
    n = v.shape[dim]
    m = -(-n // 16)
    idx = (torch.arange(m, device=v.device)[:, None] * 16 - 1
           + torch.arange(18, device=v.device))
    t = v.index_select(dim, idx.clamp(0, n - 1).reshape(-1))
    t = t.unflatten(dim, (m, 18))
    shape = [1] * t.dim()
    shape[dim], shape[dim + 1] = m, 18
    outside = ((idx < 0) | (idx >= n)).reshape(shape)
    return reduce(t.masked_fill(outside, neutral), dim + 1)


@pytest.mark.cuda
def test_value_ranges_of_a_published_u8_grid_within_the_budget():
    """The macrocell value ranges of a 2048 x 2048 x 1920 u8 grid
    (Richtmyer-Meshkov's size) built on the card: while building, no
    value comes to the host and the memory allocated rises by at most the
    slab budget and 64 MiB over the grid; the cells equal a plain
    block-by-block amax and amin, one layer of macrocells at a time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    zd, yd, xd = dims = (1920, 2048, 2048)
    grid = torch.empty(dims, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    yy = torch.arange(yd, device=dev)[None, :, None]
    xx = torch.arange(xd, device=dev)[None, None, :]
    for k in range(0, zd, 64):  # blocks whose edges miss the windows'
        zz = torch.arange(k, min(k + 64, zd), device=dev)[:, None, None]
        v = (zz // 40) * 37 + (yy // 24) * 11 + (xx // 56) * 5
        v = v + torch.randint(0, 4, v.shape, generator=gen, device=dev)
        grid[k:k + 64] = (v % 256).to(torch.uint8)
    del yy, xx, zz, v
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    slabs0 = accel.VALUE_RANGE_SLABS
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        lo, hi = accel.compute_value_ranges(grid)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    print(f"value ranges of {dims} u8: {start.elapsed_time(end):.2f} ms, "
          f"{accel.VALUE_RANGE_SLABS - slabs0} slabs, peak "
          f"{torch.cuda.max_memory_allocated()} B, {rise} B over the "
          f"{base} B before (grid {grid.numel()} B)")
    assert rise <= accel.VALUE_RANGE_BUDGET + (64 << 20)
    want_lo, want_hi = [], []
    for k in range(-(-zd // 16)):
        block = grid[max(16 * k - 1, 0):16 * k + 17]
        for want, reduce, neutral in ((want_lo, torch.amin, 255),
                                      (want_hi, torch.amax, 0)):
            t = reduce(block, 0)
            t = _plain_windows(t, 0, reduce, neutral)
            want.append(_plain_windows(t, 1, reduce, neutral))
    s = 1.0 / 255.0
    assert torch.equal(lo, torch.stack(want_lo).float() * s)
    assert torch.equal(hi, torch.stack(want_hi).float() * s)
