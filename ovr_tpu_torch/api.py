"""Public rendering API (port of `ovr_tpu.api`).

    cfg = RenderConfig(width=1920, height=1080, method="auto",
                       shading="diffuse").resolved(scene)
    frame = render(scene, cfg, macrocells=mc)

`render` takes the shear-warp fast path where a plan resolves
(`method="shearwarp"`, or `"auto"` on an eligible view) and the ray
march otherwise (`method="march"`, the default, and `"auto"`'s
fallback). With `path_tracing` it renders the reference's second
pipeline: the delta-tracking tracker (`render/pathtracer.py`) or, with
`pt_dense` and a plan, the discrete-ordinates solver gathered through
the shear-warp fan (`render/ptdense.py`). `Renderer` is the stateful
facade with setters, `commit`, `render`, `swap` and `mapframe`;
`accumulate` and `variance_of` keep
progressive sums. Scenes may carry surfaces (`geometries`: meshes and
isosurfaces, which the volume composites over) and more volumes
(`instances`, composited in depth order); `Renderer` also renders
foveated sparse frames (`set_sparse_sampling`, `set_focus`). The volume
may be a neural field (`neural.NeuralFieldVolume`): shear-warp then
renders a dense proxy baked from it (`neural_proxy_res`^3, the slice
kernel's input; `bake_proxy_scene`), and the march samples the field
exactly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from ovr_tpu_torch.core.sampling import safe_normalize, scalar
from ovr_tpu_torch.core.scene import (Camera, Scene, StructuredVolume,
                                      TransferFunction)
from ovr_tpu_torch.neural.field import is_field, volume_repr
from ovr_tpu_torch.neural.train import bake_grid, bake_grid_host
from ovr_tpu_torch.render import accel
from ovr_tpu_torch.render import integrator as ig
from ovr_tpu_torch.render import (geometry, lightgrid, multivol, pathtracer,
                                  ptdense, shearwarp, sparse)
from ovr_tpu_torch.render.camera import (blended_flow, camera_basis,
                                         generate_rays, pixel_screen_coords)
from ovr_tpu_torch.utils import readback, trace

READBACK_BYTES = 0  # bytes `Renderer.mapframe` returned to the host
READBACK_PINNED_BYTES = 0  # of those, bytes that landed in a pooled buffer
READBACK_PINNED_ALLOCS = 0  # pooled host buffers made
trace.register_counter("api.READBACK_BYTES", lambda: READBACK_BYTES)
trace.register_counter("api.READBACK_PINNED_BYTES",
                       lambda: READBACK_PINNED_BYTES)
trace.register_counter("api.READBACK_PINNED_ALLOCS",
                       lambda: READBACK_PINNED_ALLOCS)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings; the fields and defaults of
    `ovr_tpu.api.RenderConfig`. `sw_persist` and `sw_col_win` chose TPU
    kernel variants with identical results and change nothing here.
    `ovr_tpu`'s `sw_pallas` (the Pallas kernel or the XLA slice loop) has
    no counterpart: the slice loop is the kernel on the card and its plain
    version on the CPU. `ray_chunk` (march and MC tracker rays per
    chunk) stays None unless set: the JAX package's 1 << 16 default on a
    TPU, a bound on its working set there, does not carry over.

    `sw_bf16` rounds shear-warp's resampling operands to bfloat16 (to
    nearest even) and sums their products in f32, as the JAX kernel's
    bf16 variant does: in the slice loop the z-lerped plane, the row and
    column weights (the storage scale folded into the row weights), the
    row-resampled values, the analytic gradient's derivative weights and
    the shadow lattice's plane, weights and row results, with an f32
    grid of a multiple of 16 rows (along the view's rows) read as bf16;
    in the final warp the image, the tap weights and the separable
    warp's row result. The TF lookup, the FD gradient, shading and
    compositing stay f32. Under grad the backward recomputes the planes
    as the JAX package's does (`swslice._adjoint`).

    A neural-field volume plans shear-warp over its proxy lattice,
    `neural_proxy_res` per axis (with `neural_proxy`), and marches the
    field exactly otherwise."""

    width: int = 512
    height: int = 512
    spp: int = 1
    sampling_rate: float = 64.0  # samples per world unit
    base_rate: float = 1.0  # opacity-correction base
    method: str = "march"  # march | shearwarp | auto
    sw_inter_cap: int = 2048  # fan resolution cap per axis
    sw_slice_align: int = 1  # round the slice count up to a multiple
    sw_bf16: bool = False
    sw_col_win: bool = False
    sw_term: bool = True  # early ray termination in the kernel
    sw_skip: bool = True  # macrocell plane skipping in the kernel
    sw_persist: bool = True
    sw: Any = None  # resolved shear-warp plan (set by resolved())
    shading: str = ig.SHADING_SHADOW
    shadow_scale: float = 10.0
    max_steps: Optional[int] = None
    shadow_max_steps: Optional[int] = None
    path_tracing: bool = False
    max_scatters: int = 24
    pt_dense: bool = False
    pt_lattice: int = 128
    pt_dirs: int = 14
    use_macrocells: bool = False  # march: empty-space skipping
    adaptive_scale: float = 1.0  # march: > 1 stretches steps by 1/majorant
    jitter_rays: bool = False  # random t0 offset (march) / plane offset
    fast_math: bool = False  # march_while: stop when all rays are done
    shadow_grid: bool = True  # shadows from the precomputed lattice
    shadow_grid_res: int = 0  # lattice cap per axis; 0 = clamp(n/4, 128, 512)
    shading_scale: float = 0.8  # 'ssh' deferred-shade blend weight
    ray_chunk: Optional[int] = None  # march rays per chunk (None: all)
    iso_steps: int = 128
    geometry_chunk: int = 256
    neural_proxy: bool = True
    neural_proxy_res: int = 512
    dtype: Any = torch.float32

    def resolved(self, scene: Scene, camera: Optional[Camera] = None
                 ) -> "RenderConfig":
        """Fill derived step counts from the scene's world box, and the
        shear-warp plan from the camera."""
        lo = scene.volume.world_lo.detach().cpu().numpy()
        hi = scene.volume.world_hi.detach().cpu().numpy()
        diag = float(np.linalg.norm(hi - lo))
        updates = {}
        if self.max_steps is None:
            updates["max_steps"] = int(np.ceil(diag * self.sampling_rate)) + 2
        if self.shadow_max_steps is None:
            n = int(np.ceil(diag * self.sampling_rate / self.shadow_scale))
            updates["shadow_max_steps"] = n + 2
        if self.method in ("shearwarp", "auto"):
            pt_dense = self.path_tracing and self.pt_dense
            eligible = (pt_dense
                        or (not self.path_tracing
                            and self.shading in (ig.SHADING_NONE,
                                                 ig.SHADING_DIFFUSE,
                                                 ig.SHADING_SHADOW)))
            # the dense path tracer's gather is unshaded
            view = (dataclasses.replace(self, shading=ig.SHADING_NONE)
                    if pt_dense else self)
            camera = camera or scene.camera
            if (eligible and not scene.instances and self.neural_proxy
                    and is_field(scene.volume)):
                # plan over the proxy's shape; `render` bakes it
                scene = dataclasses.replace(
                    scene, volume=_proxy_shim(scene.volume, self))
            sw = None
            if eligible and scene.instances and not pt_dense:
                # one plan per volume; the screen partials composite in
                # depth order (`_sw_instances`). Placed instances, and
                # shadows (a lattice per instance), march instead.
                if (all(i.xfm is None for i in scene.instances)
                        and self.shading in (ig.SHADING_NONE,
                                             ig.SHADING_DIFFUSE)):
                    plans = tuple(shearwarp.resolve_static(
                        dataclasses.replace(scene, volume=v, tfn=t,
                                            instances=()), camera, self)
                        for v, t in _volumes(scene))
                    sw = None if None in plans else plans
            elif eligible:
                sw = shearwarp.resolve_static(scene, camera, view)
            if sw is None and self.method == "shearwarp":
                raise ValueError(
                    "shearwarp ineligible for this scene/camera/config "
                    "(needs a dense-grid volume, shading in {none, "
                    "diffuse, shadow}, and a perspective eye whose border "
                    "rays advance along the principal axis); use "
                    "method='auto' to fall back")
            updates["sw"] = sw
        elif self.sw is not None:
            updates["sw"] = None
        return dataclasses.replace(self, **updates) if updates else self


@dataclasses.dataclass(frozen=True)
class Frame:
    """Rendered frame: rgba (H, W, 4) straight alpha, grad (H, W, 3)
    camera-space shaded normal, depth (H, W) alpha-blended hit distance,
    flow (H, W, 2) screen-space optical flow against `last_camera` (None
    without one)."""

    rgba: torch.Tensor
    grad: torch.Tensor
    depth: Any = None
    flow: Any = None


@dataclasses.dataclass(frozen=True)
class _ShimVolume:
    """Shape-only stand-in for a neural field's proxy grid while a plan
    resolves: a broadcast view of one zero, nothing allocated."""

    grid: torch.Tensor
    world_lo: torch.Tensor
    world_hi: torch.Tensor


def _proxy_shim(field, cfg: RenderConfig) -> _ShimVolume:
    r = int(cfg.neural_proxy_res)
    return _ShimVolume(grid=torch.zeros(()).expand(r, r, r),
                       world_lo=field.world_lo, world_hi=field.world_hi)


def bake_proxy_scene(scene: Scene, cfg: RenderConfig, grid=None) -> Scene:
    """The scene with its neural field replaced by the dense proxy baked
    from it (`neural_proxy_res`^3, `neural.train.bake_grid`: gradients
    flow through the bake to the tables and weights); a dense volume
    stays. Pass a baked `grid` (`Renderer.commit` caches one from
    `bake_grid_host`) to reuse it across frames."""
    vol = scene.volume
    if not is_field(vol):
        return scene
    r = int(cfg.neural_proxy_res)
    if grid is None:
        grid = bake_grid(vol, (r, r, r))
    proxy = StructuredVolume(
        grid=grid, world_lo=vol.world_lo.to(cfg.dtype),
        world_hi=vol.world_hi.to(cfg.dtype),
        data_range=vol.data_range.to(cfg.dtype))
    return dataclasses.replace(scene, volume=proxy)


def _extra_lights(scene: Scene) -> dict:
    """scene.lights as the ShadeContext's light arrays: directional and
    sunSky lights shade like the primary (|N.L| I), point lights with
    inverse-square falloff; the intensity folds in the colour's mean and
    the primary's implicit 2. Ambient lights are ignored here."""
    dirs, dir_i, pts, pt_i = [], [], [], []
    for lt in scene.lights:
        mean_c = torch.mean(lt.color)
        if lt.kind in ("directional", "sunsky"):
            dirs.append(safe_normalize(lt.direction))
            dir_i.append(2.0 * lt.intensity * mean_c)
        elif lt.kind == "point":
            pts.append(lt.position)
            pt_i.append(2.0 * lt.intensity * mean_c)
    out = {}
    if dirs:
        out["extra_dirs"] = torch.stack(dirs)
        out["extra_dir_intens"] = torch.stack(dir_i)
    if pts:
        out["point_pos"] = torch.stack(pts)
        out["point_intens"] = torch.stack(pt_i)
    return out


def _shade_ctx(scene: Scene, camera: Camera, cfg: RenderConfig,
               light_alpha=None) -> ig.ShadeContext:
    _, direction, horizontal, vertical = camera_basis(camera, cfg.width,
                                                      cfg.height)
    wtc = torch.stack([safe_normalize(horizontal), safe_normalize(vertical),
                       -direction])
    return ig.ShadeContext(
        light_dir=safe_normalize(scene.light.direction), wtc=wtc,
        world_lo=scene.volume.world_lo, world_hi=scene.volume.world_hi,
        light_alpha=light_alpha, **_extra_lights(scene))


def _leaves(scene: Scene, cfg: RenderConfig):
    return (volume_repr(scene.volume), scene.tfn.color, scene.tfn.alpha,
            scene.tfn.value_range,
            cfg.base_rate * torch.ones((), dtype=cfg.dtype,
                                       device=scene.device))


def _march_cfg(cfg: RenderConfig) -> ig.MarchConfig:
    return ig.MarchConfig(
        max_steps=cfg.max_steps or 1, shading=cfg.shading,
        shadow_scale=cfg.shadow_scale,
        shadow_max_steps=cfg.shadow_max_steps or 1,
        adaptive_scale=cfg.adaptive_scale, shading_scale=cfg.shading_scale)


def _step(cfg: RenderConfig, device) -> torch.Tensor:
    """The march step 1 / sampling_rate (with `max_steps`, both from the
    config)."""
    return torch.tensor(1.0 / cfg.sampling_rate, dtype=cfg.dtype,
                        device=device)


def _wants_light_grid(cfg: RenderConfig) -> bool:
    return cfg.shadow_grid and cfg.shading in (ig.SHADING_SHADOW,
                                               ig.SHADING_SSH)


def _lattice_res(scene: Scene, cfg: RenderConfig):
    vol = scene.volume
    shape = (128, 128, 128) if is_field(vol) else vol.grid.shape
    cap = cfg.shadow_grid_res or min(512, max(128, max(shape) // 4))
    return lightgrid.default_resolution(shape, cap=cap)


def build_light_grid(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """Shadow-alpha lattice for `render(..., light_grid=...)`, by the
    dense light-axis sweep (as JAX's `build_light_grid` called outside
    jit); a neural field's by the shadow march from every texel
    (`_inline_light_grid`), as there. Rebuild when the volume, TF or
    light changes."""
    vol = scene.volume
    if is_field(vol):
        return _inline_light_grid(scene, cfg)
    direction = safe_normalize(scene.light.direction)
    return lightgrid.build_light_grid_swept(
        _leaves(scene, cfg), direction, vol.world_lo, vol.world_hi,
        _lattice_res(scene, cfg))


def _inline_light_grid(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """The lattice `render` builds when none is given: the shadow march
    from every texel centre, as JAX's jitted `render` builds it (the
    light direction is a tracer there, so it cannot pick a sweep
    axis)."""
    vol = scene.volume
    return lightgrid.build_light_grid(
        _leaves(scene, cfg), safe_normalize(scene.light.direction),
        vol.world_lo, vol.world_hi, _step(cfg, scene.device),
        _march_cfg(cfg), _lattice_res(scene, cfg))


def _volumes(scene: Scene):
    """(volume, tfn) of the primary volume, then of each instance."""
    return [(scene.volume, scene.tfn)] + [(i.volume, i.tfn)
                                          for i in scene.instances]


def render(scene: Scene, cfg: RenderConfig, camera: Optional[Camera] = None,
           frame_index: int = 0, generator: Optional[torch.Generator] = None,
           macrocells: Optional[accel.MacrocellGrid] = None,
           last_camera: Optional[Camera] = None,
           light_grid: Optional[torch.Tensor] = None,
           pt_fields=None, proxy_grid=None) -> Frame:
    """Render one frame, on the scene's device.

    `cfg` must be resolved (`cfg.resolved(scene)`); `cfg.sw` set means
    shear-warp, None the march. `generator`: the `torch.Generator` of the
    spp screen jitter, `jitter_rays` and the path tracer's draws
    (default: one on the scene's device seeded with `frame_index`); a
    CPU generator for a scene on the card draws on the CPU and copies,
    so that both devices render the same jitter. `macrocells`:
    `accel.build_macrocells` of the volume, for shear-warp's plane
    skipping and, with `cfg.use_macrocells`, the march's empty-space
    skipping and the path tracer's DDA tracking.
    `pt_fields`: `ptdense.prepare`'s (sigma, J) for a dense path-traced
    frame (built here when none is given). `proxy_grid`: a neural
    field's baked proxy for a shear-warp frame (baked here, with
    `neural.train.bake_grid`, when none is given).
    `last_camera`: fills `Frame.flow`. `light_grid`: the shadow lattice
    (`build_light_grid`); when shadow shading needs one and none is
    given, it is built here by the per-point shadow march, from the
    scene's own tensors, so a gradient reaches the volume and the TF
    through it too; a lattice passed in gets a cotangent of its own.

    Differentiable: `loss.backward()` on the frame's tensors gives the
    gradients of the volume grid (floating point), the TF colour, alpha
    and value range, the camera, the lights and a passed-in lattice, or
    of a neural field's tables and weights (through the bake, or the
    march).
    Under grad shear-warp's slice loop runs without early termination;
    the march needs `fast_math=False` (its while loop is forward-only)."""
    if cfg.max_steps is None:
        raise ValueError("call cfg.resolved(scene) first")
    if camera is None:
        camera = scene.camera
    if generator is None and (cfg.jitter_rays or cfg.spp > 1
                              or cfg.path_tracing):
        generator = torch.Generator(device=scene.device)
        generator.manual_seed(int(frame_index))
    if cfg.path_tracing:
        if cfg.pt_dense and cfg.sw is not None:
            return ptdense.render_frame_dense(scene, cfg, camera,
                                              pt_fields=pt_fields)
        return pathtracer.render_frame(scene, cfg, camera,
                                       pathtracer.GeneratorDraws(generator),
                                       macrocells)
    if cfg.sw is not None:
        scene = bake_proxy_scene(scene, cfg, grid=proxy_grid)
    if not _wants_light_grid(cfg):
        light_grid = None
    elif light_grid is None:
        light_grid = _inline_light_grid(scene, cfg)
    if cfg.sw is not None:
        return _render_shearwarp_frame(scene, cfg, camera, generator,
                                       last_camera, light_grid, macrocells)
    return _render_march_frame(scene, cfg, camera, generator, last_camera,
                               light_grid, macrocells)


def _rand(shape, generator, dtype, device) -> torch.Tensor:
    """Uniform [0, 1) numbers from `generator`, on `device`."""
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=generator.device).to(device)


def _frame(cfg: RenderConfig, color, grad, depth, alpha, flow) -> Frame:
    h, w = cfg.height, cfg.width
    rgba = torch.cat([color, alpha[..., None]], dim=-1)
    return Frame(rgba=rgba.reshape(h, w, 4), grad=grad.reshape(h, w, 3),
                 depth=depth.reshape(h, w),
                 flow=None if flow is None else flow.reshape(h, w, 2))


def _render_march_frame(scene: Scene, cfg: RenderConfig, camera: Camera,
                        generator, last_camera, light_grid,
                        macrocells) -> Frame:
    """The march for every pixel; spp > 1 jitters each sample's screen
    position, `jitter_rays` its t0, `ray_chunk` marches the rays in
    chunks (the same result; less memory, and a chunk's while loop stops
    on its own rays)."""
    dev = scene.device
    dt = cfg.dtype
    screen = pixel_screen_coords(cfg.width, cfg.height, dt, dev)
    screen = screen.reshape(-1, 2)
    n = screen.shape[0]
    mcfg = _march_cfg(cfg)
    ctx = _shade_ctx(scene, camera, cfg, light_alpha=light_grid)
    leaves = _leaves(scene, cfg)
    step = _step(cfg, dev)
    march_fn = ig.march_while if cfg.fast_math else ig.march
    occupancy = macrocells if cfg.use_macrocells else None

    def ray_batch(sc, tj):
        org, direction = generate_rays(camera, sc, cfg.width, cfg.height)
        # the surfaces first; the volume composites over them
        t_bg = None
        if scene.geometries:
            bg_rgb, bg_a, t_bg = geometry.render_geometries(
                scene, org, direction, iso_steps=cfg.iso_steps,
                chunk=cfg.geometry_chunk)
        if scene.instances:
            color, grad, depth, alpha = multivol.march_instances(
                scene, org, direction, ctx, cfg, mcfg, step)
        else:
            color, grad, depth, alpha = march_fn(
                org, direction, leaves, ctx, mcfg, step,
                occupancy=occupancy, jitter=tj, t_cap=t_bg)
        if scene.geometries:
            tr = 1.0 - alpha
            color = color + tr[..., None] * bg_rgb
            depth = depth + tr * bg_a * torch.minimum(
                t_bg, scalar(1e30, t_bg.dtype, t_bg.device))
            alpha = alpha + tr * bg_a
        flow = (None if last_camera is None else blended_flow(
            camera, last_camera, cfg.width, cfg.height, org, direction,
            depth, alpha))
        return (*ig.finalize(color, grad, depth, alpha), flow)

    acc = None
    for _ in range(cfg.spp):
        sc = screen
        if cfg.spp > 1:
            jit2 = _rand((n, 2), generator, dt, dev) - 0.5
            sc = screen + jit2 / torch.tensor([cfg.width, cfg.height],
                                              dtype=dt, device=dev)
        tj = _rand((n,), generator, dt, dev) if cfg.jitter_rays else None
        c = cfg.ray_chunk
        if c and n > c:
            parts = [ray_batch(sc[i:i + c], None if tj is None
                               else tj[i:i + c]) for i in range(0, n, c)]
            out = [None if p[0] is None else torch.cat(p)
                   for p in zip(*parts)]
        else:
            out = ray_batch(sc, tj)
        acc = out if acc is None else [
            None if a is None else a + o for a, o in zip(acc, out)]
    if cfg.spp > 1:
        acc = [None if a is None else a * (1.0 / cfg.spp) for a in acc]
    return _frame(cfg, *acc)


def _sw_instances(scene: Scene, cfg: RenderConfig, camera: Camera, off):
    """A multi-volume shear-warp frame (`cfg.sw` a tuple of plans, one
    per volume): each volume through its own plan (one slice-kernel
    launch each), then the premultiplied screen partials composited per
    pixel in order of box-entry distance (`multivol.depth_composite`)."""
    dev = scene.device
    screen = pixel_screen_coords(cfg.width, cfg.height, cfg.dtype,
                                 dev).reshape(-1, 2)
    org, direction = generate_rays(camera, screen, cfg.width, cfg.height)
    parts = []
    for (vol, tfn), plan in zip(_volumes(scene), cfg.sw):
        sv = dataclasses.replace(scene, volume=vol, tfn=tfn, instances=())
        out = shearwarp.render_shearwarp(
            sv, dataclasses.replace(cfg, sw=plan), camera, jitter=off)
        parts.append((*out, multivol.entry_distance(
            org, direction, vol.world_lo, vol.world_hi)))
    return multivol.depth_composite(parts)


def _render_shearwarp_frame(scene: Scene, cfg: RenderConfig, camera: Camera,
                            generator, last_camera, light_grid=None,
                            macrocells=None) -> Frame:
    """Shear-warp frame; spp > 1 stratifies the sample-plane offset,
    `jitter_rays` draws it at random. A tuple of plans renders the
    scene's volumes one by one (`_sw_instances`)."""
    dev = scene.device
    acc = None
    for s in range(cfg.spp):
        if cfg.jitter_rays:
            off = _rand((), generator, cfg.dtype, dev)
        elif cfg.spp > 1:
            off = (torch.tensor(float(s), dtype=cfg.dtype) + 0.5) / cfg.spp
        else:
            off = None
        if isinstance(cfg.sw, tuple):
            out = _sw_instances(scene, cfg, camera, off)
        else:
            out = shearwarp.render_shearwarp(scene, cfg, camera, jitter=off,
                                             light_grid=light_grid,
                                             macrocells=macrocells)
        acc = out if acc is None else tuple(a + o for a, o in zip(acc, out))
    if cfg.spp > 1:
        acc = tuple(a * (1.0 / cfg.spp) for a in acc)
    color, grad, depth, alpha = acc
    flow = None
    if last_camera is not None:
        screen = pixel_screen_coords(cfg.width, cfg.height, cfg.dtype,
                                     dev).reshape(-1, 2)
        org, direction = generate_rays(camera, screen, cfg.width, cfg.height)
        flow = blended_flow(camera, last_camera, cfg.width, cfg.height, org,
                            direction, depth, alpha)
    return _frame(cfg, *ig.finalize(color, grad, depth, alpha), flow)


@dataclasses.dataclass(frozen=True)
class AccumState:
    """Running sums of every Frame channel, and of the squared rgba for
    the variance."""

    rgba: torch.Tensor
    rgba_sq: torch.Tensor
    grad: torch.Tensor
    depth: Any = None
    flow: Any = None


def accumulate(frame: Frame, accum: Optional[AccumState], frame_index
               ) -> tuple[Frame, AccumState]:
    """Progressive accumulation over every frame channel. `frame_index`
    is 1-based; returns (the running mean to display, the new sums)."""
    if accum is None or frame_index <= 1:
        acc = AccumState(rgba=frame.rgba, rgba_sq=frame.rgba ** 2,
                         grad=frame.grad, depth=frame.depth, flow=frame.flow)
        return frame, acc

    def _add(a, b):
        return None if (a is None or b is None) else a + b

    new = AccumState(
        rgba=accum.rgba + frame.rgba, rgba_sq=accum.rgba_sq + frame.rgba ** 2,
        grad=accum.grad + frame.grad, depth=_add(accum.depth, frame.depth),
        flow=_add(accum.flow, frame.flow))
    k = frame_index

    def _avg(a):
        return None if a is None else a / k

    disp = Frame(rgba=new.rgba / k, grad=new.grad / k, depth=_avg(new.depth),
                 flow=_avg(new.flow))
    return disp, new


def variance_of(accum: Optional[AccumState], frame_index) -> float:
    """Mean per-pixel unbiased sample variance of the accumulated rgba;
    inf until two frames are in."""
    k = int(frame_index)
    if accum is None or k < 2:
        return float("inf")
    mean = accum.rgba / k
    var = torch.clamp(accum.rgba_sq / k - mean ** 2, min=0.0) * (k / (k - 1))
    return float(torch.mean(var))


class Renderer:
    """Stateful facade: setters queue parameter changes, `commit()`
    resolves the config and builds the macrocells and the shadow lattice
    it needs (cached until the volume, TF or light changes), `render()`
    draws a frame (and accumulates, if enabled), `mapframe()` returns
    numpy arrays that belong to the caller and stay valid after the next
    frame (from the card, up to `readback.BUDGET` of them in page-locked
    buffers the Renderer reuses once the caller drops them). With sparse
    sampling on, `render()` marches a budget of W*H/8 rays chosen around
    the focus (`render.sparse.render_sparse`) and scatters them into the
    last frame. A dense path-traced config caches the scatter lattices
    (`_pt_fields`) until the volume, TF or density scale changes. A
    neural field's shear-warp frames render a proxy baked once
    (`_proxy_grid`, `bake_grid_host`); its macrocells come from a
    min(max_resolution, 256)^3 bake. `commit` and `render` run without
    autograd. The setters, `commit`, `render` and `mapframe` open the
    spans of `utils.trace` (recorded under a torch profiler);
    `render_time` sums `render()`'s host time after its commit, the wait
    for the card included."""

    def __init__(self, scene: Scene, cfg: RenderConfig = RenderConfig()):
        self.scene = scene
        self._cfg = cfg
        self._camera = scene.camera
        self._frame_index = 0
        self._accum: Optional[AccumState] = None
        self._frame: Optional[Frame] = None
        self._macrocells: Optional[accel.MacrocellGrid] = None
        self._light_grid: Optional[torch.Tensor] = None
        self._pt_fields = None  # ptdense (sigma, J) cache
        self._proxy_grid = None  # a neural field's baked proxy
        self._sparse = False
        self._focus: Optional[sparse.FocusParams] = None
        self._accumulating = False
        self._dirty = True
        self.render_time = 0.0
        self.variance = float("inf")
        self._host = readback.HostBuffers()

    @property
    def _device(self):
        return self.scene.device

    # -- setters --
    def set_fbsize(self, size) -> None:
        w, h = int(size[0]), int(size[1])
        self._cfg = dataclasses.replace(self._cfg, width=w, height=h)
        self._reset()

    def set_camera(self, from_=None, at=None, up=None,
                   camera: Camera = None) -> None:
        with trace.span("set_camera", self._device):
            if camera is None:
                c = self._camera
                camera = Camera.create(
                    from_ if from_ is not None else c.from_,
                    at if at is not None else c.at,
                    up if up is not None else c.up,
                    fovy=c.fovy, height=c.height, kind=c.kind,
                    device=self._device)
        self._camera = camera
        # shear-warp plans depend on the camera
        self._reset(rejit=self._cfg.method != "march")

    def set_transfer_function(self, color, alpha, value_range) -> None:
        with trace.span("set_transfer_function", self._device):
            color = np.asarray(color, np.float32)
            if color.ndim == 1:
                color = color.reshape(-1, 3)
            alpha = np.asarray(alpha, np.float32)
            if alpha.ndim == 2:  # (N, 2) position/value pairs: take values
                alpha = alpha[:, 1]
            tfn = TransferFunction.create(color, alpha, value_range,
                                          device=self._device)
        self.scene = dataclasses.replace(self.scene, tfn=tfn)
        self._macrocells = None
        self._light_grid = None
        self._pt_fields = None
        self._reset(rejit=False)

    def set_sample_per_pixel(self, spp: int) -> None:
        self._cfg = dataclasses.replace(self._cfg, spp=int(spp))
        self._reset()

    def set_volume_sampling_rate(self, rate: float) -> None:
        self.scene = dataclasses.replace(
            self.scene, volume_sampling_rate=torch.tensor(
                float(rate), device=self._device))
        self._cfg = dataclasses.replace(
            self._cfg, sampling_rate=float(rate), max_steps=None,
            shadow_max_steps=None)
        self._light_grid = None
        self._reset()

    def set_volume_data(self, grid) -> None:
        """Swap the volume's voxels (as float32); the macrocells and the
        shadow lattice rebuild at the next commit."""
        grid = torch.as_tensor(np.asarray(grid) if not isinstance(
            grid, torch.Tensor) else grid)
        vol = dataclasses.replace(self.scene.volume, grid=grid.to(
            device=self._device, dtype=torch.float32))
        self.scene = dataclasses.replace(self.scene, volume=vol)
        self._macrocells = None
        self._light_grid = None
        self._pt_fields = None
        self._reset(rejit=False)

    def set_volume_density_scale(self, s: float) -> None:
        self.scene = dataclasses.replace(
            self.scene, density_scale=torch.tensor(float(s),
                                                   device=self._device))
        self._pt_fields = None  # sigma scales with density
        self._reset(rejit=False)

    def set_path_tracing(self, enabled: bool) -> None:
        self._cfg = dataclasses.replace(self._cfg, path_tracing=bool(enabled))
        self._reset()

    def set_frame_accumulation(self, enabled: bool) -> None:
        self._accumulating = bool(enabled)
        self._reset(rejit=False)

    def set_shading(self, mode: str) -> None:
        self._cfg = dataclasses.replace(self._cfg, shading=mode)
        self._reset()

    def set_sparse_sampling(self, enabled: bool) -> None:
        self._sparse = bool(enabled)
        self._reset(rejit=False)

    def set_focus(self, center, scale, base_noise) -> None:
        self._focus = sparse.FocusParams.create(center, scale, base_noise,
                                                device=self._device)
        self._reset(rejit=False)

    # -- lifecycle --
    def _reset(self, rejit: bool = True) -> None:
        self._frame_index = 0
        self._accum = None
        if rejit:
            self._dirty = True

    def commit(self) -> None:
        with torch.no_grad(), trace.span("commit", self._device):
            self._commit()

    def _commit(self) -> None:
        if self._dirty:
            with trace.span("plan", self._device):
                self._cfg = dataclasses.replace(
                    self._cfg, max_steps=None, shadow_max_steps=None
                ).resolved(self.scene, self._camera)
            self._dirty = False
        vol = self.scene.volume
        if ((self._cfg.use_macrocells or self._cfg.path_tracing)
                and self._macrocells is None):
            if is_field(vol):
                # the majorants of a bake (the vnr macrocell bake), in
                # chunks of 4 M points: the same values in fewer launches
                r = min(vol.grid_cfg.max_resolution, 256)
                grid = bake_grid(vol, (r, r, r), chunk=1 << 22)
            else:
                grid = vol.grid
            self._macrocells = accel.build_macrocells(
                grid, self.scene.tfn.alpha, self.scene.tfn.value_range)
        if _wants_light_grid(self._cfg) and self._light_grid is None:
            with trace.span("light_grid", self._device):
                self._light_grid = build_light_grid(self.scene, self._cfg)
        if (self._cfg.path_tracing and self._cfg.pt_dense
                and self._cfg.sw is not None and self._pt_fields is None):
            self._pt_fields = ptdense.prepare(self.scene, self._cfg)
        if (self._cfg.sw is not None and self._proxy_grid is None
                and is_field(vol) and not self._cfg.path_tracing):
            # baked once and reused by every frame (path-traced frames
            # sample the field itself and need none)
            r = int(self._cfg.neural_proxy_res)
            self._proxy_grid = bake_grid_host(vol, (r, r, r))

    def render(self) -> None:
        with torch.no_grad():
            self._commit()  # nothing left to do after commit()
            with trace.span("render", self._device):
                self._render()

    def _render(self) -> None:
        self._frame_index += 1
        t0 = time.perf_counter()
        if self._sparse and not self._cfg.path_tracing:
            gen = torch.Generator(device=self._device)
            gen.manual_seed(self._frame_index)
            frame, _ = sparse.render_sparse(
                self.scene, self._cfg, camera=self._camera,
                focus=self._focus, frame_index=self._frame_index,
                generator=gen, prev_frame=self._frame,
                macrocells=self._macrocells)
        else:
            frame = render(self.scene, self._cfg, camera=self._camera,
                           frame_index=self._frame_index,
                           macrocells=self._macrocells,
                           light_grid=self._light_grid,
                           pt_fields=self._pt_fields,
                           proxy_grid=self._proxy_grid)
        if self._accumulating:
            frame, self._accum = accumulate(frame, self._accum,
                                            self._frame_index)
            self.variance = variance_of(self._accum, self._frame_index)
        if frame.rgba.is_cuda:
            trace.stage("wait", frame.rgba.device)
            torch.cuda.synchronize(frame.rgba.device)
        self.render_time += time.perf_counter() - t0
        self._frame = frame

    def swap(self) -> None:
        """Double buffering is a no-op in a functional renderer."""

    def mapframe(self) -> dict[str, np.ndarray]:
        """The frame's buffers as host arrays (rgba, grad, and depth and
        flow where the frame has them); the frame's spans end here.

        The arrays belong to the caller and keep their values after later
        frames. From the card, each is copied into a page-locked host
        buffer of the Renderer's pool (`utils.readback`), reused only once
        the caller holds neither the array nor any view of it; past the
        pool's budget, into fresh pageable memory. A CPU frame's arrays are
        its tensors' own memory, as `Tensor.numpy()` gives them."""
        global READBACK_BYTES, READBACK_PINNED_BYTES, READBACK_PINNED_ALLOCS
        if self._frame is None:
            raise RuntimeError("render() first")
        f = self._frame
        bufs = {name: t for name, t in (("rgba", f.rgba), ("grad", f.grad),
                                        ("depth", f.depth),
                                        ("flow", f.flow)) if t is not None}
        out = {}
        made = self._host.made
        with trace.span("mapframe", self._device):
            self._host.keep_only({(tuple(t.shape), t.dtype)
                                  for t in bufs.values()})
            for name, t in bufs.items():
                with trace.span(name, t.device):
                    a = self._host.copy(t)
                    if a is None:
                        a = t.detach().cpu().numpy()
                    else:
                        READBACK_PINNED_BYTES += a.nbytes
                    out[name] = a
                    READBACK_BYTES += a.nbytes
            self._host.wait()
            READBACK_PINNED_ALLOCS += self._host.made - made
        trace.end_frame()
        return out
