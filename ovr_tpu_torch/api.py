"""Public rendering API (port of `ovr_tpu.api`, shear-warp branch).

    cfg = RenderConfig(width=1920, height=1080, method="auto",
                       shading="diffuse").resolved(scene)
    frame = render(scene, cfg, macrocells=mc)

`render` runs the shear-warp fast path; parts of `ovr_tpu.api` that
later slices of the port bring raise NotImplementedError naming them
(ROADMAP.md, "Queue next").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ovr_tpu_torch.core.sampling import safe_normalize
from ovr_tpu_torch.core.scene import Camera, Scene
from ovr_tpu_torch.render import accel
from ovr_tpu_torch.render import integrator as ig
from ovr_tpu_torch.render import lightgrid, shearwarp

_SHADING_EXTRAS = "the slice after the backward (sw_bf16, point lights, " \
    "jitter_rays, optical flow)"
_MARCH = "the march slice (render/integrator.py march)"
_LATER = "a later slice of ROADMAP Queue 1"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings; the fields and defaults of
    `ovr_tpu.api.RenderConfig`. `sw_persist` and `sw_col_win` chose TPU
    kernel variants with identical results and change nothing here.
    `ovr_tpu`'s `sw_pallas` (the Pallas kernel or the XLA slice loop) has
    no counterpart: the slice loop is the kernel on the card and its plain
    version on the CPU."""

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
    use_macrocells: bool = False
    adaptive_scale: float = 1.0
    jitter_rays: bool = False
    fast_math: bool = False
    shadow_grid: bool = True  # shadows from the precomputed lattice
    shadow_grid_res: int = 0  # lattice cap per axis; 0 = clamp(n/4, 128, 512)
    shading_scale: float = 0.8
    ray_chunk: Optional[int] = None
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
            eligible = (not self.path_tracing
                        and self.shading in (ig.SHADING_NONE,
                                             ig.SHADING_DIFFUSE,
                                             ig.SHADING_SHADOW))
            sw = (shearwarp.resolve_static(scene, camera or scene.camera,
                                           self) if eligible else None)
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
    flow (None until the flow slice lands)."""

    rgba: torch.Tensor
    grad: torch.Tensor
    depth: Any = None
    flow: Any = None


def _wants_light_grid(cfg: RenderConfig) -> bool:
    return cfg.shadow_grid and cfg.shading in (ig.SHADING_SHADOW,
                                               ig.SHADING_SSH)


def build_light_grid(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """Shadow-alpha lattice for `render(..., light_grid=...)`, by the
    dense light-axis sweep. Rebuild when the volume, TF or light
    changes."""
    vol = scene.volume
    leaves = (vol.grid, scene.tfn.color, scene.tfn.alpha,
              scene.tfn.value_range,
              cfg.base_rate * torch.ones((), dtype=cfg.dtype,
                                         device=vol.grid.device))
    shape = vol.grid.shape
    cap = cfg.shadow_grid_res or min(512, max(128, max(shape) // 4))
    res = lightgrid.default_resolution(shape, cap=cap)
    direction = safe_normalize(scene.light.direction)
    return lightgrid.build_light_grid_swept(leaves, direction, vol.world_lo,
                                            vol.world_hi, res)


def _unsupported(scene: Scene, cfg: RenderConfig, last_camera):
    """The first feature outside this slice of the port, or None."""
    if cfg.path_tracing:
        return f"path tracing arrives with {_LATER} (render/pathtracer.py)"
    if not hasattr(scene.volume, "grid"):
        return f"neural-field volumes arrive with {_LATER} (neural/)"
    if scene.geometries:
        return f"geometries arrive with {_LATER} (render/geometry.py)"
    if scene.instances:
        return f"volume instances arrive with {_LATER} (render/multivol.py)"
    if any(lt.kind == "point" for lt in scene.lights):
        return f"point lights arrive with {_SHADING_EXTRAS}"
    n_dir = sum(lt.kind in ("directional", "sunsky") for lt in scene.lights)
    if n_dir > 4 and cfg.shading != ig.SHADING_NONE:
        return (f"{n_dir} extra directional lights: the slice kernel has "
                f"slots for 4; more arrive with {_SHADING_EXTRAS}")
    if cfg.jitter_rays:
        return f"jitter_rays arrives with {_SHADING_EXTRAS}"
    if last_camera is not None:
        return f"optical flow (last_camera) arrives with {_SHADING_EXTRAS}"
    if cfg.sw_bf16:
        return f"sw_bf16 arrives with {_SHADING_EXTRAS}"
    if cfg.sw is None:
        return (f"method={cfg.method!r} without an eligible shear-warp plan "
                f"needs {_MARCH}")
    return None


def render(scene: Scene, cfg: RenderConfig, camera: Optional[Camera] = None,
           macrocells: Optional[accel.MacrocellGrid] = None,
           last_camera: Optional[Camera] = None,
           light_grid: Optional[torch.Tensor] = None) -> Frame:
    """Render one frame through the shear-warp fast path.

    `cfg` must be resolved (`cfg.resolved(scene)`). `light_grid`: the
    shadow lattice (`build_light_grid`), built here when shadow shading
    needs one and none is given. Inputs that require grad raise: the
    backward is the next slice."""
    if cfg.max_steps is None:
        raise ValueError("call cfg.resolved(scene) first")
    if camera is None:
        camera = scene.camera
    why = _unsupported(scene, cfg, last_camera)
    if why is not None:
        raise NotImplementedError(why)
    if light_grid is None and _wants_light_grid(cfg):
        light_grid = build_light_grid(scene, cfg)
    return _render_shearwarp_frame(scene, cfg, camera, light_grid,
                                   macrocells)


def _render_shearwarp_frame(scene: Scene, cfg: RenderConfig, camera: Camera,
                            light_grid=None, macrocells=None) -> Frame:
    """Shear-warp frame; spp > 1 stratifies the sample-plane offset."""
    acc = None
    for s in range(cfg.spp):
        off = ((torch.tensor(float(s), dtype=cfg.dtype) + 0.5) / cfg.spp
               if cfg.spp > 1 else None)
        out = shearwarp.render_shearwarp(scene, cfg, camera, jitter=off,
                                         light_grid=light_grid,
                                         macrocells=macrocells)
        acc = out if acc is None else tuple(a + o for a, o in zip(acc, out))
    if cfg.spp > 1:
        acc = tuple(a * (1.0 / cfg.spp) for a in acc)
    color, grad, depth, alpha = ig.finalize(*acc)
    rgba = torch.cat([color, alpha[..., None]], dim=-1)
    return Frame(rgba=rgba.reshape(cfg.height, cfg.width, 4),
                 grad=grad.reshape(cfg.height, cfg.width, 3),
                 depth=depth.reshape(cfg.height, cfg.width))
