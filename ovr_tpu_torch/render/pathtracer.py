"""Delta-tracking (Woodcock) volumetric path tracer (port of
`ovr_tpu.render.pathtracer`).

The reference's second pipeline (`ovr/devices/optix7/shaders_pathtracing.cu`):
per pixel, track to a collision through the volume, scatter isotropically,
repeat up to the scatter budget, collect ambient light on escape after
>= 1 scatter:

- collision sampling (`delta_tracking`, shaders_pathtracing.cu:269-475):
  * global-majorant free flight (use_dda == 0, `:447-470`):
      t += -log(1-u)/mu_max; accept when u2 < alpha(t)*density_scale/mu_max
  * macrocell DDA tracking (use_dda == 1, spatial_partition.h:56-96):
      consume optical depth tau = -log(1-u) against per-cell majorants,
      candidate collision where tau runs out, rejection-test against the
      true opacity.
- scattering (`pathtracing`, `:477-542`): isotropic uniform-sphere
  direction, albedo = TF color, Le = ambient on escape (scatter_index
  != 0), throughput *= albedo per collision. The reference increments
  scatter_index twice per level (`:506-516`), so `max_scatters = 24`
  allows 12 collisions — reproduced.

The ray batch advances in lockstep, one state machine per ray: a Python
loop per scatter level whose iterations each handle one macrocell
segment or one collision candidate, and which stops when every ray is
done or after `max_track_steps`, as the JAX package's `lax.while_loop`
does. Each iteration works on the rays still tracking only (one host
sync an iteration reads how many are left); a ray's numbers do not
depend on the others', so this changes no result. Plain PyTorch: the
JAX package's tracker is XLA.

Randomness comes through `Draws`, an interface with the JAX package's
key structure: `fold_in(i)` names a sub-stream (frame -> sample -> level
-> track iteration, plus the scatter direction and `tau0`), `uniform`
draws from it. `GeneratorDraws` is its one implementation here: a
`torch.Generator`, read in call order. The stream names keep the draw
of a given ray at a given step addressable, so another implementation
can replay another generator's numbers exactly. The tracker is
forward-only, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ovr_tpu_torch.core.sampling import classify, intersect_box
from ovr_tpu_torch.neural.field import sample_any_volume, volume_repr
from ovr_tpu_torch.render.accel import MacrocellGrid
from ovr_tpu_torch.render.camera import generate_rays, pixel_screen_coords

BIG = 3.4e38
# tracker iterations of each scatter level run (appended by
# `trace_paths`; reset it to read a frame's)
LEVEL_STEPS: list[int] = []


class Draws:
    """Uniform [0, 1) numbers addressed like JAX keys: `fold_in(i)` is the
    sub-stream named i, `uniform(shape, dtype, device)` draws from this
    stream."""

    def fold_in(self, i: int) -> "Draws":
        raise NotImplementedError

    def uniform(self, shape, dtype=torch.float32, device=None
                ) -> torch.Tensor:
        raise NotImplementedError


class GeneratorDraws(Draws):
    """Draws from one `torch.Generator`, in the order they are asked for
    (every sub-stream is the generator itself). A generator on the CPU
    serving tensors on the card draws on the CPU and copies, so both
    devices trace with the same numbers (as `api._rand` does)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def fold_in(self, i: int) -> "GeneratorDraws":
        return self

    def uniform(self, shape, dtype=torch.float32, device=None):
        g = self.generator
        u = torch.rand(shape, generator=g, dtype=dtype, device=g.device)
        return u if device is None else u.to(device)


def uniform_sample_sphere(u: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere from u (..., 2) in [0,1)^2
    (`uniform_sample_sphere`, shaders_common.h:347-354)."""
    phi = 2.0 * math.pi * u[..., 0]
    cos_t = 1.0 - 2.0 * u[..., 1]
    sin_t = 2.0 * torch.sqrt(u[..., 1] * (1.0 - u[..., 1]))
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                        cos_t], dim=-1)


@dataclasses.dataclass(frozen=True)
class PTConfig:
    max_scatters: int = 24  # params.h:86 (reference counts 2 per level)
    max_track_steps: int = 512  # bound on tracking-loop iterations per level
    use_dda: bool = True


def _sample_alpha(leaves, world_lo, world_hi, pos):
    grid, color_table, alpha_table, value_range, _ = leaves
    p_obj = (pos - world_lo) / (world_hi - world_lo)
    return classify(color_table, alpha_table, value_range,
                    sample_any_volume(grid, p_obj))


def _track(step, org, direction, t0, t1, state0, draws: Draws,
           max_steps: int):
    """The lockstep tracking loop shared by both trackers: iteration i
    draws u (n, 2) from `draws.fold_in(i)` and calls `step` on the rays
    still tracking, `step(u, org, direction, t, t1, state) -> (t, state,
    accept, rgb, done)`. Returns (hit (n,), t (n,), albedo (n, 3))
    for all rays; the loop ends when every ray is done or after
    `max_steps` iterations."""
    n = org.shape[0]
    hit = torch.zeros(n, dtype=torch.bool, device=org.device)
    albedo = torch.zeros((n, 3), dtype=org.dtype, device=org.device)
    t = t0.clone()
    idx = torch.nonzero(t0 < t1).squeeze(1)
    o, d, tt, t1a, st = org[idx], direction[idx], t[idx], t1[idx], (
        None if state0 is None else state0[idx])
    steps = 0
    for i in range(max_steps):
        if idx.numel() == 0:
            break
        u = draws.fold_in(i).uniform((n, 2), org.dtype, org.device)[idx]
        tt, st, accept, rgb, done = step(u, o, d, tt, t1a, st)
        steps += 1
        t.index_copy_(0, idx, tt)
        hit.index_copy_(0, idx, accept)
        albedo.index_copy_(0, idx, torch.where(accept[:, None], rgb, 0.0))
        keep = torch.nonzero(~done).squeeze(1)  # the iteration's one sync
        idx, o, d, tt, t1a = idx[keep], o[keep], d[keep], tt[keep], t1a[keep]
        st = None if st is None else st[keep]
    LEVEL_STEPS.append(steps)
    return hit, t, albedo


def delta_track_global(leaves, world_lo, world_hi, org, direction, t0, t1,
                       draws: Draws, cfg: PTConfig):
    """Global-majorant free-flight tracking (shaders_pathtracing.cu:447-470).

    Returns (hit (N,), t (N,), albedo (N,3)). mu_max = density_scale * 1.
    """
    density_scale = leaves[4]
    mu_max = density_scale  # * max_opacity(=1), shaders_pathtracing.cu:281-283

    def step(u, o, d, t, t1a, _):
        t_new = t + -torch.log1p(-u[:, 0]) / mu_max
        escaped = t_new > t1a
        rgb, a = _sample_alpha(leaves, world_lo, world_hi,
                               o + t_new[:, None] * d)
        accept = ~escaped & (u[:, 1] < a * density_scale / mu_max)
        return t_new, None, accept, rgb, escaped | accept

    return _track(step, org, direction, t0, t1, None, draws,
                  cfg.max_track_steps)


def delta_track_dda(leaves, world_lo, world_hi, org, direction, t0, t1,
                    draws: Draws, cfg: PTConfig, mc: MacrocellGrid):
    """Macrocell-majorant tracking: the reference's DeltaTrackingIter
    (spatial_partition.h:56-96) as a lockstep state machine. Each loop
    iteration either (a) consumes the current cell's optical-depth budget
    and advances to the cell exit, or (b) places a collision candidate
    and rejection-tests it.

    A grazing ray can stall in (a): its nudge past the cell face
    (`cell_exit_t`'s 1e-5 in t) moves it less than an f32 ulp along the
    face's axis, so the next iteration finds it in the same cell and
    gives the same exit. That is a fixed point (case (a) reads no draw):
    the JAX package's loop keeps such a ray until `max_track_steps` and
    returns it unchanged, not hit; here it is retired at once with that
    same result."""
    n = org.shape[0]
    density_scale = leaves[4]
    extent = world_hi - world_lo
    eps = 1e-7

    u0 = draws.fold_in(0xFFFF).uniform((n,), org.dtype, org.device)
    tau0 = -torch.log1p(-u0)

    def step(u, o, d, t, t1a, tau):
        t_probe = t + eps
        p_obj = (o + t_probe[:, None] * d - world_lo) / extent
        maj = mc.majorant_at(p_obj) * density_scale
        t_exit = mc.cell_exit_t(o, d, t_probe, world_lo, world_hi)
        seg_end = torch.minimum(t_exit, t1a)

        empty = maj <= 1.19e-7
        dtau_cap = (seg_end - t) * maj
        passes = empty | (tau > dtau_cap)  # tau survives the whole cell
        # (a) pass through the cell
        tau_pass = torch.where(empty, tau, tau - dtau_cap)
        done_pass = seg_end >= t1a  # exits the volume: no collision
        # (b) collision candidate inside this cell
        t_cand = t + tau / torch.clamp(maj, min=1e-30)
        rgb, a = _sample_alpha(leaves, world_lo, world_hi,
                               o + t_cand[:, None] * d)
        accept = u[:, 0] * maj < a * density_scale
        tau_new = -torch.log1p(-u[:, 1])  # redraw on rejection

        new_t = torch.where(passes, seg_end, t_cand)
        new_tau = torch.where(passes, tau_pass, tau_new)
        new_hit = ~passes & accept
        stalled = seg_end == t  # (a) without progress: a fixed point
        new_done = torch.where(passes, done_pass | stalled, accept)
        return new_t, new_tau, new_hit, rgb, new_done

    return _track(step, org, direction, t0, t1, tau0, draws,
                  cfg.max_track_steps)


def _box(org, direction, world_lo, world_hi):
    t0 = torch.zeros(org.shape[0], dtype=org.dtype, device=org.device)
    t0, t1 = intersect_box(org, direction, world_lo, world_hi, t0,
                           torch.full_like(t0, BIG))
    return torch.clamp(t0, min=0.0), t1


def trace_paths(leaves, world_lo, world_hi, org, direction, draws: Draws,
                ambient, cfg: PTConfig, mc: Optional[MacrocellGrid] = None):
    """Full multi-scatter transport for a ray batch.

    Returns (color (N,3), alpha (N,)). Iterative form of the recursion in
    `pathtracing` (shaders_pathtracing.cu:477-542). Rays no longer on a
    path are not tracked again (the JAX package tracks them and masks
    the result out), and the levels stop when no path is left.
    """
    n = org.shape[0]
    t0, t1 = _box(org, direction, world_lo, world_hi)
    box_hit = t1 > t0
    alpha = box_hit.to(org.dtype)  # CH sets payload.alpha = 1 (:541)

    # reference counts scatter_index by 2 per level (see module docstring)
    max_levels = cfg.max_scatters // 2 + 1
    use_dda = mc is not None and cfg.use_dda

    throughput = torch.ones((n, 3), dtype=org.dtype, device=org.device)
    radiance = torch.zeros_like(throughput)
    si = torch.zeros(n, dtype=torch.int32, device=org.device)
    active = box_hit
    for li in range(max_levels):
        if li and not bool(active.any()):
            break
        k = draws.fold_in(li)
        ta = torch.where(active, t0, t1)  # done from the start elsewhere
        if use_dda:
            hit, t_hit, albedo = delta_track_dda(
                leaves, world_lo, world_hi, org, direction, ta, t1,
                k.fold_in(1), cfg, mc)
        else:
            hit, t_hit, albedo = delta_track_global(
                leaves, world_lo, world_hi, org, direction, ta, t1,
                k.fold_in(1), cfg)

        escaped = active & ~hit
        # ambient on escape after >= 1 scatter (:495-497)
        radiance = radiance + torch.where(
            (escaped & (si != 0))[:, None], throughput * ambient, 0.0)

        si_hit = si + 1
        cont = si_hit <= cfg.max_scatters  # :507
        active = active & hit & cont
        throughput = torch.where(active[:, None], throughput * albedo,
                                 throughput)

        new_org = org + t_hit[:, None] * direction
        u = k.fold_in(2).uniform((n, 2), org.dtype, org.device)
        new_dir = uniform_sample_sphere(u)
        nt0, nt1 = _box(new_org, new_dir, world_lo, world_hi)
        org = torch.where(active[:, None], new_org, org)
        direction = torch.where(active[:, None], new_dir, direction)
        t0 = torch.where(active, nt0, t0)
        t1 = torch.where(active, torch.maximum(nt1, nt0), t1)
        si = torch.where(hit, si_hit + 1, si)  # child payload gets si+1 (:516)
    return radiance, alpha


def render_frame(scene, cfg, camera, draws: Draws, macrocells=None):
    """Render a path-traced frame (called from api.render). `draws`: the
    frame's random numbers (`GeneratorDraws`); sample s draws its screen
    jitter from `draws.fold_in(s)` and traces with
    `draws.fold_in(s).fold_in(3)`. With `cfg.ray_chunk` the rays are
    traced in chunks of that many (the last padded as in the JAX
    package), each from the same sub-stream."""
    from ovr_tpu_torch.api import Frame

    dev = scene.device
    dt = cfg.dtype
    screen = pixel_screen_coords(cfg.width, cfg.height, dt, dev)
    screen = screen.reshape(-1, 2)
    n = screen.shape[0]
    leaves = (volume_repr(scene.volume), scene.tfn.color, scene.tfn.alpha,
              scene.tfn.value_range, scene.density_scale)
    lo = scene.volume.world_lo
    hi = scene.volume.world_hi
    ptcfg = PTConfig(max_scatters=cfg.max_scatters,
                     max_track_steps=max(cfg.max_steps * 2, 64),
                     use_dda=cfg.use_macrocells)
    ambient = scene.light.ambient

    color_acc = torch.zeros((n, 3), dtype=dt, device=dev)
    alpha_acc = torch.zeros((n,), dtype=dt, device=dev)
    for s in range(cfg.spp):
        sd = draws.fold_in(s)
        sc = screen
        if cfg.spp > 1:
            jit2 = sd.uniform((n, 2), dt, dev) - 0.5
            sc = screen + jit2 / torch.tensor([cfg.width, cfg.height],
                                              dtype=dt, device=dev)
        org, direction = generate_rays(camera, sc, cfg.width, cfg.height)

        def trace(o, d):
            return trace_paths(leaves, lo, hi, o, d, sd.fold_in(3), ambient,
                               ptcfg, macrocells)

        c = cfg.ray_chunk
        if c and n > c:
            # chunk the launch: bounds the tracker's working set
            pad = -(-n // c) * c - n
            org_p = F.pad(org, (0, 0, 0, pad))
            dir_p = F.pad(direction, (0, 0, 0, pad), value=1.0)
            outs = [trace(org_p[i:i + c], dir_p[i:i + c])
                    for i in range(0, n + pad, c)]
            color = torch.cat([o[0] for o in outs])[:n]
            alpha = torch.cat([o[1] for o in outs])[:n]
        else:
            color, alpha = trace(org, direction)
        color_acc = color_acc + color
        alpha_acc = alpha_acc + alpha
    color, alpha = color_acc / cfg.spp, alpha_acc / cfg.spp
    rgba = torch.cat([color, alpha[:, None]], dim=-1)
    return Frame(rgba=rgba.reshape(cfg.height, cfg.width, 4),
                 grad=torch.zeros((cfg.height, cfg.width, 3), dtype=dt,
                                  device=dev))
