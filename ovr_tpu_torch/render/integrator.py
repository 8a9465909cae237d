"""Front-to-back emission-absorption ray march (port of
`ovr_tpu.render.integrator`).

The march is the JAX package's correctness oracle and its general path:
every view, every shading mode, extra and point lights. One step for the
whole ray batch:

    t = (t0, min(t1, t0 + step))
    while t.y > t.x and alpha < 0.9999:
        s     = volume(org + 0.5*(t.x+t.y)*dir)
        rgba  = transfer_function(s);  a = 1-(1-a)^(base*(t.y-t.x))
        shade = gradient normal (+ shadow at 'shadow')
        C    += (1-alpha) * clamp(rgb) * a;  alpha += (1-alpha) * a
        t     = (t.y, min(t.y + step, t1))

Two loops share `_march_step`:
- `march` runs all `max_steps` steps (JAX's `lax.scan`); autograd
  records every step, so gradients reach the grid, the TF tables, the
  camera rays, the lights and a lattice.
- `march_while` stops once no ray is active (JAX's `lax.while_loop`); it
  asks the device every `CHECK_EVERY` steps, and the steps it runs past
  the last active ray change nothing, so it gives `march`'s bits.
  Forward-only: it raises under grad.

With a `MacrocellGrid`, a step in a cell whose majorant is zero jumps to
the cell's exit; `adaptive_scale > 1` stretches the step by
1/majorant, capped. The shadow term is one fetch from a precomputed
lattice (`ShadeContext.light_alpha`) or, without one, a march toward the
light from every sample (`_shadow_alpha`).

No kernel: JAX's march is XLA, so this is plain PyTorch, placed on the
device of the rays. `STEPS` counts the steps the loops ran.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ovr_tpu_torch.core.sampling import (classify, clip, fd_points,
                                         intersect_box, opacity_correction,
                                         safe_normalize, sample_volume,
                                         scalar)
from ovr_tpu_torch.neural.field import sample_any_volume, volume_rdim

SHADING_NONE = "none"
SHADING_DIFFUSE = "diffuse"  # gradient shading, no shadow
SHADING_SHADOW = "shadow"  # gradient shading + shadow
SHADING_SSH = "ssh"  # single-shade heuristic (march only)

EARLY_EXIT_ALPHA = 0.9999
CHECK_EVERY = 16  # march_while: steps between "any ray active?" reads
STEPS = 0  # steps run by march / march_while (a diagnostic counter)


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Static integrator settings."""

    max_steps: int
    shading: str = SHADING_SHADOW
    shadow_scale: float = 10.0
    shadow_max_steps: int = 64
    light_intensity: float = 2.0
    # step *= clip(1/majorant, 1, adaptive_scale) inside each macrocell;
    # 1.0 = fixed steps
    adaptive_scale: float = 1.0
    shading_scale: float = 0.8  # the 'ssh' deferred-shade blend weight


def _clamp01(x):
    return clip(x, 0.0, 1.0)


def _to_object(p, world_lo, world_hi):
    """World position -> normalized [0,1]^3 texture coordinate."""
    return (p - world_lo) / (world_hi - world_lo)


def _shadow_alpha(grid, color_table, alpha_table, value_range, base,
                  pos, light_dir, world_lo, world_hi, step,
                  cfg: MarchConfig):
    """Alpha accumulated marching from each `pos` (N, 3) toward the light
    at `shadow_scale * step`, `shadow_max_steps` steps."""
    n = pos.shape[0]
    t0 = pos.new_zeros((n,))
    t1 = pos.new_full((n,), 3.4e38)
    t0, t1 = intersect_box(pos, light_dir, world_lo, world_hi, t0, t1)
    sstep = cfg.shadow_scale * step
    tx = t0
    ty = torch.minimum(t1, t0 + sstep)
    alpha = pos.new_zeros((n,))
    for _ in range(cfg.shadow_max_steps):
        active = (ty > tx) & (alpha < EARLY_EXIT_ALPHA)
        mid = 0.5 * (tx + ty)
        p = pos + mid[..., None] * light_dir
        s = sample_any_volume(grid, _to_object(p, world_lo, world_hi))
        _, a = classify(color_table, alpha_table, value_range, s)
        a = opacity_correction(a, base, ty - tx)
        alpha = torch.where(active, alpha + (1.0 - alpha) * a, alpha)
        tx2 = ty
        ty2 = torch.minimum(tx2 + sstep, t1)
        tx = torch.where(active, tx2, tx)
        ty = torch.where(active, ty2, ty)
    return alpha


@dataclasses.dataclass(frozen=True)
class ShadeContext:
    """Per-frame shading inputs.

    `light_dir` (3,) unit, toward the light; `wtc` (3, 3) world-to-camera
    rows; `grad_hi`: the volume's upper boundary in local coordinates
    (None = 1), where the forward difference flips; `light_alpha`: the
    shadow lattice, or None for the per-sample shadow march; extra
    directional lights as (L, 3) unit directions and (L,) intensities,
    point lights as (L, 3) positions and (L,) intensities with
    inverse-square falloff."""

    light_dir: Any
    wtc: Any
    world_lo: Any
    world_hi: Any
    grad_hi: Any = None
    light_alpha: Any = None
    extra_dirs: Any = None
    extra_dir_intens: Any = None
    point_pos: Any = None
    point_intens: Any = None


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _max(x, v: float):
    """jnp.maximum(x, v): the cotangent halves at a tie."""
    return torch.maximum(x, scalar(v, x.dtype, x.device))


def _march_step(carry, scene_leaves, ctx: ShadeContext, cfg: MarchConfig,
                org, direction, step, t1, occupancy=None):
    """One front-to-back step for the whole ray batch; returns the new
    carry (tx, ty, color, gradient, depth, alpha)."""
    grid, color_table, alpha_table, value_range, base = scene_leaves
    tx, ty, color, gradient, depth, alpha = carry

    active = (ty > tx) & (alpha < EARLY_EXIT_ALPHA)
    mid = 0.5 * (tx + ty)
    pos = org + mid[..., None] * direction
    p_obj = _to_object(pos, ctx.world_lo, ctx.world_hi)

    if cfg.shading != SHADING_NONE:
        # the sample and its three forward-difference probes in one fetch
        stp, pts = fd_points(p_obj,
                             volume_rdim(grid, p_obj.dtype, p_obj.device),
                             1.0 if ctx.grad_hi is None else ctx.grad_hi,
                             center=True)
        vals = sample_any_volume(grid, pts)
        s = vals[..., 0]
        g = (vals[..., 1:] - s[..., None]) / stp
    else:
        s = sample_any_volume(grid, p_obj)
    rgb, a = classify(color_table, alpha_table, value_range, s)
    a = opacity_correction(a, base, ty - tx)

    if cfg.shading != SHADING_NONE:
        # normal: flipped, normalized gradient; dividing by the box
        # extent first is exact for the diagonal object-to-world map
        extent = ctx.world_hi - ctx.world_lo
        n_world = safe_normalize(-g / extent)
        # products as sums along the last axis, not matmuls: a ray's bits
        # then do not depend on the batch (ray_chunk)
        n_cam = safe_normalize(_dot(n_world[..., None, :], ctx.wtc))
        cos_nl = torch.abs(torch.sum(ctx.light_dir * n_world, dim=-1))
        if cfg.shading == SHADING_SHADOW:
            if ctx.light_alpha is not None:
                shadow = sample_volume(ctx.light_alpha, p_obj)
            else:
                shadow = _shadow_alpha(
                    grid, color_table, alpha_table, value_range, base, pos,
                    ctx.light_dir, ctx.world_lo, ctx.world_hi, step, cfg)
        else:
            shadow = 0.0
        total = cos_nl * cfg.light_intensity
        if ctx.extra_dirs is not None:
            cos_e = torch.abs(_dot(n_world[:, None, :], ctx.extra_dirs))
            total = total + _dot(cos_e, ctx.extra_dir_intens)
        if ctx.point_pos is not None:
            delta = ctx.point_pos[None, :, :] - pos[:, None, :]  # (N, L, 3)
            r2 = torch.sum(delta * delta, dim=-1)
            ldir = delta * torch.rsqrt(_max(r2, 1e-12))[..., None]
            cos_p = torch.abs(torch.sum(n_world[:, None, :] * ldir, dim=-1))
            total = total + _dot(cos_p / _max(r2, 1e-6), ctx.point_intens)
        shade = 0.5 + 0.5 * total * (1.0 - shadow)
        rgb = rgb * shade[..., None]
    else:
        n_cam = torch.zeros_like(pos)

    tr = 1.0 - alpha
    w = tr * torch.where(active, a, 0.0)
    color = color + w[..., None] * _clamp01(rgb)
    gradient = gradient + w[..., None] * _clamp01(n_cam)
    # premultiplied expected depth: with alpha it rebuilds the blended
    # sample position, and from it the blended optical flow
    depth = depth + w * mid
    alpha = alpha + w

    # advance; in an empty macrocell jump to its exit
    tx_next = ty
    ty_next = torch.minimum(tx_next + step, t1)
    if occupancy is not None:
        maj = occupancy.majorant_at(p_obj)
        empty = maj <= 1.19e-7
        t_exit = occupancy.cell_exit_t(org, direction, mid, ctx.world_lo,
                                       ctx.world_hi)
        skip_to = torch.maximum(t_exit, tx_next)
        tx_next = torch.where(empty & active, torch.minimum(skip_to, t1),
                              tx_next)
        if cfg.adaptive_scale > 1.0:
            # an interval overruns its cell by at most one base step, so
            # a dense cell after a sparse one starts at base density
            ss = step * clip(1.0 / _max(maj, 1e-6), 1.0, cfg.adaptive_scale)
            ty_next = torch.minimum(torch.minimum(tx_next + ss,
                                                  skip_to + step), t1)
        else:
            ty_next = torch.minimum(tx_next + step, t1)
    tx = torch.where(active, tx_next, tx)
    ty = torch.where(active, ty_next, ty)
    return (tx, ty, color, gradient, depth, alpha)


def _init_carry(org, direction, ctx, step, big=3.4e38):
    n = org.shape[0]
    t0 = org.new_zeros((n,))
    t1 = org.new_full((n,), big)
    t0, t1 = intersect_box(org, direction, ctx.world_lo, ctx.world_hi, t0,
                           t1)
    t0 = _max(t0, 0.0)
    t1 = torch.maximum(t1, t0)  # empty intervals collapse to zero length
    tx = t0
    ty = torch.minimum(t1, t0 + step)
    zero3 = org.new_zeros((n, 3))
    zero = org.new_zeros((n,))
    return (tx, ty, zero3, zero3, zero, zero), t1


def _apply_t_cap(carry, t1, t_cap):
    """Clip each ray's interval at `t_cap` (a background surface hit)."""
    if t_cap is None:
        return carry, t1
    tx, ty, c, g, d, a = carry
    t1 = torch.minimum(t1, t_cap)
    tx = torch.minimum(tx, t1)
    ty = torch.minimum(ty, t1)
    return (tx, ty, c, g, d, a), t1


def _start(org, direction, ctx, step, jitter, t_cap):
    carry, t1 = _init_carry(org, direction, ctx, step)
    carry, t1 = _apply_t_cap(carry, t1, t_cap)
    if jitter is not None:
        tx, ty, c, g, d, a = carry
        tx = tx + jitter * step
        ty = torch.minimum(t1, tx + step)
        carry = (tx, ty, c, g, d, a)
    return carry, t1


def _ssh_deferred_shade(color, alpha, pk_w, pk_t, org, direction,
                        scene_leaves, ctx: ShadeContext, cfg: MarchConfig,
                        step):
    """Single-shade heuristic: one shadow evaluation at the ray's
    highest-contribution sample, blended over the unshaded composite."""
    grid, color_table, alpha_table, value_range, base = scene_leaves
    pos = org + pk_t[..., None] * direction
    p_obj = _to_object(pos, ctx.world_lo, ctx.world_hi)
    s = sample_any_volume(grid, p_obj)
    rgb, _ = classify(color_table, alpha_table, value_range, s)
    if ctx.light_alpha is not None:
        sh_a = sample_volume(ctx.light_alpha, p_obj)
    else:
        sh_a = _shadow_alpha(grid, color_table, alpha_table, value_range,
                             base, pos, ctx.light_dir, ctx.world_lo,
                             ctx.world_hi, step, cfg)
    lit = _clamp01(rgb) * (alpha * (1.0 - sh_a))[..., None]
    w = cfg.shading_scale
    shaded = (1.0 - w) * color + w * lit
    return torch.where((pk_w > 0)[..., None], shaded, color)


def _stepper(scene_leaves, ctx, cfg, org, direction, step, t1, occupancy):
    """The step function and the state it carries: (carry, pk_w, pk_t),
    the last two the ssh peak weight and its depth (unused otherwise)."""
    ssh = cfg.shading == SHADING_SSH
    inner = dataclasses.replace(cfg, shading=SHADING_NONE) if ssh else cfg

    def one(state):
        global STEPS
        carry, pk_w, pk_t = state
        alpha_old = carry[5]
        mid = 0.5 * (carry[0] + carry[1])
        carry = _march_step(carry, scene_leaves, ctx, inner, org, direction,
                            step, t1, occupancy)
        if ssh:
            w = carry[5] - alpha_old  # this step's contribution tr*a
            better = w > pk_w
            pk_w = torch.where(better, w, pk_w)
            pk_t = torch.where(better, mid, pk_t)
        STEPS += 1
        return carry, pk_w, pk_t

    return one


def _finish(state, org, direction, scene_leaves, ctx, cfg, step):
    carry, pk_w, pk_t = state
    _, _, color, gradient, depth, alpha = carry
    if cfg.shading == SHADING_SSH:
        color = _ssh_deferred_shade(color, alpha, pk_w, pk_t, org, direction,
                                    scene_leaves, ctx, cfg, step)
    return color, gradient, depth, alpha


def march(org, direction, scene_leaves, ctx: ShadeContext, cfg: MarchConfig,
          step, occupancy=None, jitter=None, t_cap=None):
    """Differentiable march over all `cfg.max_steps` steps. Returns the
    premultiplied (color, gradient, depth, alpha) (see `finalize`).

    `org`/`direction`: (N, 3) world-space rays. `scene_leaves` = (grid,
    color_table, alpha_table, value_range, base), the grid dense or a
    `NeuralFieldVolume` (sampled through `sample_any_volume`; its
    gradient step is one finest-level cell). `step`: the world step
    (1 / sampling_rate). `occupancy`: a `MacrocellGrid` for empty-space
    skipping (its majorants are a control input: no gradient reaches
    them). `jitter`: optional (N,) in [0,1), times `step` added to t0.
    `t_cap`: optional (N,) march stop."""
    carry, t1 = _start(org, direction, ctx, step, jitter, t_cap)
    occupancy = _detached(occupancy)
    one = _stepper(scene_leaves, ctx, cfg, org, direction, step, t1,
                   occupancy)
    zero = org.new_zeros((org.shape[0],))
    state = (carry, zero, zero)
    for _ in range(cfg.max_steps):
        state = one(state)
    return _finish(state, org, direction, scene_leaves, ctx, cfg, step)


def march_while(org, direction, scene_leaves, ctx: ShadeContext,
                cfg: MarchConfig, step, occupancy=None, jitter=None,
                t_cap=None):
    """Forward-only march that stops once every ray has terminated or
    left the volume (or after `max_steps`). Same arguments and result as
    `march`, bit for bit. Raises under grad, as JAX's while loop does."""
    leaves = [org, direction, step, jitter, t_cap, *scene_leaves,
              *(getattr(ctx, f.name) for f in dataclasses.fields(ctx))]
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in leaves):
        raise RuntimeError(
            "march_while (fast_math) is forward-only: under grad use march "
            "(RenderConfig(fast_math=False))")
    carry, t1 = _start(org, direction, ctx, step, jitter, t_cap)
    one = _stepper(scene_leaves, ctx, cfg, org, direction, step, t1,
                   _detached(occupancy))
    zero = org.new_zeros((org.shape[0],))
    state = (carry, zero, zero)
    i = 0
    while i < cfg.max_steps:
        tx, ty, alpha = state[0][0], state[0][1], state[0][5]
        if not bool(torch.any((ty > tx) & (alpha < EARLY_EXIT_ALPHA))):
            break
        for _ in range(min(CHECK_EVERY, cfg.max_steps - i)):
            state = one(state)
            i += 1
    return _finish(state, org, direction, scene_leaves, ctx, cfg, step)


def _detached(occupancy):
    if occupancy is None:
        return None
    return dataclasses.replace(occupancy,
                               majorant=occupancy.majorant.detach())


def finalize(color, gradient, depth, alpha):
    """Premultiplied accumulators -> stored (straight) outputs: divide by
    the final alpha where it exceeds 1e-12, else 0 (zero background).
    `depth` becomes the alpha-blended expected hit distance."""
    sel = alpha > 1e-12
    safe = torch.where(sel, alpha, torch.ones_like(alpha))
    sel3 = sel[..., None]
    safe3 = safe[..., None]
    out_color = torch.where(sel3, color / safe3, 0.0)
    out_grad = torch.where(sel3, gradient / safe3, 0.0)
    out_depth = torch.where(sel, depth / safe, 0.0)
    return out_color, out_grad, out_depth, alpha
