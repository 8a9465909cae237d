"""Z-slab bricked volumes with ring compositing of partial ray segments
(port of `ovr_tpu.parallel.bricks`).

The front-to-back recurrence C <- C + T c a, T <- T (1 - a) is
associative in (C, T) pairs, so a ray splits into segments integrated
apart and combined in ray order. The volume's Z axis is cut into B slabs
("bricks"), one per rank of the `bricks` axis; a rank holds only its slab
(S + 4 rows: a 2-voxel edge-clamped halo on each side for trilinear taps
and the gradient probe), the global box, the TF, the light and the
camera. Each rank integrates its rays' segment on the global lattice:
the march through `integrator.march_segment`, shear-warp through the
slice kernel with the brick's sample box, its ownership clip box and,
when the view's principal axis is Z, its share of the plane schedule.
The partials are combined around a ring of B - 1 hops
(`ring_composite`) or by one all-gather (`gather_composite`), then the
fan is warped to the screen once.

Brick b of a (D, H, W) grid cut into S = D / B rows holds global rows
[b S - 2, b S + S + 2) (clamped at the edges); its sampling box is chosen
so its texel centres coincide with the global grid's, and it owns
z in [b / B, (b + 1) / B) of the world box.

Limitations (as in the JAX package): 'shadow' in the march marches
shadow rays within the local brick only; shear-warp's shadow lattice is
the global one, replicated; jitter is unsupported; scenes with surfaces
take the march; in diffuse the axial finite difference restarts at each
brick's first plane, so a bricked shear-warp frame differs from the
unbricked one by up to ~3e-2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ovr_tpu_torch import api
from ovr_tpu_torch.core.sampling import intersect_box, safe_normalize
from ovr_tpu_torch.core.scene import Camera, Scene
from ovr_tpu_torch.parallel.mesh import Mesh
from ovr_tpu_torch.parallel.tiles import (_rgba, _screen_rows, band_cfg,
                                          bands, march_cfg)
from ovr_tpu_torch.render import integrator as ig
from ovr_tpu_torch.render import shearwarp
from ovr_tpu_torch.render.camera import camera_basis, generate_rays

HALO = 2  # rows of edge-clamped halo on each side of a slab


@dataclasses.dataclass(frozen=True)
class BrickedVolume:
    """A Z-slab decomposition of a StructuredVolume.

    `bricks` (n, S+4, H, W): the slabs; `brick_lo`/`brick_hi` (n, 3)
    each slab's sampling box; `own_lo`/`own_hi` (n, 3) the z-range each
    brick integrates. n is the whole count B (`index` None), or 1: brick
    `index` alone, as a rank holds it."""

    bricks: torch.Tensor
    brick_lo: torch.Tensor
    brick_hi: torch.Tensor
    own_lo: torch.Tensor
    own_hi: torch.Tensor
    index: Optional[int] = None

    def local(self, b: int, device=None) -> "BrickedVolume":
        """Brick b alone (on `device`, default where it is)."""
        if self.index is None:
            sel = slice(b, b + 1)
        elif self.index == b:
            sel = slice(0, 1)
        else:
            raise ValueError(f"this volume holds brick {self.index}, "
                             f"not {b}")
        return BrickedVolume(
            *(t[sel].to(device) if device is not None else t[sel]
              for t in (self.bricks, self.brick_lo, self.brick_hi,
                        self.own_lo, self.own_hi)), index=b)


def slab_rows(depth: int, n_bricks: int, b: int) -> torch.Tensor:
    """The global Z rows brick b holds, halo included, clamped at the
    grid's edges (the edge padding)."""
    if depth % n_bricks:
        raise ValueError(f"depth {depth} must divide into {n_bricks} "
                         "bricks")
    s = depth // n_bricks
    return torch.clamp(torch.arange(b * s - HALO, b * s + s + HALO), 0,
                       depth - 1)


def brick_bounds(world_lo, world_hi, depth: int, n_bricks: int):
    """(brick_lo, brick_hi, own_lo, own_hi), (B, 3) f32 numpy each, in
    the JAX package's f32 arithmetic."""
    wlo, whi = (np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                           else x, np.float32) for x in (world_lo, world_hi))
    s = depth // n_bricks
    ez = whi[2] - wlo[2]
    blo, bhi, olo, ohi = (np.tile(x, (n_bricks, 1))
                          for x in (wlo, whi, wlo, whi))
    for b in range(n_bricks):
        # local texel centre l + 0.5 of the S+4 slab maps to global texel
        # centre (b S - 2) + l + 0.5
        blo[b, 2] = wlo[2] + ez * (b * s - 2) / depth
        bhi[b, 2] = wlo[2] + ez * (b * s + s + 2) / depth
        olo[b, 2] = wlo[2] + ez * b / n_bricks
        ohi[b, 2] = wlo[2] + ez * (b + 1) / n_bricks
    return blo, bhi, olo, ohi


def brick_volume(volume, n_bricks: int,
                 only: Optional[int] = None) -> BrickedVolume:
    """The Z-slab decomposition of `volume` (D % n_bricks == 0), on the
    grid's device; `only=b` keeps brick b alone."""
    grid = volume.grid
    d = grid.shape[0]
    which = range(n_bricks) if only is None else [only]
    # CUDA's index kernels have no uint16 version: move its int16 bits
    src = grid.view(torch.int16) if grid.dtype == torch.uint16 else grid
    bricks = torch.stack([src.index_select(
        0, slab_rows(d, n_bricks, b).to(grid.device))
        for b in which]).view(grid.dtype)
    bounds = [torch.from_numpy(x[list(which)]).to(grid.device)
              for x in brick_bounds(volume.world_lo, volume.world_hi, d,
                                    n_bricks)]
    return BrickedVolume(bricks, *bounds, index=only)


def from_slab(slab: torch.Tensor, world_lo, world_hi, depth: int,
              n_bricks: int, b: int) -> BrickedVolume:
    """Brick b of a depth-row grid from its slab alone (the grid's rows
    `slab_rows(depth, n_bricks, b)`), as a rank that loads only its own
    rows holds it."""
    bounds = [torch.from_numpy(x[b:b + 1]).to(slab.device)
              for x in brick_bounds(world_lo, world_hi, depth, n_bricks)]
    return BrickedVolume(slab[None], *bounds, index=b)


def _over(front, back):
    """Over-compose premultiplied (color, grad, depth, transmittance)
    partials, `front` nearer the camera. Identity: (0, 0, 0, 1)."""
    cf, gf, df, tf = front
    cb, gb, db, tb = back
    return (cf + tf[..., None] * cb, gf + tf[..., None] * gb,
            df + tf * db, tf * tb)


def _select(pred, a, b):
    """Per-ray select of two partials (pred (N,) bool)."""
    return tuple(torch.where(pred[..., None] if x.ndim > pred.ndim else pred,
                             x, y) for x, y in zip(a, b))


def _flat(parts) -> torch.Tensor:
    """A partial's tensors as one flat tensor (one message)."""
    return torch.cat([t.reshape(-1) for t in parts])


def _unflat(flat: torch.Tensor, like):
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return tuple(out)


def _ident(color, depth):
    return (torch.zeros_like(color), torch.zeros_like(color),
            torch.zeros_like(depth), torch.ones_like(depth))


def ring_composite(color, grad, depth, alpha, ascending, mesh: Mesh):
    """Combine the bricks' premultiplied partials over the brick axis with
    a ring of B - 1 hops, in each ray's front-to-back order.

    `ascending` (N,) bool: the ray visits bricks in increasing index
    order. Each hop moves every brick's own partial one rank on; arrivals
    from a smaller index fold into a front accumulator, from a larger one
    into a back accumulator, prepended or appended per ray so each stays
    in front-to-back order. Differentiable: a hop's backward sends its
    cotangent one rank back (`Mesh.shift`), so every brick's partial gets
    the sum of all ranks' cotangents, as JAX's transposed ppermute gives.
    Returns (color, grad, depth, alpha) of the whole ray, alike on every
    brick; with one brick, the partials as they are."""
    n, i = mesh.n_bricks, mesh.brick
    if n == 1:
        return color, grad, depth, alpha
    own = (color, grad, depth, 1.0 - alpha)
    acc_lt = acc_gt = _ident(color, depth)
    trav = _flat(own)
    for s in range(1, n):
        trav = mesh.shift(trav, 1)
        arrived = _unflat(trav, own)
        j = (i - s) % n
        # arrivals come in decreasing j within each group; ascending rays
        # need increasing order -> prepend, descending -> append
        if j < i:
            acc_lt = _select(ascending, _over(arrived, acc_lt),
                             _over(acc_lt, arrived))
        else:
            acc_gt = _select(ascending, _over(arrived, acc_gt),
                             _over(acc_gt, arrived))
    asc_res = _over(acc_lt, _over(own, acc_gt))
    desc_res = _over(acc_gt, _over(own, acc_lt))
    c, g, d, t = _select(ascending, asc_res, desc_res)
    return c, g, d, 1.0 - t


def gather_composite(color, grad, depth, alpha, ascending, mesh: Mesh):
    """The same composite from one all-gather over the brick axis."""
    n = mesh.n_bricks
    if n == 1:
        return color, grad, depth, alpha
    own = (color, grad, depth, 1.0 - alpha)
    every = mesh.gather(_flat(own), "bricks")
    parts = [_unflat(every[b], own) for b in range(n)]
    asc = desc = _ident(color, depth)
    for b in range(n):
        asc = _over(asc, parts[b])
        desc = _over(desc, parts[n - 1 - b])
    c, g, d, t = _select(ascending, asc, desc)
    return c, g, d, 1.0 - t


def _render_brick_rows(scene: Scene, camera: Camera, cfg: api.RenderConfig,
                       bricked: BrickedVolume, screen_rows: torch.Tensor,
                       segment_steps: int, composite, mesh: Mesh):
    """March my brick's segment of my rows' rays, then composite over the
    brick axis. Returns (rows, W, 4)."""
    h, w = screen_rows.shape[:2]
    org, direction = generate_rays(camera, screen_rows.reshape(-1, 2),
                                   cfg.width, cfg.height)
    brick = bricked.bricks[0]
    blo, bhi = bricked.brick_lo[0], bricked.brick_hi[0]
    olo, ohi = bricked.own_lo[0], bricked.own_hi[0]
    vol = scene.volume
    n = org.shape[0]
    t0g, t1g = intersect_box(org, direction, vol.world_lo, vol.world_hi,
                             org.new_zeros((n,)), org.new_full((n,), 3.4e38))
    t0g = torch.clamp(t0g, min=0.0)
    t1g = torch.maximum(t1g, t0g)
    t_enter, t_exit = intersect_box(org, direction, olo, ohi, t0g, t1g)
    t_exit = torch.maximum(t_exit, t_enter)
    _, cdir, chor, cver = camera_basis(camera, cfg.width, cfg.height)
    ctx = ig.ShadeContext(
        light_dir=safe_normalize(scene.light.direction),
        wtc=torch.stack([safe_normalize(chor), safe_normalize(cver), -cdir]),
        world_lo=blo, world_hi=bhi,
        grad_hi=(vol.world_hi - blo) / (bhi - blo))
    leaves = (brick, scene.tfn.color, scene.tfn.alpha, scene.tfn.value_range,
              cfg.base_rate * torch.ones((), dtype=org.dtype,
                                         device=org.device))
    out = ig.march_segment(org, direction, leaves, ctx, march_cfg(cfg),
                           api._step(cfg, org.device), t0g, t1g, t_enter,
                           t_exit, segment_steps)
    out = composite(*out, direction[..., 2] >= 0, mesh)
    return _rgba(*out, h, w)


def brick_hooks(sw, local: BrickedVolume, n_bricks: int) -> dict:
    """`render_shearwarp`'s hooks for the brick `local` holds: its sample
    and clip boxes and its planes. A view along the brick axis splits
    the schedule evenly over the bricks (a descending view in reverse
    order); a transverse view runs the whole schedule on every slab."""
    b = local.index
    if sw.axis == 2:
        n_loc = sw.n_slices // n_bricks
        slice0 = float((b if sw.sign > 0 else n_bricks - 1 - b) * n_loc)
    else:
        n_loc, slice0 = sw.n_slices, 0.0
    return dict(sample_box=(local.brick_lo[0], local.brick_hi[0]),
                clip_box=(local.own_lo[0], local.own_hi[0]), slice0=slice0,
                n_slices_loc=n_loc)


def _render_brick_rows_sw(scene: Scene, camera: Camera,
                          cfg: api.RenderConfig, bricked: BrickedVolume,
                          light_grid, mesh: Mesh, composite):
    """Shear-warp on my brick's slab over my band's fan (one slice-kernel
    launch), then the fan partials composited over the brick axis and
    warped once. The plane schedule is the global box's; my slab gives
    the sample box, my ownership range the clip box, so each plane's
    intervals are the unbricked ones cut to my segment (`brick_hooks`)."""
    s = dataclasses.replace(scene, volume=dataclasses.replace(
        scene.volume, grid=bricked.bricks[0]))
    row0, hb = bands(cfg.height, mesh)
    color, grad, depth, alpha, asc, warp = shearwarp.render_shearwarp(
        s, cfg, camera, light_grid=light_grid, row0=row0, n_rows=hb,
        fan_only=True, **brick_hooks(cfg.sw, bricked, mesh.n_bricks))
    hi_i, wi_i = alpha.shape
    c, g, d, a = composite(color.reshape(-1, 3), grad.reshape(-1, 3),
                           depth.reshape(-1), alpha.reshape(-1),
                           asc.reshape(-1), mesh)
    out = warp(c.reshape(hi_i, wi_i, 3), g.reshape(hi_i, wi_i, 3),
               d.reshape(hi_i, wi_i), a.reshape(hi_i, wi_i))
    return _rgba(*out, hb, cfg.width)


def _check(cfg: api.RenderConfig, mesh: Mesh):
    if cfg.max_steps is None:
        raise ValueError("call cfg.resolved(scene) first")
    if cfg.jitter_rays:
        raise ValueError("jitter is unsupported on the bricked path")
    sw = cfg.sw
    if sw is not None and sw.axis == 2 and sw.n_slices % mesh.n_bricks:
        raise ValueError(
            f"n_slices={sw.n_slices} must divide over {mesh.n_bricks} "
            "bricks; resolve cfg with sw_slice_align=n_bricks")


def render_bricked(scene: Scene, bricked: BrickedVolume,
                   cfg: api.RenderConfig, mesh: Mesh,
                   camera: Optional[Camera] = None,
                   segment_steps: Optional[int] = None,
                   use_ring: bool = True, light_grid=None) -> torch.Tensor:
    """This rank's band (H / n_tiles, W, 4) of the frame, rows split over
    `tiles` and the volume over `bricks`, alike on every brick of a band.

    `bricked`: all B bricks, or this rank's own (`brick_volume(...,
    only=b)`); only its slab goes to the rank's device. `scene` gives the
    global world box, the TF, the light and the camera; its grid is not
    read, unless shadow shading needs the lattice and none is passed (it
    is then built from the scene, which must hold the whole grid).

    Takes the shear-warp path (per-brick slice loops, fan partials
    composited, one warp) when cfg carries a plan and the scene has no
    surfaces; when the view's principal axis is the brick axis, resolve
    cfg with sw_slice_align=n_bricks. `segment_steps` (march only)
    bounds each brick's march (default cfg.max_steps, always safe)."""
    if camera is None:
        camera = scene.camera
    _check(cfg, mesh)
    local = bricked.local(mesh.brick, mesh.device)
    composite = ring_composite if use_ring else gather_composite
    if cfg.sw is not None and not scene.geometries:
        if light_grid is None and api._wants_light_grid(cfg):
            d = (local.bricks.shape[1] - 2 * HALO) * mesh.n_bricks
            if scene.volume.grid.shape != (d, *local.bricks.shape[2:]):
                raise ValueError("shadow shading of a bricked volume needs "
                                 "light_grid (or the whole grid in scene)")
            light_grid = api.build_light_grid(scene, cfg)
        return _render_brick_rows_sw(scene, camera,
                                     band_cfg(cfg, mesh.n_tiles), local,
                                     light_grid, mesh, composite)
    return _render_brick_rows(scene, camera, cfg, local,
                              _screen_rows(cfg, mesh),
                              segment_steps or cfg.max_steps, composite,
                              mesh)


def make_train_step_bricked(cfg: api.RenderConfig, mesh: Mesh,
                            lr: float = 1e-2,
                            segment_steps: Optional[int] = None):
    """A distributed train step with the volume split over bricks, never
    replicated.

    Each rank renders its brick's segment of its band (shear-warp with a
    plan, else the march), composites over the ring and takes the band
    loss. Every brick of a band computes the same loss, and the ring's
    backward sums all their cotangents, so the loss is divided by
    n_bricks. Then: the slab's gradient is summed over the tile axis;
    the halo rows' gradients go to the neighbours that own those rows
    (a global edge's halo folds into the brick's own edge row, as the
    edge padding copied it); the TF gradients and the loss are summed
    over the mesh. After the SGD update of the owned rows, each halo is
    refreshed from the neighbour's updated rows.

    Returns step(bricked, tf_color, tf_alpha, scene, camera, target) ->
    (bricked', tf_color', tf_alpha', loss): `bricked` as for
    `render_bricked`, `bricked'` this rank's brick alone; `target` the
    whole (H, W, 4) frame."""
    _check(cfg, mesh)
    row0, hb = bands(cfg.height, mesh)
    n = mesh.n_bricks
    seg = segment_steps or cfg.max_steps
    cfg_band = band_cfg(cfg, mesh.n_tiles) if cfg.sw is not None else None

    def loss_fn(slab, local, tfc, tfa, scene, camera, target_rows):
        bv = dataclasses.replace(local, bricks=slab[None])
        s = dataclasses.replace(scene, tfn=dataclasses.replace(
            scene.tfn, color=tfc, alpha=tfa))
        if cfg.sw is not None:
            rgba = _render_brick_rows_sw(s, camera, cfg_band, bv, None, mesh,
                                         ring_composite)
        else:
            rgba = _render_brick_rows(s, camera, cfg, bv,
                                      _screen_rows(cfg, mesh), seg,
                                      ring_composite, mesh)
        return torch.sum((rgba - target_rows) ** 2) / (
            cfg.height * cfg.width * 4 * n)

    def step(bricked: BrickedVolume, tfc, tfa, scene: Scene, camera: Camera,
             target: torch.Tensor):
        local = bricked.local(mesh.brick, mesh.device)
        slab, tfc, tfa = (t.detach().requires_grad_(True)
                          for t in (local.bricks[0], tfc, tfa))
        with torch.enable_grad():
            loss = loss_fn(slab, local, tfc, tfa, scene, camera,
                           target[row0:row0 + hb])
            g_slab, g_c, g_a = torch.autograd.grad(loss, (slab, tfc, tfa))
        g_slab = mesh.all_reduce(g_slab, "tiles")
        g_c, g_a, loss = (mesh.all_reduce(x) for x in (g_c, g_a,
                                                        loss.detach()))
        s_own = slab.shape[0] - 2 * HALO
        first, last = mesh.brick == 0, mesh.brick == n - 1
        g_pre = g_slab[0:HALO]  # rows of the previous brick
        g_own = g_slab[HALO:s_own + HALO].clone()
        g_post = g_slab[s_own + HALO:]  # rows of the next brick
        from_next = mesh.shift_raw(g_pre, -1)
        from_prev = mesh.shift_raw(g_post, 1)
        # interior: add the neighbours' halo gradients; at a global edge
        # the halo rows were copies of my edge row: fold them into it
        if not first:
            g_own[0:HALO] += from_prev
        else:
            g_own[0] += g_pre.sum(0)
        if not last:
            g_own[s_own - HALO:] += from_next
        else:
            g_own[s_own - 1] += g_post.sum(0)
        slab = slab.detach()
        new_own = slab[HALO:s_own + HALO] - lr * g_own
        # refresh the halos from the neighbours' updated rows
        top = mesh.shift_raw(new_own[s_own - HALO:], 1)
        bot = mesh.shift_raw(new_own[0:HALO], -1)
        if first:
            top = new_own[0:1].expand_as(top)
        if last:
            bot = new_own[-1:].expand_as(bot)
        new_local = dataclasses.replace(
            local, bricks=torch.cat([top, new_own, bot])[None])
        return (new_local, torch.clamp(tfc.detach() - lr * g_c, 0.0, 1.0),
                torch.clamp(tfa.detach() - lr * g_a, 0.0, 1.0), loss)

    return step
