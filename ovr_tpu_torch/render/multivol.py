"""Multi-volume scenes: depth-sorted over-compositing (port of
`ovr_tpu.render.multivol`).

Each volume of the scene (the primary one and every `VolumeInstance`)
is marched on its own into premultiplied partials; the partials are
composited per pixel front to back in order of box-entry distance. The
over operator on premultiplied (colour, alpha) is associative, so for
volumes that do not overlap this equals one interleaved march; the
order comes from an odd-even transposition network of dense
where-swaps. Overlapping volumes composite approximately, as in the
JAX package. Plain PyTorch: the JAX package's version is XLA.
"""

from __future__ import annotations

import dataclasses

import torch

from ovr_tpu_torch.core.sampling import intersect_box, safe_normalize
from ovr_tpu_torch.neural.field import volume_repr
from ovr_tpu_torch.render import integrator as ig
from ovr_tpu_torch.render.geometry import _rays_to_object, xfm_apply


def entry_distance(org, direction, world_lo, world_hi):
    """Per ray, the distance at which it enters the box (inf: it misses)."""
    n = org.shape[0]
    t0, t1 = intersect_box(org, direction, world_lo, world_hi,
                           org.new_zeros((n,)), org.new_full((n,), 3.4e38))
    t0c = torch.clamp(t0, min=0.0)
    return torch.where(t1 > t0c, t0c, torch.inf)


def _march_one(org, direction, vol, tfn, ctx_base, cfg, mcfg, step,
               xfm=None):
    """March one volume: premultiplied (color, grad, depth, alpha) and the
    rays' entry distance. `xfm` (3, 4) places the instance: rays go
    world -> object with the direction unnormalized (t, steps and depth
    stay in world units), and the light directions, point lights and the
    world-to-camera rows go into object space with them."""
    leaves = (volume_repr(vol), tfn.color, tfn.alpha, tfn.value_range,
              cfg.base_rate * torch.ones((), dtype=cfg.dtype,
                                         device=vol.world_lo.device))
    ctx = dataclasses.replace(ctx_base, world_lo=vol.world_lo,
                              world_hi=vol.world_hi, light_alpha=None)
    if xfm is not None:
        org, direction, inv = _rays_to_object(xfm, org, direction)
        a_inv = inv[:, :3]
        # n_w . l_w = n_o . (A^-1 l_w); ncam = (wtc A^-T) n_o
        updates = dict(light_dir=safe_normalize(a_inv @ ctx.light_dir),
                       wtc=ctx.wtc @ a_inv.T)
        if ctx.extra_dirs is not None:
            updates["extra_dirs"] = torch.einsum("ij,kj->ki", a_inv,
                                                 ctx.extra_dirs)
        if ctx.point_pos is not None:
            updates["point_pos"] = xfm_apply(inv, ctx.point_pos)
        ctx = dataclasses.replace(ctx, **updates)
    march_fn = ig.march_while if cfg.fast_math else ig.march
    color, grad, depth, alpha = march_fn(org, direction, leaves, ctx, mcfg,
                                         step)
    t_in = entry_distance(org, direction, vol.world_lo, vol.world_hi)
    return color, grad, depth, alpha, t_in


def _swap_if(a, b):
    """Order two partials by entry distance: a dense where-swap."""
    pred = a[4] > b[4]

    def sel(x, y):
        p = pred.reshape(pred.shape + (1,) * (x.ndim - pred.ndim))
        return torch.where(p, y, x), torch.where(p, x, y)

    outs = [sel(x, y) for x, y in zip(a, b)]
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


def _compose(front, back):
    """Over-composite premultiplied partials (front over back)."""
    c1, g1, d1, a1, t1 = front
    c2, g2, d2, a2, t2 = back
    tr = 1.0 - a1
    return (c1 + tr[..., None] * c2, g1 + tr[..., None] * g2,
            d1 + tr * d2, a1 + tr * a2, torch.minimum(t1, t2))


def depth_composite(parts):
    """Partials (color, grad, depth, alpha, entry distance), composited
    per pixel in order of entry distance by an odd-even transposition
    network: the premultiplied (color, grad, depth, alpha)."""
    parts = list(parts)
    k = len(parts)
    for p in range(k):
        for i in range(p % 2, k - 1, 2):
            parts[i], parts[i + 1] = _swap_if(parts[i], parts[i + 1])
    out = parts[0]
    for nxt in parts[1:]:
        out = _compose(out, nxt)
    return out[:4]


def march_instances(scene, org, direction, ctx_base, cfg, mcfg, step):
    """March the scene's primary volume and every VolumeInstance, and
    composite them per pixel in depth order. Returns premultiplied
    (color, grad, depth, alpha), as `integrator.march` does."""
    vols = [(scene.volume, scene.tfn, None)] + [
        (inst.volume, inst.tfn, inst.xfm) for inst in scene.instances]
    return depth_composite(
        _march_one(org, direction, v, t, ctx_base, cfg, mcfg, step, xfm=x)
        for v, t, x in vols)
