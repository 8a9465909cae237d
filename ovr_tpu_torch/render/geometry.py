"""Surface geometry: triangle meshes and isosurfaces (port of
`ovr_tpu.render.geometry`).

Scenes carry OBJ-style triangle meshes and isosurfaces of the volume;
the volume composites over them (the surfaces are the background layer
of each ray). A mesh is intersected by Möller-Trumbore against every
triangle, densely: no BVH, as in the JAX package, since the meshes of
scientific scenes (clip boxes, glyphs, annotations) are small. An
isosurface is found by fixed-step root bracketing along the ray with
one secant step, its normal from the volume gradient. Instances carry a
(3, 4) object-to-world affine; rays go world -> object with the
direction left unnormalized, so t stays in world units.

Plain PyTorch: the JAX package's geometry is XLA, not a kernel.

Memory and time. XLA fuses the (rays x triangles) block of the
intersection; eager PyTorch writes out every intermediate of it.
`intersect_mesh` therefore blocks rays as well as triangles
(`RAY_BLOCK_ELEMS` pairs per block, 64 MiB per intermediate, 1.4 GiB at
its peak at 1080p whatever the ray count) and finds each ray's nearest
triangle without autograd, skipping the blocks of triangles whose
bounding box (padded) no ray of the block meets, and sharing the
origin-dependent terms where all rays start at one point (a
perspective camera's rays, the fan's); the triangles it does test give
the same bits either way. It then recomputes that one triangle's hit
per ray with autograd, which gives the JAX package's gradient (its
argmin gathers the same entries) while saving O(rays) for the backward.
"""

from __future__ import annotations

import torch

from ovr_tpu_torch.core.sampling import (clip, gradient_of, intersect_box,
                                         normalize_value, safe_normalize,
                                         scalar)
from ovr_tpu_torch.neural.field import (sample_any_volume, volume_rdim,
                                        volume_repr)

BIG = 3.4e38
# (ray, triangle) pairs per block of the mesh intersection
RAY_BLOCK_ELEMS = 1 << 24


def xfm_apply(xfm: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a (3, 4) affine [R | t] to points (..., 3)."""
    return torch.einsum("ij,...j->...i", xfm[:, :3], p) + xfm[:, 3]


def xfm_inverse(xfm: torch.Tensor) -> torch.Tensor:
    """Invert a (3, 4) affine: [R | t] -> [R^-1 | -R^-1 t]."""
    rinv = torch.linalg.inv(xfm[:, :3])
    return torch.cat([rinv, -(rinv @ xfm[:, 3])[:, None]], dim=1)


def _one_origin(org) -> bool:
    """Do all rays (N, 3) start at one point (a broadcast origin)?"""
    return org.ndim == 2 and org.shape[0] > 1 and org.stride(0) == 0


def _rays_to_object(xfm, org, direction):
    """World rays -> object space (the direction unnormalized, so t keeps
    world units); a broadcast origin stays broadcast. Returns (org,
    direction, the inverse affine)."""
    inv = xfm_inverse(xfm)
    org_o = (xfm_apply(inv, org[:1]).expand_as(org) if _one_origin(org)
             else xfm_apply(inv, org))
    dir_o = torch.einsum("ij,...j->...i", inv[:, :3], direction)
    return org_o, dir_o, inv


def _cross(a, b):
    """Cross product over the last axis of broadcastable a and b."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _mt(org, direction, v0, e1, e2):
    """Möller-Trumbore of rays against triangles (broadcasting): returns
    (t, u, v, hit), the JAX package's arithmetic and tolerances."""
    eps, t_eps, b_eps = 1e-9, 1e-5, 1e-6
    pvec = _cross(direction, e2)
    det = _dot(e1, pvec)
    ok = torch.abs(det) > eps
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = org - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(direction, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ok & (u >= -b_eps) & (v >= -b_eps) & (u + v <= 1 + b_eps) & (
        t > t_eps)
    return t, u, v, hit


def _nearest_triangle(org, direction, tris, chunk: int):
    """Per ray, the index of the nearest hit triangle (the first of equal
    hits) and its t (BIG: no hit), without autograd, in blocks of rays x
    `chunk` triangles. A block of triangles is tested only if some ray of
    the block meets its bounding box, padded by 1e-3 of the box's size
    (a hit within the barycentric tolerance lies 1e-6 of an edge outside
    its triangle)."""
    n, f = org.shape[0], tris.shape[0]
    t_best = org.new_full((n,), BIG)
    j_best = torch.zeros((n,), dtype=torch.long, device=org.device)
    rows = max(1, RAY_BLOCK_ELEMS // chunk)
    one = _one_origin(org)
    starts = list(range(0, f, chunk))
    with torch.no_grad():
        lo = torch.stack([tris[c0:c0 + chunk].amin((0, 1)) for c0 in starts])
        hi = torch.stack([tris[c0:c0 + chunk].amax((0, 1)) for c0 in starts])
        pad = 1e-3 * (hi - lo).amax(1, keepdim=True) + 1e-6
        lo, hi = lo - pad, hi + pad
        zero = org.new_zeros(())
        for r0 in range(0, n, rows):
            o = org[:1, None, :] if one else org[r0:r0 + rows, None, :]
            d = direction[r0:r0 + rows, None, :]
            tb, jb = t_best[r0:r0 + rows], j_best[r0:r0 + rows]
            b0, b1 = intersect_box(o, d, lo[None], hi[None], zero,
                                   org.new_full((), BIG))
            meets = torch.any(b1 >= b0, dim=0).tolist()
            for c0, live in zip(starts, meets):
                if not live:
                    continue
                tri = tris[c0:c0 + chunk]
                v0 = tri[None, :, 0]
                t, _, _, hit = _mt(o, d, v0, tri[None, :, 1] - v0,
                                   tri[None, :, 2] - v0)
                t_c, j = torch.min(torch.where(hit, t, BIG), dim=1)
                better = t_c < tb
                tb.copy_(torch.where(better, t_c, tb))
                jb.copy_(torch.where(better, j + c0, jb))
    return t_best, j_best


def intersect_mesh(org: torch.Tensor, direction: torch.Tensor, mesh,
                   chunk: int = 256):
    """Nearest hit of each ray (N, 3) on `mesh`, Möller-Trumbore over all
    triangles in blocks of `chunk` triangles (and of rays: module note).

    Returns (t (N,) with BIG on a miss, normal (N, 3) facing the ray
    origin, colour (N, 3) and uv (N, 2) interpolated barycentrically);
    a miss has normal 0, colour 1 and uv 0."""
    faces = mesh.faces
    tris = mesh.verts[faces]  # (F, 3, 3)
    t_near, j = _nearest_triangle(org.detach(), direction.detach(),
                                  tris.detach(), chunk)
    hit = t_near < BIG
    # the nearest triangle again, with autograd: the same arithmetic on
    # the same values gives the same t, u and v
    tri = tris[j]
    v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    t, u, v, _ = _mt(org, direction, v0, e1, e2)
    fj = faces[j]

    def interp(attr):
        a = attr[fj]
        return (a[:, 0] * (1 - u - v)[:, None] + a[:, 1] * u[:, None]
                + a[:, 2] * v[:, None])

    col, uv = interp(mesh.colors), interp(mesh.uvs)
    nrm = safe_normalize(torch.where(hit[:, None], _cross(e1, e2), 0.0))
    nrm = torch.where((_dot(nrm, direction) > 0)[:, None], -nrm, nrm)
    return (torch.where(hit, t, BIG), nrm,
            torch.where(hit[:, None], col, 1.0),
            torch.where(hit[:, None], uv, 0.0))


def sample_texture(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear (H, W, 3) texture fetch at uv (N, 2) in [0, 1]^2, clamp
    addressing, v up (image row 0 is v = 1)."""
    h, w, _ = tex.shape
    fx = clip(uv[:, 0], 0.0, 1.0) * (w - 1)
    fy = (1.0 - clip(uv[:, 1], 0.0, 1.0)) * (h - 1)
    x0 = torch.clamp(torch.floor(fx).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(fy).long(), 0, h - 2)
    ax = (fx - x0)[:, None]
    ay = (fy - y0)[:, None]
    t00, t01 = tex[y0, x0], tex[y0, x0 + 1]
    t10, t11 = tex[y0 + 1, x0], tex[y0 + 1, x0 + 1]
    return ((t00 * (1 - ax) + t01 * ax) * (1 - ay)
            + (t10 * (1 - ax) + t11 * ax) * ay)


def intersect_isosurface(grid, value_range: torch.Tensor,
                         world_lo, world_hi, org, direction, iso,
                         steps: int):
    """First crossing of any of `iso.isovalues` (normalized TF units)
    along each ray through `grid` (a dense grid or a neural field):
    `steps` fixed steps across the box, one secant step in the
    bracketing interval. Returns (t (N,) with BIG on a miss,
    normal (N, 3) from the negated volume gradient, facing the ray
    origin)."""
    n = org.shape[0]
    t0, t1 = intersect_box(org, direction, world_lo, world_hi,
                           org.new_zeros((n,)), org.new_full((n,), BIG))
    t0 = torch.maximum(t0, scalar(0.0, t0.dtype, t0.device))
    t1 = torch.maximum(t1, t0)
    step = (t1 - t0) / steps
    isov = iso.isovalues

    def field(t):
        p = org + t[:, None] * direction
        return normalize_value(sample_any_volume(
            grid, (p - world_lo) / (world_hi - world_lo)), value_range)

    t_hit = org.new_full((n,), BIG)
    s_prev = field(t0)
    for i in range(steps):
        t_cur = t0 + (i + 1.0) * step
        s_cur = field(t_cur)
        lo = torch.minimum(s_prev, s_cur)[:, None]
        hi = torch.maximum(s_prev, s_cur)[:, None]
        crossed = (isov[None, :] >= lo) & (isov[None, :] <= hi)
        any_cross = torch.any(crossed, dim=1) & (step > 0)
        d = torch.where(crossed, torch.abs(isov[None, :] - s_prev[:, None]),
                        BIG)
        iso_v = isov[torch.argmin(d, dim=1)]
        denom = s_cur - s_prev
        big_d = torch.abs(denom) > 1e-12
        frac = torch.where(big_d, (iso_v - s_prev) / torch.where(
            big_d, denom, 1.0), 0.5)
        t_c = t_cur - step + clip(frac, 0.0, 1.0) * step
        t_hit = torch.where(any_cross & (t_hit >= BIG), t_c, t_hit)
        s_prev = s_cur

    p = org + torch.minimum(t_hit, scalar(1e30, t_hit.dtype,
                                          t_hit.device))[:, None] * direction
    p_obj = clip((p - world_lo) / (world_hi - world_lo), 0.0, 1.0)
    s = sample_any_volume(grid, p_obj)
    rdim = volume_rdim(grid, org.dtype, org.device)
    g = gradient_of(lambda q: sample_any_volume(grid, q), p_obj, s, rdim)
    nrm = safe_normalize(-g / (world_hi - world_lo))
    nrm = torch.where((_dot(nrm, direction) > 0)[:, None], -nrm, nrm)
    return t_hit, nrm


def shade_phong(material, base_color, nrm, light, light_dir, view_dir):
    """Blinn-Phong: kd * base * (ambient + cos(N, L) * light) +
    ks * cos(N, H)^ns * light (the OSPRay `obj` material)."""
    zero = scalar(0.0, nrm.dtype, nrm.device)
    cos_nl = torch.maximum(_dot(nrm, light_dir), zero)
    h = safe_normalize(light_dir + view_dir)
    cos_nh = torch.maximum(_dot(nrm, h), zero)
    diffuse = material.kd * base_color * (
        light.ambient + cos_nl[:, None] * light.color)
    specular = material.ks * (cos_nh ** material.ns)[:, None] * light.color
    return diffuse + specular


def render_geometries(scene, org: torch.Tensor, direction: torch.Tensor,
                      iso_steps: int = 128, chunk: int = 256):
    """Every geometry instance of `scene` on rays (N, 3); the nearest hit
    wins. Returns (rgb (N, 3) premultiplied, alpha (N,), t (N,) with BIG
    on a miss): the background layer the volume composites over."""
    n = org.shape[0]
    t_best = org.new_full((n,), BIG)
    rgb_best = org.new_zeros((n, 3))
    a_best = org.new_zeros((n,))
    light_dir = safe_normalize(scene.light.direction)
    view_dir = -safe_normalize(direction)
    vol = scene.volume
    for inst in scene.geometries:
        org_o, dir_o, inv = _rays_to_object(inst.xfm, org, direction)
        if inst.kind == "isosurface":
            t, nrm_o = intersect_isosurface(
                volume_repr(vol), scene.tfn.value_range, vol.world_lo,
                vol.world_hi, org_o, dir_o, inst.geometry, iso_steps)
            base = org.new_ones((n, 3))
        else:
            t, nrm_o, base, uv = intersect_mesh(org_o, dir_o, inst.geometry,
                                                chunk)
            if inst.material.map_kd is not None:
                base = base * sample_texture(inst.material.map_kd, uv)
        # normals object -> world by (R^-1)^T
        nrm = safe_normalize(torch.einsum("ji,...j->...i", inv[:, :3],
                                          nrm_o))
        nrm = torch.where((_dot(nrm, direction) > 0)[:, None], -nrm, nrm)
        rgb = shade_phong(inst.material, base, nrm, scene.light, light_dir,
                          view_dir)
        hit = t < BIG
        a = torch.where(hit, inst.material.d, 0.0)
        better = hit & (t < t_best)
        t_best = torch.where(better, t, t_best)
        rgb_best = torch.where(better[:, None], rgb * a[:, None], rgb_best)
        a_best = torch.where(better, a, a_best)
    return rgb_best, a_best, t_best
