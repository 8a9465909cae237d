"""Shading-mode names and the premultiplied -> straight conversion
(port of the parts of `ovr_tpu.render.integrator` the shear-warp path
uses; the march integrator comes with its own slice of the port)."""

from __future__ import annotations

import torch

SHADING_NONE = "none"
SHADING_DIFFUSE = "diffuse"  # gradient shading, no shadow
SHADING_SHADOW = "shadow"  # gradient shading + shadow
SHADING_SSH = "ssh"  # single-shade heuristic (march only)


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
