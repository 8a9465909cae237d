"""Bounded-memory analytic adjoint of front-to-back over-compositing.

Port of `ovr_tpu.ops.adjoint`. A front-to-back composite of per-step
premultiplied values v_k and opacities a_k,

    V = sum_k  T_k * a_k * v_k,        T_k = prod_{j<k} (1 - a_j),

has closed-form per-step cotangents. With R_k = sum_{j>k} T_j a_j (V̄·v_j)
kept as a reverse running sum and transmittance rebuilt backwards by
inverting its own recurrence, T_k = T_{k+1} / (1 - a_k) (a_k clamped
below 1):

    v̄_k = T_k a_k V̄
    ā_k = T_k (V̄·v_k) - (R_k + T̄ T_N) / (1 - a_k)

`adjoint_sweep` recomputes (v_k, a_k) per step in reverse order and pulls
these cotangents back to the step's parameters with `torch.autograd.grad`,
so residual memory is O(1) in the step count: only the parameters and the
final transmittance are kept. `over_scan` is the composite with this
backward as an autograd.Function; `march_adjoint` is the unshaded march
expressed through it.

A step is `f(params, k) -> (v (M, ...), a (...))`, values channel first
as the slice loop's (8, Hi, Wi) output is. `params` maps names to
tensors or to host lists of ints (per-step slab indices). Floating-point
tensors get cotangents; integer tensors and lists get None.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ovr_tpu_torch.core.sampling import (classify, clip, intersect_box,
                                         opacity_correction, sample_volume)
from ovr_tpu_torch.neural.field import apply_field, is_field

A_MAX = 1.0 - 1e-6  # keep 1 - a invertible in fp32


def over_scan(f: Callable, n_steps: int, params: dict):
    """Composite `n_steps` of `f` front to back with a bounded-memory
    backward. `a` is clipped to [0, A_MAX] (forward and backward alike).
    Returns (V (M, ...), T (...)): composited values and final
    transmittance (alpha = 1 - T)."""
    keys = list(params)
    return _OverScan.apply(f, n_steps, keys, *(params[k] for k in keys))


class _OverScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, n_steps, keys, *values):
        params = dict(zip(keys, values))
        big_v = trans = None
        for k in range(n_steps):
            v, a = f(params, k)
            a = clip(a, 0.0, A_MAX)
            if big_v is None:
                big_v = torch.zeros_like(v)
                trans = torch.ones_like(a)
            big_v = big_v + (trans * a)[None] * v
            trans = trans * (1.0 - a)
        ctx.f, ctx.n_steps, ctx.keys = f, n_steps, keys
        ctx.is_t = [isinstance(x, torch.Tensor) for x in values]
        ctx.others = [x for x, t in zip(values, ctx.is_t) if not t]
        ctx.save_for_backward(*(x for x, t in zip(values, ctx.is_t) if t),
                              trans)
        return big_v, trans

    @staticmethod
    def backward(ctx, v_bar, t_bar):
        *tensors, t_final = ctx.saved_tensors
        ts, others = iter(tensors), iter(ctx.others)
        values = [next(ts) if t else next(others) for t in ctx.is_t]
        params = dict(zip(ctx.keys, values))
        grads = adjoint_sweep(ctx.f, ctx.n_steps, params, t_final, v_bar,
                              t_bar)
        return (None, None, None, *(grads[k] for k in ctx.keys))


def _inexact(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _slab_window(params: dict, n_steps: int) -> Optional[list]:
    """Slab windows for the slice loop's volumes, or None.

    When `params` holds a 3D floating-point "grid" read per step at the
    slab pair (kz[k], kz[k]+1) of the host list "kz", return for it (and
    for a shadow lattice "lgrid" read at k0l[k], k0l[k]+1, and for the
    dense path tracer's emission lattice "jlat", (A, Nr, Nc, 3) read at
    the grid's own slabs and windowed alike) the window size
    w such that the slab pairs of steps k and k-1 always fit in w slabs.
    Consecutive indices advance at most ceil(n_a / n_steps), so
    w = 2 + ceil(n_a / n_steps). The grid's window includes the previous
    step's pair (`lookback`: the shaded step recomputes plane k-1 for the
    axial difference).

    Each reverse step then differentiates against the windows alone and
    adds their cotangents into float32 accumulators: O(slab) instead of
    O(volume) traffic per step."""
    specs = []
    for key, idxk, lookback in (("grid", "kz", True),
                                ("jlat", "kz", True),
                                ("lgrid", "k0l", False)):
        g = params.get(key)
        if params.get(idxk) is None or not _inexact(g) or g.ndim < 3:
            continue  # integer storage has no cotangent
        n_a = g.shape[0]
        w = min(n_a, 2 + -(-n_a // max(n_steps, 1)))
        if w >= n_a:
            continue  # the window would be the whole array
        specs.append((key, idxk, lookback, w))
    if not any(s[0] == "grid" for s in specs):
        return None  # the grid is the point; no window for lgrid alone
    return specs


def adjoint_sweep(f: Callable, n_steps: int, params: dict, t_final, v_bar,
                  t_bar) -> dict:
    """The analytic reverse sweep: given the forward's final transmittance
    `t_final` and the output cotangents (v_bar for V, t_bar for T),
    recompute each step of `f` in reverse and return the cotangent of
    every entry of `params` (None for integer tensors and host lists).

    Usable as the backward of any forward that computes the same
    composite (the slice kernel included): only (params, t_final) must be
    kept. Slab-windowed for the slice loop's volumes (`_slab_window`)."""
    specs = _slab_window(params, n_steps)
    return _adjoint_sweep_sliced(f, n_steps, params, t_final, v_bar, t_bar,
                                 specs or [])


def _adjoint_sweep_sliced(f, n_steps, params, t_final, v_bar, t_bar,
                          specs) -> dict:
    """`adjoint_sweep` with the arrays of `specs` differentiated through
    per-step slab windows: each step gets a fresh float32 leaf of the
    w-slab window that covers the slabs it reads, its slab-index list
    shifted into window coordinates, and a fresh leaf of every other
    floating-point entry; the window's cotangent goes into a float32
    accumulator at [kb, kb + w), cast to the array's dtype at the end."""
    f32 = torch.float32
    win = {s[0]: s for s in specs}
    acc = {k: torch.zeros(v.shape, dtype=f32 if v.dtype != torch.float64
                          else v.dtype, device=v.device)
           for k, v in params.items() if _inexact(v)}
    if v_bar is None:
        v_bar = 0.0
    if t_bar is None:
        t_bar = torch.zeros_like(t_final)
    run = torch.zeros_like(t_final)
    trans_next = t_final
    for k in range(n_steps - 1, -1, -1):
        km = max(k - 1, 0)
        p = dict(params)
        leaves, kbs = {}, {}
        for key, idxk, lookback, w in specs:
            idx = params[idxk]
            lo = min(idx[k], idx[km]) if lookback else idx[k]
            kb = min(max(lo, 0), params[key].shape[0] - w)
            kbs[key] = kb
            leaves[key] = params[key][kb:kb + w].detach().to(f32)
            p[idxk] = [i - kb for i in idx]
        for key in acc:
            if key not in leaves:
                leaves[key] = params[key].detach()
        for key, leaf in leaves.items():
            p[key] = leaf.requires_grad_(True)
        with torch.enable_grad():
            v, a = f(p, k)
            a = clip(a, 0.0, A_MAX)
        with torch.no_grad():
            vd, ad = v.detach(), a.detach()
            one_m = torch.clamp(1.0 - ad, min=1e-12)
            trans = trans_next / one_m  # T_k rebuilt in reverse
            wdot = torch.sum(v_bar * vd, dim=0)  # V̄·v_k
            a_bar = trans * wdot - (run + t_bar * t_final) / one_m
            v_bar_k = (trans * ad)[None] * v_bar
        outs = [(o, c) for o, c in ((v, v_bar_k), (a, a_bar))
                if o.requires_grad]
        if outs:
            names = list(leaves)
            grads = torch.autograd.grad(
                [o for o, _ in outs], [leaves[n] for n in names],
                [c for _, c in outs], allow_unused=True)
            with torch.no_grad():
                for name, g in zip(names, grads):
                    if g is None:
                        continue
                    if name in win:
                        kb = kbs[name]
                        acc[name][kb:kb + win[name][3]] += g
                    else:
                        acc[name] += g
        run = run + trans * ad * wdot
        trans_next = trans
    return {k: (acc[k].to(v.dtype) if k in acc else None)
            for k, v in params.items()}


def march_adjoint(org, direction, scene_leaves, ctx, cfg, step):
    """Fixed-lattice emission-absorption march (shading 'none') through
    `over_scan`, so its backward is the bounded-memory analytic sweep.
    Same outputs as `integrator.march` with shading 'none' and no
    occupancy, jitter or t_cap: premultiplied (color (N, 3), zero
    gradient, depth (N,), alpha (N,)). `scene_leaves` = (volume,
    color_table, alpha_table, value_range, base), the volume a dense grid
    or a `NeuralFieldVolume`; `cfg.max_steps` steps.

    Gradients reach the grid (or the field's tables and weights), the TF
    tables and range, the rays, the box and the step."""
    volume, color_table, alpha_table, value_range, base = scene_leaves
    n = org.shape[0]
    params = dict(org=org, direction=direction, color_table=color_table,
                  alpha_table=alpha_table, value_range=value_range,
                  base=base, world_lo=ctx.world_lo, world_hi=ctx.world_hi,
                  step=step)
    if is_field(volume):
        params["tables"] = volume.tables
        for i, (w, b) in enumerate(volume.weights):
            params[f"w{i}"], params[f"b{i}"] = w, b
        n_layers = len(volume.weights)

        def sample(p, q):
            pairs = [(p[f"w{i}"], p[f"b{i}"]) for i in range(n_layers)]
            return apply_field(p["tables"], pairs, volume.grid_cfg,
                               volume.compute_dtype, q)
    else:
        params["grid"] = volume

        def sample(p, q):
            return sample_volume(p["grid"], q)

    def f(p, k):
        stp = p["step"]
        t0 = p["org"].new_zeros((n,))
        t1 = p["org"].new_full((n,), 3.4e38)
        t0, t1 = intersect_box(p["org"], p["direction"], p["world_lo"],
                               p["world_hi"], t0, t1)
        t0 = torch.maximum(t0, torch.zeros_like(t0))
        t1 = torch.maximum(t1, t0)
        tx = torch.minimum(t0 + k * stp, t1)
        ty = torch.minimum(tx + stp, t1)
        mid = 0.5 * (tx + ty)
        pos = p["org"] + mid[..., None] * p["direction"]
        p_obj = (pos - p["world_lo"]) / (p["world_hi"] - p["world_lo"])
        rgb, a = classify(p["color_table"], p["alpha_table"],
                          p["value_range"], sample(p, p_obj))
        a = opacity_correction(a, p["base"], ty - tx)
        a = torch.where(ty > tx, a, 0.0)
        v = torch.cat([clip(rgb, 0.0, 1.0), mid[..., None]], dim=-1)
        return v.T, a

    big_v, trans = over_scan(f, cfg.max_steps, params)
    color = big_v[:3].T
    return color, torch.zeros_like(color), big_v[3], 1.0 - trans
