"""Plain shear-warp frame, the benchmark's reference for the renderer.

Given the volume, the transfer function, the camera and (for shadows) a
shadow lattice, it works out the shear-warp plan, the ray fan, the plane
schedule, the slice loop on chosen fan tiles, the warp to the screen and
the straight-alpha frame, in plain PyTorch and float32, with the
operations in the order the algorithm states them:

- plan: the principal axis of the view, the plane count (world extent
  along it times the sampling rate), the fan size (2 samples a voxel
  across, at most 1.25x the paired screen axis, rounded up to 8, capped);
- fan: the screen rays' coordinates P, Q on the unit plane along the axis,
  their range widened by 1%, sampled at fan-pixel centres;
- slice loop: per plane, two voxel slabs lerped along the axis and read
  bilinearly at each fan ray, the value classified through the nodal RGBA
  table, opacity corrected over the exact overlap of the plane's slab with
  the ray's box interval, shaded (fan-space finite differences, or the
  analytic bilinear derivative for small fans) against the primary light
  and the lattice's shadow, composited front to back; a tile of 8 x 32
  fan rays stops once none of its rays has T > 1e-4 before its exit;
- warp: two passes of two-tap linear resampling (columns at the rows each
  screen row needs, then rows at each pixel's column), then division by
  alpha.

Nothing here is taken from the program under test: it is given the raw
inputs and computes everything else itself. Tiles are whole 8 x 32 blocks
so that the termination rule applies as stated. Empty-space skipping is
not done here: the planes it skips have zero opacity, so the result does
not depend on it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

T_EPS = 1e-4
BLOCK_ROWS, BLOCK_COLS = 8, 32  # the termination tile of the slice loop
TILE_ROWS, TILE_COLS = 2 * BLOCK_ROWS, 2 * BLOCK_COLS  # a checked tile


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _full(x, device) -> torch.Tensor:
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _clip(x, lo, hi):
    """min(max(x, lo), hi) with 0-d float32 bounds."""
    dev = x.device
    return torch.minimum(torch.maximum(x, _full(lo, dev)), _full(hi, dev))


def safe_normalize(v: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.maximum(n2, _full(1e-12, v.device)))


def storage_scale(dtype) -> float:
    """Normalized integers sample as raw / int_max; floats as they are."""
    if dtype.is_floating_point:
        return 1.0
    return 1.0 / float(torch.iinfo(dtype).max)


@dataclasses.dataclass(frozen=True)
class Inputs:
    """What one frame is made from: the grid (Z, Y, X) on the device and
    its world box, the TF (colour (K, 3), alpha (K,), value range), the
    camera (eye, target, up, vertical field of view in degrees), the
    primary light's direction and the render settings."""

    grid: torch.Tensor
    world_lo: tuple
    world_hi: tuple
    color: np.ndarray
    alpha: np.ndarray
    value_range: tuple
    eye: tuple
    at: tuple
    up: tuple
    fovy: float
    light_dir: tuple
    width: int
    height: int
    sampling_rate: float
    base_rate: float
    shading: str  # none | diffuse | shadow
    inter_cap: int = 2048


@dataclasses.dataclass(frozen=True)
class Plan:
    axis: int
    sign: int
    n_slices: int
    inter_h: int
    inter_w: int
    swap: bool
    separable: bool
    fd: bool


def _perp(axis):
    p = [w for w in (0, 1, 2) if w != axis]
    return p[0], p[1]


def plan_of(inp: Inputs) -> Plan:
    """The shear-warp plan of a perspective view from outside the box."""
    eye = np.array(inp.eye, np.float32).astype(np.float64)
    at = np.array(inp.at, np.float32).astype(np.float64)
    up = np.array(inp.up, np.float32).astype(np.float64)
    lo = np.array(inp.world_lo, np.float32).astype(np.float64)
    hi = np.array(inp.world_hi, np.float32).astype(np.float64)
    aspect = inp.width / float(inp.height)
    d = at - eye
    d = d / max(np.linalg.norm(d), 1e-30)
    t = 2.0 * np.tan(np.deg2rad(float(np.float32(inp.fovy))) * 0.5)
    h = np.cross(d, up)
    h = t * aspect * h / max(np.linalg.norm(h), 1e-30)
    v = np.cross(h, d) / aspect
    axis = int(np.argmax(np.abs(d)))
    if abs(d[axis]) < 1e-6:
        raise ValueError("the view has no principal axis")
    sign = 1 if d[axis] >= 0 else -1
    if lo[axis] - 1e-6 <= eye[axis] <= hi[axis] + 1e-6:
        raise ValueError("the reference covers eyes outside the box")
    w1, w2 = _perp(axis)
    swap = bool(abs(h[w1]) < abs(v[w1]))
    eps = 1e-6 * (np.linalg.norm(h) + np.linalg.norm(v))
    cross = ((abs(v[w1]), abs(h[w2])) if not swap
             else (abs(h[w1]), abs(v[w2])))
    axial = (abs(h[axis]), abs(v[axis]))
    separable = bool(max(*cross, *axial) < eps)
    ext = hi - lo
    n_slices = max(4, int(round(float(ext[axis]) * inp.sampling_rate)))
    zyx = inp.grid.shape
    dims = (zyx[2], zyx[1], zyx[0])

    def rnd(x):
        return int(-(-x // 8) * 8)

    scr_p = inp.height if swap else inp.width
    scr_q = inp.width if swap else inp.height
    cap = int(inp.inter_cap)
    wi = rnd(min(cap, max(64, min(2 * dims[w1], int(1.25 * scr_p)))))
    hi_i = rnd(min(cap, max(64, min(2 * dims[w2], int(1.25 * scr_q)))))
    fd = wi >= 1024 or dims[w1] >= 512
    return Plan(axis, sign, n_slices, hi_i, wi, swap, separable, fd)


def _safe_div(a, b, eps=1e-9):
    d = torch.where(torch.abs(b) < eps,
                    torch.where(b < 0, -eps, eps).to(b.dtype), b)
    return a / d


def _taps(pos, n):
    i0f = torch.floor(pos)
    i0 = i0f.long()
    return i0, torch.clamp(i0 + 1, max=n - 1), pos - i0f


def _axis_rng(o, d, lo, ext):
    small = torch.abs(d) < 1e-12
    dd = torch.where(small, torch.ones_like(d), d)
    a = (lo - o) / dd
    b = (lo + ext - o) / dd
    big = torch.full_like(a, 3.4e38)
    lo_t = torch.where(small, torch.where(o >= lo, -big, big),
                       torch.minimum(a, b))
    hi_t = torch.where(small, torch.where(o <= lo + ext, big, -big),
                       torch.maximum(a, b))
    return lo_t, hi_t


def _gather(src, idx):
    """src[idx] as float32 raw values (idx a tuple of broadcastable index
    tensors); 16-bit unsigned voxels are read through their int16 bits."""
    if src.dtype == torch.uint16:
        v = src.view(torch.int16)[idx]
        return (v.to(torch.int32) & 0xFFFF).to(torch.float32)
    return src[idx].to(torch.float32)


def _corners(src, s_pair, r0, r1, c0, c1):
    """The 2 x 2 x 2 taps of the planes s_pair (2,) at rows r0/r1 (T, R)
    and columns c0/c1 (T, C): (2 planes, 2 rows, 2 columns, T, R, C)."""
    rr = torch.stack([r0, r1])[None, :, None, :, :, None]
    cc = torch.stack([c0, c1])[None, None, :, :, None, :]
    return _gather(src, (s_pair[:, None, None, None, None, None], rr, cc))


class Frame:
    """One frame's plan, fan and plane schedule; `render(tiles)` runs the
    slice loop on the given fan tiles and warps them to the screen."""

    def __init__(self, inp: Inputs, lattice=None):
        self.inp = inp
        self.plan = plan_of(inp)
        if inp.shading == "shadow" and lattice is None:
            raise ValueError("shadow shading needs the lattice")
        self.lattice = lattice
        self._geometry()

    # ---- plan-level quantities, every one float32 on the device ----
    def _geometry(self):
        inp, pl = self.inp, self.plan
        dev = inp.grid.device
        self.dev = dev
        f32 = torch.float32
        opts = dict(dtype=f32, device=dev)
        axis, sign = pl.axis, pl.sign
        w1, w2 = _perp(axis)
        self.w = (w1, w2)
        frm, at, up = (_f32(x, dev) for x in (inp.eye, inp.at, inp.up))
        fovy = _f32(inp.fovy, dev)
        aspect = inp.width / float(inp.height)
        direction = safe_normalize(at - frm)
        t = 2.0 * torch.tan(fovy * (math.pi / 180.0) * 0.5)
        horizontal = t * aspect * safe_normalize(
            torch.linalg.cross(direction, up))
        vertical = torch.linalg.cross(horizontal, direction) / aspect
        e = frm
        lo, hi = _f32(inp.world_lo, dev), _f32(inp.world_hi, dev)
        ext = hi - lo
        # the grid with the principal axis first, rows w2, columns w1
        g = inp.grid.permute(2 - axis, 2 - w2, 2 - w1)
        self.grid_v = g
        n_a, n_r, n_c = g.shape
        self.n = (n_a, n_r, n_c)

        u = (torch.arange(inp.width, **opts) + 0.5) / inp.width - 0.5
        v = (torch.arange(inp.height, **opts) + 0.5 + 0.0) / inp.height - 0.5
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        dw = (direction[None, None, :] + uu[..., None] * horizontal
              + vv[..., None] * vertical)
        da = dw[..., axis] * sign
        p_scr = _safe_div(dw[..., w1], da)
        q_scr = _safe_div(dw[..., w2], da)

        def rng(x):
            m = 0.01 * (torch.max(x) - torch.min(x)) + 1e-6
            return torch.min(x) - m, torch.max(x) + m

        p_lo, p_hi = rng(p_scr)
        q_lo, q_hi = rng(q_scr)
        hi_i, wi_i = pl.inter_h, pl.inter_w
        dp = (p_hi - p_lo) / wi_i
        dq = (q_hi - q_lo) / hi_i
        pg = p_lo + (torch.arange(wi_i, **opts) + 0.5) * dp
        qg = q_lo + (torch.arange(hi_i, **opts) + 0.5) * dq

        # the plane schedule (perspective: ray parameter = axial distance)
        dz = ext[axis] / pl.n_slices
        off = _full(0.5, dev) + _full(0.0, dev)
        jj = _full(0.0, dev) + torch.arange(pl.n_slices, **opts)
        z_rel = (jj + off) * dz
        z_abs = lo[axis] + z_rel if sign > 0 else hi[axis] - z_rel
        lam_r = (z_abs - e[axis]) * sign
        c = torch.clamp((z_rel - (lo[axis] - lo[axis] if sign > 0
                                  else hi[axis] - hi[axis]))
                        / ext[axis] * n_a - 0.5, 0.0, n_a - 1.0)
        k0 = torch.clamp(torch.floor(c).to(torch.int32), 0, n_a - 2).long()
        # each plane's slab pair in the grid's storage order
        self.slabs = (torch.stack([n_a - 1 - k0, n_a - 2 - k0], 1)
                      if sign < 0 else torch.stack([k0, k0 + 1], 1))
        den_a = 1.0 / sign
        cl_a = (lo[axis] - e[axis]) / den_a
        cl_b = (hi[axis] - e[axis]) / den_a

        # the slice loop's scalars, each rounded to float32 as stated
        S = {}
        S["lo1"], S["ex1"] = lo[w1], hi[w1] - lo[w1]
        S["lo2"], S["ex2"] = lo[w2], hi[w2] - lo[w2]
        S["e1"], S["e2"] = e[w1], e[w2]
        S["half"] = 0.5 * dz * 1.0
        S["dz"] = dz
        S["off"] = off + _full(0.0, dev)
        vr = _f32(inp.value_range, dev)
        S["vlo"], S["vscale"] = vr[0], 1.0 / (vr[1] - vr[0])
        S["base"] = inp.base_rate * torch.ones((), **opts)
        S["lam0"] = lam_r[0] - (off + _full(0.0, dev)) * dz * 1.0
        S["na"] = _full(float(n_a), dev)
        S["dlam"] = _full(1.0, dev)
        S["exa"] = ext[axis]
        S["cla"] = torch.minimum(cl_a, cl_b)
        S["cha"] = torch.maximum(cl_a, cl_b)
        S["smp0"] = (lo[axis] - lo[axis]) if sign > 0 else (hi[axis]
                                                           - hi[axis])
        S["smpsc"] = n_a / ext[axis]
        S["glo1"], S["gex1"] = lo[w1], ext[w1]
        S["glo2"], S["gex2"] = lo[w2], ext[w2]
        S["gs"] = _full(storage_scale(inp.grid.dtype), dev)
        S["dp"] = pg[1] - pg[0]
        S["dq"] = qg[1] - qg[0]
        S["qlo"] = qg[0]
        S["invda"] = _full(float(sign), dev)
        S["dzdlam"] = dz * 1.0
        if inp.shading != "none":
            ld = safe_normalize(_f32(inp.light_dir, dev))
            S["ld1"], S["ld2"], S["lda"] = ld[w1], ld[w2], ld[axis]
        if inp.shading == "shadow":
            lg = self.lattice.to(f32).permute(2 - axis, 2 - w2, 2 - w1)
            lg = (lg.flip(0) if sign < 0 else lg).contiguous()
            l_a = lg.shape[0]
            cl = torch.clamp(z_rel / ext[axis] * l_a - 0.5, 0.0, l_a - 1.0)
            k0l = torch.clamp(torch.floor(cl).to(torch.int32), 0,
                              max(l_a - 2, 0)).long()
            self.lat_slabs = torch.stack(
                [k0l, torch.clamp(k0l + 1, max=l_a - 1)], 1)
            self.lg = lg
            S["nla"] = _full(float(l_a), dev)
        S = {k: (x.to(device=dev, dtype=f32).reshape(()) if isinstance(
            x, torch.Tensor) else _full(x, dev)) for k, x in S.items()}
        self.S = S

        # per fan pixel: the box interval, its exit and the ray's speed
        ones = torch.ones((hi_i, wi_i), **opts)
        p2, q2 = pg[None, :], qg[:, None]
        l1, h1 = _axis_rng(S["e1"] * ones, p2 * ones, S["lo1"], S["ex1"])
        l2, h2 = _axis_rng(S["e2"] * ones, q2 * ones, S["lo2"], S["ex2"])
        l_in = torch.clamp(torch.maximum(torch.maximum(l1, l2), S["cla"]),
                           min=0.0)
        exit_t = torch.minimum(torch.minimum(h1, h2), S["cha"])
        self.lin, self.exit = l_in, exit_t
        self.lout = torch.maximum(exit_t, l_in)
        self.speed = torch.sqrt(p2 * p2 + q2 * q2 + 1.0)
        jf = torch.arange(pl.n_slices, **opts)
        z2 = (jf + S["off"]) * S["dz"]
        cc = torch.clamp((z2 - S["smp0"]) * S["smpsc"] - 0.5, min=0.0)
        cc = torch.minimum(cc, S["na"] - 1.0)
        kf = torch.minimum(torch.clamp(torch.floor(cc), min=0.0),
                           S["na"] - 2.0)
        self.lam = z2 * S["dlam"] + S["lam0"]
        self.fz = cc - kf
        if inp.shading == "shadow":
            cl2 = torch.clamp(z2 / S["exa"] * S["nla"] - 0.5, min=0.0)
            cl2 = torch.minimum(cl2, S["nla"] - 1.0)
            kl = torch.minimum(torch.clamp(torch.floor(cl2), min=0.0),
                               S["nla"] - 2.0)
            self.fzl = cl2 - kl
        rows = torch.arange(-1, hi_i + 1, **opts)
        self.q_smp = S["qlo"] + rows * S["dq"] if pl.fd else qg
        self.pg, self.qg = pg, qg
        self.tab = torch.cat([_f32(inp.color, dev).reshape(-1, 3),
                              _f32(inp.alpha, dev).reshape(-1, 1)], dim=1)
        if inp.color.reshape(-1, 3).shape[0] != inp.alpha.reshape(-1).shape[0]:
            raise ValueError("colour and alpha tables need one length")
        self.warp_args = (p_scr, q_scr, p_lo, q_lo, dp, dq, u, v, e,
                          direction, horizontal, vertical)

    # ---- tiles ----
    def rays_meeting(self, box_lo, box_hi) -> torch.Tensor:
        """(Hi, Wi) bool: the fan rays that pass through the world box
        [box_lo, box_hi]."""
        pl = self.plan
        w1, w2 = self.w
        dev = self.dev
        e = _f32(self.inp.eye, dev)
        blo, bhi = _f32(box_lo, dev), _f32(box_hi, dev)
        ones = torch.ones((pl.inter_h, pl.inter_w), device=dev)
        l1, h1 = _axis_rng(e[w1] * ones, self.pg[None, :] * ones, blo[w1],
                           bhi[w1] - blo[w1])
        l2, h2 = _axis_rng(e[w2] * ones, self.qg[:, None] * ones, blo[w2],
                           bhi[w2] - blo[w2])
        ta = (blo[pl.axis] - e[pl.axis]) * pl.sign
        tb = (bhi[pl.axis] - e[pl.axis]) * pl.sign
        t_in = torch.clamp(torch.maximum(torch.maximum(l1, l2),
                                         torch.minimum(ta, tb)), min=0.0)
        t_out = torch.minimum(torch.minimum(h1, h2), torch.maximum(ta, tb))
        return t_in < t_out

    def tile_origins(self, rng: np.random.Generator, content_box=None,
                     per_side: int = 4, n_content: int = 48) -> list:
        """Fan tiles to hold: one drawn in each cell of a per_side x
        per_side split of the whole fan, and n_content drawn among the
        tiles whose rays meet `content_box` ((lo, hi) world corners: where
        the volume holds anything), without repeats. Tiles are whole
        blocks inside the fan."""
        hi_i, wi_i = self.plan.inter_h, self.plan.inter_w
        nbr, nbc = hi_i // BLOCK_ROWS - 1, wi_i // BLOCK_COLS - 1
        out = []
        for i in range(per_side):
            for j in range(per_side):
                r_lo, r_hi = i * nbr // per_side, (i + 1) * nbr // per_side
                c_lo, c_hi = j * nbc // per_side, (j + 1) * nbc // per_side
                br = int(rng.integers(r_lo, max(r_hi, r_lo + 1)))
                bc = int(rng.integers(c_lo, max(c_hi, c_lo + 1)))
                out.append((br, bc))
        if content_box is not None:
            hit = self.rays_meeting(*content_box)
            blk = hit[:(nbr + 1) * BLOCK_ROWS, :(nbc + 1) * BLOCK_COLS]
            blk = blk.reshape(nbr + 1, BLOCK_ROWS, nbc + 1, BLOCK_COLS).any(
                3).any(1)
            tile = blk[:-1, :-1] | blk[1:, :-1] | blk[:-1, 1:] | blk[1:, 1:]
            cand = torch.nonzero(tile).cpu().numpy()
            pick = rng.choice(len(cand), size=min(n_content, len(cand)),
                              replace=False) if len(cand) else []
            out += [(int(cand[k][0]), int(cand[k][1])) for k in pick]
        # a small fan draws some twice
        return [(br * BLOCK_ROWS, bc * BLOCK_COLS)
                for br, bc in dict.fromkeys(out)]

    # ---- the slice loop on tiles ----
    def _samples(self, j, rows_q, cols, lam):
        """Sample values (T, len(rows), len(cols)) of plane j at the fan
        positions q_smp[rows_q] x pg[cols], with the analytic gradient's
        parts."""
        S = self.S
        n_a, n_r, n_c = self.n
        q = self.q_smp[rows_q]
        p = self.pg[cols]
        x2 = S["e2"] + q * lam
        x1 = S["e1"] + p * lam
        vr = torch.clamp((x2 - S["lo2"]) / S["ex2"] * n_r - 0.5, 0.0,
                         n_r - 1.0)
        vc = torch.clamp((x1 - S["lo1"]) / S["ex1"] * n_c - 0.5, 0.0,
                         n_c - 1.0)
        ir0, ir1, fr = _taps(vr, n_r)
        ic0, ic1, fc = _taps(vc, n_c)
        fz = self.fz[j]
        g = _corners(self.grid_v, self.slabs[j], ir0, ir1, ic0, ic1)
        v = g[0] * (1.0 - fz) + g[1] * fz
        v00, v01, v10, v11 = v[0, 0], v[0, 1], v[1, 0], v[1, 1]
        gs = S["gs"]
        wr0 = ((1.0 - fr) * gs)[:, :, None]
        wr1 = (fr * gs)[:, :, None]
        fcr = fc[:, None, :]
        t0 = v00 * wr0 + v10 * wr1
        t1 = v01 * wr0 + v11 * wr1
        smp = t0 * (1.0 - fcr) + t1 * fcr
        return smp, (t0, t1, v00, v01, v10, v11, fr[:, :, None], fcr)

    def _shadow(self, j, rows_l, cols, lam):
        S = self.S
        lg = self.lg
        l_a, l_r, l_c = lg.shape
        fzl = self.fzl[j]
        x1 = S["e1"] + self.pg[cols] * lam
        x2 = S["e2"] + self.q_smp[rows_l] * lam
        lvr = torch.clamp((x2 - S["glo2"]) / S["gex2"] * l_r - 0.5, 0.0,
                          l_r - 1.0)
        lvc = torch.clamp((x1 - S["glo1"]) / S["gex1"] * l_c - 0.5, 0.0,
                          l_c - 1.0)
        lr0, lr1, lfr = _taps(lvr, l_r)
        lc0, lc1, lfc = _taps(lvc, l_c)
        lfr = lfr[:, :, None]
        lfc = lfc[:, None, :]
        t = _corners(lg, self.lat_slabs[j], lr0, lr1, lc0, lc1)
        p = t[0] * (1.0 - fzl) + t[1] * fzl
        return ((p[0, 0] * (1.0 - lfr) + p[1, 0] * lfr) * (1.0 - lfc)
                + (p[0, 1] * (1.0 - lfr) + p[1, 1] * lfr) * lfc)

    def _classify(self, smp):
        S = self.S
        tab = self.tab
        n_tab = tab.shape[0]
        v_raw = (smp - S["vlo"]) * S["vscale"]
        cc = torch.clamp(v_raw, 0.0, 1.0) * (n_tab - 1)
        i0f = torch.clamp(torch.floor(cc), 0.0, n_tab - 1.0)
        f = (cc - i0f)[..., None]
        i0 = i0f.long()
        i1 = torch.clamp(i0 + 1, max=n_tab - 1)
        return tab[i0] * (1.0 - f) + tab[i1] * f

    def slice_tiles(self, origins):
        """Premultiplied colour (T, R, C, 3) and alpha (T, R, C) of the
        tiles with these (row, column) origins."""
        S, pl, dev = self.S, self.plan, self.dev
        f32 = torch.float32
        n_a, n_r, n_c = self.n
        wi = pl.inter_w
        tt = len(origins)
        r0 = torch.tensor([o[0] for o in origins], device=dev)
        c0 = torch.tensor([o[1] for o in origins], device=dev)
        ar = torch.arange(TILE_ROWS, device=dev)
        ac = torch.arange(TILE_COLS, device=dev)
        rows = r0[:, None] + ar[None, :]  # (T, R) fan rows
        cols = c0[:, None] + ac[None, :]  # (T, C) fan columns
        fd = pl.fd and self.inp.shading != "none"
        if fd:
            rows_q = r0[:, None] + torch.arange(TILE_ROWS + 2, device=dev)
            cols_w = torch.clamp(c0[:, None] + torch.arange(
                -1, TILE_COLS + 1, device=dev), 0, wi - 1)
            rows_l = rows + 1  # q_smp index of a fan row
        else:
            rows_q, cols_w, rows_l = rows, cols, rows

        def pix(x):
            return x[rows[:, :, None], cols[:, None, :]]

        lin, lout, ext_t = pix(self.lin), pix(self.lout), pix(self.exit)
        speed = pix(self.speed)
        k1 = self.pg[cols][:, None, :]
        k2 = self.qg[rows][:, :, None]
        colg = cols[:, None, :]
        acc = torch.zeros((3, tt, TILE_ROWS, TILE_COLS), dtype=f32,
                          device=dev)
        trans = torch.ones((tt, TILE_ROWS, TILE_COLS), dtype=f32, device=dev)
        prev = torch.zeros_like(trans)
        alive = torch.ones((tt, 2, 2), dtype=torch.bool, device=dev)
        shaded = self.inp.shading != "none"
        for j in range(pl.n_slices):
            lam = self.lam[j]
            smp_w, parts = self._samples(j, rows_q, cols_w, lam)
            smp = smp_w[:, 1:-1, 1:-1] if fd else smp_w
            rgba = self._classify(smp)
            rgb = torch.clamp(rgba[..., :3], 0.0, 1.0)
            a_raw = rgba[..., 3]
            seg_lo = torch.maximum(lam - S["half"], lin)
            seg_hi = torch.minimum(lam + S["half"], lout)
            dt_w = torch.clamp(seg_hi - seg_lo, min=0.0) * speed
            kk = S["base"] * dt_w
            a_c = _clip(a_raw, 0.0, 1.0 - 1e-7)
            a = _clip(1.0 - torch.exp(kk * torch.log1p(-a_c)), 0.0, 1.0)
            a = torch.where(torch.abs(kk - 1.0) < 1e-7,
                            _clip(a_raw, 0.0, 1.0), a)
            a = torch.where(dt_w > 0.0, a, 0.0)
            vals = [rgb[..., 0], rgb[..., 1], rgb[..., 2]]
            if shaded:
                a = torch.minimum(a, a.new_full((), 1.0 - 1e-6))
                if fd:
                    fwd = smp_w[:, 1:-1, 2:] - smp
                    bwd = smp - smp_w[:, 1:-1, :-2]
                    g1 = torch.where(colg == 0, fwd, torch.where(
                        colg >= wi - 1, bwd, 0.5 * (fwd + bwd))) / (
                            S["dp"] * lam)
                    g2 = (smp_w[:, 2:, 1:-1] - smp_w[:, :-2, 1:-1]) * (
                        0.5 / (S["dq"] * lam))
                else:
                    t0, t1, v00, v01, v10, v11, fr, fcr = parts
                    gs = S["gs"]
                    g1 = torch.where(fcr > 0, t1 - t0, 0.0) * (
                        n_c / S["ex1"])
                    d0 = (v10 - v00) * gs
                    d1 = (v11 - v01) * gs
                    g2 = torch.where(fr > 0, d0 * (1.0 - fcr) + d1 * fcr,
                                     0.0) * (n_r / S["ex2"])
                ds = ((smp - prev) / S["dzdlam"] if j > 0
                      else torch.zeros_like(smp))
                ga = (ds - g1 * k1 - g2 * k2) * S["invda"]
                n1, n2, na = -g1, -g2, -ga
                inv = torch.rsqrt(n1 * n1 + n2 * n2 + na * na + 1e-12)
                total = torch.abs(S["ld1"] * n1 + S["ld2"] * n2
                                  + S["lda"] * na) * inv
                if self.inp.shading == "shadow":
                    total = total * (1.0 - _clip(
                        self._shadow(j, rows_l, cols, lam), 0.0, 1.0))
                shade = 0.5 + total
                vals = [_clip(x * shade, 0.0, 1.0) for x in vals]
            a = torch.clamp(a, max=1.0 - 1e-6)
            comp = alive.repeat_interleave(BLOCK_ROWS, 1).repeat_interleave(
                BLOCK_COLS, 2)
            aw = trans * a
            new_acc = acc + aw[None] * torch.stack(vals)
            trans_next = trans * (1.0 - a)
            acc = torch.where(comp[None], new_acc, acc)
            trans = torch.where(comp, trans_next, trans)
            if shaded:
                prev = torch.where(comp, smp, prev)
            ray_alive = (trans_next > T_EPS) & (ext_t > lam)
            blk = ray_alive.view(tt, 2, BLOCK_ROWS, 2, BLOCK_COLS).any(
                4).any(2)
            alive = torch.where(alive, blk, alive)
            if j % 32 == 31 and not bool(alive.any()):
                break
        return acc.permute(1, 2, 3, 0), 1.0 - trans, rows, cols

    # ---- the warp and the frame ----
    def render(self, origins):
        """The straight-alpha rgba (H, W, 4) of the screen pixels that the
        tiles cover, and the bool mask (H, W) of those pixels."""
        pl = self.plan
        color_t, alpha_t, rows, cols = self.slice_tiles(origins)
        hi_i, wi_i = pl.inter_h, pl.inter_w
        f32 = torch.float32
        stack = torch.zeros((hi_i, wi_i, 5), dtype=f32, device=self.dev)
        stack[..., 4] = 1.0
        rr, cc = rows[:, :, None], cols[:, None, :]
        stack[rr, cc, 0:3] = color_t
        stack[rr, cc, 3] = alpha_t
        stack[rr, cc, 4] = 0.0
        out = self._warp(stack)
        color = out[..., 0:3].reshape(-1, 3)
        alpha = torch.clamp(out[..., 3], 0.0, 1.0).reshape(-1)
        covered = (out[..., 4] == 0.0)
        sel = alpha > 1e-12
        safe = torch.where(sel, alpha, torch.ones_like(alpha))
        color = torch.where(sel[..., None], color / safe[..., None], 0.0)
        rgba = torch.cat([color, alpha[..., None]], dim=-1)
        return (rgba.reshape(self.inp.height, self.inp.width, 4),
                covered)

    def _warp(self, stack):
        pl = self.plan
        (p_scr, q_scr, p_lo, q_lo, dp, dq, u, v, e, direction, horizontal,
         vertical) = self.warp_args
        axis, sign = pl.axis, pl.sign
        w1, w2 = self.w
        cp = (p_scr - p_lo) / dp - 0.5

        def q_to_row(q):
            return (q - q_lo) / dq - 0.5

        def q_at(us, vs):
            num = direction[w2] + us * horizontal[w2] + vs * vertical[w2]
            den = (direction[axis] + us * horizontal[axis]
                   + vs * vertical[axis]) * sign
            return _safe_div(num, den)

        if pl.separable:
            cq = q_to_row(q_scr)
            if not pl.swap:
                return _warp_separable(stack, cq[:, 0], cp[0, :])
            return _warp_separable(stack, cq[0, :], cp[:, 0]).transpose(0, 1)
        if not pl.swap:
            vs = v[:, None]
            pi = self.pg[None, :]
            num = (pi * (direction[axis] + vs * vertical[axis]) * sign
                   - direction[w1] - vs * vertical[w1])
            den = horizontal[w1] - pi * horizontal[axis] * sign
            us = _safe_div(num, den)
            r1 = q_to_row(q_at(us, vs))
            t = _warp_rows(stack.transpose(0, 1), r1.T)
            return _warp_rows(t.transpose(0, 1), cp)
        us = u[None, :]
        pi = self.pg[:, None]
        num = (pi * (direction[axis] + us * horizontal[axis]) * sign
               - direction[w1] - us * horizontal[w1])
        den = vertical[w1] - pi * vertical[axis] * sign
        vs = _safe_div(num, den)
        r1 = q_to_row(q_at(us, vs))
        t = _warp_rows(stack.transpose(0, 1), r1)
        return _warp_rows(t.transpose(0, 1), cp.T).transpose(0, 1)


def _clamped_taps(pos, n):
    return _taps(torch.clamp(torch.nan_to_num(pos, nan=0.0), 0.0, n - 1.0),
                 n)


def _warp_rows(img, pos):
    """Each row r of img (R, I, C) resampled at columns pos (R, O)."""
    r, n_in, ch = img.shape
    i0, i1, f = _clamped_taps(pos, n_in)
    g0 = torch.gather(img, 1, i0[..., None].expand(-1, -1, ch))
    g1 = torch.gather(img, 1, i1[..., None].expand(-1, -1, ch))
    f = f[..., None].to(img.dtype)
    return g0 * (1.0 - f) + g1 * f


def _warp_separable(img, row_pos, col_pos):
    hi_i, wi_i, _ = img.shape
    r0, r1, fr = _clamped_taps(row_pos, hi_i)
    fr = fr[:, None, None].to(img.dtype)
    t = img[r0] * (1.0 - fr) + img[r1] * fr
    c0, c1, fc = _clamped_taps(col_pos, wi_i)
    fc = fc[None, :, None].to(img.dtype)
    return t[:, c0] * (1.0 - fc) + t[:, c1] * fc
