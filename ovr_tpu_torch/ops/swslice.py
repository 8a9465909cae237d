"""The fused shear-warp slice loop: Hopper kernel wrapper and plain version.

`slice_composite` runs the whole front-to-back slice loop of the
shear-warp renderer in one launch of the CUDA kernel in
`csrc/swslice.cu` (the port of `ovr_tpu.ops.swslice`'s Pallas kernels
`_kernel_persist` and `_kernel`). For each fan pixel and each plane of
the schedule it z-lerps two voxel slabs, resamples bilinearly into the
fan, classifies through the merged RGBA table, opacity-corrects with the
exact plane/ray overlap, in modes 1/2 shades with a fan-space gradient
(and mode 2's shadow lattice), and composites into 8 channels
[r, g, b, nx, ny, nz, depth, alpha] (premultiplied; alpha = 1 - T).

Work avoidance, per CUDA block of BLOCK_ROWS x BLOCK_COLS fan pixels:
- a plane whose slab pair and the block's voxel footprint lie only in
  macrocells with majorant <= MAJ_EPS classifies to zero opacity and is
  skipped (exact). Modes >= 1 also compute the plane before each active
  one, whose samples feed the axial difference;
- the block stops once no ray in it has T > T_EPS with its box exit
  still ahead of the plane.

`slice_composite_plain` is the same function in PyTorch, block
semantics included, so the kernel can be held against it at tight
tolerances; the wrapper takes it for CPU tensors only.

Arguments follow `ovr_tpu.ops.swslice.slice_composite_pallas` (the
72-slot scalar layout below included), without the TPU tiling knobs.
`axial_flip` lets the caller pass a storage-ordered volume (and
majorant grid) that the schedule walks from its last plane.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ovr_tpu_torch.core.sampling import storage_scale

LAUNCHES = 0  # kernel launches through `slice_composite`

BLOCK_ROWS = 8  # fan rows per CUDA block (csrc/swslice.cu: BR)
BLOCK_COLS = 32  # fan columns per CUDA block (csrc/swslice.cu: BC)
MC = 16  # macrocell edge in voxels (render.accel.MACROCELL_SIZE)
T_EPS = 1e-4  # termination transmittance (alpha >= 0.9999)
MAJ_EPS = 1.19e-7  # a macrocell at or below this majorant is empty
MAX_TAB = 2048  # RGBA table rows the kernel keeps in shared memory

# scalar vector layout (N_SCALARS,) f32, as in ovr_tpu.ops.swslice.
# S_LO1/EX1/LO2/EX2: sample box (texel coordinates); S_C*: clip box (ray
# interval clamp); S_SMP0/S_SMPSC map traversal depth to the axial texel
# coordinate; S_OFF folds the slice offset (slice0 + jitter).
(S_LO1, S_EX1, S_LO2, S_EX2, S_EW1, S_EW2, S_DW1, S_DW2, S_HALF, S_DZ,
 S_OFF, S_VLO, S_VSCALE, S_BASE, S_LAM0, S_NA, S_DLAM, S_EXA,
 S_ORTHO, S_LD1, S_LD2, S_LDA, S_K1O, S_K2O, S_INVDA, S_DZDLAM, S_NLA,
 S_W00, S_W01, S_W02, S_W10, S_W11, S_W12, S_W20, S_W21, S_W22,
 S_CLO1, S_CEX1, S_CLO2, S_CEX2, S_CLA, S_CHA, S_SMP0, S_SMPSC,
 S_GLO1, S_GEX1, S_GLO2, S_GEX2) = range(48)
S_EL0 = 48  # up to 4 extra directional lights: d_w1, d_w2, d_axis, I
S_GS = 64  # normalized-integer storage scale (set here)
S_DP = 65  # fan column spacing (set here)
S_DQ = 66  # fan row spacing (set here)
S_QLO = 67  # first fan row's q (set here)
N_SCALARS = 72

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2,
               torch.uint16: 3}


def _prepared_scalars(scalars, grid_dtype, pg, qg) -> torch.Tensor:
    """The caller's scalars with the slots this module owns filled in."""
    sc = scalars.to(torch.float32).clone()
    sc[S_GS] = storage_scale(grid_dtype)
    sc[S_DP] = pg[1] - pg[0] if pg.shape[0] > 1 else 1.0
    sc[S_DQ] = qg[1] - qg[0] if qg.shape[0] > 1 else 1.0
    sc[S_QLO] = qg[0]
    return sc


def _check(grid_v, rgba_tab, scalars, pg, qg, k0, n_slices, mode, lgrid,
           k0l, n_extra, majorant_v):
    arrays = (grid_v, rgba_tab, scalars, pg, qg, k0, lgrid, k0l, majorant_v)
    if any(t is not None and t.requires_grad for t in arrays):
        raise RuntimeError(
            "slice_composite has no backward yet (the adjoint is the next "
            "slice of the port); detach the inputs")
    if mode not in (0, 1, 2):
        raise ValueError(f"mode must be 0, 1 or 2, got {mode}")
    if mode == 2 and (lgrid is None or k0l is None):
        raise ValueError("mode 2 needs lgrid and k0l")
    if not 0 <= n_extra <= 4:
        raise ValueError(f"at most 4 extra lights, got {n_extra}")
    if grid_v.ndim != 3 or min(grid_v.shape) < 2:
        raise ValueError(f"grid_v must be (A, Nr, Nc) >= 2, got "
                         f"{tuple(grid_v.shape)}")
    if grid_v.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported grid dtype {grid_v.dtype}")
    if tuple(k0.shape) != (n_slices,) or tuple(scalars.shape) != (
            N_SCALARS,):
        raise ValueError("k0 must be (n_slices,) and scalars (N_SCALARS,)")
    if rgba_tab.ndim != 2 or rgba_tab.shape[1] != 4:
        raise ValueError("rgba_tab must be (K, 4)")


def slice_composite(grid_v, rgba_tab, scalars, pg, qg, k0, n_slices: int,
                    mode: int = 0, lgrid=None, k0l=None, n_extra: int = 0,
                    majorant_v=None, term: bool = True, fd: bool = True,
                    axial_flip: bool = False,
                    block_planes: Optional[torch.Tensor] = None):
    """Run the fused slice loop. grid_v (A, Nr, Nc) volume in traversal
    layout (f32, bf16, u8 or u16; any strides); rgba_tab (K, 4) merged
    nodal table; scalars (N_SCALARS,) in the S_* layout; pg (Wi,), qg
    (Hi,) fan coordinates; k0 (n_slices,) slab indices; mode 0/1/2 =
    none/diffuse/shadow; lgrid (La, Lr, Lc) traversal-ordered shadow
    lattice + k0l (n_slices,) for mode 2; n_extra extra directional
    lights in the scalars; majorant_v (MA, MR, MC) macrocell majorants
    in grid_v's layout (enables skipping); term enables early
    termination; fd selects the finite-difference gradient (modes 1/2);
    axial_flip walks grid_v (and majorant_v) from plane A-1 down.
    `block_planes`, if given, is an int32 tensor of one entry per block
    (row-major over a ceil(Hi/BLOCK_ROWS) x ceil(Wi/BLOCK_COLS) grid)
    that receives the number of planes each block composited.

    Returns (8, Hi, Wi) f32. CUDA tensors run the kernel (or raise);
    CPU tensors run `slice_composite_plain`."""
    _check(grid_v, rgba_tab, scalars, pg, qg, k0, n_slices, mode, lgrid,
           k0l, n_extra, majorant_v)
    fn = _slice_composite_cuda if grid_v.is_cuda else slice_composite_plain
    return fn(grid_v, rgba_tab, scalars, pg, qg, k0, n_slices, mode=mode,
              lgrid=lgrid, k0l=k0l, n_extra=n_extra, majorant_v=majorant_v,
              term=term, fd=fd, axial_flip=axial_flip,
              block_planes=block_planes)


def _bind(lib):
    f = lib.ovr_swslice_launch
    if f.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [
            p, ll, ll, ll, i, i, i, i,  # grid, strides, dims, dtype
            p, i, p,  # table, rows, scalars
            p, i, p, i,  # pg, wi, qg, hi
            p, i,  # k0, n_slices
            p, p, i, i, i,  # lattice, k0l, dims
            p, i, i, i, i,  # majorants, dims, flip
            i, i, i, i,  # mode, fd, n_extra, term
            p, p, p]  # out, block_planes, stream
        f.restype = ctypes.c_int
        lib.ovr_swslice_error_string.argtypes = [ctypes.c_int]
        lib.ovr_swslice_error_string.restype = ctypes.c_char_p
        lib.ovr_swslice_block_dims.argtypes = [ctypes.POINTER(ctypes.c_int),
                                               ctypes.POINTER(ctypes.c_int)]
        br, bc = ctypes.c_int(), ctypes.c_int()
        lib.ovr_swslice_block_dims(ctypes.byref(br), ctypes.byref(bc))
        if (br.value, bc.value) != (BLOCK_ROWS, BLOCK_COLS):
            raise RuntimeError("csrc/swslice.cu block shape differs from "
                               "BLOCK_ROWS x BLOCK_COLS")
    return f


def _slice_composite_cuda(grid_v, rgba_tab, scalars, pg, qg, k0, n_slices,
                          *, mode, lgrid, k0l, n_extra, majorant_v, term, fd,
                          axial_flip, block_planes):
    global LAUNCHES
    from ovr_tpu_torch.ops import cuda_build

    dev = grid_v.device
    for t in (rgba_tab, scalars, pg, qg, k0, lgrid, k0l, majorant_v,
              block_planes):
        if t is not None and t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    if rgba_tab.shape[0] > MAX_TAB:
        raise ValueError(f"rgba_tab has more than {MAX_TAB} rows")
    launch = _bind(cuda_build.load("swslice").lib)
    n_a, n_r, n_c = grid_v.shape
    hi, wi = qg.shape[0], pg.shape[0]
    pgf = pg.to(torch.float32).contiguous()
    qgf = qg.to(torch.float32).contiguous()
    sc = _prepared_scalars(scalars, grid_v.dtype, pgf, qgf).contiguous()
    tab = rgba_tab.to(torch.float32).contiguous()
    k0i = k0.to(torch.int32).contiguous()
    sa, sr, scs = grid_v.stride()
    base = grid_v.data_ptr()
    if axial_flip:
        base += (n_a - 1) * sa * grid_v.element_size()
        sa = -sa
    if mode == 2:
        lg = lgrid.to(torch.float32).contiguous()
        k0li = k0l.to(torch.int32).contiguous()
        (la, lr, lc), lg_p, k0l_p = lg.shape, lg.data_ptr(), k0li.data_ptr()
    else:
        la = lr = lc = 0
        lg_p = k0l_p = None
    if majorant_v is not None:
        maj = majorant_v.to(torch.float32).contiguous()
        (ma, mr, mcn), maj_p = maj.shape, maj.data_ptr()
    else:
        ma = mr = mcn = 0
        maj_p = None
    if block_planes is not None:
        n_blocks = math.ceil(hi / BLOCK_ROWS) * math.ceil(wi / BLOCK_COLS)
        if (block_planes.dtype != torch.int32
                or block_planes.numel() != n_blocks
                or not block_planes.is_contiguous()):
            raise ValueError(f"block_planes must be {n_blocks} contiguous "
                             "int32")
    out = torch.empty((8, hi, wi), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            base, sa, sr, scs, n_a, n_r, n_c, _DTYPE_CODE[grid_v.dtype],
            tab.data_ptr(), tab.shape[0], sc.data_ptr(),
            pgf.data_ptr(), wi, qgf.data_ptr(), hi,
            k0i.data_ptr(), n_slices,
            lg_p, k0l_p, la, lr, lc,
            maj_p, ma, mr, mcn, int(axial_flip),
            mode, int(fd), n_extra, int(term),
            out.data_ptr(),
            None if block_planes is None else block_planes.data_ptr(),
            stream)
    if err:
        lib = cuda_build.load("swslice").lib
        raise RuntimeError("swslice kernel launch failed: "
                           + lib.ovr_swslice_error_string(err).decode())
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _taps(pos, n: int):
    """Two-tap linear interpolation of already-clamped positions."""
    i0f = torch.floor(pos)
    i0 = i0f.long()
    return i0, torch.clamp(i0 + 1, max=n - 1), pos - i0f


def _axis_rng(o, d, lo, ext):
    """Per-axis slab entry/exit parameters of o + t*d vs [lo, lo+ext];
    |d| < 1e-12 counts as parallel."""
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


def _blocks_any(mask, nbr, nbc):
    """(Hi, Wi) bool -> (nbr, nbc): any over each block's pixels."""
    hi, wi = mask.shape
    m = torch.zeros((nbr * BLOCK_ROWS, nbc * BLOCK_COLS), dtype=torch.bool,
                    device=mask.device)
    m[:hi, :wi] = mask
    return m.view(nbr, BLOCK_ROWS, nbc, BLOCK_COLS).any(3).any(1)


def _to_pixels(blk, hi, wi):
    """(nbr, nbc) -> (Hi, Wi): each block's value on its pixels."""
    return blk.repeat_interleave(BLOCK_ROWS, 0).repeat_interleave(
        BLOCK_COLS, 1)[:hi, :wi]


def _vr_of(S, q, lam, n_r, ortho):
    x2 = q + S[S_DW2] * lam if ortho else S[S_EW2] + q * lam
    return torch.clamp((x2 - S[S_LO2]) / S[S_EX2] * n_r - 0.5, 0.0,
                       n_r - 1.0)


def _vc_of(S, p, lam, n_c, ortho):
    x1 = p + S[S_DW1] * lam if ortho else S[S_EW1] + p * lam
    return torch.clamp((x1 - S[S_LO1]) / S[S_EX1] * n_c - 0.5, 0.0,
                       n_c - 1.0)


def _block_active(maj, S, pg, qg, k: int, lam, n_a, n_r, n_c, fd_on, ortho,
                  axial_flip):
    """(nbr, nbc) bool: does any macrocell under the block's voxel
    footprint of plane (slab k, lam) have a majorant > MAJ_EPS? The
    footprint spans the taps of the block's extreme rows and columns
    (halo included with fd_on) plus a one-voxel margin; positions are
    monotone along rows and columns, so this covers every tap."""
    hi, wi = qg.shape[0], pg.shape[0]
    dev = pg.device
    rf = torch.arange(0, hi, BLOCK_ROWS, device=dev)
    rl = torch.clamp(rf + BLOCK_ROWS, max=hi) - 1
    if fd_on:
        qa = S[S_QLO] + (rf - 1).float() * S[S_DQ]
        qb = S[S_QLO] + (rl + 1).float() * S[S_DQ]
    else:
        qa, qb = qg[rf], qg[rl]
    cf = torch.arange(0, wi, BLOCK_COLS, device=dev)
    cl = torch.clamp(cf + BLOCK_COLS, max=wi) - 1
    if fd_on:
        cf = torch.clamp(cf - 1, min=0)
        cl = torch.clamp(cl + 1, max=wi - 1)

    def cells(lo_pos, hi_pos, n):
        lo_v = torch.minimum(lo_pos, hi_pos)
        hi_v = torch.maximum(lo_pos, hi_pos)
        v0 = torch.clamp(torch.floor(lo_v).long() - 1, min=0)
        v1 = torch.clamp(torch.floor(hi_v).long() + 2, max=n - 1)
        return v0 // MC, v1 // MC

    r0, r1 = cells(_vr_of(S, qa, lam, n_r, ortho),
                   _vr_of(S, qb, lam, n_r, ortho), n_r)
    c0, c1 = cells(_vc_of(S, pg[cf], lam, n_c, ortho),
                   _vc_of(S, pg[cl], lam, n_c, ortho), n_c)
    sa, sb = (n_a - 1 - k, n_a - 2 - k) if axial_flip else (k, k + 1)
    a0, a1 = min(sa, sb) // MC, max(sa, sb) // MC
    m_a = maj[a0:a1 + 1].amax(0)  # (MR, MC)
    ir = torch.arange(maj.shape[1], device=dev)
    ic = torch.arange(maj.shape[2], device=dev)
    neg = torch.tensor(float("-inf"), device=dev)
    in_r = (ir[None] >= r0[:, None]) & (ir[None] <= r1[:, None])
    m_r = torch.where(in_r[:, :, None], m_a[None], neg).amax(1)  # (nbr, MC)
    in_c = (ic[None] >= c0[:, None]) & (ic[None] <= c1[:, None])
    m_rc = torch.where(in_c[None], m_r[:, None, :], neg).amax(2)
    return m_rc > MAJ_EPS


def slice_composite_plain(grid_v, rgba_tab, scalars, pg, qg, k0,
                          n_slices: int, *, mode: int = 0, lgrid=None,
                          k0l=None, n_extra: int = 0, majorant_v=None,
                          term: bool = True, fd: bool = True,
                          axial_flip: bool = False, block_planes=None):
    """The fused slice loop in PyTorch, arithmetic in the kernel's order
    and per-block skipping/termination as the kernel does them. Same
    arguments and result as `slice_composite`."""
    f32 = torch.float32
    dev = grid_v.device
    n_a, n_r, n_c = grid_v.shape
    hi, wi = qg.shape[0], pg.shape[0]
    nbr, nbc = -(-hi // BLOCK_ROWS), -(-wi // BLOCK_COLS)
    pg = pg.to(f32)
    qg = qg.to(f32)
    S = _prepared_scalars(scalars, grid_v.dtype, pg, qg).unbind()
    ortho = bool(S[S_ORTHO] > 0.5)
    fd_on = mode >= 1 and fd
    tab = rgba_tab.to(f32)
    n_tab = tab.shape[0]
    gs = S[S_GS]

    # slice-independent per-pixel geometry: clip-box interval and speed
    p2, q2 = pg[None, :], qg[:, None]
    ones = torch.ones((hi, wi), dtype=f32, device=dev)
    l1, h1 = _axis_rng(p2 * ones if ortho else S[S_EW1] * ones,
                       S[S_DW1] * ones if ortho else p2 * ones,
                       S[S_CLO1], S[S_CEX1])
    l2, h2 = _axis_rng(q2 * ones if ortho else S[S_EW2] * ones,
                       S[S_DW2] * ones if ortho else q2 * ones,
                       S[S_CLO2], S[S_CEX2])
    l_in = torch.clamp(torch.maximum(torch.maximum(l1, l2), S[S_CLA]),
                       min=0.0)
    exit_t = torch.minimum(torch.minimum(h1, h2), S[S_CHA])
    l_out = torch.maximum(exit_t, l_in)
    speed = ones if ortho else torch.sqrt(p2 * p2 + q2 * q2 + 1.0)

    # the plane schedule
    jf = torch.arange(n_slices, dtype=f32, device=dev)
    z_rel = (jf + S[S_OFF]) * S[S_DZ]
    lam_all = z_rel * S[S_DLAM] + S[S_LAM0]
    c = torch.clamp((z_rel - S[S_SMP0]) * S[S_SMPSC] - 0.5, min=0.0)
    c = torch.minimum(c, S[S_NA] - 1.0)
    kf = torch.minimum(torch.clamp(torch.floor(c), min=0.0), S[S_NA] - 2.0)
    fz_all = c - kf
    k0_host = k0.tolist()
    if mode == 2:
        la, l_r, l_c = lgrid.shape
        lg = lgrid.to(f32)
        cl = torch.clamp(z_rel / S[S_EXA] * S[S_NLA] - 0.5, min=0.0)
        cl = torch.minimum(cl, S[S_NLA] - 1.0)
        kl = torch.minimum(torch.clamp(torch.floor(cl), min=0.0),
                           S[S_NLA] - 2.0)
        fzl_all = cl - kl
        k0l_host = k0l.tolist()
    if fd_on:
        rows = torch.arange(-1, hi + 1, dtype=f32, device=dev)
        q_smp = S[S_QLO] + rows * S[S_DQ]
    else:
        q_smp = qg
    col = torch.arange(wi, device=dev)[None, :]

    acc = torch.zeros((7, hi, wi), dtype=f32, device=dev)
    trans = ones.clone()
    prev = torch.zeros((hi, wi), dtype=f32, device=dev)
    jpos = torch.zeros((hi, wi), dtype=torch.int32, device=dev)
    alive = torch.ones((nbr, nbc), dtype=torch.bool, device=dev)
    planes = torch.zeros((nbr, nbc), dtype=torch.int32, device=dev)
    maj = None if majorant_v is None else majorant_v.to(f32)

    def raw_active(j):
        return _block_active(maj, S, pg, qg, k0_host[j], lam_all[j], n_a,
                             n_r, n_c, fd_on, ortho, axial_flip)

    raw_next = raw_active(0) if maj is not None and mode >= 1 else None
    for j in range(n_slices):
        lam = lam_all[j]
        if maj is None:
            comp_blk = alive
        elif mode == 0:
            comp_blk = alive & raw_active(j)
        else:
            raw_j = raw_next
            raw_next = (raw_active(j + 1) if j + 1 < n_slices
                        else torch.zeros_like(alive))
            comp_blk = alive & (raw_j | raw_next)
        if not bool(comp_blk.any()):
            if term and not bool(alive.any()):
                break
            continue
        comp = _to_pixels(comp_blk, hi, wi)

        # resample the plane (and the FD halo rows) into the fan
        k = k0_host[j]
        s0, s1 = ((n_a - 1 - k, n_a - 2 - k) if axial_flip else (k, k + 1))
        g0 = grid_v[s0].to(f32)
        g1_ = grid_v[s1].to(f32)
        fz = fz_all[j]
        vr = _vr_of(S, q_smp, lam, n_r, ortho)
        vc = _vc_of(S, pg, lam, n_c, ortho)
        x1 = pg + S[S_DW1] * lam if ortho else S[S_EW1] + pg * lam
        x2 = q_smp + S[S_DW2] * lam if ortho else S[S_EW2] + q_smp * lam
        ir0, ir1, fr = _taps(vr, n_r)
        ic0, ic1, fc = _taps(vc, n_c)

        def tap(ri, ci):
            ri, ci = ri[:, None], ci[None, :]
            return g0[ri, ci] * (1.0 - fz) + g1_[ri, ci] * fz

        v00, v01, v10, v11 = (tap(ir0, ic0), tap(ir0, ic1), tap(ir1, ic0),
                              tap(ir1, ic1))
        wr0 = ((1.0 - fr) * gs)[:, None]
        wr1 = (fr * gs)[:, None]
        t0 = v00 * wr0 + v10 * wr1
        t1 = v01 * wr0 + v11 * wr1
        fcr = fc[None, :]
        smp_e = t0 * (1.0 - fcr) + t1 * fcr
        smp = smp_e[1:-1] if fd_on else smp_e
        x2c = x2[1:-1] if fd_on else x2

        # classify: two-tap nodal lookup
        v = torch.clamp((smp - S[S_VLO]) * S[S_VSCALE], 0.0, 1.0)
        cc = v * (n_tab - 1)
        i0f = torch.clamp(torch.floor(cc), 0.0, n_tab - 1.0)
        f = (cc - i0f)[..., None]
        i0 = i0f.long()
        rgba = tab[i0] * (1.0 - f) + tab[torch.clamp(i0 + 1, max=n_tab - 1)
                                         ] * f
        rgb = torch.clamp(rgba[..., :3], 0.0, 1.0)
        a_raw = rgba[..., 3]

        # opacity correction over the exact plane/ray overlap
        seg_lo = torch.maximum(lam - S[S_HALF], l_in)
        seg_hi = torch.minimum(lam + S[S_HALF], l_out)
        dt_w = torch.clamp(seg_hi - seg_lo, min=0.0) * speed
        kk = S[S_BASE] * dt_w
        a_c = torch.clamp(a_raw, 0.0, 1.0 - 1e-7)
        a = torch.clamp(1.0 - torch.exp(kk * torch.log1p(-a_c)), 0.0, 1.0)
        a = torch.where(torch.abs(kk - 1.0) < 1e-7,
                        torch.clamp(a_raw, 0.0, 1.0), a)
        a = torch.where(dt_w > 0.0, a, 0.0)
        a = torch.clamp(a, max=1.0 - 1e-6)

        vals = [rgb[..., 0], rgb[..., 1], rgb[..., 2]]
        if mode >= 1:
            lamf = 1.0 if ortho else lam
            if fd_on:
                fwd = torch.roll(smp, -1, 1) - smp
                bwd = smp - torch.roll(smp, 1, 1)
                g1 = torch.where(col == 0, fwd, torch.where(
                    col >= wi - 1, bwd, 0.5 * (fwd + bwd))) / (S[S_DP] * lamf)
                g2 = (smp_e[2:] - smp_e[:-2]) * (0.5 / (S[S_DQ] * lamf))
            else:
                g1 = torch.where(fcr > 0, t1 - t0, 0.0) * (n_c / S[S_EX1])
                d0 = (v10 - v00) * gs
                d1 = (v11 - v01) * gs
                g2 = torch.where(fr[:, None] > 0,
                                 d0 * (1.0 - fcr) + d1 * fcr,
                                 0.0) * (n_r / S[S_EX2])
            ds = torch.where(jpos > 0, (smp - prev) / S[S_DZDLAM], 0.0)
            k1 = S[S_K1O] if ortho else p2
            k2 = S[S_K2O] if ortho else q2
            ga = (ds - g1 * k1 - g2 * k2) * S[S_INVDA]
            n1, n2, na = -g1, -g2, -ga
            inv = torch.rsqrt(n1 * n1 + n2 * n2 + na * na + 1e-12)
            total = torch.abs(S[S_LD1] * n1 + S[S_LD2] * n2
                              + S[S_LDA] * na) * inv
            for i in range(n_extra):
                b0 = S_EL0 + 4 * i
                ce = torch.abs(S[b0] * n1 + S[b0 + 1] * n2
                               + S[b0 + 2] * na) * inv
                total = total + 0.5 * ce * S[b0 + 3]
            if mode == 2:
                ka = k0l_host[j]
                lp = lg[ka] * (1.0 - fzl_all[j]) + lg[min(ka + 1, la - 1)
                                                       ] * fzl_all[j]
                lvr = torch.clamp((x2c - S[S_GLO2]) / S[S_GEX2] * l_r - 0.5,
                                  0.0, l_r - 1.0)
                lvc = torch.clamp((x1 - S[S_GLO1]) / S[S_GEX1] * l_c - 0.5,
                                  0.0, l_c - 1.0)
                lr0, lr1, lfr = _taps(lvr, l_r)
                lc0, lc1, lfc = _taps(lvc, l_c)
                lfr = lfr[:, None]
                lfc = lfc[None, :]
                r_0, r_1 = lr0[:, None], lr1[:, None]
                sh = ((lp[r_0, lc0[None]] * (1.0 - lfr)
                       + lp[r_1, lc0[None]] * lfr) * (1.0 - lfc)
                      + (lp[r_0, lc1[None]] * (1.0 - lfr)
                         + lp[r_1, lc1[None]] * lfr) * lfc)
                total = total * (1.0 - torch.clamp(sh, 0.0, 1.0))
            shade = 0.5 + total
            vals = [torch.clamp(x * shade, 0.0, 1.0) for x in vals]
            nu = (n1 * inv, n2 * inv, na * inv)
            for r in range(3):
                w = S[S_W00 + 3 * r:S_W00 + 3 * r + 3]
                vals.append(torch.clamp(w[0] * nu[0] + w[1] * nu[1]
                                        + w[2] * nu[2], 0.0, 1.0))
        else:
            vals += [torch.zeros_like(a)] * 3
        vals.append(lam * speed)

        aw = trans * a
        new_acc = acc + aw[None] * torch.stack(vals)
        trans_next = trans * (1.0 - a)
        acc = torch.where(comp[None], new_acc, acc)
        trans = torch.where(comp, trans_next, trans)
        if mode >= 1:
            prev = torch.where(comp, smp, prev)
        jpos = jpos + comp.to(torch.int32)
        planes = planes + comp_blk.to(torch.int32)
        if term:
            ray_alive = (trans_next > T_EPS) & (exit_t > lam)
            alive = torch.where(comp_blk, _blocks_any(ray_alive, nbr, nbc),
                                alive)
    if block_planes is not None:
        block_planes.copy_(planes.reshape(-1))
    return torch.cat([acc, (1.0 - trans)[None]])
