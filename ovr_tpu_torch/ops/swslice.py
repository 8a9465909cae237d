"""The fused shear-warp slice loop: Hopper kernel wrapper and plain version.

`slice_composite` runs the whole front-to-back slice loop of the
shear-warp renderer in one launch of the CUDA kernel in
`csrc/swslice.cu` (the port of `ovr_tpu.ops.swslice`'s Pallas kernels
`_kernel_persist` and `_kernel`). For each fan pixel and each plane of
the schedule it z-lerps two voxel slabs, resamples bilinearly into the
fan, classifies through the merged RGBA table, opacity-corrects with the
exact plane/ray overlap, in modes 1/2 shades with a fan-space gradient,
the primary light, a table of extra directional and point lights (and
mode 2's shadow lattice), and composites into 8 channels
[r, g, b, nx, ny, nz, depth, alpha] (premultiplied; alpha = 1 - T).

`bf16=True` is the JAX kernel's `bf16=True` variant: every operand of
its resampling matmuls is rounded to bfloat16 (round to nearest even)
and the products are summed in f32. Here the resampling is a bilinear
read, so the same values are rounded where they arise: the z-lerped
plane (formed in f32 as one fma, `_lerp_fma`), the row weights with the
storage scale folded in, the row-resampled values before the column
step, the column weights, the analytic gradient's derivative weights,
and mode 2's lattice plane, its weights and its row result. The TF
lookup and the FD differences stay f32, as in the JAX kernel. An f32
grid whose view has a multiple of 16 rows is read as bf16 (`_streamed`).

Work avoidance, per CUDA block of BLOCK_ROWS x BLOCK_COLS fan pixels:
- a plane whose slab pair and the block's voxel footprint lie only in
  macrocells with majorant <= MAJ_EPS classifies to zero opacity and is
  skipped (exact). Modes >= 1 also compute the plane before each active
  one, whose samples feed the axial difference;
- the block stops once no ray in it has T > T_EPS with its exit still
  ahead of the plane (the box exit, or a surface's where `exit_map`
  clamps it).

`slice_composite_plain` is the same function in PyTorch, block
semantics included, so the kernel can be held against it at tight
tolerances; the wrapper takes it for CPU tensors only.

Arguments follow `ovr_tpu.ops.swslice.slice_composite_pallas` (the
72-slot scalar layout below), without the TPU tiling knobs. Its 16
extra-light slots (4 directional lights) became a light table of any
length, `lights`, and two of them hold the plane's axial world
coordinate, which point lights read. `axial_flip` lets the caller pass
a storage-ordered volume (and majorant grid) that the schedule walks
from its last plane. `exit_map` is an input the TPU kernels lack: each
fan ray's exit clamped at the nearest surface, which the JAX package's
XLA slice loop reads (`ovr_tpu/render/shearwarp.py:1048-1062`) and its
Pallas kernels ignore.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ovr_tpu_torch.core.sampling import clip, storage_scale
from ovr_tpu_torch.ops.adjoint import adjoint_sweep, over_scan

LAUNCHES = 0  # kernel launches through `slice_composite`
LAUNCHES_BF16 = 0  # of them, launches of the kernel's bf16 variant
PLAIN_CALLS = 0  # runs of `slice_composite_plain`, on any device

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
# the plane's axial world coordinate is S_ZA0 + S_ZSG * z_rel (point
# lights); slots 50-63 are spare
S_ZA0 = 48
S_ZSG = 49
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
    # fills and device copies only: assigning a Python number copies it
    # from the host, which waits for the stream
    sc[S_GS].fill_(storage_scale(grid_dtype))
    for slot, g in ((S_DP, pg), (S_DQ, qg)):
        if g.shape[0] > 1:
            sc[slot] = g[1] - g[0]
        else:
            sc[slot].fill_(1.0)
    sc[S_QLO] = qg[0]
    return sc


def _check(grid_v, rgba_tab, scalars, pg, qg, k0, n_slices, mode, lgrid,
           k0l, lights, n_dir):
    if mode not in (0, 1, 2):
        raise ValueError(f"mode must be 0, 1 or 2, got {mode}")
    if mode == 2 and (lgrid is None or k0l is None):
        raise ValueError("mode 2 needs lgrid and k0l")
    n_lights = 0 if lights is None else lights.shape[0]
    if lights is not None and (lights.ndim != 2 or lights.shape[1] != 4):
        raise ValueError("lights must be (L, 4)")
    if not 0 <= n_dir <= n_lights:
        raise ValueError(f"n_dir must be in [0, {n_lights}], got {n_dir}")
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


def _streamed(grid_v, bf16: bool):
    """The grid as the slice loop reads it. Under `bf16` an f32 grid
    whose view has a multiple of 16 rows is rounded to bfloat16 once per
    call, as the JAX kernel streams it: its `_storage_plan` picks bf16
    storage for such a grid to fill the TPU's 16-row bf16 tiles
    (`ovr_tpu/ops/swslice.py:948-966`) and casts the whole grid
    (`:1051`); with another row count the grid stays f32. That rule of
    the TPU's memory layout changes results, so it is kept. A u8 grid
    that the JAX kernel streams as bf16 is exact in bf16, and u16 is
    never cast, so other grids are read as they are."""
    if bf16 and grid_v.dtype == torch.float32 and grid_v.shape[1] % 16 == 0:
        return grid_v.to(torch.bfloat16)
    return grid_v


def slice_composite(grid_v, rgba_tab, scalars, pg, qg, k0, n_slices: int,
                    mode: int = 0, lgrid=None, k0l=None, lights=None,
                    n_dir: int = 0, majorant_v=None, term: bool = True,
                    fd: bool = True, bf16: bool = False,
                    axial_flip: bool = False, exit_map=None,
                    block_planes: Optional[torch.Tensor] = None,
                    pixel_samples: Optional[torch.Tensor] = None,
                    stage_counts: Optional[torch.Tensor] = None):
    """Run the fused slice loop. grid_v (A, Nr, Nc) volume in traversal
    layout (f32, bf16, u8 or u16; any strides); rgba_tab (K, 4) merged
    nodal table; scalars (N_SCALARS,) in the S_* layout; pg (Wi,), qg
    (Hi,) fan coordinates; k0 (n_slices,) slab indices; mode 0/1/2 =
    none/diffuse/shadow; lgrid (La, Lr, Lc) traversal-ordered shadow
    lattice + k0l (n_slices,) for mode 2; lights (L, 4) the extra lights
    that modes 1/2 shade with, its first n_dir rows directional (fan-axis
    direction d_w1, d_w2, d_axis and the folded intensity), the rest
    point lights (fan-axis position p_w1, p_w2, p_axis and the folded
    intensity), any number of each; majorant_v (MA, MR, MC) macrocell
    majorants in grid_v's layout (enables skipping); term enables early
    termination; fd selects the finite-difference gradient (modes 1/2);
    bf16 rounds the resampling operands as the JAX kernel's bf16 variant
    does (module note); axial_flip walks grid_v (and majorant_v) from
    plane A-1 down; exit_map (Hi, Wi) f32, each fan ray's exit from the
    volume in ray-parameter units where something nearer than the clip
    box's far side stops it (a surface; 3.4e38 elsewhere): the ray's
    interval becomes [l_in, max(min(box exit, exit_map), l_in)], read
    once per pixel before the plane loop (None: the clip box alone).
    `block_planes`, if given, is an int32 tensor of one entry per block
    (row-major over a ceil(Hi/BLOCK_ROWS) x ceil(Wi/BLOCK_COLS) grid)
    that receives the number of planes each block composited.
    `pixel_samples`, if given, is an int32 (Hi, Wi) tensor that receives
    per pixel the samples the function needs: those at which the pixel's
    T > T_EPS and its opacity is not zero, and in modes >= 1 also the
    previous computed plane before each such one (its sample feeds the
    axial difference). Skipping and termination leave it unchanged.
    `stage_counts` (CUDA tensors only), if given, is an int32 (2,) tensor
    that receives the planes the kernel's blocks sampled from staged slab
    windows and from the grid directly. Given either, the kernel runs its
    counting variant; the timed launch carries no counter.

    Returns (8, Hi, Wi) f32. CUDA tensors run the kernel (or raise);
    CPU tensors run `slice_composite_plain`.

    Differentiable in grid_v (floating point), rgba_tab, scalars, pg, qg,
    lgrid, lights and exit_map: when grad is enabled and any of them
    requires it, the forward runs with termination off (`term` is
    ignored; skipping stays on) and keeps only the inputs and the final
    transmittance; the backward is the bounded-memory analytic adjoint
    (`ops.adjoint`), which recomputes each plane in reverse through
    `plane_step`. Under
    `bf16` the recompute rounds as the JAX package's backward does (its
    XLA slice loop's rounding, on the grid as given)."""
    _check(grid_v, rgba_tab, scalars, pg, qg, k0, n_slices, mode, lgrid,
           k0l, lights, n_dir)
    if exit_map is not None and tuple(exit_map.shape) != (qg.shape[0],
                                                          pg.shape[0]):
        raise ValueError("exit_map must be (Hi, Wi)")
    opts = dict(n_slices=n_slices, mode=mode, n_dir=n_dir, fd=fd, bf16=bf16,
                axial_flip=axial_flip, block_planes=block_planes,
                pixel_samples=pixel_samples, stage_counts=stage_counts)
    diff = (grid_v, rgba_tab, scalars, pg, qg, lgrid, lights, exit_map)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in diff):
        return _SliceComposite.apply(*diff, k0, k0l, majorant_v, opts)
    return _run(grid_v, rgba_tab, scalars, pg, qg, k0, lgrid=lgrid, k0l=k0l,
                lights=lights, majorant_v=majorant_v, term=term,
                exit_map=exit_map, **opts)


def _run(grid_v, rgba_tab, scalars, pg, qg, k0, *, n_slices, stage_counts,
         **kw):
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if grid_v.is_cuda:
        return _slice_composite_cuda(grid_v, rgba_tab, scalars, pg, qg, k0,
                                     n_slices, stage_counts=stage_counts,
                                     **kw)
    if stage_counts is not None:
        raise ValueError("stage_counts describes a kernel launch; CPU "
                         "tensors run the plain version")
    return slice_composite_plain(grid_v, rgba_tab, scalars, pg, qg, k0,
                                 n_slices, **kw)


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
            p, i, i,  # lights, rows, directional rows
            p, i, i, i, i,  # majorants, dims, flip
            p,  # exit map
            i, i, i, i,  # mode, fd, bf16, term
            p, p, p, p, p]  # out, the three counts, stream
        f.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ovr_swslice_occupancy.argtypes = ([p, ll, ll, ll] + [i] * 9
                                              + [ip] * 3)
        lib.ovr_swslice_occupancy.restype = ctypes.c_int
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


def kernel_occupancy(grid_v, mode: int, fd: bool, n_tab: int,
                     n_slices: int, axial_flip: bool = False,
                     bf16: bool = False, n_lights: int = 0) -> dict:
    """What the kernel variant and launch configuration that
    `slice_composite` runs for these arguments (without counts) take on
    the current card,
    as the CUDA runtime reports it: `threads` per block, `smem_bytes` of
    dynamic shared memory and `blocks_per_sm`
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    from ovr_tpu_torch.ops import cuda_build
    lib = cuda_build.load("swslice").lib
    _bind(lib)
    grid_v = _streamed(grid_v, bf16)
    base, sa, sr, scs = _grid_layout(grid_v, axial_flip)
    vals = [ctypes.c_int() for _ in range(3)]
    err = lib.ovr_swslice_occupancy(
        base, sa, sr, scs, grid_v.shape[1], grid_v.shape[2],
        _DTYPE_CODE[grid_v.dtype], mode, int(fd), int(bf16), n_lights,
        n_tab, n_slices, *map(ctypes.byref, vals))
    if err:
        raise RuntimeError("swslice occupancy query failed: "
                           + lib.ovr_swslice_error_string(err).decode())
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def _grid_layout(grid_v, axial_flip):
    """The kernel's view of grid_v: the address of traversal slab 0 and
    element strides (a negative axial stride walks it backward)."""
    sa, sr, scs = grid_v.stride()
    base = grid_v.data_ptr()
    if axial_flip:
        base += (grid_v.shape[0] - 1) * sa * grid_v.element_size()
        sa = -sa
    return base, sa, sr, scs


def _check_int32(name, t, n):
    if t is not None and (t.dtype != torch.int32 or t.numel() != n
                          or not t.is_contiguous()):
        raise ValueError(f"{name} must be {n} contiguous int32")


def _slice_composite_cuda(grid_v, rgba_tab, scalars, pg, qg, k0, n_slices,
                          *, mode, lgrid, k0l, lights, n_dir, majorant_v,
                          term, fd, bf16, axial_flip, exit_map, block_planes,
                          pixel_samples, stage_counts):
    global LAUNCHES, LAUNCHES_BF16
    from ovr_tpu_torch.ops import cuda_build

    dev = grid_v.device
    for t in (rgba_tab, scalars, pg, qg, k0, lgrid, k0l, lights, majorant_v,
              exit_map, block_planes, pixel_samples, stage_counts):
        if t is not None and t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    if rgba_tab.shape[0] > MAX_TAB:
        raise ValueError(f"rgba_tab has more than {MAX_TAB} rows")
    launch = _bind(cuda_build.load("swslice").lib)
    grid_v = _streamed(grid_v, bf16)
    n_a, n_r, n_c = grid_v.shape
    hi, wi = qg.shape[0], pg.shape[0]
    pgf = pg.to(torch.float32).contiguous()
    qgf = qg.to(torch.float32).contiguous()
    sc = _prepared_scalars(scalars, grid_v.dtype, pgf, qgf).contiguous()
    tab = rgba_tab.to(torch.float32).contiguous()
    k0i = k0.to(torch.int32).contiguous()
    base, sa, sr, scs = _grid_layout(grid_v, axial_flip)
    if mode == 2:
        lg = lgrid.to(torch.float32).contiguous()
        k0li = k0l.to(torch.int32).contiguous()
        (la, lr, lc), lg_p, k0l_p = lg.shape, lg.data_ptr(), k0li.data_ptr()
    else:
        la = lr = lc = 0
        lg_p = k0l_p = None
    if lights is not None and mode >= 1 and lights.shape[0] > 0:
        lt = lights.to(torch.float32).contiguous()
        n_lt, lt_p = lt.shape[0], lt.data_ptr()
    else:
        n_lt, lt_p, n_dir = 0, None, 0
    if majorant_v is not None:
        maj = majorant_v.to(torch.float32).contiguous()
        (ma, mr, mcn), maj_p = maj.shape, maj.data_ptr()
    else:
        ma = mr = mcn = 0
        maj_p = None
    ex = (None if exit_map is None
          else exit_map.to(torch.float32).contiguous())
    _check_int32("block_planes", block_planes,
                 math.ceil(hi / BLOCK_ROWS) * math.ceil(wi / BLOCK_COLS))
    _check_int32("pixel_samples", pixel_samples, hi * wi)
    _check_int32("stage_counts", stage_counts, 2)
    if stage_counts is not None:
        stage_counts.zero_()  # the kernel's blocks add into it
    out = torch.empty((8, hi, wi), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            base, sa, sr, scs, n_a, n_r, n_c, _DTYPE_CODE[grid_v.dtype],
            tab.data_ptr(), tab.shape[0], sc.data_ptr(),
            pgf.data_ptr(), wi, qgf.data_ptr(), hi,
            k0i.data_ptr(), n_slices,
            lg_p, k0l_p, la, lr, lc,
            lt_p, n_lt, n_dir,
            maj_p, ma, mr, mcn, int(axial_flip),
            None if ex is None else ex.data_ptr(),
            mode, int(fd), int(bf16), int(term),
            out.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (block_planes, pixel_samples, stage_counts)),
            stream)
    if err:
        lib = cuda_build.load("swslice").lib
        raise RuntimeError("swslice kernel launch failed: "
                           + lib.ovr_swslice_error_string(err).decode())
    LAUNCHES += 1
    LAUNCHES_BF16 += int(bf16)
    return out


class _SliceComposite(torch.autograd.Function):
    """The slice loop with the analytic adjoint as its backward (the
    counterpart of `ovr_tpu.render.shearwarp`'s `_fused_none` and
    `_shaded_loop` custom VJPs)."""

    @staticmethod
    def forward(ctx, grid_v, rgba_tab, scalars, pg, qg, lgrid, lights,
                exit_map, k0, k0l, majorant_v, opts):
        # termination off: the adjoint rebuilds T_k from the final
        # transmittance by dividing out each plane's (1 - a_k), so a
        # truncated forward would corrupt every rebuilt T. Skipping is
        # exact (skipped planes have zero opacity) and stays on.
        out = _run(grid_v, rgba_tab, scalars, pg, qg, k0, lgrid=lgrid,
                   k0l=k0l, lights=lights, majorant_v=majorant_v,
                   term=False, exit_map=exit_map, **opts)
        ctx.opts = {k: opts[k] for k in ("n_slices", "mode", "n_dir", "fd",
                                         "bf16", "axial_flip")}
        ctx.save_for_backward(grid_v, rgba_tab, scalars, pg, qg, lgrid,
                              lights, exit_map, k0, k0l, 1.0 - out[7])
        return out

    @staticmethod
    def backward(ctx, cot):
        *ins, k0, k0l, t_final = ctx.saved_tensors
        grads = _adjoint(*(None if t is None else t.detach() for t in ins),
                         k0, k0l, t_final, cot, **ctx.opts)
        out = [None if g is None else g.to(t.dtype)
               for g, t in zip(grads, ins)]
        return (*out, None, None, None, None)


def _adjoint(grid_v, rgba_tab, scalars, pg, qg, lgrid, lights, exit_map,
             k0, k0l, t_final, cot, *, n_slices, mode, n_dir, fd, bf16,
             axial_flip):
    """Cotangents of (grid_v, rgba_tab, scalars, pg, qg, lgrid, lights,
    exit_map) for the output cotangent `cot` (8, Hi, Wi): the adjoint
    sweep over the planes of `_plane_params`, then the chain through
    `_setup` back to the scalars, the fan coordinates and the exit map
    (the planes are recomputed with the clamped interval, as the JAX
    package's backward recomputes them).

    Under `bf16` the planes are recomputed as the JAX package's backward
    recomputes them (`_plane_fields`, `_shade_fields` and the unshaded
    step `f` with `sw.bf16`): the resampling operands rounded from the
    grid as given (not `_streamed`), the storage scale on the plane, and
    the classifier's weights and table rounded too (`_classify_impl`)."""
    f32 = torch.float32
    fd_on = mode >= 1 and fd
    leaves = [t.requires_grad_(True) for t in (scalars, pg, qg)
              + ((exit_map,) if exit_map is not None else ())]
    with torch.enable_grad():
        geo, ortho = _setup(leaves[0], grid_v.dtype, leaves[1], leaves[2],
                            n_slices, mode, fd_on,
                            leaves[3] if exit_map is not None else None)
    del geo["exit"]
    params = dict(geo, grid=grid_v, tab=rgba_tab.to(f32),
                  kz=[min(_slabs(grid_v, k, axial_flip))
                      for k in k0.tolist()])
    if mode == 2:
        params.update(lgrid=lgrid.to(f32), k0l=k0l.tolist())
    if mode >= 1 and lights is not None:
        params["lights"] = lights.to(f32)
    step = _plane_params(grid_v, mode=mode, fd_on=fd_on, ortho=ortho,
                         n_dir=n_dir, axial_flip=axial_flip,
                         rounding="xla" if bf16 else None)
    if mode == 0:
        # as the JAX package's unshaded backward (the VJP of over_scan):
        # T_final from the recomputed composite, since 1 - alpha in f32
        # keeps nothing of a transmittance below 6e-8
        with torch.no_grad():
            t_final = over_scan(step, n_slices, params)[1]
    g = adjoint_sweep(step, n_slices, params, t_final, cot[0:7], -cot[7])
    pairs = [(geo[k], g[k]) for k in geo
             if g[k] is not None and geo[k].requires_grad]
    d_sc, d_pg, d_qg, *d_exit = torch.autograd.grad(
        [t for t, _ in pairs], leaves, [c for _, c in pairs],
        allow_unused=True)
    return (g["grid"], g["tab"], d_sc, d_pg, d_qg, g.get("lgrid"),
            g.get("lights"), d_exit[0] if d_exit else None)


def _plane_params(grid_v, *, mode, fd_on, ortho, n_dir, axial_flip,
                  rounding):
    """The adjoint's step: plane k of the loop as (v (7, Hi, Wi), a) from
    the params dict of `_adjoint` (or its slab windows). Modes >= 1
    recompute plane k-1's sample for the axial difference, as the JAX
    package's `_shaded_step` does.

    Every plane is recomputed, the ones the forward skipped too, as the
    JAX package's backward does: their opacity is at most the majorant
    threshold (MAJ_EPS), so the rebuilt transmittance is that of the
    forward, and the gradient does not depend on skip decisions (a TF
    node of zero opacity has a gradient from every sample that reads it,
    skipped or not)."""
    f32 = torch.float32

    def step(p, k):
        S = p["sc"].unbind()

        def slabs(i):
            kz = p["kz"][i]
            lo, up = p["grid"][kz].to(f32), p["grid"][kz + 1].to(f32)
            return (up, lo) if axial_flip else (lo, up)

        prev = lattice = None
        if mode >= 1:
            km = max(k - 1, 0)
            prev, _ = _resample(*slabs(km), p["fz"][km], p["lam"][km], S,
                                p["pg"], p["q_smp"], ortho, rounding)
            prev = prev[1:-1] if fd_on else prev
        if mode == 2:
            lg, ka = p["lgrid"], p["k0l"][k]
            lattice = (lg[ka], lg[min(ka + 1, lg.shape[0] - 1)])
        has_prev = torch.full(p["lin"].shape, k > 0, dtype=torch.bool,
                              device=p["lin"].device)
        vals, a, _ = plane_step(*slabs(k), k, p["tab"], S, p, mode=mode,
                                fd_on=fd_on, ortho=ortho,
                                lights=p.get("lights"), n_dir=n_dir,
                                prev=prev, has_prev=has_prev,
                                lattice=lattice, rounding=rounding)
        return torch.stack(vals), a

    return step


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


def _setup(scalars, grid_dtype, pg, qg, n_slices: int, mode: int,
           fd_on: bool, exit_map=None):
    """The slice loop's plane-independent quantities, differentiable in
    (scalars, pg, qg, exit_map): the prepared scalars "sc", the fan
    coordinates "pg" and "qg" (f32) and the rows "q_smp" that are sampled
    (with one halo row at each end for the FD gradient), each fan pixel's
    interval "lin"/"lout" (the clip box's, its exit clamped by
    `exit_map` as JAX's `render_shearwarp` clamps `l_out`) and its exit
    "exit" (the termination test's), its "speed" (|d| per unit
    of the ray parameter), and per plane the ray parameter "lam", the
    axial texel fraction "fz", the axial world coordinate "zabs" and, in
    mode 2, the lattice's "fzl".
    Returns (that dict, ortho)."""
    f32 = torch.float32
    dev = pg.device
    hi, wi = qg.shape[0], pg.shape[0]
    pg = pg.to(f32)
    qg = qg.to(f32)
    sc = _prepared_scalars(scalars, grid_dtype, pg, qg)
    S = sc.unbind()
    ortho = bool(S[S_ORTHO] > 0.5)

    # per-pixel geometry: clip-box interval and speed
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
    if exit_map is not None:
        # JAX's order of min and max: the same values as the kernel's
        # max(min(exit, exit_map), l_in), and its cotangents at ties
        ex = exit_map.to(f32)
        l_out = torch.maximum(torch.minimum(l_out, ex), l_in)
        exit_t = torch.minimum(exit_t, ex)
    speed = ones if ortho else torch.sqrt(p2 * p2 + q2 * q2 + 1.0)

    # the plane schedule
    jf = torch.arange(n_slices, dtype=f32, device=dev)
    z_rel = (jf + S[S_OFF]) * S[S_DZ]
    c = torch.clamp((z_rel - S[S_SMP0]) * S[S_SMPSC] - 0.5, min=0.0)
    c = torch.minimum(c, S[S_NA] - 1.0)
    kf = torch.minimum(torch.clamp(torch.floor(c), min=0.0), S[S_NA] - 2.0)
    geo = dict(sc=sc, pg=pg, qg=qg, lin=l_in, lout=l_out, exit=exit_t,
               speed=speed, lam=z_rel * S[S_DLAM] + S[S_LAM0], fz=c - kf,
               zabs=S[S_ZA0] + S[S_ZSG] * z_rel)
    if mode == 2:
        cl = torch.clamp(z_rel / S[S_EXA] * S[S_NLA] - 0.5, min=0.0)
        cl = torch.minimum(cl, S[S_NLA] - 1.0)
        kl = torch.minimum(torch.clamp(torch.floor(cl), min=0.0),
                           S[S_NLA] - 2.0)
        geo["fzl"] = cl - kl
    if fd_on:
        rows = torch.arange(-1, hi + 1, dtype=f32, device=dev)
        geo["q_smp"] = S[S_QLO] + rows * S[S_DQ]
    else:
        geo["q_smp"] = qg
    return geo, ortho


def bf16_round(x):
    """x rounded to bfloat16 (to nearest, ties to even), kept in f32. Its
    gradient is rounded so too, as the VJP of JAX's `astype` is."""
    return x.to(torch.bfloat16).to(torch.float32)


def _lerp_fma(a, b, f):
    """a * (1 - f) + b * f as one fused multiply-add, fma(a, 1 - f, b * f),
    the form the JAX package's loops take on the CPU (XLA contracts the
    z-lerp so). With bf16 operands after it this matters: bf16-valued
    voxels lerped at f = 1/4 or 3/4 often land on a bf16 rounding tie,
    which the last bit of the lerp decides. A product of two f32 is
    exact in f64, so this is the fma's result wherever the f64 sum is
    exact too (for bf16-valued voxels, unless its terms lie more than
    2^21 apart) and elsewhere unless that sum's rounding lands on an f32
    rounding tie (about one sum in 2^29)."""
    f64 = torch.float64
    return (a.to(f64) * (1.0 - f).to(f64) + (b * f).to(f64)).to(torch.float32)


def _resample(g0, g1, fz, lam, S, pg, q_smp, ortho, rounding=None):
    """Slabs g0, g1 (Nr, Nc) z-lerped at fz and resampled bilinearly at
    the fan rows q_smp and columns pg of plane lam. Returns the sample
    field and the parts the analytic gradient reads: (smp, (t0, t1, v00,
    v01, v10, v11, fr (rows,), fc (1, Wi), wc0, wc1, wgs)): the
    row-resampled values, the four taps, the fractions, the column
    weights and the storage scale of the derivative weights. The taps
    are gathered a row index, then a column index at a time, so their
    backward is two index_adds, not a sort-based index_put.

    `rounding` None is f32 throughout. "kernel" rounds to bf16 what the
    JAX kernel's bf16 variant rounds (module note): the plane, the row
    weights with the storage scale folded in, the row results and the
    column weights; products of rounded values are exact in f32, so each
    sum of two rounds once, as the matmul's f32 accumulation does.
    "xla" rounds as the JAX package's XLA slice loop does under
    `sw_bf16` (`_plane_fields`): the storage scale on the plane, the row
    weights without it. Both form the z-lerp as one fma (`_lerp_fma`)."""
    n_r, n_c = g0.shape
    if rounding is None:
        plane = g0 * (1.0 - fz) + g1 * fz
    else:
        plane = _lerp_fma(g0, g1, fz)
    ir0, ir1, fr = _taps(_vr_of(S, q_smp, lam, n_r, ortho), n_r)
    ic0, ic1, fc = _taps(_vc_of(S, pg, lam, n_c, ortho), n_c)
    gs = S[S_GS]
    fcr = fc[None, :]
    if rounding is None:
        wr0 = ((1.0 - fr) * gs)[:, None]
        wr1 = (fr * gs)[:, None]
        wc0, wc1, wgs = 1.0 - fcr, fcr, gs
    elif rounding == "kernel":
        plane = bf16_round(plane)
        wr0 = bf16_round((1.0 - fr) * gs)[:, None]
        wr1 = bf16_round(fr * gs)[:, None]
        wc0, wc1, wgs = bf16_round(1.0 - fcr), bf16_round(fcr), bf16_round(gs)
    else:
        plane = bf16_round(plane * gs)
        wr0 = bf16_round(1.0 - fr)[:, None]
        wr1 = bf16_round(fr)[:, None]
        wc0, wc1, wgs = bf16_round(1.0 - fcr), bf16_round(fcr), 1.0
    p0, p1 = plane.index_select(0, ir0), plane.index_select(0, ir1)
    v00, v01 = p0.index_select(1, ic0), p0.index_select(1, ic1)
    v10, v11 = p1.index_select(1, ic0), p1.index_select(1, ic1)
    t0 = v00 * wr0 + v10 * wr1
    t1 = v01 * wr0 + v11 * wr1
    if rounding is None:
        smp = t0 * (1.0 - fcr) + t1 * fcr
    else:
        t0, t1 = bf16_round(t0), bf16_round(t1)
        smp = t0 * wc0 + t1 * wc1
    return smp, (t0, t1, v00, v01, v10, v11, fr, fcr, wc0, wc1, wgs)


class _Classify(torch.autograd.Function):
    """Two-tap nodal TF lookup, smp (Hi, Wi) -> rgba (Hi, Wi, 4), with the
    cotangents of `ovr_tpu.render.shearwarp._classify_dense`: the table's
    is the per-pixel weighted histogram; the sample's and the value
    range's are zero where the normalized value is at or outside [0, 1],
    where the node coordinate is at 0 or K-1, and exactly on a node.
    `rounded` rounds the two weights and the table to bf16 in the
    forward, as `_classify_impl` does under `sw_bf16`; the cotangents
    stay f32, as that custom VJP's do."""

    @staticmethod
    def forward(ctx, smp, tab, vlo, vscale, rounded):
        rgba, (v_raw, cc, f, i0, i1) = _classify_taps(smp, tab, vlo, vscale,
                                                      rounded)
        live = ((cc > 0.0) & (cc < tab.shape[0] - 1.0) & (v_raw > 0.0)
                & (v_raw < 1.0) & (f[..., 0] > 0.0))
        ctx.save_for_backward(smp, tab, vlo, vscale, f, i0, i1, live)
        return rgba

    @staticmethod
    def backward(ctx, cot):
        smp, tab, vlo, vscale, f, i0, i1, live = ctx.saved_tensors
        n_tab = tab.shape[0]
        d_tab = None
        if ctx.needs_input_grad[1]:
            # one histogram per fan row, then their sum: a table of a few
            # nodes takes atomics from every pixel of a row, not the fan
            hist = cot.new_zeros((cot.shape[0], n_tab, 4))
            hist.scatter_add_(1, i0[..., None].expand_as(cot),
                              cot * (1.0 - f))
            hist.scatter_add_(1, i1[..., None].expand_as(cot), cot * f)
            d_tab = hist.sum(0)
        step = _rows(torch.diff(tab, dim=0, append=tab[-1:]), i0)
        d_v = torch.where(live, torch.sum(cot * step, dim=-1) * (n_tab - 1),
                          0.0)
        return (d_v * vscale, d_tab, -torch.sum(d_v) * vscale,
                torch.sum(d_v * (smp - vlo)), None)


def _rows(table, idx):
    """table[idx] for a 2D table and an index tensor of any shape."""
    return table.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, table.shape[1])


def _classify_taps(smp, tab, vlo, vscale, rounded=False):
    """The lookup's result and its (v_raw, node coordinate, weight of
    the upper node (..., 1), lower and upper node indices)."""
    n_tab = tab.shape[0]
    v_raw = (smp - vlo) * vscale
    cc = torch.clamp(v_raw, 0.0, 1.0) * (n_tab - 1)
    i0f = torch.clamp(torch.floor(cc), 0.0, n_tab - 1.0)
    f = (cc - i0f)[..., None]
    i0 = i0f.long()
    i1 = torch.clamp(i0 + 1, max=n_tab - 1)
    taps = (v_raw, cc, f, i0, i1)
    if rounded:
        tab = bf16_round(tab)
        return (_rows(tab, i0) * bf16_round(1.0 - f)
                + _rows(tab, i1) * bf16_round(f)), taps
    return _rows(tab, i0) * (1.0 - f) + _rows(tab, i1) * f, taps


def plane_step(g0, g1, j, tab, S, geo, *, mode: int, fd_on: bool,
               ortho: bool, lights=None, n_dir: int = 0, prev=None,
               has_prev=None, lattice=None, rounding=None):
    """One plane of the slice loop: slabs g0, g1 (Nr, Nc) f32 (z-lerped
    at geo["fz"][j]), the merged table `tab`, the scalars S (unbound) and
    `_setup`'s dict `geo`. Modes >= 1 take `prev`, the previous plane's
    sample field, and the bool (Hi, Wi) `has_prev`, where it exists (the
    axial difference is 0 elsewhere), and shade with the light table
    `lights` (L, 4) (first `n_dir` rows directional, the rest point
    lights; `slice_composite`); mode 2 takes `lattice` = (lattice slab
    k0l[j], slab k0l[j]+1), lerped at geo["fzl"][j]. `rounding`: None,
    "kernel" or "xla" (`_resample`; "xla" also rounds the classifier).

    Returns (vals, a, smp): the seven values [r, g, b, nx, ny, nz, depth]
    (Hi, Wi) each, the opacity (Hi, Wi) (mode 0 leaves its cap at
    1 - 1e-6 to the compositing) and the sample field. Each clamp that
    the JAX package's gradient passes through as `jnp.clip` is `clip`
    here, so the cotangents match it where values sit on a bound."""
    lam = geo["lam"][j]
    pg, qg, speed = geo["pg"], geo["qg"], geo["speed"]
    wi = pg.shape[0]
    smp_e, (t0, t1, v00, v01, v10, v11, fr, fcr, wc0, wc1, wgs) = _resample(
        g0, g1, geo["fz"][j], lam, S, pg, geo["q_smp"], ortho, rounding)
    smp = smp_e[1:-1] if fd_on else smp_e

    rgba = _Classify.apply(smp, tab, S[S_VLO], S[S_VSCALE],
                           rounding == "xla")
    if mode >= 1:
        # the JAX package shades the unclipped colour: a colour within
        # [0, 1] passes this clamp with its whole cotangent
        rgb = torch.clamp(rgba[..., :3], 0.0, 1.0)
    else:
        rgb = clip(rgba[..., :3], 0.0, 1.0)
    a_raw = rgba[..., 3]

    # opacity correction over the exact plane/ray overlap
    seg_lo = torch.maximum(lam - S[S_HALF], geo["lin"])
    seg_hi = torch.minimum(lam + S[S_HALF], geo["lout"])
    dt_w = torch.clamp(seg_hi - seg_lo, min=0.0) * speed
    kk = S[S_BASE] * dt_w
    a_c = clip(a_raw, 0.0, 1.0 - 1e-7)
    a = clip(1.0 - torch.exp(kk * torch.log1p(-a_c)), 0.0, 1.0)
    a = torch.where(torch.abs(kk - 1.0) < 1e-7, clip(a_raw, 0.0, 1.0), a)
    a = torch.where(dt_w > 0.0, a, 0.0)

    vals = [rgb[..., 0], rgb[..., 1], rgb[..., 2]]
    if mode >= 1:
        a = torch.minimum(a, a.new_full((), 1.0 - 1e-6))
        n_r, n_c = g0.shape
        lamf = 1.0 if ortho else lam
        if fd_on:
            col = torch.arange(wi, device=smp.device)[None, :]
            fwd = torch.roll(smp, -1, 1) - smp
            bwd = smp - torch.roll(smp, 1, 1)
            g1 = torch.where(col == 0, fwd, torch.where(
                col >= wi - 1, bwd, 0.5 * (fwd + bwd))) / (S[S_DP] * lamf)
            g2 = (smp_e[2:] - smp_e[:-2]) * (0.5 / (S[S_DQ] * lamf))
        elif rounding is None:
            gs = S[S_GS]
            g1 = torch.where(fcr > 0, t1 - t0, 0.0) * (n_c / S[S_EX1])
            d0 = (v10 - v00) * gs
            d1 = (v11 - v01) * gs
            g2 = torch.where(fr[:, None] > 0, d0 * (1.0 - fcr) + d1 * fcr,
                             0.0) * (n_r / S[S_EX2])
        else:
            # the derivative weights are -/+ the (rounded) storage scale
            # on the two taps: one rounding of the exact difference
            g1 = torch.where(fcr > 0, t1 - t0, 0.0) * (n_c / S[S_EX1])
            d0 = bf16_round(v10 * wgs - v00 * wgs)
            d1 = bf16_round(v11 * wgs - v01 * wgs)
            g2 = torch.where(fr[:, None] > 0, d0 * wc0 + d1 * wc1,
                             0.0) * (n_r / S[S_EX2])
        ds = torch.where(has_prev, (smp - prev) / S[S_DZDLAM], 0.0)
        k1 = S[S_K1O] if ortho else pg[None, :]
        k2 = S[S_K2O] if ortho else qg[:, None]
        ga = (ds - g1 * k1 - g2 * k2) * S[S_INVDA]
        n1, n2, na = -g1, -g2, -ga
        inv = torch.rsqrt(n1 * n1 + n2 * n2 + na * na + 1e-12)
        total = torch.abs(S[S_LD1] * n1 + S[S_LD2] * n2
                          + S[S_LDA] * na) * inv
        if lights is not None and lights.shape[0]:
            total = _add_lights(total, lights, n_dir, S, pg, qg, lam,
                                geo["zabs"][j], n1, n2, na, inv, ortho)
        if mode == 2:
            total = total * (1.0 - clip(
                _shadow(lattice, geo["fzl"][j], S, pg, geo["q_smp"], lam,
                        fd_on, ortho, rounding), 0.0, 1.0))
        shade = 0.5 + total
        vals = [clip(x * shade, 0.0, 1.0) for x in vals]
        nu = (n1 * inv, n2 * inv, na * inv)
        for r in range(3):
            w = S[S_W00 + 3 * r:S_W00 + 3 * r + 3]
            vals.append(clip(w[0] * nu[0] + w[1] * nu[1] + w[2] * nu[2],
                             0.0, 1.0))
    else:
        vals += [torch.zeros_like(a)] * 3
    vals.append(lam * speed)
    return vals, a, smp


def _add_lights(total, lights, n_dir, S, pg, qg, lam, zabs, n1, n2, na, inv,
                ortho):
    """`total` plus each extra light's term of the shade, added in table
    order (`ovr_tpu.render.shearwarp._shade_fields`): a directional light
    adds 0.5 |d.n| I, a point light at p adds 0.5 |(p - x).n| I / |p - x|^3
    (inverse-square falloff), x the sample's world position on the plane
    (the fan row's q, not the FD lattice's)."""
    x1 = (pg + S[S_DW1] * lam if ortho else S[S_EW1] + pg * lam)[None, :]
    x2 = (qg + S[S_DW2] * lam if ortho else S[S_EW2] + qg * lam)[:, None]
    for i, (e0, e1, e2, e3) in enumerate(lt.unbind() for lt in lights):
        if i < n_dir:
            ce = torch.abs(e0 * n1 + e1 * n2 + e2 * na) * inv
            total = total + 0.5 * ce * e3
            continue
        d1p, d2p, dap = e0 - x1, e1 - x2, e2 - zabs
        r2 = d1p * d1p + d2p * d2p + dap * dap
        cos_p = (torch.abs(d1p * n1 + d2p * n2 + dap * na) * inv
                 * torch.rsqrt(torch.clamp(r2, min=1e-12)))
        total = total + 0.5 * (cos_p / torch.clamp(r2, min=1e-6)) * e3
    return total


def _shadow(lattice, fzl, S, pg, q_smp, lam, fd_on, ortho, rounding=None):
    """The shadow lattice's alpha at the fan pixels of plane lam. With
    `rounding` the lerped lattice plane, both weights and the row
    results are rounded to bf16, as both JAX loops round them (the
    plane lerped as one fma, `_lerp_fma`)."""
    l0, l1 = lattice
    l_r, l_c = l0.shape
    lp = (l0 * (1.0 - fzl) + l1 * fzl if rounding is None
          else _lerp_fma(l0, l1, fzl))
    x1 = pg + S[S_DW1] * lam if ortho else S[S_EW1] + pg * lam
    x2 = q_smp + S[S_DW2] * lam if ortho else S[S_EW2] + q_smp * lam
    x2c = x2[1:-1] if fd_on else x2
    lvr = torch.clamp((x2c - S[S_GLO2]) / S[S_GEX2] * l_r - 0.5, 0.0,
                      l_r - 1.0)
    lvc = torch.clamp((x1 - S[S_GLO1]) / S[S_GEX1] * l_c - 0.5, 0.0,
                      l_c - 1.0)
    lr0, lr1, lfr = _taps(lvr, l_r)
    lc0, lc1, lfc = _taps(lvc, l_c)
    lfr = lfr[:, None]
    lfc = lfc[None, :]
    if rounding is None:
        p0, p1 = lp.index_select(0, lr0), lp.index_select(0, lr1)
        return ((p0.index_select(1, lc0) * (1.0 - lfr)
                 + p1.index_select(1, lc0) * lfr) * (1.0 - lfc)
                + (p0.index_select(1, lc1) * (1.0 - lfr)
                   + p1.index_select(1, lc1) * lfr) * lfc)
    lp = bf16_round(lp)
    wr0, wr1 = bf16_round(1.0 - lfr), bf16_round(lfr)
    wc0, wc1 = bf16_round(1.0 - lfc), bf16_round(lfc)
    p0, p1 = lp.index_select(0, lr0), lp.index_select(0, lr1)
    lt0, lt1 = (bf16_round(p0.index_select(1, c) * wr0
                           + p1.index_select(1, c) * wr1) for c in (lc0, lc1))
    return lt0 * wc0 + lt1 * wc1


def _slabs(grid_v, k: int, axial_flip: bool):
    """Storage indices of the slab pair (k, k+1) of the traversal."""
    n_a = grid_v.shape[0]
    return (n_a - 1 - k, n_a - 2 - k) if axial_flip else (k, k + 1)


def slice_composite_plain(grid_v, rgba_tab, scalars, pg, qg, k0,
                          n_slices: int, *, mode: int = 0, lgrid=None,
                          k0l=None, lights=None, n_dir: int = 0,
                          majorant_v=None, term: bool = True, fd: bool = True,
                          bf16: bool = False, axial_flip: bool = False,
                          exit_map=None, block_planes=None,
                          pixel_samples=None):
    """The fused slice loop in PyTorch, arithmetic in the kernel's order
    and per-block skipping/termination as the kernel does them. Same
    arguments and result as `slice_composite` (without `stage_counts`)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    f32 = torch.float32
    grid_v = _streamed(grid_v, bf16)
    if mode == 0 or lights is None:
        lights = None
    else:
        lights = lights.to(f32)
    dev = grid_v.device
    n_a, n_r, n_c = grid_v.shape
    hi, wi = qg.shape[0], pg.shape[0]
    nbr, nbc = -(-hi // BLOCK_ROWS), -(-wi // BLOCK_COLS)
    fd_on = mode >= 1 and fd
    geo, ortho = _setup(scalars, grid_v.dtype, pg, qg, n_slices, mode,
                        fd_on, exit_map)
    S = geo["sc"].unbind()
    tab = rgba_tab.to(f32)
    exit_t, lam_all = geo["exit"], geo["lam"]
    k0_host = k0.tolist()
    if mode == 2:
        lg = lgrid.to(f32)
        k0l_host = k0l.tolist()

    acc = torch.zeros((7, hi, wi), dtype=f32, device=dev)
    trans = torch.ones((hi, wi), dtype=f32, device=dev)
    prev = torch.zeros((hi, wi), dtype=f32, device=dev)
    jpos = torch.zeros((hi, wi), dtype=torch.int32, device=dev)
    alive = torch.ones((nbr, nbc), dtype=torch.bool, device=dev)
    planes = torch.zeros((nbr, nbc), dtype=torch.int32, device=dev)
    n_need = torch.zeros((hi, wi), dtype=torch.int32, device=dev)
    last_need = torch.zeros((hi, wi), dtype=torch.bool, device=dev)
    maj = None if majorant_v is None else majorant_v.to(f32)

    def raw_active(j):
        return _block_active(maj, S, geo["pg"], geo["qg"], k0_host[j],
                             lam_all[j], n_a, n_r, n_c, fd_on, ortho,
                             axial_flip)

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

        s0, s1 = _slabs(grid_v, k0_host[j], axial_flip)
        lattice = None
        if mode == 2:
            ka = k0l_host[j]
            lattice = (lg[ka], lg[min(ka + 1, lg.shape[0] - 1)])
        vals, a, smp = plane_step(
            grid_v[s0].to(f32), grid_v[s1].to(f32), j, tab, S, geo,
            mode=mode, fd_on=fd_on, ortho=ortho, lights=lights, n_dir=n_dir,
            prev=prev, has_prev=jpos > 0, lattice=lattice,
            rounding="kernel" if bf16 else None)
        a = torch.clamp(a, max=1.0 - 1e-6)
        need = comp & (trans > T_EPS) & (a > 0.0)
        n_need = n_need + need.to(torch.int32)
        if mode >= 1:
            n_need = n_need + (need & (jpos > 0) & ~last_need).to(
                torch.int32)
        last_need = torch.where(comp, need, last_need)

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
    if pixel_samples is not None:
        pixel_samples.copy_(n_need.reshape(pixel_samples.shape))
    return torch.cat([acc, (1.0 - trans)[None]])
