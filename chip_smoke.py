"""Drive the PyTorch + CUDA port (ovr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit);
2. builds csrc/swslice.cu with nvcc, into its timed and its counting
   library at once, and prints, per kernel variant (the f32 function and
   its bf16 variant, each with and without the light table, on slab
   windows or staged runs), the registers and spills ptxas reports;
3. holds the slice kernel against its plain PyTorch version on the card
   for modes 0/1/2, both gradient stencils, skipping and termination on
   and off, f32/bf16/u8/u16 grids, perspective, orthographic and
   principal-x cameras (the last with strided fan columns), at 64^3 and
   256^3 and on the 1024^3 headline volume at 240x135 (the last and a
   256^3 frame at 64x36 with fans so coarse that the tiles' footprints
   exceed the slab windows), with light tables of directional and point
   lights, and in the bf16 variant (f32 grids read as bf16 or, at 60
   rows, as f32; bf16, u8 and u16 grids; staged windows, staged runs and
   direct taps); in each case it also runs the kernel's counting
   variant, which must give the same bits, and holds the planes per
   block and the samples each pixel needs against the plain version's
   counts, and the planes sampled from staged slab windows, straight
   from the grid or from staged runs against the path the case must
   take;
4. renders the headline frame through `api.render`: a 1024^3 bf16 volume
   (bench.py's synthetic field, built on the card), 1920x1080, 1024
   planes, macrocell skipping on, in diffuse, none and shadow shading and
   in diffuse from the principal x axis; the same in diffuse with
   bench.py's BENCH_EXTRA_LIGHTS=6 lights and with two directional lights
   and a point light; then bench.py's BENCH_BF16=1 frame (sw_bf16, the
   kernel's bf16 variant) in the four views; checks each frame, counts
   kernel launches per group (the bf16 variant's apart), and times frames
   and the kernel alone with CUDA events; prints the bf16 frame's
   difference from the f32 frame; prints each kernel variant's threads,
   dynamic shared memory and blocks per SM
   (cudaOccupancyMaxActiveBlocksPerMultiprocessor); then holds the
   kernel against its plain version on each frame's own inputs, cut to a
   band of 64 fan rows with all columns, and times both there; then the
   same field as a 1024^3 u16 grid (round(field * 65535), 2.15 GB) in
   diffuse, none and shadow (the f32 function on 16-bit storage, its
   launches counted apart), timed and held so;
5. takes gradients through `api.render` (the slice kernel forward with
   termination off, the analytic adjoint backward): at 64^3 f32 (bench
   and sparse fields, perspective and orthographic, none/diffuse/shadow,
   sw_bf16, directional and point lights, macrocells on) it holds the
   gradients of the grid and the TF's alpha, colour and value range
   against the same on CPU copies of the inputs, and checks that each
   frame launched the kernel once and never ran the plain version on the
   card; on the headline frame (none, diffuse, shadow, and diffuse under
   sw_bf16) it times bench.py's backward step (mean(rgba^2) +
   mean(grad^2), gradients of the grid and the TF alpha), prints ms per
   step, Mrays/s, peak memory and launches per step, checks the
   gradients and holds the TF alpha's against a central directional
   difference; then splits a reverse sweep (the diffuse frame cut to 16
   planes) into device and host time with torch.profiler;
6. runs the ray march (plain PyTorch; the JAX package's march is XLA):
   (a) at 64^3 (bench and sparse fields; perspective, orthographic and
   a wide-FOV interior eye that method="auto" must send to the march;
   none, diffuse, shadow from the lattice built inside `api.render` and
   from the exact shadow march, ssh; macrocells, adaptive steps, two
   extra directional lights and a point light, jitter_rays from a CPU
   generator seed, optical flow) it holds the card's frames against the
   CPU's, `fast_math` (march_while) against the march bit for bit, and
   the gradients of the grid, the TF and the camera (in float64)
   against the CPU's; (b) renders the headline volume through
   method="march" at 1920x1080, rate 1024 (fast_math, macrocells, as
   bench.py's BENCH_METHOD=march) in diffuse and shadow, and prints
   frame ms, Mrays/s, the steps run, launches and peak memory, with a
   torch.profiler split of the frame cut to 32 steps; (c) holds the
   slice kernel against the march (128x72, rate 256): PSNR >= 35 dB;
   (d) renders the wide-FOV interior eye at 1080p through
   method="auto", which must fall back to the march;
7. loads and path-traces scene files: writes bench.py's field at 1024^3
   as a 1 GiB UNSIGNED_BYTE raw with a VIDI3D JSON and a USDA settings
   file, loads both onto the card through `io.create_scene`, renders
   them through `Renderer` (1080p, auto, diffuse; the slice kernel once
   a frame) bit for bit against a directly built scene, and the same
   for the field as a 2 GiB UNSIGNED_SHORT raw (the grid arrives as
   uint16); holds both path
   tracers card against CPU at 64^3 (MC with the global majorant and the
   macrocell DDA from a CPU generator's draws; the dense solver's
   fields, its gather on the card's own inputs, its frames, also under
   sw_bf16); renders both at the 1024^3 bf16 1080p headline (dense:
   `prepare` and frame ms; MC: frame ms, tracker iterations per level,
   launches an iteration), checks the frames, and holds the dense frame
   against the MC mean by tests/test_pathtracer.py's rule; no
   path-traced frame may launch the slice kernel or run its plain
   version;
8. renders neural-field volumes: at a small hash grid it holds the
   encoding, the field (f32 and bf16), the bakes, proxy frames (none,
   diffuse, shadow: the slice kernel once a frame), the exact field
   march and the train step's gradients on the card against the CPU;
   at full width (12 levels, 2^17 entries, a 24-64-64-1 MLP) it fits the
   field to the 1024^3 volume with `fit_to_grid`, bakes the 512^3 proxy
   (`bake_grid_host`), renders 1080p rate-1024 frames through `Renderer`
   in diffuse and shadow (the main path, its launches counted from 0),
   holds the kernel against its plain version on a band of those
   frames' inputs and times it alone, takes one inverse-rendering step
   at a 128^3 proxy, holds the proxy frame against the exact field
   march (480x270: mean |rgba| < 0.05) and renders the unfitted field;
9. drives the multi-device paths (`ovr_tpu_torch.parallel`), right
   after step 3: (a) holds the slice kernel against its plain version on
   the inputs of bricks (B = 2, 4: a slab's sample box, its ownership
   clip box and its share of the planes; ascending, descending and
   transverse views) and bands (2, 4 row bands, each its own fan) at
   64^3 and 256^3, f32/bf16/u8, modes 0/1/2, the counting variant too;
   (b) over NCCL with one rank, renders the headline frame (1920x1080,
   rate 1024, none/diffuse/shadow) through `tiles.render_sharded` and a
   1 x 1 `bricks.render_bricked`, which must give `api.render`'s bits;
   (c) starts 4 gloo ranks that share the card (this script with
   `--rank`; gloo moves the CUDA tensors through host copies, NCCL
   refuses two ranks on one device), each building its own volume on
   the card (a brick rank only its slab), and renders that frame bricked
   1 x 2 (against the unbricked frame: 1e-3 unshaded, 3e-2 shaded), as
   tiles x bricks 2 x 2 and as tiles 2 x 1 (JAX's banded rule: interior
   p95 < 0.06), each rank printing its launches per frame (one), frame
   and kernel ms (time-shared), the kernel's bound and its peak and
   resident memory, with the kernel held against its plain version on a
   band of one brick's inputs; (d) takes the tiles train step at the
   headline (2 ranks; its loss against its forward frame's, the state
   alike on both ranks) and the tiles step at 64^3 and the bricked step
   at 128^3 on the card and on the same ranks' CPUs (1e-3 of the largest
   element);
10. runs the port's programs (`ovr_tpu_torch.apps`, `.examples`) on the
   card after the neural phase, over bench.py's field as a 1 GiB u8
   1024^3 VIDI3D scene, at 1920x1080, rate 1024, auto, diffuse,
   macrocells on: render_batch's single frame (bit for bit a direct
   Renderer's), --ab (PSNR >= 35 dB), the orbit with --resume (K1 twice;
   needs PIL), --sequence over 4 u8 timesteps of bench.py's
   phase-shifted field (pinned uploads on a side stream: their ms, GB/s
   and overlap with the render against a pageable .to(), every frame bit
   for bit a serial run's), the viewer behind its HTTP server at 512x512
   and 1080p (the frame after POST /set bit for bit a direct Renderer's,
   no render error), both examples card vs CPU, and the timer's fence
   against CUDA events;
11. runs the port's bench program (`ovr_tpu_torch.bench`, bench.py's
   BENCH_* knobs) last: first it issues one headline diffuse frame under
   torch's sync debug mode "error" (no host-device synchronization may
   happen inside a frame); (a) `python3 -m ovr_tpu_torch.bench` with no
   knobs as a subprocess (the 1024^3 bf16 1080p diffuse headline, 3 + 10
   frames), which must print exactly one JSON line with bench.py's four
   keys and metric text, launch K1 once a frame with no plain call, and
   give rays/s within 10% of step 4's diffuse frame timed again just
   before it; (b) every other mode
   once in process at the headline size (none, shadow, bf16, six lights,
   u8, opaque with termination on and off, the eye inside, the march,
   the backward, both path tracers, the neural field forward and its
   train step at a 128^3 proxy, four streamed timesteps, two gloo ranks
   sharing the card as bricks 1 x 2), the slow ones at a cut depth, each
   printing its key, rays/s, frame ms by events and host clock, peak
   memory, K1 launches and path; (c) breaks down K1's work (samples
   needed, planes composited, kernel ms against its bound) on the
   headline's, the eye inside's and the opaque frames' inputs;
12. prints one JSON line each of backward, march, surfaces, scene-file
   and path-tracing, parallel, neural, apps, bench and kernel
   measurements (the kernel line with an entry for the f32 function,
   with a block for 16-bit storage, and one for its bf16 variant), then,
   last, the device line {"ok": true, "device": {...}}. Each phase logs
   "phase <name>: <seconds>" when it ends, and a JSON line before the
   kernel line holds them all.

Steps 6 (a) and 7's path-tracing cases at 64^3 (card against CPU, and
dense against MC) run first, while nvcc builds the kernel (2): they
launch no kernel. The card-against-CPU gradients of 5 and the surface
and multi-volume cases at 64^3 run in this process while the ranks of 9
(c, d) run in theirs. The headline's timed frames and steps that the
bench phase (11) times at the same shape run once in the earlier
phases, for their checks: the backward step per shading, the march
frames, the path-traced frames and the neural train step.

Exits non-zero without a CUDA device, without the repository beside it,
or when any phase fails. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time

# f32 operations per sample that the slice function needs, counted from
# csrc/swslice.cu (add, mul, div, compare/select, min/max, abs, floor and
# each of expf/log1pf/rsqrtf count one; a clamp two). Work shared by a
# whole fan row, column or plane (tap positions and weights, the plane's
# depth, the lattice coordinates) and the kernel's own overheads (the FD
# halo samples it recomputes, the skip test, the termination test) are
# left out.
#   sample: 4 z-lerps (3 each) + 2 row lerps (3) + column lerp (3)    21
#   classify: normalize (4), table index (5), 4 channel lerps (13),
#             rgb clamp (6)                                          28
#   opacity: overlap (6), 1-(1-a)^kk with expf/log1pf (10), the
#            nearly-equal branch (3), dt_w > 0 (1)                   20
#   composite r, g, b, depth, transmittance                          12
# mode 0 = 81. Modes 1/2 add the gradient (FD 7, analytic 12), the axial
# term and normal (18), the primary light (7), 10 per extra directional
# light and 23 per point light (the offset to the light 3, its squared
# length 5, the dot with the normal 5, abs, the scale by the inverse
# normal length, two max, rsqrtf, the division and three more products
# and the sum 10), the shade (10), the camera-space normal (24) and
# compositing three more channels (6); mode 2 adds the z-lerped bilinear
# lattice read (21) and the shadow factor (4). The bf16 variant rounds 6
# values of each sample (the 4 z-lerped taps and the 2 row results), 2
# more in the analytic gradient (the two row differences) and 6 in the
# lattice read (its 4 taps and 2 row results); its lerps are fmas, each
# counted as the product and the sum it replaces.
OPS_SAMPLE, OPS_COMPOSITE = 21 + 28 + 20, 12
OPS_GRAD = {True: 7, False: 12}
OPS_SHADE, OPS_LIGHT, OPS_SHADOW = 18 + 7 + 10 + 24 + 6, 10, 21 + 4
OPS_POINT = 23
OPS_BF16_SAMPLE, OPS_BF16_GRAD, OPS_BF16_SHADOW = 6, 2, 6


def ops_per_sample(mode, fd, n_dir=0, n_pt=0, bf16=False):
    ops = OPS_SAMPLE + OPS_COMPOSITE + (OPS_BF16_SAMPLE if bf16 else 0)
    if mode >= 1:
        ops += (OPS_GRAD[fd] + OPS_SHADE + OPS_LIGHT * n_dir
                + OPS_POINT * n_pt)
        ops += OPS_BF16_GRAD if bf16 and not fd else 0
    if mode == 2:
        ops += OPS_SHADOW + (OPS_BF16_SHADOW if bf16 else 0)
    return ops


H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
FRAMES, WARMUP = 10, 3  # timed and warm-up frames per headline shading
BAND_ROWS = 64  # headline fan rows held against the plain version


def log(*a):
    print(*a, flush=True)


def field(n, kind, device, z_rows=None):
    """bench.py's synthetic volume ("bench", built on the device by the
    port's bench, `ovr_tpu_torch.bench.field_on_device`, so that both
    time the same volume), or a blob in one octant ("sparse"), as f32 on
    the device; `z_rows` (an index tensor) keeps those Z rows only,
    computed alone (a brick's slab)."""
    import torch
    if kind != "sparse":
        from ovr_tpu_torch.bench import field_on_device
        return field_on_device(n, device, z_rows)
    ax = torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    x, y, z = ax[None, None, :], ax[None, :, None], ax[:, None, None]
    if z_rows is not None:
        z = z[z_rows.to(device)]
    return torch.exp(-((x - 0.7) ** 2 + (y - 0.3) ** 2
                       + (z - 0.6) ** 2) * 120)


def quantized(g, dt):
    """A field in [0, 1] as normalized-integer counts: "u8" round(g * 255),
    "u16" round(g * 65535)."""
    import torch
    top, dtype = {"u8": (255, torch.uint8), "u16": (65535, torch.uint16)}[dt]
    return torch.clamp(torch.round(g * top), 0, top).to(dtype)


CAMERAS = {
    "persp": dict(from_=(0.5, 0.5, -1.6), at=(0.5, 0.5, 0.5), fovy=45.0),
    "ortho": dict(from_=(0.5, 0.5, -2.0), at=(0.5, 0.5, 0.5), height=1.3,
                  kind="orthographic"),
    "back": dict(from_=(0.45, 0.6, 2.3), at=(0.5, 0.5, 0.5), fovy=40.0),
    # principal axis x: the fan's columns are the volume's y axis
    "side": dict(from_=(-1.6, 0.5, 0.5), at=(0.5, 0.5, 0.5), fovy=45.0),
}


# point lights outside the volume: (position, intensity)
POINTS = (((0.5, 1.8, 0.5), 1.2), ((-0.6, 0.2, 0.4), 0.9),
          ((1.4, -0.5, -0.3), 0.7))


def make_scene(grid, kind, cam, n_lights=0, n_points=0):
    """bench.py's scene on `grid`: n_lights extra directional lights as
    BENCH_EXTRA_LIGHTS makes them, then n_points of POINTS."""
    import torch
    from ovr_tpu_torch.core.scene import Camera, Light, simple_scene
    scene = simple_scene(grid, device=grid.device)
    if kind == "sparse":
        alpha = torch.cat([torch.zeros(10), torch.linspace(0, 0.9, 22)])
    elif kind == "opaque":
        alpha = torch.linspace(0.6, 1.0, 16)
    else:
        alpha = None
    if alpha is not None:
        scene = dataclasses.replace(scene, tfn=dataclasses.replace(
            scene.tfn, alpha=alpha.to(grid.device)))
    lights = tuple(Light.create(direction=(0.4 * i - 0.6, 0.3, -1.0),
                                intensity=0.5 + 0.1 * i, device=grid.device)
                   for i in range(n_lights))
    lights += tuple(Light.create(kind="point", position=pos, intensity=i,
                                 device=grid.device)
                    for pos, i in POINTS[:n_points])
    return dataclasses.replace(scene, lights=lights, camera=Camera.create(
        **CAMERAS[cam], device=grid.device))


def rig_scene(grid, cam):
    """The headline scene with tests/test_scene_features.py's light rig:
    two extra directional lights and a point light outside the volume."""
    from ovr_tpu_torch.core.scene import Light
    scene = make_scene(grid, "bench", cam)
    dev = grid.device
    return dataclasses.replace(scene, lights=(
        Light.create(direction=(0.3, -0.2, -1.0), intensity=0.7, device=dev),
        Light.create(direction=(-1.0, 0.4, 0.1), intensity=0.5, device=dev),
        Light.create(position=(0.5, 1.8, 0.5), kind="point", intensity=1.2,
                     device=dev)))


def capture_call(fn):
    """Call `fn` (a frame) and return the arguments it passed to the slice
    kernel's wrapper (the last call)."""
    from ovr_tpu_torch.ops import swslice
    seen, orig = {}, swslice.slice_composite

    def spy(*args, **kw):
        seen.update(args=args, kw=kw)
        return orig(*args, **kw)

    swslice.slice_composite = spy
    try:
        fn()
    finally:
        swslice.slice_composite = orig
    return seen["args"], seen["kw"]


def capture(scene, cfg, **render_kw):
    """Render one frame and return the arguments the renderer passed to
    the slice kernel's wrapper."""
    from ovr_tpu_torch import api
    return capture_call(lambda: api.render(scene, cfg, **render_kw))


def cuda_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(out, ref, term):
    """Largest kernel-vs-plain differences (rgb/normals, alpha, depth) and
    whether they are within the stated tolerances."""
    tol_c, tol_d = (5e-4, 5e-4) if term else (1e-4, 5e-4)
    err_c = float((out[0:6] - ref[0:6]).abs().max())
    err_a = float((out[7] - ref[7]).abs().max())
    err_d = float((out[6] - ref[6]).abs().max())
    ok = err_c <= tol_c and err_a <= tol_c and err_d <= tol_d
    return err_c, err_a, err_d, ok


PTX_TYPES = {"f": "f32", "6bf16_t": "bf16", "h": "u8", "t": "u16"}


def storage(grid):
    """The name of a grid's storage type, as PTX_TYPES names it."""
    import torch
    return {torch.float32: "f32", torch.bfloat16: "bf16", torch.uint8: "u8",
            torch.uint16: "u16"}[grid.dtype]


def ptxas_summary(text):
    """{(dtype, mode, fd, counting, bf16, lights, runs): (registers, spill
    store bytes, spill load bytes)} of each kernel variant, from `nvcc
    -Xptxas -v` (runs False for a kernel without the run variants)."""
    out, key, spills = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Function properties for _Z14swslice_kernelI(\w+?)"
                      r"Li(\d)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E(?:Lb(\d)E)?",
                      line)
        if m:
            key = (PTX_TYPES.get(m.group(1), m.group(1)), int(m.group(2)),
                   *(bool(int(m.group(i) or 0)) for i in (3, 4, 5, 6, 7)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and key is not None:
            out[key] = (int(m.group(1)), *spills)
            key, spills = None, (0, 0)
    return out


COUNTING = ("SWSLICE_COUNTING=1",)  # the counting variants' library


def build_kernel():
    """Build the kernel's two libraries, the timed variants and the
    counting ones, at once (two nvcc processes share the host's cores);
    returns the ptxas summary of both and the seconds of each build."""
    from concurrent.futures import ThreadPoolExecutor
    from ovr_tpu_torch.ops import cuda_build
    with ThreadPoolExecutor(2) as pool:
        built = list(pool.map(lambda d: cuda_build.load("swslice", d),
                              ((), COUNTING)))
    regs = {}
    for b in built:
        regs.update(ptxas_summary(b.log))
    log(f"swslice build: {built[0].seconds:.1f} s -> {built[0].path.name} "
        f"(timed), {built[1].seconds:.1f} s -> {built[1].path.name} "
        f"(counting), {len(regs)} kernel variants (ptxas: registers per "
        f"thread, spill store/load bytes):")
    for (dt, mode, fd, cnt, b16, lt, runs), (r, st, ld) in sorted(
            regs.items()):
        log(f"  {dt:4s} mode {mode} fd={fd:d}{' bf16' if b16 else ''}"
            f"{' lights' if lt else ''}{' counting' if cnt else ''}"
            f"{' runs' if runs else ''}: {r} registers, spills {st}/{ld} B")
    # 4 storage types x (f32, bf16) x (timed, counting) x (mode 0, and
    # modes 1/2 with either gradient, with and without the light table)
    # x (slab windows or direct taps, staged runs), the timed and the
    # counting variants each in their own library
    if len(regs) != 288 or sum(k[3] for k in regs) != 144:
        raise SystemExit(f"expected 288 kernel variants in the ptxas logs, "
                         f"144 of them counting, found {len(regs)}")
    return regs, [b.seconds for b in built]


def counts(args):
    """Zeroed block_planes (per block) and pixel_samples (per fan pixel)."""
    import torch
    from ovr_tpu_torch.ops import swslice
    hi, wi = args[4].shape[0], args[3].shape[0]
    n_blocks = (-(-hi // swslice.BLOCK_ROWS)
                * -(-wi // swslice.BLOCK_COLS))
    z = dict(dtype=torch.int32, device=args[0].device)
    return dict(block_planes=torch.zeros(n_blocks, **z),
                pixel_samples=torch.zeros((hi, wi), **z))


def counted(args, kw, out):
    """The kernel's counting variant on the same inputs: its counts and
    its planes sampled from staged windows / from the grid / from staged
    runs. Exits unless it gives the same bits as `out`, the timed
    variant's result."""
    import torch
    from ovr_tpu_torch.ops import swslice
    cnt = counts(args)
    stages = torch.zeros(3, dtype=torch.int32, device=args[0].device)
    out_c = swslice.slice_composite(*args, **dict(kw, **cnt),
                                    stage_counts=stages)
    if not torch.equal(out_c, out):
        raise SystemExit("the kernel's counting variant gives other bits")
    return cnt, stages.tolist()


# Kernel-vs-plain cases: (n, dtype, kind, shading, fd, skip, term, cam,
# width, height, (extra directional lights, point lights), bf16) and the
# path the kernel must take: slab windows staged in shared memory, runs
# along the traversal staged there (principal-x views), taps read
# straight from the grid (a principal-x view of a grid off the run
# alignment), or some of each (tile footprints larger than the windows). "f32r60" is the f32 grid cut
# to 60 rows along the view's rows, which the bf16 variant reads as f32
# (not a multiple of 16); an f32 grid of 64 or 256 rows is read as bf16.
PARITY_CASES = [
    (64, "f32", "bench", "none", True, False, False, "persp", 160, 90,
     (0, 0), False, "staged"),
    (64, "u8", "sparse", "none", True, True, True, "ortho", 160, 90, (0, 0),
     False, "staged"),
    (64, "bf16", "bench", "diffuse", True, False, False, "persp", 240, 135,
     (0, 0), False, "staged"),
    (64, "f32", "sparse", "diffuse", False, True, True, "ortho", 240, 135,
     (0, 0), False, "staged"),
    (64, "u8", "sparse", "shadow", True, True, False, "persp", 160, 90,
     (2, 0), False, "staged"),
    (64, "bf16", "opaque", "shadow", False, False, True, "back", 160, 90,
     (0, 0), False, "staged"),
    (64, "f32", "opaque", "diffuse", True, False, True, "back", 160, 90,
     (4, 0), False, "staged"),
    (256, "bf16", "sparse", "diffuse", True, True, False, "persp", 480, 270,
     (0, 0), False, "staged"),
    (256, "u8", "opaque", "shadow", True, False, True, "ortho", 480, 270,
     (0, 0), False, "staged"),
    (256, "f32", "sparse", "none", True, True, True, "back", 480, 270,
     (0, 0), False, "staged"),
    (256, "bf16", "bench", "diffuse", True, True, True, "side", 480, 270,
     (0, 0), False, "runs"),
    # the same view on the grid copied one voxel off the storage's run
    # alignment (`off_aligned`): no run can be staged, so every tap is
    # read from the grid
    (256, "bf16", "bench", "diffuse", True, True, True, "side", 480, 270,
     (0, 0), False, "direct"),
    (256, "f32", "bench", "shadow", True, True, True, "persp", 64, 36,
     (0, 0), False, "some direct"),
    (1024, "bf16", "bench", "diffuse", True, True, True, "persp", 240, 135,
     (0, 0), False, "some direct"),
    (1024, "bf16", "bench", "none", True, True, False, "persp", 240, 135,
     (0, 0), False, "some direct"),
    (1024, "bf16", "bench", "shadow", True, True, True, "persp", 240, 135,
     (0, 0), False, "some direct"),
    # the light table (any number of directional and point lights)
    (64, "f32", "sparse", "diffuse", True, True, True, "ortho", 240, 135,
     (6, 0), False, "staged"),
    (64, "u8", "bench", "shadow", False, False, False, "persp", 160, 90,
     (1, 2), False, "staged"),
    (256, "bf16", "bench", "shadow", True, True, True, "side", 480, 270,
     (2, 1), False, "runs"),
    # the bf16 variant
    (64, "f32", "bench", "diffuse", True, False, False, "persp", 240, 135,
     (0, 0), True, "staged"),
    (64, "f32r60", "bench", "none", True, True, True, "persp", 160, 90,
     (0, 0), True, "staged"),
    (64, "u8", "sparse", "shadow", True, True, False, "persp", 160, 90,
     (2, 1), True, "staged"),
    (64, "bf16", "opaque", "diffuse", False, False, True, "back", 160, 90,
     (0, 2), True, "staged"),
    (64, "f32r60", "opaque", "shadow", False, True, True, "ortho", 160, 90,
     (6, 0), True, "staged"),
    (256, "f32", "sparse", "shadow", True, True, False, "persp", 480, 270,
     (2, 1), True, "staged"),
    (256, "u8", "opaque", "diffuse", False, False, True, "ortho", 480, 270,
     (0, 0), True, "staged"),
    (256, "bf16", "bench", "diffuse", True, True, True, "side", 480, 270,
     (0, 0), True, "runs"),
    (256, "f32", "bench", "shadow", True, True, True, "persp", 64, 36,
     (1, 1), True, "some direct"),
    # 16-bit storage: each mode, a light table, direct and some direct
    # taps, the bf16 variant
    (64, "u16", "bench", "none", True, False, True, "persp", 160, 90,
     (0, 0), False, "staged"),
    (64, "u16", "sparse", "diffuse", False, True, False, "ortho", 240, 135,
     (0, 0), False, "staged"),
    (256, "u16", "opaque", "shadow", True, True, True, "back", 480, 270,
     (0, 0), False, "staged"),
    (64, "u16", "bench", "shadow", True, False, False, "persp", 160, 90,
     (2, 1), False, "staged"),
    (256, "u16", "bench", "diffuse", True, True, True, "side", 480, 270,
     (0, 0), False, "runs"),
    (256, "u16", "bench", "shadow", True, True, True, "persp", 64, 36,
     (0, 0), False, "some direct"),
    (64, "u16", "bench", "diffuse", True, False, False, "persp", 240, 135,
     (0, 0), True, "staged"),
    (256, "u16", "sparse", "shadow", False, True, True, "ortho", 480, 270,
     (1, 1), True, "staged"),
]


# Kernel-vs-plain cases with a surface: the scene carries SPHERE, which
# cuts the volume, so the renderer passes the kernel its exit map (modes
# 0/1/2, the f32 function and its bf16 variant, a light table in one).
EXIT_CASES = [
    (64, "f32", "bench", "none", True, True, True, "persp", 160, 90,
     (0, 0), False, "staged"),
    (64, "bf16", "bench", "diffuse", True, True, False, "ortho", 240, 135,
     (0, 0), False, "staged"),
    (64, "u8", "opaque", "shadow", False, False, True, "back", 160, 90,
     (0, 0), False, "staged"),
    (256, "bf16", "bench", "diffuse", True, True, True, "persp", 480, 270,
     (2, 1), False, "staged"),
    (64, "f32", "bench", "none", True, True, True, "persp", 160, 90,
     (0, 0), True, "staged"),
    (64, "bf16", "bench", "diffuse", False, False, True, "persp", 240, 135,
     (0, 0), True, "staged"),
    (256, "f32", "bench", "shadow", True, True, True, "persp", 480, 270,
     (0, 0), True, "staged"),
    (64, "u16", "opaque", "diffuse", True, True, True, "back", 160, 90,
     (1, 0), False, "staged"),
]


def off_aligned(gv):
    """A copy of `gv`, a principal-x view walked forward (unit traversal
    stride), in storage one voxel off the kernel's run alignment: the
    same values, and no run of it can be staged."""
    import torch
    if gv.stride(0) != 1:
        raise SystemExit(f"off_aligned: traversal stride {gv.stride(0)}")
    pad = torch.zeros((*gv.shape[1:], gv.shape[0] + 1), dtype=gv.dtype,
                      device=gv.device)
    pad[..., 1:] = gv.permute(1, 2, 0)
    return pad[..., 1:].permute(2, 0, 1)


def parity(grids, cases=PARITY_CASES, surfaces=False):
    """Kernel vs plain on the card; returns the largest error seen over
    all cases and over the bf16 variant's cases. `surfaces`: each scene
    carries SPHERE, and the kernel must be given an exit map that clamps
    some of its fan rays."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import accel

    worst = {False: 0.0, True: 0.0}
    for (n, dt, kind, shading, fd, skip, term, cam, w, h, (nd, npt), bf16,
         path) in cases:
        grid = grids[(n, dt, "sparse" if kind == "sparse" else "bench")]
        scene = make_scene(grid, kind, cam, nd, npt)
        if surfaces:
            scene = with_sphere(scene)
        cfg = api.RenderConfig(
            width=w, height=h, sampling_rate=float(n), shading=shading,
            method="shearwarp", base_rate=n / 4.0 if kind == "opaque" else 1.0,
            sw_term=term, sw_bf16=bf16).resolved(scene)
        cfg = dataclasses.replace(cfg, sw=dataclasses.replace(
            cfg.sw, fd_grad=fd))
        mc = (accel.build_macrocells(grid, scene.tfn.alpha,
                                     scene.tfn.value_range) if skip else None)
        args, kw = capture(scene, cfg, macrocells=mc)
        if path == "direct":
            if kw["axial_flip"]:
                raise SystemExit("the off-aligned case needs a forward view")
            args = (off_aligned(args[0]), *args[1:])
        name = (f"{n}^3 {dt} {kind} {shading} {cam} {w}x{h}"
                f"{' bf16' if bf16 else ''}{' exit map' if surfaces else ''}"
                f"{' off-aligned' if path == 'direct' else ''}")
        ex = kw.get("exit_map")
        clamped = 0 if ex is None else int((ex < 1e38).sum())
        if surfaces != (clamped > 0):
            raise SystemExit(f"{name}: the exit map clamps {clamped} fan "
                             f"rays")
        n0, b0 = swslice.LAUNCHES, swslice.LAUNCHES_BF16
        r0, d0 = swslice.LAUNCHES_RUNS, swslice.LAUNCHES_DIRECT
        out = swslice.slice_composite(*args, **kw)
        torch.cuda.synchronize()
        if (swslice.LAUNCHES, swslice.LAUNCHES_BF16) != (n0 + 1, b0 + bf16):
            raise SystemExit("slice_composite did not launch the kernel "
                             "variant")
        # the launcher's path, as the wrapper counts it
        if (swslice.LAUNCHES_RUNS - r0, swslice.LAUNCHES_DIRECT - d0) != (
                int(path == "runs"), int(path == "direct")):
            raise SystemExit(f"{name}: the launch was counted on the runs "
                             f"path {swslice.LAUNCHES_RUNS - r0} and the "
                             f"direct path {swslice.LAUNCHES_DIRECT - d0} "
                             f"times (must be {path})")
        cnt, (staged, direct, runs) = counted(args, kw, out)
        cnt_p = counts(args)
        ref = swslice.slice_composite_plain(*args, **kw, **cnt_p)
        err_c, err_a, err_d, ok = compare(out, ref, term)
        worst[bf16] = max(worst[bf16], err_c, err_a, err_d)
        alpha_max = float(ref[7].max())
        same = all(torch.equal(cnt[k], cnt_p[k]) for k in cnt)
        # a run-staged view reads the grid only on a plane past a skip
        # whose two runs find one free buffer
        path_ok = {"staged": staged > 0 and runs == 0,
                   "some direct": direct > 0,
                   "direct": direct > 0 and staged == runs == 0,
                   "runs": runs > 0 and staged == 0
                   and direct <= runs // 20}[path]
        n_lt = 0 if kw.get("lights") is None else kw["lights"].shape[0]
        log(f"parity {name} fd={fd:d} skip={skip:d} term={term:d} "
            f"lights={nd}+{npt}: rgb/n {err_c:.2e} alpha {err_a:.2e} depth "
            f"{err_d:.2e} (max alpha {alpha_max:.3f}); planes per block and "
            f"samples per pixel {'equal' if same else 'DIFFER'} "
            f"({int(cnt['pixel_samples'].sum())} samples); planes sampled "
            f"from staged windows {staged}, from the grid {direct}, from "
            f"staged runs {runs} (must be {path})"
            f"{f'; {clamped} fan rays clamped' if surfaces else ''} "
            f"{'ok' if ok and same and path_ok else 'FAIL'}")
        if (not ok or not same or not path_ok or alpha_max < 0.05
                or n_lt != (nd + npt if shading != "none" else 0)):
            raise SystemExit(f"kernel disagrees with the plain version, "
                             f"took the wrong path, or nothing is in view, "
                             f"in case {name}")
    return max(worst.values()), worst[True]


def bound(args, kw, pixel_samples):
    """Least time for the slice function on these inputs: each input read
    once and the output written once at the HBM rate, against the
    operations of the samples this run needs at the f32 rate. The samples
    are counted per pixel, whatever the tile (`pixel_samples`, as the
    kernel's counting variant counts them): those at which the pixel's
    T > 1e-4 and its opacity is not zero, and in shaded modes the previous
    computed plane before each such one. Neighbours that only feed an FD
    gradient are not counted, so this stays a lower bound."""
    import torch
    hi, wi = args[4].shape[0], args[3].shape[0]
    samples = float(pixel_samples.sum(dtype=torch.float64))
    inputs = [t for t in (*args, *kw.values()) if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in inputs) + 8 * hi * wi * 4
    n_lt = 0 if kw.get("lights") is None else kw["lights"].shape[0]
    n_dir = kw.get("n_dir", 0)
    ops = ops_per_sample(kw["mode"], kw["fd"], n_dir, n_lt - n_dir,
                         kw.get("bf16", False))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = samples * ops / H100_F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", samples, nbytes, ops)


def breakdown(scene, cfg, mc):
    """Device time by kernel over one headline frame (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ovr_tpu_torch import api
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        api.render(scene, cfg, macrocells=mc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0), reverse=True)
    if not rows:
        log("device time by kernel: not measured (the profiler saw no "
            "device activity)")
        return
    busy = sum(r[0] for r in rows)
    log(f"device time by kernel, one diffuse headline frame ({wall_ms:.2f} "
        f"ms wall under the profiler, {busy:.2f} ms of kernels, "
        f"{len(rows)} kernel names):")
    for ms, count, key in rows[:10]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {key[:90]}")


# (label, shading, camera) of the timed headline frames
HEADLINES = (("diffuse", "diffuse", "persp"), ("none", "none", "persp"),
             ("shadow", "shadow", "persp"), ("diffuse-x", "diffuse", "side"))


def headline_cfg(scene, shading, rate=1024.0, bf16=False):
    """The headline frame's resolved config: 1920x1080, 1024 planes (or
    `rate` planes); `bf16`: bench.py's BENCH_BF16=1 (sw_bf16)."""
    from ovr_tpu_torch import api
    cfg = api.RenderConfig(
        width=1920, height=1080, spp=1, sampling_rate=rate,
        shading=shading, method="auto", fast_math=True,
        use_macrocells=True, sw_bf16=bf16).resolved(scene)
    if cfg.sw is None:
        raise SystemExit(f"{shading}: the headline does not take the "
                         "kernel's shear-warp path")
    return cfg


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_frames(specs, mc):
    """Render, check and time each (label, scene, shading, bf16) frame
    through api.render with CUDA events (WARMUP, then FRAMES frames);
    each frame must launch the kernel once (the bf16 variant where bf16
    is set) and never run the plain version on the card."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    results = {}
    for label, scene, shading, bf16 in specs:
        cfg = headline_cfg(scene, shading, bf16=bf16)
        lg = (api.build_light_grid(scene, cfg) if shading == "shadow"
              else None)
        n0, b0 = swslice.LAUNCHES, swslice.LAUNCHES_BF16
        with PlainCalls() as plain:
            frame = api.render(scene, cfg, macrocells=mc, light_grid=lg)
            torch.cuda.synchronize()
            rgba = frame.rgba
            check_frame(label, frame, 1920, 1080)
            for _ in range(WARMUP):
                api.render(scene, cfg, macrocells=mc, light_grid=lg)
            torch.cuda.reset_peak_memory_stats()
            frame_ms = cuda_ms(lambda: api.render(
                scene, cfg, macrocells=mc, light_grid=lg), FRAMES)
        peak = torch.cuda.max_memory_allocated()
        n = 1 + WARMUP + FRAMES
        if (swslice.LAUNCHES - n0, swslice.LAUNCHES_BF16 - b0,
                plain.n) != (n, n * bf16, 0):
            raise SystemExit(f"{label}: {swslice.LAUNCHES - n0} kernel "
                             f"launches ({swslice.LAUNCHES_BF16 - b0} of the "
                             f"bf16 variant) and {plain.n} plain calls for "
                             f"{n} frames")
        results[label] = dict(frame_ms=frame_ms, peak_bytes=peak, cfg=cfg,
                              lg=lg, scene=scene, axis=cfg.sw.axis,
                              alpha_mean=float(rgba[..., 3].mean()),
                              rgba=rgba)
    return results


def kernel_alone(results, mc, card, regs):
    """The kernel alone, and against its plain version, on the inputs of
    each frame of `results` (these launches are not the main path's)."""
    from ovr_tpu_torch.ops import swslice
    for label, r in results.items():
        args, kw = capture(r["scene"], r["cfg"], macrocells=mc,
                           light_grid=r["lg"])
        hi, wi = args[4].shape[0], args[3].shape[0]
        full = swslice.slice_composite(*args, **kw)
        cnt, (staged, direct, runs) = counted(args, kw, full)
        r["kernel_ms"] = cuda_ms(
            lambda: swslice.slice_composite(*args, **kw), 5)
        (r["bound_ms"], r["bound_by"], r["samples"], r["bytes"],
         r["ops_per_sample"]) = bound(args, kw, cnt["pixel_samples"])
        r["share_of_bound"] = r["bound_ms"] / r["kernel_ms"]
        r["fan"] = (hi, wi)
        r["planes"] = args[6]
        r["block_planes"] = int(cnt["block_planes"].sum())
        r["planes_staged"], r["planes_direct"] = staged, direct
        r["planes_runs"] = runs
        mode, fd, bf16 = kw["mode"], kw["fd"] and kw["mode"] >= 1, kw["bf16"]
        n_lt = 0 if kw.get("lights") is None else kw["lights"].shape[0]
        occ = swslice.kernel_occupancy(args[0], mode, fd, args[1].shape[0],
                                       args[6], axial_flip=kw["axial_flip"],
                                       bf16=bf16, n_lights=n_lt,
                                       run_footprint=kw["run_footprint"])
        st = storage(args[0])
        reg = regs[(st, mode, fd, False, bf16, n_lt > 0,
                    occ["path"] == "runs")]
        r.update(occ, registers=reg[0], spill_bytes=reg[1] + reg[2],
                 lights=n_lt, storage=st)
        variant = (f"{st} storage mode {mode} fd={fd:d}"
                   f"{' bf16' if bf16 else ''}"
                   f"{f' lights ({n_lt})' if n_lt else ''}, {occ['path']}")
        log(f"kernel {label}: {variant} variant, "
            f"{reg[0]} registers, spills {reg[1]}/{reg[2]} B (ptxas); "
            f"{occ['threads']} threads, {occ['smem_bytes']} B dynamic "
            f"shared memory, {occ['blocks_per_sm']} blocks/SM (CUDA "
            f"occupancy API); planes sampled from staged windows {staged}, "
            f"from the grid {direct}, from staged runs {runs}; planes "
            f"composited {r['block_planes']}")
        band_check(label, r, args, kw, full)
        mrays = 1920 * 1080 / (r["frame_ms"] * 1e-3) / 1e6
        log(f"headline {label:14s} 1920x1080 1024^3 {st} storage: frame "
            f"{r['frame_ms']:.2f} ms ({mrays:.2f} Mrays/s), kernel "
            f"{r['kernel_ms']:.2f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}; {r['samples']:.4e} samples needed of "
            f"{hi * wi * args[6]:.3e}, {r['ops_per_sample']} ops each; "
            f"{100 * r['share_of_bound']:.1f}% of the bound), peak memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, fan {hi}x{wi}, "
            f"{args[6]} planes, axis {r['axis']}, mean alpha "
            f"{r['alpha_mean']:.3f}; {card}")
        r["mrays_s"] = mrays
        del r["rgba"]


def main_path(grid, card, regs):
    """The headline frame through api.render, per shading and in diffuse
    from the principal x axis (the f32 function); bench.py's
    BENCH_EXTRA_LIGHTS=6 frame and the headline with two directional and
    a point light (the f32 function's light table); then bench.py's
    BENCH_BF16=1 frame, per shading and in diffuse-x (the bf16 variant).
    Each group is driven with the launch counts set to 0 just before it
    and read just after. Returns the f32 and bf16 results and launches."""
    import math
    import torch
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import accel

    scenes = {cam: make_scene(grid, "bench", cam) for cam in ("persp", "side")}
    mc = accel.build_macrocells(grid, scenes["persp"].tfn.alpha,
                                scenes["persp"].tfn.value_range)
    swslice.LAUNCHES = swslice.LAUNCHES_BF16 = 0
    f32 = time_frames([(label, scenes[cam], shading, False)
                       for label, shading, cam in HEADLINES]
                      + [("diffuse 6 lights",
                          make_scene(grid, "bench", "persp", 6), "diffuse",
                          False),
                         ("diffuse 2+1 lights", rig_scene(grid, "persp"),
                          "diffuse", False)], mc)
    launches = swslice.LAUNCHES
    if swslice.LAUNCHES_BF16:
        raise SystemExit("an f32 frame launched the bf16 variant")
    swslice.LAUNCHES = swslice.LAUNCHES_BF16 = 0
    b16 = time_frames([(f"{label} bf16", scenes[cam], shading, True)
                       for label, shading, cam in HEADLINES], mc)
    launches_bf16 = swslice.LAUNCHES_BF16
    if launches_bf16 != swslice.LAUNCHES:
        raise SystemExit("a bf16 frame launched the f32 function")
    breakdown(scenes["persp"], f32["diffuse"]["cfg"], mc)
    # the bf16 frame against the f32 frame (premultiplied rgb)
    vs = {}
    for label in ("diffuse", "none", "shadow", "diffuse-x"):
        a, b = f32[label]["rgba"], b16[f"{label} bf16"]["rgba"]
        pa = torch.cat([a[..., :3] * a[..., 3:], a[..., 3:]], -1)
        pb = torch.cat([b[..., :3] * b[..., 3:], b[..., 3:]], -1)
        mse = float(torch.mean((pa[..., :3] - pb[..., :3]) ** 2))
        vs[label] = dict(max_abs_rgba=float((a - b).abs().max()),
                         max_abs_premultiplied=float((pa - pb).abs().max()),
                         psnr_db=10.0 * math.log10(1.0 / max(mse, 1e-20)))
        log(f"bf16 vs f32 headline {label}: max |rgba| difference "
            f"{vs[label]['max_abs_rgba']:.3e} (straight colour; "
            f"premultiplied {vs[label]['max_abs_premultiplied']:.3e}), "
            f"PSNR of the premultiplied rgb {vs[label]['psnr_db']:.2f} dB")
    kernel_alone(f32, mc, card, regs)
    kernel_alone(b16, mc, card, regs)
    return f32, launches, b16, launches_bf16, vs


# (label, shading) of the 16-bit storage headline
U16_HEADLINES = (("diffuse u16", "diffuse"), ("none u16", "none"),
                 ("shadow u16", "shadow"))


def u16_headline(card, regs):
    """The headline frame on 16-bit storage: bench.py's field at 1024^3
    as u16 counts (round(field * 65535), 2.15 GB, built on the card and
    freed after), through api.render in diffuse, none and shadow (the f32
    function reading u16), each frame checked and timed (`time_frames`),
    the launches counted from 0 just before and read just after; then
    the kernel alone on each frame's inputs, its bound (2 bytes a voxel)
    and a band of those inputs against the plain version (`kernel_alone`).
    Returns the results and the launches."""
    import torch
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import accel
    grid = quantized(field(1024, "bench", "cuda"), "u16")
    scene = make_scene(grid, "bench", "persp")
    mc = accel.build_macrocells(grid, scene.tfn.alpha, scene.tfn.value_range)
    swslice.LAUNCHES = swslice.LAUNCHES_BF16 = 0
    res = time_frames([(label, scene, shading, False)
                       for label, shading in U16_HEADLINES], mc)
    launches = swslice.LAUNCHES
    if swslice.LAUNCHES_BF16 or launches != len(U16_HEADLINES) * (
            1 + WARMUP + FRAMES):
        raise SystemExit(f"u16 headline: {launches} launches of the f32 "
                         f"function, {swslice.LAUNCHES_BF16} of the bf16 "
                         f"variant")
    kernel_alone(res, mc, card, regs)
    for r in res.values():  # they hold the 2.15 GB grid
        for k in ("scene", "cfg", "lg"):
            del r[k]
    del scene, mc, grid
    torch.cuda.empty_cache()
    return res, launches


def band_check(label, r, args, kw, full):
    """The kernel against its plain version on the headline frame's own
    inputs, cut to a band of BAND_ROWS fan rows (all columns) that starts
    on a block boundary in the middle of the fan; the counts too. Times
    both there (the plain version once, with its counts)."""
    import torch
    from ovr_tpu_torch.ops import swslice
    hi = args[4].shape[0]
    r0 = (hi // 2 - BAND_ROWS // 2) // swslice.BLOCK_ROWS * swslice.BLOCK_ROWS
    band = list(args)
    band[4] = args[4][r0:r0 + BAND_ROWS]
    if kw.get("exit_map") is not None:
        kw = dict(kw, exit_map=kw["exit_map"][r0:r0 + BAND_ROWS])
    out = swslice.slice_composite(*band, **kw)
    cnt, _ = counted(band, kw, out)
    cnt_p = counts(band)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    marks[0].record()
    ref = swslice.slice_composite_plain(*band, **kw, **cnt_p)
    marks[1].record()
    torch.cuda.synchronize()
    err_c, err_a, err_d, ok = compare(out, ref, kw["term"])
    same = all(torch.equal(cnt[k], cnt_p[k]) for k in cnt)
    alpha_max = float(ref[7].max())
    r["band"] = f"fan rows {r0}-{r0 + BAND_ROWS - 1} of {hi}, all columns"
    r["band_err"] = max(err_c, err_a, err_d)
    r["band_plain_ms"] = marks[0].elapsed_time(marks[1])
    r["band_kernel_ms"] = cuda_ms(
        lambda: swslice.slice_composite(*band, **kw), 5)
    # the band's FD rows lie on its own row lattice, so it matches the
    # full frame's rows closely but not bit for bit
    vs_full = float((out - full[:, r0:r0 + BAND_ROWS]).abs().max())
    log(f"parity headline {label:9s} {r['band']}: rgb/n {err_c:.2e} "
        f"alpha {err_a:.2e} depth {err_d:.2e} (max alpha {alpha_max:.3f}; "
        f"{vs_full:.2e} from the full frame's rows); planes per block and "
        f"samples per pixel {'equal' if same else 'DIFFER'}; plain "
        f"{r['band_plain_ms']:.1f} ms, kernel {r['band_kernel_ms']:.3f} ms "
        f"{'ok' if ok and same else 'FAIL'}")
    if (not ok or not same or alpha_max < 0.05
            or not torch.isfinite(out).all()):
        raise SystemExit("kernel disagrees with the plain version on the "
                         "headline frame's inputs")


class PlainCalls:
    """Counts calls of `slice_composite_plain` with CUDA tensors while
    installed (a `with` block)."""

    def __enter__(self):
        from ovr_tpu_torch.ops import swslice
        self.n, self.orig = 0, swslice.slice_composite_plain

        def spy(grid_v, *args, **kw):
            self.n += int(grid_v.is_cuda)
            return self.orig(grid_v, *args, **kw)

        swslice.slice_composite_plain = spy
        return self

    def __exit__(self, *exc):
        from ovr_tpu_torch.ops import swslice
        swslice.slice_composite_plain = self.orig


def loss_and_grads(scene, cfg, wrt, **render_kw):
    """bench.py's backward loss, mean(rgba^2) + mean(grad^2), of one
    `api.render` frame, and its gradients with respect to the scene
    tensors named in `wrt` (grid, alpha, color, value_range, from_). The
    forward ends at CUDA event `marks[0]`, the backward at `marks[1]` (on
    the card)."""
    import torch
    from ovr_tpu_torch import api
    vals = {"grid": scene.volume.grid, "alpha": scene.tfn.alpha,
            "color": scene.tfn.color, "value_range": scene.tfn.value_range,
            "from_": scene.camera.from_}
    vals = {k: vals[k].detach().requires_grad_(True) for k in wrt}
    tfn = dataclasses.replace(scene.tfn, **{
        k: v for k, v in vals.items() if k in ("alpha", "color",
                                               "value_range")})
    vol = dataclasses.replace(scene.volume,
                              grid=vals.get("grid", scene.volume.grid))
    cam = dataclasses.replace(scene.camera,
                              from_=vals.get("from_", scene.camera.from_))
    frame = api.render(dataclasses.replace(scene, volume=vol, tfn=tfn,
                                           camera=cam), cfg, **render_kw)
    loss = (frame.rgba ** 2).mean() + (frame.grad ** 2).mean()
    cuda = loss.is_cuda
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    if cuda:
        marks[0].record()
    grads = torch.autograd.grad(loss, list(vals.values()))
    if cuda:
        marks[1].record()
    return loss.detach(), dict(zip(vals, grads)), marks


# card-vs-CPU gradient cases: (field, camera, shading, sw_bf16, extra
# directional lights, point lights). Held within 1e-3 of the CPU's
# largest element, and 1e-2 under sw_bf16 or with extra lights:
# - under sw_bf16 the recompute rounds each plane's cotangent of its
#   operands to bf16, as the JAX package's VJP of the rounding does,
#   after card and CPU summed it in other orders (atomics on the card),
#   so an element can round one bf16 ulp apart (2^-8 of it);
# - extra lights brighten the shade, so more shaded colours sit at their
#   clip at 1, where the grid's gradient jumps; the card's rsqrtf and the
#   CPU's rsqrt, an ulp apart, put a few such samples on different sides
#   (on the CPU, scaling rsqrt by 1 + 2e-7 moves the bench field's grid
#   gradient in ortho diffuse by 2.5e-3 of its largest element with the
#   2+1 rig, 3.9e-3 with two directional lights, 1.9e-5 without).
# The sw_bf16 shaded cases take the bench field: on the sparse one, bf16
# rounding leaves planes flat around the blob, where the normal's
# gradient is rounding noise times 1e6 (card against CPU 0.50 of the
# largest element in shadow).
BWD_PARITY = ([(kind, cam, shading, False, 0, 0)
               for kind in ("bench", "sparse") for cam in ("persp", "ortho")
               for shading in ("none", "diffuse", "shadow")]
              + [("bench", "persp", "none", True, 0, 0),
                 ("bench", "persp", "diffuse", True, 0, 0),
                 ("bench", "ortho", "shadow", True, 1, 1),
                 ("bench", "ortho", "diffuse", False, 2, 1),
                 ("sparse", "persp", "shadow", False, 0, 2)])


def backward_parity(grids):
    """The frame's gradients with the kernel forward and the adjoint on
    the card against the same on CPU copies of the inputs (the plain
    forward, the same adjoint), 64^3 f32, macrocells on, in the cases of
    BWD_PARITY. Returns the largest error, normalised by the largest
    element of the CPU's."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import accel
    worst = 0.0
    wrt = ("grid", "alpha", "color", "value_range")
    for kind, cam, shading, bf16, nd, npt in BWD_PARITY:
        grads = []
        for grid in (grids[(64, "f32", kind)],
                     grids[(64, "f32", kind)].cpu()):
            scene = make_scene(grid, kind, cam, nd, npt)
            cfg = api.RenderConfig(
                width=160, height=90, sampling_rate=64.0,
                shading=shading, method="shearwarp",
                sw_bf16=bf16).resolved(scene)
            mc = accel.build_macrocells(grid, scene.tfn.alpha,
                                        scene.tfn.value_range)
            n0 = swslice.LAUNCHES
            with PlainCalls() as plain:
                _, g, _ = loss_and_grads(scene, cfg, wrt,
                                         macrocells=mc)
            n1 = swslice.LAUNCHES - n0
            if grid.is_cuda and (n1 != 1 or plain.n):
                raise SystemExit(
                    f"backward {kind} {cam} {shading}: {n1} kernel "
                    f"launches for one frame, {plain.n} plain calls "
                    f"with CUDA tensors")
            grads.append(g)
        errs = {k: float((grads[0][k].cpu() - grads[1][k]).abs().max()
                         / grads[1][k].abs().max()) for k in wrt}
        worst = max([worst] + list(errs.values()))
        tol = 1e-2 if bf16 or nd or npt else 1e-3
        ok = all(e <= tol for e in errs.values())
        log(f"backward parity 64^3 f32 {kind} {cam} {shading}"
            f"{' sw_bf16' if bf16 else ''} lights={nd}+{npt}: card "
            f"vs CPU gradient, normalised max error " + ", ".join(
                f"{k} {e:.2e}" for k, e in errs.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the card's gradient disagrees with the "
                             "CPU's")
    return worst


# (label, shading, sw_bf16) of the timed backward steps
BWD_STEPS = (("none", "none", False), ("diffuse", "diffuse", False),
             ("shadow", "shadow", False), ("diffuse bf16", "diffuse", True))
# the TF alpha's directional derivative against a central difference of
# the forward: within 2e-2, and 5e-2 under sw_bf16, where the backward
# differentiates the loop the JAX package's backward recomputes (the
# classifier's weights and table rounded to bf16: an opacity of 0.999
# becomes 0.996) rather than the forward's (the kernel's f32 lookup)
FD_TOL = {False: 2e-2, True: 5e-2}
FD_EPS = 1e-2  # step of the directional difference in the TF alpha


def backward_headline(grid, smi):
    """The headline frame's backward (bench.py's BENCH_BACKWARD loss,
    gradients of the grid and the TF alpha) per shading, and in diffuse
    under sw_bf16 (BENCH_BF16=1): one step each, CUDA events around the
    forward and the backward (the first step of the run is cold: the
    bench phase times the warm diffuse step, BENCH_BACKWARD=1); checks
    the gradients and holds the TF alpha's against a central directional
    difference."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import accel

    scene = make_scene(grid, "bench", "persp")
    mc = accel.build_macrocells(grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    d = torch.randn(scene.tfn.alpha.shape[0],
                    generator=torch.Generator().manual_seed(0)).to(grid.device)
    results = {}
    swslice.LAUNCHES = 0
    for label, shading, bf16 in BWD_STEPS:
        cfg = headline_cfg(scene, shading, bf16=bf16)
        lg = None
        if shading == "shadow":  # built once, as bench.py does
            with torch.no_grad():
                lg = api.build_light_grid(scene, cfg)
        kw = dict(macrocells=mc, light_grid=lg)
        n0, b0 = swslice.LAUNCHES, swslice.LAUNCHES_BF16
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, g, marks = loss_and_grads(scene, cfg, ("grid", "alpha"), **kw)
        torch.cuda.synchronize()
        fwd = [start.elapsed_time(marks[0])]
        bwd = [marks[0].elapsed_time(marks[1])]
        peak = torch.cuda.max_memory_allocated()
        launches = swslice.LAUNCHES - n0
        launches_bf16 = swslice.LAUNCHES_BF16 - b0
        gg, ga = g["grid"], g["alpha"]
        finite = bool(torch.isfinite(gg).all() and torch.isfinite(ga).all())
        nonzero = bool(gg.abs().max() > 0 and ga.abs().max() > 0)
        # the directional difference, both sides without termination
        cfg_nt = dataclasses.replace(cfg, sw=dataclasses.replace(
            cfg.sw, term=False))
        side = []
        with torch.no_grad():
            for s in (1.0, -1.0):
                tfn = dataclasses.replace(
                    scene.tfn, alpha=scene.tfn.alpha + s * FD_EPS * d)
                f = api.render(dataclasses.replace(scene, tfn=tfn), cfg_nt,
                               **kw)
                side.append(float(((f.rgba ** 2).mean()
                                   + (f.grad ** 2).mean()).double()))
        fd = (side[0] - side[1]) / (2 * FD_EPS)
        an = float((ga.double() * d.double()).sum())
        fd_err = abs(fd - an) / max(abs(an), 1e-30)
        step_ms = [a + b for a, b in zip(fwd, bwd)]
        med = sorted(step_ms)[len(step_ms) // 2]
        r = dict(step_ms=step_ms, fwd_ms=fwd, bwd_ms=bwd, steps=1,
                 first_of_run=not results,
                 mrays_s=1920 * 1080 * cfg.spp / (med * 1e-3) / 1e6,
                 peak_bytes=peak, launches_per_step=launches,
                 grid_grad=f"{gg.dtype} {tuple(gg.shape)}",
                 loss=float(loss), fd=fd, analytic=an, fd_rel_err=fd_err)
        results[label] = r
        log(f"backward headline {label:12s} 1920x1080 1024^3 bf16: step "
            f"{', '.join(f'{x:.0f}' for x in step_ms)} ms (one step"
            f"{', the first of the run' if r['first_of_run'] else ''}; "
            f"forward {', '.join(f'{x:.1f}' for x in fwd)} ms, backward "
            f"{', '.join(f'{x:.0f}' for x in bwd)} ms), {r['mrays_s']:.3f} "
            f"Mrays/s fwd+bwd, peak memory {peak / 2**30:.2f} GiB, "
            f"{launches:g} kernel launches per step, grid gradient "
            f"{r['grid_grad']}, finite {finite}, nonzero {nonzero}; TF alpha "
            f"directional derivative {an:.6e} vs central difference "
            f"{fd:.6e} (eps {FD_EPS}), relative error {fd_err:.2e}; {smi}")
        if (not finite or not nonzero or fd_err > FD_TOL[bf16] or launches != 1
                or launches_bf16 != int(bf16)
                or gg.dtype != torch.bfloat16
                or tuple(gg.shape) != tuple(grid.shape)):
            raise SystemExit(f"backward {label} failed its checks")
        del g, gg, ga
    return results, swslice.LAUNCHES, scene, mc


PROFILE_PLANES = 16  # planes of the profiled sweep (reading a profile
# costs ~0.1 ms per event on the host, ~1000 events per plane)


def backward_profile(scene, mc):
    """One reverse sweep of the diffuse headline frame, cut to
    PROFILE_PLANES planes: its wall time without a profiler, then under
    torch.profiler the device time of its kernels, the kernels and the
    ops (by input shapes) that take most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ovr_tpu_torch import api

    cfg = headline_cfg(scene, "diffuse", rate=float(PROFILE_PLANES))
    grid = scene.volume.grid.detach().requires_grad_(True)
    vol = dataclasses.replace(scene.volume, grid=grid)
    frame = api.render(dataclasses.replace(scene, volume=vol), cfg,
                       macrocells=mc)
    loss = (frame.rgba ** 2).mean() + (frame.grad ** 2).mean()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.autograd.grad(loss, [grid], retain_graph=True)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        torch.autograd.grad(loss, [grid])
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    # one pass over the events (each costs host time): grouped by input
    # shapes, where kernels, which have none, form one group a name
    groups = prof.key_averages(group_by_input_shape=True)
    kernels = [e for e in groups if e.device_type == DeviceType.CUDA
               and e.device_time_total > 0]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    top_kernels = sorted(((e.device_time_total / 1e3, e.count, e.key)
                          for e in kernels), reverse=True)[:8]
    # aten ops by input shapes and the device time of their kernels
    # (an op's children included: nested ops count in both)
    ops = sorted(((e.device_time_total / 1e3, e.count,
                   e.cpu_time_total / 1e3, e.key, str(e.input_shapes))
                  for e in groups
                  if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")), reverse=True)[:12]
    n_launch = sum(e.count for e in kernels)
    log(f"backward profile, one reverse sweep of the diffuse headline "
        f"frame cut to {cfg.sw.n_slices} planes: {wall_ms:.0f} ms wall "
        f"({prof_wall_ms:.0f} ms under the profiler), {busy:.0f} ms of "
        f"kernels ({100 * busy / wall_ms:.1f}% of the wall; the rest is "
        f"host time, launches included), {n_launch} kernel launches "
        f"({1e3 * wall_ms / max(n_launch, 1):.1f} us of wall each); "
        f"profile read in {time.perf_counter() - t0:.0f} s. Kernels by "
        f"device time:")
    for ms, count, key in top_kernels:
        log(f"  {ms:9.1f} ms  x{count:<7d} {key[:90]}")
    log("aten ops by device time (with children), by input shapes:")
    for dev_ms, count, cpu_ms, key, shapes in ops:
        log(f"  {dev_ms:9.1f} ms device  x{count:<6d} {cpu_ms:8.1f} ms host"
            f"  {key} {shapes[:70]}")
    return dict(planes=cfg.sw.n_slices, wall_ms=wall_ms,
                profiled_wall_ms=prof_wall_ms, device_ms=busy,
                launches=n_launch,
                top_kernels=[dict(kernel=k[:120], device_ms=ms, count=c)
                             for ms, c, k in top_kernels],
                top_ops=[dict(op=k, shapes=s[:200], count=c, host_ms=h,
                              device_ms=d) for d, c, h, k, s in ops])


# ---------------------------------------------------------------------------
# the march (no kernel: plain PyTorch, as the JAX package's is XLA)
# ---------------------------------------------------------------------------

# (field, camera, shading, lattice shadows) of the card-vs-CPU cases; the
# wide-FOV interior eye goes through method="auto", which must fall back.
# The eyes sit off the volume's symmetry planes (march_parity says why).
MARCH_CASES = (
    ("bench", "persp", "none", True),
    ("bench", "persp", "diffuse", True),
    ("sparse", "ortho", "diffuse", True),
    ("bench", "wide", "diffuse", True),
    ("bench", "persp", "shadow", True),  # the lattice built inline
    ("sparse", "persp", "shadow", False),  # the exact shadow march
    ("bench", "ortho", "ssh", True),
    ("bench", "wide", "ssh", False),
)
MARCH_WRT = ("grid", "alpha", "color", "value_range", "from_")
WIDE = dict(from_=(0.5, 0.5, 0.5), at=(0.9, 0.75, 0.5), fovy=130.0)
MARCH_CAMERAS = {
    "persp": dict(from_=(0.53, 0.46, -1.6), at=(0.5, 0.52, 0.5), fovy=45.0),
    "ortho": dict(from_=(0.47, 0.54, -2.0), at=(0.52, 0.49, 0.5),
                  height=1.3, kind="orthographic"),
    "wide": dict(WIDE, from_=(0.48, 0.53, 0.51)),
}


def march_scene(grid, kind, cam):
    """make_scene with two extra directional lights and a point light,
    seen from MARCH_CAMERAS[cam] ("wide": a wide-FOV interior eye)."""
    from ovr_tpu_torch.core.scene import Camera, Light
    scene = make_scene(grid, kind, "persp", 2)
    point = Light.create(kind="point", position=(1.3, 1.1, -0.5),
                         intensity=0.8, device=grid.device)
    return dataclasses.replace(
        scene, lights=scene.lights + (point,),
        camera=Camera.create(**MARCH_CAMERAS[cam], device=grid.device))


def in_f64(scene):
    """The scene with every floating-point tensor in float64."""
    def cast(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).double()
            for f in dataclasses.fields(obj)
            if getattr(getattr(obj, f.name), "is_floating_point",
                       lambda: False)()})
    return dataclasses.replace(
        scene, volume=cast(scene.volume), tfn=cast(scene.tfn),
        light=cast(scene.light), camera=cast(scene.camera),
        lights=tuple(cast(lt) for lt in scene.lights))


def march_parity():
    """Phase (a): the march on the card against the same march on CPU
    copies, 64^3 f32, 64x48, rate 64, macrocells on, adaptive_scale 4,
    two extra directional lights and a point light, jitter_rays from one
    CPU generator seed, flow against a moved camera: rgba and normals
    within 1e-4, depth and flow within 5e-4; march_while gives the
    march's bits on the card. The gradients of the grid, the TF's alpha,
    colour and value range and the camera's from_ are held within 1e-3
    of the CPU's largest element in float64 on both devices: shaded
    normals make them ill-conditioned in float32 (on the CPU the float32
    grid gradient of the bench field in diffuse is 8.3e-2 of its largest
    element from the float64 one; card against CPU in float32 up to
    1.8e-3, PERF.md). The eyes sit
    off the volume's symmetry planes: from a symmetric eye some samples
    sit on kinks of the trilinear interpolation, where the gradient
    jumps (moving the eye by 1e-13 changes it by 5.8e-3). Returns the
    largest errors."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.core.scene import Camera
    from ovr_tpu_torch.render import accel
    worst = dict(frame=0.0, grad=0.0)
    for kind, cam, shading, lattice in MARCH_CASES:
        frames, grads = [], []
        card_grid = field(64, kind, torch.device("cuda"))
        for dev in ("cuda", "cpu"):
            grid = card_grid.to(dev)  # the CPU's is a copy of the card's
            scene = march_scene(grid, kind, cam)
            cfg = api.RenderConfig(
                width=64, height=48, sampling_rate=64.0, shading=shading,
                method="auto" if cam == "wide" else "march",
                shadow_grid=lattice, use_macrocells=True, adaptive_scale=4.0,
                jitter_rays=True).resolved(scene)
            if cfg.sw is not None:
                raise SystemExit(f"march {kind} {cam} {shading}: auto did "
                                 f"not fall back to the march")
            for f64 in (False, True):
                sc = in_f64(scene) if f64 else scene
                last = dataclasses.replace(sc.camera,
                                           from_=sc.camera.from_ + 0.02)
                mc = accel.build_macrocells(sc.volume.grid, sc.tfn.alpha,
                                            sc.tfn.value_range)
                c = dataclasses.replace(
                    cfg, dtype=torch.float64 if f64 else torch.float32)

                def kw():
                    return dict(macrocells=mc, last_camera=last,
                                generator=torch.Generator().manual_seed(7))

                if f64:
                    grads.append(loss_and_grads(sc, c, MARCH_WRT, **kw())[1])
                    continue
                frame = api.render(sc, c, **kw())
                frames.append(frame)
                if dev == "cuda":
                    if not all(x.is_cuda for x in (frame.rgba, frame.grad,
                                                   frame.depth, frame.flow)):
                        raise SystemExit("the march left the card")
                    fast = api.render(sc, dataclasses.replace(
                        c, fast_math=True), **kw())
                    same = all(torch.equal(getattr(fast, k),
                                           getattr(frame, k))
                               for k in ("rgba", "grad", "depth", "flow"))
        errs = {k: float((getattr(frames[0], k).cpu()
                          - getattr(frames[1], k)).abs().max())
                for k in ("rgba", "grad", "depth", "flow")}

        g64 = {k: float((grads[0][k].cpu() - grads[1][k]).abs().max()
                        / grads[1][k].abs().max()) for k in MARCH_WRT}
        ok = (errs["rgba"] <= 1e-4 and errs["grad"] <= 1e-4
              and errs["depth"] <= 5e-4 and errs["flow"] <= 5e-4 and same
              and all(e <= 1e-3 for e in g64.values())
              and float(frames[1].rgba[..., 3].max()) > 0.05)
        worst["frame"] = max([worst["frame"]] + list(errs.values()))
        worst["grad"] = max([worst["grad"]] + list(g64.values()))
        log(f"march parity 64^3 {kind} {cam} {shading}"
            f"{'' if lattice else ' (exact shadows)'}: card vs CPU, f32 "
            f"frame " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
            + f"; march_while {'equals' if same else 'DIFFERS from'} the "
            f"march; gradient, normalised, f64: " + ", ".join(
                f"{k} {e:.2e}" for k, e in g64.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the march on the card disagrees with the CPU's")
    return worst


def march_cfg(scene, shading, width=1920, height=1080, rate=1024.0,
              method="march", **kw):
    """bench.py's BENCH_METHOD=march config: fast_math, macrocells."""
    from ovr_tpu_torch import api
    kw = dict(dict(fast_math=True, use_macrocells=True), **kw)
    return api.RenderConfig(
        width=width, height=height, spp=1, sampling_rate=rate,
        shading=shading, method=method, **kw).resolved(scene)


def check_frame(label, frame, width, height, min_alpha=0.5):
    import torch
    rgba = frame.rgba
    a = rgba[..., 3]
    ok = (rgba.is_cuda and tuple(rgba.shape) == (height, width, 4)
          and bool(torch.isfinite(rgba).all() and torch.isfinite(
              frame.grad).all() and torch.isfinite(frame.depth).all())
          and float(a.min()) >= 0.0 and float(a.max()) <= 1.0
          and float(a.max()) > min_alpha)
    if not ok:
        raise SystemExit(f"{label} frame failed its checks")


def march_profile(scene, mc, steps):
    """Kernel launches and device time of the headline diffuse march cut
    to `steps` steps (march, not march_while): wall ms without the
    profiler, then under torch.profiler the launches and the kernels'
    device time, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ovr_tpu_torch import api
    cfg = march_cfg(scene, "diffuse", max_steps=steps, fast_math=False)
    api.render(scene, cfg, macrocells=mc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.render(scene, cfg, macrocells=mc)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        api.render(scene, cfg, macrocells=mc)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type ==
               DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(((e.device_time_total / 1e3, e.count, e.key)
                  for e in kernels), reverse=True)[:8]
    return dict(steps=steps, wall_ms=wall_ms, device_ms=busy,
                launches=sum(e.count for e in kernels),
                top=[dict(kernel=k[:120], device_ms=ms, count=c)
                     for ms, c, k in top])


def march_headline(grid, smi):
    """Phase (b): the headline volume through method="march" at 1920x1080,
    rate 1024, in diffuse and in shadow (the lattice built once, as
    bench.py does): one checked frame each, timed with CUDA events (the
    bench phase times the warm diffuse frame, BENCH_METHOD=march), its
    peak memory and the steps the loop ran; launches per frame and the
    device/host split from torch.profiler on the frame cut to 16 and 32
    steps."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.render import accel
    from ovr_tpu_torch.render import integrator as ig
    scene = make_scene(grid, "bench", "persp")
    mc = accel.build_macrocells(grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    p16, p32 = march_profile(scene, mc, 16), march_profile(scene, mc, 32)
    per_step = (p32["launches"] - p16["launches"]) / 16
    setup = p16["launches"] - 16 * per_step
    log(f"march profile, the diffuse headline cut to 32 steps: "
        f"{p32['wall_ms']:.1f} ms wall ({p32['wall_ms'] / 32:.2f} ms a "
        f"step), {p32['device_ms']:.1f} ms of kernels "
        f"({100 * p32['device_ms'] / p32['wall_ms']:.1f}% of the wall; the "
        f"rest is host time, launches included), {p32['launches']} kernel "
        f"launches; {per_step:g} launches a step and {setup:g} outside "
        f"the loop (16- and 32-step cuts). Kernels by device time:")
    for k in p32["top"]:
        log(f"  {k['device_ms']:9.2f} ms  x{k['count']:<6d} "
            f"{k['kernel'][:90]}")
    results = {}
    for shading in ("diffuse", "shadow"):
        cfg = march_cfg(scene, shading)
        lg = None
        if shading == "shadow":
            with torch.no_grad():
                lg = api.build_light_grid(scene, cfg)
        n0 = ig.STEPS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
        frame = api.render(scene, cfg, macrocells=mc, light_grid=lg)
        marks[1].record()
        torch.cuda.synchronize()
        ms = [marks[0].elapsed_time(marks[1])]
        peak = torch.cuda.max_memory_allocated()
        steps = ig.STEPS - n0
        check_frame(f"march {shading}", frame, 1920, 1080)
        alpha_mean = float(frame.rgba[..., 3].mean())
        del frame
        med = ms[0]
        r = dict(frame_ms=ms, steps=steps,
                 max_steps=cfg.max_steps, peak_bytes=peak,
                 mrays_s=1920 * 1080 / (med * 1e-3) / 1e6,
                 launches_per_frame=setup + per_step * steps,
                 alpha_mean=alpha_mean)
        results[shading] = r
        log(f"march headline {shading:7s} 1920x1080 1024^3 bf16 rate 1024: "
            f"frame {ms[0]:.0f} ms (one checked frame), {r['mrays_s']:.3f} "
            f"Mrays/s, {steps} steps run of {cfg.max_steps}, ~"
            f"{r['launches_per_frame']:.0f} launches a frame ({per_step:g} "
            f"a step), peak memory {peak / 2**30:.2f} GiB, mean alpha "
            f"{alpha_mean:.3f}; {smi}")
    return results, dict(per_step=per_step, setup=setup, profile_32=p32,
                         profile_16_launches=p16["launches"]), scene, mc


def march_oracle(scene, mc):
    """Phase (c): the slice kernel (method="shearwarp") against the march
    on the headline volume, diffuse, 128x72, rate 256: PSNR of the
    premultiplied rgb (apps/render_batch.py --ab) >= 35 dB, mean alphas
    within 1e-3."""
    import math
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    out = {}
    for method in ("shearwarp", "march"):
        cfg = march_cfg(scene, "diffuse", 128, 72, 256.0, method=method)
        n0 = swslice.LAUNCHES
        out[method] = api.render(scene, cfg, macrocells=mc).rgba
        if (swslice.LAUNCHES - n0 == 1) != (method == "shearwarp"):
            raise SystemExit(f"oracle: {method} launched the slice kernel "
                             f"{swslice.LAUNCHES - n0} times")
    a, b = out["march"], out["shearwarp"]
    mse = float(torch.mean((a[..., :3] * a[..., 3:] - b[..., :3] * b[..., 3:])
                           ** 2))
    psnr = 10.0 * math.log10(1.0 / max(mse, 1e-12))
    da = abs(float(a[..., 3].mean()) - float(b[..., 3].mean()))
    ok = psnr >= 35.0 and da <= 1e-3
    log(f"march oracle 1024^3 bf16 diffuse 128x72 rate 256: slice kernel vs "
        f"march PSNR {psnr:.2f} dB (mse {mse:.3e}), mean alpha "
        f"{float(b[..., 3].mean()):.5f} vs {float(a[..., 3].mean()):.5f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the slice kernel disagrees with the march oracle")
    return dict(psnr_db=psnr, mse=mse, mean_alpha_diff=da)


def march_fallback(grid, mc, smi):
    """Phase (d): method="auto" from a wide-FOV interior eye on the
    headline volume at 1080p falls back to the march on the card."""
    import torch
    from ovr_tpu_torch.core.scene import Camera
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import integrator as ig
    scene = dataclasses.replace(make_scene(grid, "bench", "persp"),
                                camera=Camera.create(**WIDE,
                                                     device=grid.device))
    cfg = march_cfg(scene, "diffuse", method="auto")
    if cfg.sw is not None:
        raise SystemExit("auto resolved a shear-warp plan for the wide eye")
    n0, s0 = swslice.LAUNCHES, ig.STEPS
    t0 = time.perf_counter()
    frame = api.render(scene, cfg, macrocells=mc)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    check_frame("fallback", frame, 1920, 1080)
    if swslice.LAUNCHES != n0:
        raise SystemExit("the fallback launched the slice kernel")
    r = dict(frame_s=sec, steps=ig.STEPS - s0,
             alpha_mean=float(frame.rgba[..., 3].mean()))
    log(f"march fallback: auto from the wide-FOV interior eye, 1920x1080 "
        f"1024^3 bf16 diffuse: cfg.sw None, march frame {sec:.1f} s "
        f"(first call, one frame), {r['steps']} steps, finite, mean alpha "
        f"{r['alpha_mean']:.3f}; {smi}")
    return r


# ---------------------------------------------------------------------------
# surfaces, multi-volume scenes and sparse sampling
# ---------------------------------------------------------------------------

# the opaque UV sphere of the geometry headline: 64 x 32 segments (3968
# triangles: the pole bands' degenerate triangles are left out)
SPHERE = dict(n_lon=64, n_lat=32, center=(0.5, 0.5, 0.55), radius=0.3)
GEO_FRAMES = 3  # timed frames per geometry headline (after one warm-up)
ORACLE_P95 = 0.06  # tests/test_geometry.py:146, the march against shear-warp


def uv_sphere(n_lon, n_lat, center, radius):
    """(verts (V, 3), faces (F, 3), uvs (V, 2)) numpy arrays of a
    latitude-longitude sphere, the seam's vertices doubled for the uvs."""
    import numpy as np
    th = np.linspace(0.0, np.pi, n_lat + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    t, p = np.meshgrid(th, ph, indexing="ij")
    unit = np.stack([np.sin(t) * np.cos(p), np.cos(t),
                     np.sin(t) * np.sin(p)], -1)
    verts = (np.asarray(center) + radius * unit).reshape(-1, 3)
    uvs = np.stack([p / (2.0 * np.pi), 1.0 - t / np.pi], -1).reshape(-1, 2)
    w, faces = n_lon + 1, []
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * w + j, i * w + j + 1
            c, d = a + w, b + w
            if i > 0:
                faces.append((a, b, d))
            if i < n_lat - 1:
                faces.append((a, d, c))
    return (verts.astype(np.float32), np.asarray(faces, np.int64),
            uvs.astype(np.float32))


def with_sphere(scene, verts=None):
    """`scene` with SPHERE as its one surface (kd 0.9, ks 0.3, ns 20);
    `verts` replaces its vertices (a leaf for their gradient)."""
    from ovr_tpu_torch.core.scene import (GeometryInstance, Material,
                                          TriangleMesh)
    dev = scene.device
    v, f, uv = uv_sphere(**SPHERE)
    mesh = TriangleMesh.create(v if verts is None else verts, f, uvs=uv,
                               device=dev)
    mat = Material.create(kd=(0.9, 0.9, 0.9), ks=(0.3, 0.3, 0.3), ns=20.0,
                          device=dev)
    return dataclasses.replace(scene, geometries=(
        GeometryInstance.create(mesh, mat, device=dev),))


def with_iso(scene, value=0.5):
    """`scene` with its volume's isosurface at `value` (normalized)."""
    from ovr_tpu_torch.core.scene import GeometryInstance, Isosurface
    dev = scene.device
    return dataclasses.replace(scene, geometries=(GeometryInstance.create(
        Isosurface.create(value, device=dev), device=dev),))


def oracle_error(scene, mc, drop_exit_map=False):
    """The slice kernel (shear-warp) against the march on `scene` at the
    oracle probe (128x72, rate 256, diffuse): the 95th percentile, over
    the surface's interior pixels, of the largest premultiplied-rgb
    difference (tests/test_geometry.py:121-147's rule; the interior is
    the surface's hit mask eroded by 3 pixels, as that test's frame
    interior is the frame eroded by 3), and the PSNR over the frame.
    `drop_exit_map` renders the shear-warp frame without the exit map:
    volume behind the surface, which the rule must reject."""
    import math
    import torch
    import torch.nn.functional as F
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import geometry
    from ovr_tpu_torch.render.camera import generate_rays, pixel_screen_coords
    out = {}
    orig = swslice.slice_composite

    def no_map(*args, **kw):
        return orig(*args, **dict(kw, exit_map=None))

    for method in ("shearwarp", "march"):
        cfg = march_cfg(scene, "diffuse", 128, 72, 256.0, method=method)
        if drop_exit_map and method == "shearwarp":
            swslice.slice_composite = no_map
        try:
            f = api.render(scene, cfg, macrocells=mc).rgba
        finally:
            swslice.slice_composite = orig
        out[method] = f[..., :3] * f[..., 3:]
    screen = pixel_screen_coords(128, 72, torch.float32,
                                 scene.device).reshape(-1, 2)
    org, d = generate_rays(scene.camera, screen, 128, 72)
    hit = (geometry.render_geometries(scene, org, d, iso_steps=128)[1]
           > 0).reshape(1, 1, 72, 128).float()
    inner = (-F.max_pool2d(-hit, 7, stride=1, padding=3))[0, 0] > 0.5
    inner[:3], inner[-3:], inner[:, :3], inner[:, -3:] = False, False, \
        False, False
    err = (out["march"] - out["shearwarp"]).abs().amax(-1)[inner]
    mse = float(torch.mean((out["march"] - out["shearwarp"]) ** 2))
    return (float(torch.quantile(err, 0.95)), int(inner.sum()),
            10.0 * math.log10(1.0 / max(mse, 1e-12)))


def geometry_headline(grid, smi):
    """The headline volume with a surface, through method="auto" (the
    slice kernel with the exit map), diffuse, 1920x1080, rate 1024,
    macrocells and termination on: (a) SPHERE, (b) the isosurface at
    0.5 (iso_steps 128). Per case: frame ms over GEO_FRAMES frames after
    a warm-up, Mrays/s, the kernel alone on the frame's inputs and a
    band of them against the plain version, the geometry's own ms and
    peak memory, peak memory of the frame, and the oracle probe against
    the march: the sphere within ORACLE_P95, and with the exit map
    dropped, both cases beyond it. The isosurface is not held to
    ORACLE_P95: the two paths hit its folds on different rays and its
    one-voxel FD normals (on a bf16 volume) shade the hits apart, which
    the JAX package does as much (tests/test_torch_geometry.py::
    test_isosurface_march_gap_is_the_references); `geometry_parity`
    holds it card against CPU instead. The launch counts are set to 0
    just before the frames and read after."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import accel, geometry
    base = make_scene(grid, "bench", "persp")
    mc = accel.build_macrocells(grid, base.tfn.alpha, base.tfn.value_range)
    results, launches = {}, 0
    for label, scene in (("sphere", with_sphere(base)),
                         ("isosurface", with_iso(base))):
        cfg = headline_cfg(scene, "diffuse")
        swslice.LAUNCHES = 0
        with PlainCalls() as plain:
            frame = api.render(scene, cfg, macrocells=mc)
            torch.cuda.synchronize()
            check_frame(f"geometry {label}", frame, 1920, 1080)
            alpha_mean = float(frame.rgba[..., 3].mean())
            del frame
            torch.cuda.reset_peak_memory_stats()
            frame_ms = cuda_ms(lambda: api.render(scene, cfg, macrocells=mc),
                               GEO_FRAMES)
            peak = torch.cuda.max_memory_allocated()
        n = swslice.LAUNCHES
        if (n, plain.n) != (1 + GEO_FRAMES, 0):
            raise SystemExit(f"geometry {label}: {n} kernel launches and "
                             f"{plain.n} plain calls for {1 + GEO_FRAMES} "
                             f"frames")
        launches += n
        # the surfaces alone, on the frame's fan rays
        seen = {}
        orig = geometry.render_geometries

        def spy(*args, **kw):
            seen.update(args=args, kw=kw)
            return orig(*args, **kw)

        geometry.render_geometries = spy
        try:
            args, kw = capture(scene, cfg, macrocells=mc)
        finally:
            geometry.render_geometries = orig
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        geo_ms = cuda_ms(lambda: orig(*seen["args"], **seen["kw"]), 1)
        geo_peak = torch.cuda.max_memory_allocated() - base_mem
        ex = kw["exit_map"]
        full = swslice.slice_composite(*args, **kw)
        kernel_ms = cuda_ms(lambda: swslice.slice_composite(*args, **kw), 3)
        r = dict(frame_ms=frame_ms, peak_bytes=peak, alpha_mean=alpha_mean,
                 kernel_ms=kernel_ms, geometry_ms=geo_ms,
                 geometry_peak_bytes=geo_peak,
                 fan_rays_clamped=int((ex < 1e38).sum()),
                 fan_rays=ex.numel(), launches=n)
        band_check(f"{label} map", r, args, kw, full)
        p95, n_in, psnr = oracle_error(with_sphere(base) if label == "sphere"
                                       else with_iso(base), mc)
        p95_bad, _, psnr_bad = oracle_error(
            with_sphere(base) if label == "sphere" else with_iso(base), mc,
            drop_exit_map=True)
        ok = (p95 < ORACLE_P95 or label == "isosurface") and (
            max(p95, ORACLE_P95) <= p95_bad)
        r.update(oracle_p95=p95, oracle_pixels=n_in, oracle_psnr_db=psnr,
                 unclamped_p95=p95_bad, unclamped_psnr_db=psnr_bad,
                 mrays_s=1920 * 1080 / (frame_ms * 1e-3) / 1e6)
        results[label] = r
        log(f"geometry headline {label:10s} 1920x1080 1024^3 bf16 diffuse "
            f"auto: frame {frame_ms:.2f} ms ({r['mrays_s']:.2f} Mrays/s), "
            f"kernel {kernel_ms:.2f} ms with the exit map "
            f"({r['fan_rays_clamped']} of {ex.numel()} fan rays clamped), "
            f"geometry {geo_ms:.2f} ms (peak {geo_peak / 2**30:.2f} GiB "
            f"above the {base_mem / 2**30:.2f} GiB held), frame peak "
            f"{peak / 2**30:.2f} GiB, mean alpha {alpha_mean:.3f}; oracle "
            f"128x72 rate 256 against the march: p95 {p95:.4f} over "
            f"{n_in} interior pixels ("
            f"{f'< {ORACLE_P95}' if label == 'sphere' else 'not gated'}), "
            f"PSNR {psnr:.2f} dB; "
            f"without the exit map p95 {p95_bad:.4f} (must be >= "
            f"{ORACLE_P95} and the clamped p95), PSNR {psnr_bad:.2f} dB "
            f"{'ok' if ok else 'FAIL'}; {smi}")
        if not ok:
            raise SystemExit(f"geometry {label}: the slice kernel with the "
                             f"exit map disagrees with the march, or the "
                             f"probe cannot tell the clamp")
    return results, launches


def geometry_parity(grids):
    """Frames with SPHERE and with the isosurface at 0.5 (64^3 f32,
    160x90, diffuse, auto: the kernel with the exit map, and the march),
    card against CPU: rgba and normals within 1e-4, depth 5e-4."""
    from ovr_tpu_torch import api
    worst = 0.0
    for label, add in (("sphere", with_sphere), ("isosurface", with_iso)):
        for method in ("auto", "march"):
            frames = []
            for grid in (grids[(64, "f32", "bench")],
                         grids[(64, "f32", "bench")].cpu()):
                scene = add(make_scene(grid, "bench", "persp"))
                cfg = api.RenderConfig(width=160, height=90,
                                       sampling_rate=64.0, shading="diffuse",
                                       method=method).resolved(scene)
                with PlainCalls() as plain:
                    frames.append(api.render(scene, cfg))
                if grid.is_cuda and plain.n:
                    raise SystemExit("geometry parity: a plain call on the "
                                     "card")
            e = [float((getattr(frames[0], k).cpu() - getattr(frames[1], k))
                       .abs().max()) for k in ("rgba", "grad", "depth")]
            worst = max(worst, *e)
            ok = e[0] <= 1e-4 and e[1] <= 1e-4 and e[2] <= 5e-4
            log(f"geometry parity 64^3 {label} {method}: card vs CPU rgba "
                f"{e[0]:.2e} normals {e[1]:.2e} depth {e[2]:.2e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("geometry: the card disagrees with the CPU")
    return worst


def geometry_backward(grids):
    """Gradients of a shear-warp frame with SPHERE (64^3 f32, 160x90,
    none and diffuse): the grid's, the TF alpha's and the sphere's
    vertices', card against CPU, within 1e-3 of the CPU's largest
    element; one kernel launch per frame, no plain call on the card."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    worst = 0.0
    v0 = uv_sphere(**SPHERE)[0]
    for shading in ("none", "diffuse"):
        grads = []
        for grid in (grids[(64, "f32", "bench")],
                     grids[(64, "f32", "bench")].cpu()):
            verts = torch.tensor(v0, device=grid.device, requires_grad=True)
            alpha = make_scene(grid, "bench", "persp").tfn.alpha.detach()
            alpha.requires_grad_(True)
            g = grid.detach().requires_grad_(True)
            scene = with_sphere(make_scene(g, "bench", "persp"), verts)
            scene = dataclasses.replace(scene, tfn=dataclasses.replace(
                scene.tfn, alpha=alpha))
            cfg = api.RenderConfig(width=160, height=90, sampling_rate=64.0,
                                   shading=shading,
                                   method="shearwarp").resolved(scene)
            n0 = swslice.LAUNCHES
            with PlainCalls() as plain:
                frame = api.render(scene, cfg)
                loss = (frame.rgba ** 2).mean() + (frame.grad ** 2).mean()
                gr = torch.autograd.grad(loss, [g, alpha, verts])
            if grid.is_cuda and (swslice.LAUNCHES - n0 != 1 or plain.n):
                raise SystemExit("geometry backward: the frame did not "
                                 "launch the kernel once")
            grads.append([x.cpu() for x in gr])
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(*grads)]
        worst = max([worst] + errs)
        ok = max(errs) <= 1e-3 and all(float(b.abs().max()) > 0
                                       for b in grads[1])
        log(f"geometry backward 64^3 f32 sphere {shading}: card vs CPU "
            f"gradient, normalised max error grid {errs[0]:.2e}, alpha "
            f"{errs[1]:.2e}, vertices {errs[2]:.2e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("geometry backward: the card's gradient "
                             "disagrees with the CPU's")
    return worst


MV_CAMERA = dict(from_=(1.05, 0.5, -2.2), at=(1.05, 0.5, 0.5), fovy=45.0)


def multivol_scene(grid, grid2):
    """The multi-volume headline: `grid` in [0,1]^3 with the bench TF and
    `grid2` in [1.1, 2.1] x [0,1] x [0,1] with a second TF."""
    import numpy as np
    from ovr_tpu_torch.core.scene import (Camera, StructuredVolume,
                                          TransferFunction, VolumeInstance)
    dev = grid.device
    scene = make_scene(grid, "bench", "persp")
    tfn2 = TransferFunction.create(
        np.stack([np.linspace(0.2, 1.0, 16), np.linspace(1.0, 0.3, 16),
                  np.full(16, 0.4)], -1),
        np.linspace(0.0, 0.8, 16) ** 2, scene.tfn.value_range, device=dev)
    inst = VolumeInstance.create(StructuredVolume.create(
        grid2, world_lo=(1.1, 0.0, 0.0), world_hi=(2.1, 1.0, 1.0),
        device=dev), tfn2)
    return dataclasses.replace(scene, instances=(inst,),
                               camera=Camera.create(**MV_CAMERA, device=dev))


def multivol_headline(grid, smi):
    """The 1024^3 bf16 volume and a 512^3 bf16 instance of the same field
    through method="auto" at 1920x1080, rate 1024, none and diffuse: a
    plan per volume (cfg.sw a 2-tuple), two kernel launches a frame,
    frame ms (1 warm-up, 5 timed) and peak memory. Counts set to 0 just
    before, read just after."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    grid2 = field(512, "bench", grid.device).to(torch.bfloat16)
    scene = multivol_scene(grid, grid2)
    results, launches = {}, 0
    for shading in ("none", "diffuse"):
        cfg = api.RenderConfig(width=1920, height=1080, sampling_rate=1024.0,
                               shading=shading,
                               method="auto").resolved(scene)
        if not (isinstance(cfg.sw, tuple) and len(cfg.sw) == 2):
            raise SystemExit("multi-volume: no pair of shear-warp plans")
        swslice.LAUNCHES = 0
        with PlainCalls() as plain:
            frame = api.render(scene, cfg)
            torch.cuda.synchronize()
            check_frame(f"multi-volume {shading}", frame, 1920, 1080)
            alpha_mean = float(frame.rgba[..., 3].mean())
            del frame
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: api.render(scene, cfg), 5)
            peak = torch.cuda.max_memory_allocated()
        n = swslice.LAUNCHES
        if (n, plain.n) != (2 * 6, 0):
            raise SystemExit(f"multi-volume {shading}: {n} kernel launches "
                             f"and {plain.n} plain calls for 6 frames")
        launches += n
        results[shading] = dict(frame_ms=ms, peak_bytes=peak, launches=n,
                                alpha_mean=alpha_mean,
                                mrays_s=1920 * 1080 / (ms * 1e-3) / 1e6)
        log(f"multi-volume headline {shading:7s} 1920x1080 1024^3 + 512^3 "
            f"bf16 rate 1024 auto: frame {ms:.2f} ms "
            f"({results[shading]['mrays_s']:.2f} Mrays/s), 2 launches a "
            f"frame, peak memory {peak / 2**30:.2f} GiB, mean alpha "
            f"{alpha_mean:.3f}; {smi}")
    del grid2, scene
    return results, launches


def multivol_parity(grids):
    """The multi-volume frame (64^3 and a 32^3 instance, 160x90, none and
    diffuse, auto: two plans) and the march over both volumes, card
    against CPU: rgba and normals within 1e-4, depth 5e-4."""
    import torch
    from ovr_tpu_torch import api
    worst = 0.0
    g64 = grids[(64, "f32", "bench")]
    g32 = field(32, "bench", g64.device)
    for method, shading in (("auto", "none"), ("auto", "diffuse"),
                            ("march", "diffuse")):
        frames = []
        for a, b in ((g64, g32), (g64.cpu(), g32.cpu())):
            scene = multivol_scene(a, b)
            cfg = api.RenderConfig(width=160, height=90, sampling_rate=64.0,
                                   shading=shading,
                                   method=method).resolved(scene)
            if (method == "auto") != isinstance(cfg.sw, tuple):
                raise SystemExit("multi-volume parity: wrong plan")
            frames.append(api.render(scene, cfg))
        e = [float((getattr(frames[0], k).cpu() - getattr(frames[1], k))
                   .abs().max()) for k in ("rgba", "grad", "depth")]
        worst = max(worst, *e)
        ok = e[0] <= 1e-4 and e[1] <= 1e-4 and e[2] <= 5e-4
        log(f"multi-volume parity 64^3 + 32^3 {method} {shading}: card vs "
            f"CPU rgba {e[0]:.2e} normals {e[1]:.2e} depth {e[2]:.2e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("multi-volume: the card disagrees with the CPU")
    return worst


def sparse_frames(scene, cfg):
    """Two frames of a `Renderer` with sparse sampling on and the focus
    (0.5, 0.5), 0.2, 0.1: (frames, their sample indices, ms each)."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.render import sparse
    r = api.Renderer(scene, cfg)
    r.set_sparse_sampling(True)
    r.set_focus((0.5, 0.5), 0.2, 0.1)
    frames, idx, ms = [], [], []
    cuda = scene.device.type == "cuda"
    for i in (1, 2):
        if cuda:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record()
        r.render()
        if cuda:
            marks[1].record()
            torch.cuda.synchronize()
            ms.append(marks[0].elapsed_time(marks[1]))
        frames.append(r._frame)
        idx.append(sparse.select_samples(
            None, cfg.width, cfg.height, r._focus, i,
            cfg.width * cfg.height // 8))
    return frames, idx, ms


def check_sparse(label, frames, idx, width, height):
    """The second frame is the first with the second's samples written:
    outside them it keeps the first's pixels."""
    import torch
    keep = torch.ones(height * width, dtype=torch.bool,
                      device=idx[1].device)
    keep[idx[1]] = False
    same = torch.equal(frames[1].rgba.reshape(-1, 4)[keep],
                       frames[0].rgba.reshape(-1, 4)[keep])
    new = float(frames[1].rgba.reshape(-1, 4)[idx[1], 3].max())
    if not same or not new > 0 or len(idx[1]) != width * height // 8:
        raise SystemExit(f"sparse {label}: the second frame is not the "
                         f"first with its samples scattered in")


def sparse_headline(grid, smi):
    """Renderer with sparse sampling on the 1024^3 bf16 volume, 1920x1080,
    method="march", fast_math, macrocells, diffuse, rate 1024: a budget
    of W*H/8 = 259 200 rays a frame; two frames timed, the second
    scattered into the first. Held against the CPU at 64^3 (160x90):
    the same indices, rgba within 1e-4."""
    import torch
    from ovr_tpu_torch.render import integrator as ig
    scene = make_scene(grid, "bench", "persp")
    cfg = march_cfg(scene, "diffuse")
    s0 = ig.STEPS
    torch.cuda.reset_peak_memory_stats()
    frames, idx, ms = sparse_frames(scene, cfg)
    check_sparse("headline", frames, idx, 1920, 1080)
    check_frame("sparse", frames[1], 1920, 1080, min_alpha=0.1)
    res = dict(frame_ms=ms, rays=len(idx[1]), steps=ig.STEPS - s0,
               peak_bytes=torch.cuda.max_memory_allocated(),
               mrays_s=[len(idx[1]) / (t * 1e-3) / 1e6 for t in ms])
    small = {}
    for g in (field(64, "bench", grid.device),
              field(64, "bench", grid.device).cpu()):
        sc = make_scene(g, "bench", "persp")
        small[g.device.type] = sparse_frames(sc, march_cfg(
            sc, "diffuse", 160, 90, 64.0))
    (fc, ic, _), (fh, ih, _) = small["cuda"], small["cpu"]
    same_idx = all(torch.equal(a.cpu(), b) for a, b in zip(ic, ih))
    err = max(float((a.rgba.cpu() - b.rgba).abs().max())
              for a, b in zip(fc, fh))
    check_sparse("64^3", fc, ic, 160, 90)
    res.update(parity_64_same_indices=same_idx, parity_64_rgba_err=err)
    ok = same_idx and err <= 1e-4
    log(f"sparse headline 1920x1080 1024^3 bf16 march fast_math diffuse: "
        f"{res['rays']} rays a frame, frames "
        f"{', '.join(f'{t:.0f}' for t in ms)} ms "
        f"({', '.join(f'{x:.3f}' for x in res['mrays_s'])} Mrays/s), "
        f"{res['steps']} steps in the two, peak memory "
        f"{res['peak_bytes'] / 2**30:.2f} GiB; 64^3 160x90 card vs CPU: "
        f"indices {'equal' if same_idx else 'DIFFER'}, rgba {err:.2e} "
        f"{'ok' if ok else 'FAIL'}; {smi}")
    if not ok:
        raise SystemExit("sparse: the card disagrees with the CPU")
    return res


# ---------------------------------------------------------------------------
# scene files and path tracing
# ---------------------------------------------------------------------------

IO_FRAMES = 5  # timed Renderer frames of a loaded scene (after a warm-up)
# the bench.py camera in a VIDI3D file (world box [0, 1]^3 by "scales")
BENCH_LIGHT = (-907.108, 2205.875, -400.0267)  # toward the light


RAW_TYPES = {"u8": "UNSIGNED_BYTE", "u16": "UNSIGNED_SHORT"}


def scene_files(grid, tmp):
    """bench.py's field as an UNSIGNED_BYTE (or, for a u16 grid,
    UNSIGNED_SHORT) little-endian raw file with a VIDI3D JSON
    (scales 1/n: the world box [0, 1]^3; the bench camera; a 256-entry
    base64 alpha table (its ends above 0.01 or 0, which the reader's
    end-bin cleanup keeps) and colour controls at the table's sample
    positions, so both rasterize to the arrays given; a directional
    light; sampleDistance 1/n) and a USDA settings file pointing at it
    that restates the camera and light (USD's light direction points
    away from the light). Returns (raw, json, usda paths, color, alpha)."""
    import base64
    import numpy as np
    n = grid.shape[0]
    raw = os.path.join(tmp, "field.raw")
    grid.cpu().numpy().tofile(raw)
    k = 256
    alpha = np.linspace(0.0, 1.0, k, dtype=np.float32) ** 1.2
    x = (np.arange(k) + 0.5) / k
    color = np.stack([x, np.full(k, 0.5), 1.0 - x], -1).astype(np.float32)
    cam = CAMERAS["persp"]
    doc = {
        "version": "VIDI3D",
        "dataSource": [{
            "format": "REGULAR_GRID_RAW_BINARY", "fileName": ["field.raw"],
            "dimensions": {"x": n, "y": n, "z": n},
            "type": RAW_TYPES[storage(grid)],
            "offset": 0, "endian": "LITTLE_ENDIAN",
            "scales": {"x": 1 / n, "y": 1 / n, "z": 1 / n}}],
        "view": {
            "camera": {"eye": dict(zip("xyz", cam["from_"])),
                       "center": dict(zip("xyz", cam["at"])),
                       "up": {"x": 0, "y": 1, "z": 0}, "fovy": cam["fovy"]},
            "lightSource": {"type": "DIRECTIONAL_LIGHT",
                            "position": dict(zip("xyz", BENCH_LIGHT)),
                            "diffuse": {"r": 1, "g": 1, "b": 1}},
            "volume": {
                "sampleDistance": 1 / n,
                "scalarMappingRange": {"minimum": 0.0, "maximum": 1.0},
                "transferFunction": {
                    "alphaArray": {"encoding": "BASE64", "data":
                                   base64.b64encode(alpha.astype("<f4")
                                                    .tobytes()).decode()},
                    "colorControls": [
                        {"position": float(p), "color": dict(zip(
                            "rgb", (float(c) for c in rgb)))}
                        for p, rgb in zip(x, color)]}}}}
    js = os.path.join(tmp, "scene.json")
    with open(js, "w") as f:
        json.dump(doc, f)
    usda = os.path.join(tmp, "scene.usda")
    fmt = ", ".join
    with open(usda, "w") as f:
        f.write(f"""#usda 1.0
def "scene" {{
    def "rendering" {{
        int use_dda = 1
        bool simple_path_tracing = False
    }}
    def "volume" {{
        string data_path = "scene.json"
    }}
    def "camera" {{
        float3 from = ({fmt(str(v) for v in cam['from_'])})
        float3 at = ({fmt(str(v) for v in cam['at'])})
        float3 up = (0, 1, 0)
    }}
    def "light" {{
        def "ambient" {{
            def "sky" {{
                float intensity = 1
            }}
        }}
        def "directional" {{
            def "sun" {{
                float intensity = 1
                float3 direction = ({fmt(str(-v) for v in BENCH_LIGHT)})
                float3 color = (1, 1, 1)
            }}
        }}
    }}
}}
""")
    return raw, js, usda, color, alpha


def scene_io(smi, dt="u8"):
    """Scene files on the card: bench.py's field at 1024^3 written as a
    raw of `dt` counts (`quantized`: "u8" a 1 GiB UNSIGNED_BYTE raw,
    "u16" a 2 GiB UNSIGNED_SHORT one) with a VIDI3D JSON and, for u8, a
    USDA settings file (`scene_files`, in a temporary directory removed
    after), each loaded through `io.create_scene(..., device="cuda")`
    (load time printed). The grid must arrive in its type on the card,
    equal to `np.fromfile` of the file. The JSON scene renders through
    `Renderer` at 1920x1080, method="auto", diffuse, macrocells on:
    frame ms (IO_FRAMES after a warm-up), Mrays/s, peak memory; the
    slice kernel launched once a frame (counts set to 0 just before,
    read after), its plain version never. The frame must equal, bit for
    bit, `api.render` of a scene built directly from the same arrays,
    and the USDA scene's frame."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from ovr_tpu_torch import api, io
    from ovr_tpu_torch.core.scene import (Camera, Light, Scene,
                                          StructuredVolume, TransferFunction)
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import accel
    grid = quantized(field(1024, "bench", "cuda"), dt)
    on_file = {"u8": np.uint8, "u16": np.dtype("<u2")}[dt]
    bits = {"u8": torch.int8, "u16": torch.int16}[dt]  # compared as these
    tmp = tempfile.mkdtemp(prefix="ovr_scene_")
    try:
        t0 = time.perf_counter()
        raw, js, usda, color, alpha = scene_files(grid, tmp)
        write_s = time.perf_counter() - t0
        scenes, load_s = {}, {}
        for label, path in (("vidi3d", js), ("usda", usda))[
                :2 if dt == "u8" else 1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scenes[label] = io.create_scene(path, device="cuda")
            torch.cuda.synchronize()
            load_s[label] = time.perf_counter() - t0
        on_disk = torch.from_numpy(np.fromfile(raw, on_file)).cuda()
    finally:
        shutil.rmtree(tmp)
    for label, sc in scenes.items():
        gl = sc.volume.grid
        if not (gl.dtype == grid.dtype and gl.is_cuda
                and torch.equal(gl.reshape(-1).view(bits),
                                on_disk.view(bits))):
            raise SystemExit(f"scene io: the {label} grid is not the file's "
                             f"values as {grid.dtype} on the card")
    del on_disk
    scene = scenes["vidi3d"]
    rate = float(scene.volume_sampling_rate)
    r = api.Renderer(scene, api.RenderConfig(
        width=1920, height=1080, sampling_rate=rate, shading="diffuse",
        method="auto", use_macrocells=True))
    swslice.LAUNCHES = 0
    with PlainCalls() as plain:
        r.render()
        torch.cuda.synchronize()
        check_frame("scene io", r._frame, 1920, 1080)
        torch.cuda.reset_peak_memory_stats()
        frame_ms = cuda_ms(r.render, IO_FRAMES)
        peak = torch.cuda.max_memory_allocated()
    launches = swslice.LAUNCHES
    if (launches, plain.n) != (1 + IO_FRAMES, 0) or r._cfg.sw is None:
        raise SystemExit(f"scene io: {launches} kernel launches and "
                         f"{plain.n} plain calls for {1 + IO_FRAMES} frames")
    dev = grid.device
    direct = Scene.create(
        StructuredVolume.create(grid, world_hi=(1.0, 1.0, 1.0), device=dev),
        TransferFunction.create(color, alpha, (0.0, 1.0), device=dev),
        light=Light.create(direction=BENCH_LIGHT, position=BENCH_LIGHT,
                           kind="directional", device=dev),
        camera=Camera.create(**CAMERAS["persp"], device=dev),
        volume_sampling_rate=rate)
    mc = accel.build_macrocells(grid, direct.tfn.alpha,
                                direct.tfn.value_range)
    ref = api.render(direct, r._cfg, macrocells=mc)
    frames = {"direct": r._frame}
    if "usda" in scenes:
        ru = api.Renderer(scenes["usda"], r._cfg)
        ru.render()
        frames["usda"] = ru._frame
    same = {k: all(torch.equal(getattr(f, c), getattr(ref, c))
                   for c in ("rgba", "grad", "depth"))
            for k, f in frames.items()}
    res = dict(write_s=write_s, load_s=load_s, frame_ms=frame_ms,
               mrays_s=1920 * 1080 / (frame_ms * 1e-3) / 1e6,
               peak_bytes=peak, launches=launches,
               bit_identical=same, axis=r._cfg.sw.axis,
               alpha_mean=float(ref.rgba[..., 3].mean()))
    gib = grid.numel() * grid.element_size() / 2**30
    log(f"scene io 1024^3 {dt} ({gib:.0f} GiB {RAW_TYPES[dt]} raw): "
        f"written in {write_s:.1f} s, loaded onto the card in " + " and ".join(
            f"{v:.2f} s ({k})" for k, v in load_s.items())
        + f", {grid.dtype}, equal to the file; Renderer 1920x1080 auto "
        f"diffuse: frame {frame_ms:.2f} ms, {res['mrays_s']:.2f} Mrays/s, "
        f"peak memory {peak / 2**30:.2f} GiB, {launches} kernel launches "
        f"for {1 + IO_FRAMES} frames, no plain call; bit for bit against "
        f"a directly built scene: {'yes' if same['direct'] else 'NO'}"
        + (f", the USDA scene's frame: {'yes' if same['usda'] else 'NO'}"
           if "usda" in same else "") + f"; {smi}")
    if not all(same.values()):
        raise SystemExit("scene io: a loaded scene renders other bits than "
                         "the directly built one")
    return res


def pt_cfg(scene, width, height, rate, dense, **kw):
    """bench.py's BENCH_PT config (mc: macrocell DDA; dense: auto with
    the 128-lattice solver, 14 directions), max_scatters 24."""
    from ovr_tpu_torch import api
    kw = dict(dict(fast_math=True, use_macrocells=True, method="auto",
                   max_scatters=24), **kw)
    return api.RenderConfig(
        width=width, height=height, spp=kw.pop("spp", 1), sampling_rate=rate,
        shading="diffuse", path_tracing=True, pt_dense=dense,
        **kw).resolved(scene)


class NoSliceLoop:
    """Inside the block, fail on any slice-kernel launch and count plain
    slice-loop calls on the card (path-traced frames run neither)."""

    def __enter__(self):
        from ovr_tpu_torch.ops import swslice
        self.n0, self.b0 = swslice.LAUNCHES, swslice.LAUNCHES_BF16
        self.plain = PlainCalls().__enter__()
        return self

    def __exit__(self, *exc):
        from ovr_tpu_torch.ops import swslice
        self.plain.__exit__(*exc)
        if exc[0] is None and (swslice.LAUNCHES != self.n0
                               or swslice.LAUNCHES_BF16 != self.b0
                               or self.plain.n):
            raise SystemExit("a path-traced frame ran the slice loop")


def bf16_frame_rule(a, b):
    """The sw_bf16 rule for a dense frame rendered on two devices (a, b):
    every rgba value within two bf16 ulps (2 * 2^-7) of the largest rgba
    value, every depth within two bf16 ulps of the largest depth. The
    two devices form the frame's positions (camera basis, plane
    schedule, fan) an f32 ulp apart in places (CUDA divides a tensor by a
    host scalar through its reciprocal; tanf, rsqrt); where a gather
    operand's bf16 rounding sits at a tie, that ulp moves the rounded
    operand by one bf16 ulp, and a pixel whose planes meet more than one
    such tie moves by more than one. The arithmetic itself is held by
    the gather on the card's own inputs (`capture_gather`). Returns
    (ok, stats)."""
    dr = float((a.rgba.cpu() - b.rgba).abs().max())
    dd = float((a.depth.cpu() - b.depth).abs().max())
    st = dict(rgba_max=dr, rgba_bound=2.0 ** -6 * float(b.rgba.abs().max()),
              depth_max=dd,
              depth_bound=2.0 ** -6 * float(b.depth.abs().max()))
    return dr <= st["rgba_bound"] and dd <= st["depth_bound"], st


def capture_gather(scene, cfg, fields):
    """Render a dense frame; return it and the dense gather's `over_scan`
    call (step function, steps, inputs)."""
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import adjoint
    seen = {}
    orig = adjoint.over_scan

    def spy(f, n, params):
        seen.update(f=f, n=n, params=params)
        return orig(f, n, params)

    adjoint.over_scan = spy
    try:
        frame = api.render(scene, cfg, pt_fields=fields)
    finally:
        adjoint.over_scan = orig
    return frame, seen


def pt_parity():
    """Path tracing at 64^3 (bench field and scene, 96x64, rate 64), card
    against CPU: the MC tracker with the global majorant and with the
    macrocell DDA (spp 2, max_scatters 24, draws from a CPU generator of
    the same seed on both, as api._rand does): rgba within 1e-4 but for
    pixels whose path flips at an acceptance tie (at most 0.5%); the
    dense solver (pt_lattice 32): sigma and J of `prepare` within 1e-4
    of their largest element, the gather on the card's own inputs run on
    the CPU within 1e-4 (f32 and sw_bf16), the frame within 1e-4 (rgba)
    and 5e-4 (depth), under sw_bf16 within two bf16 ulps of the largest
    value (`bf16_frame_rule`). No frame runs the slice loop."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import adjoint
    from ovr_tpu_torch.render import accel, ptdense
    out = {}
    g = field(64, "bench", "cuda")
    scenes = {g.device.type: make_scene(g, "bench", "persp"),
              "cpu": make_scene(g.cpu(), "bench", "persp")}
    mcs = {d: accel.build_macrocells(s.volume.grid, s.tfn.alpha,
                                     s.tfn.value_range)
           for d, s in scenes.items()}
    with NoSliceLoop():
        for label, dda in (("mc global", False), ("mc dda", True)):
            frames = {}
            for d, s in scenes.items():
                cfg = pt_cfg(s, 96, 64, 64.0, False, spp=2,
                             use_macrocells=dda)
                frames[d] = api.render(s, cfg, macrocells=mcs[d],
                                       generator=torch.Generator()
                                       .manual_seed(7)).rgba
            diff = (frames["cuda"].cpu() - frames["cpu"]).abs().amax(-1)
            flips = int((diff > 1e-4).sum())
            out[label] = dict(flipped_pixels=flips,
                              flipped_share=flips / diff.numel(),
                              max_abs=float(diff.max()),
                              rgb_mean=float(frames["cpu"][..., :3].mean()))
            log(f"pt parity 64^3 {label}: {flips} of {diff.numel()} pixels "
                f"beyond 1e-4 (acceptance ties; largest {diff.max():.2e}), "
                f"mean rgb {out[label]['rgb_mean']:.4f}")
            if flips > 0.005 * diff.numel():
                raise SystemExit(f"pt parity {label}: card and CPU differ")
        fields = {}
        for bf16 in (False, True):
            res, cap = {}, None
            for d, s in scenes.items():
                cfg = pt_cfg(s, 96, 64, 64.0, True, pt_lattice=32,
                             sw_bf16=bf16)
                if cfg.sw is None:
                    raise SystemExit("pt parity: no plan for the dense frame")
                if d not in fields:
                    fields[d] = ptdense.prepare(s, cfg)
                res[d], seen = capture_gather(s, cfg, fields[d])
                cap = cap or seen  # the card's, first
            errs = {}
            if not bf16:
                for i, name in enumerate(("sigma", "J")):
                    c, h = fields["cuda"][i].cpu(), fields["cpu"][i]
                    errs[name] = float((c - h).abs().max() / h.abs().max())
            host = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                    for k, v in cap["params"].items()}
            vc, tc = adjoint.over_scan(cap["f"], cap["n"], cap["params"])
            vh, th = adjoint.over_scan(cap["f"], cap["n"], host)
            errs["gather_same_inputs"] = max(
                float((vc.cpu() - vh).abs().max()),
                float((tc.cpu() - th).abs().max()))
            c, h = res["cuda"], res["cpu"]
            if bf16:
                ok, st = bf16_frame_rule(c, h)
                errs.update(st)
            else:
                errs["rgba"] = float((c.rgba.cpu() - h.rgba).abs().max())
                errs["depth"] = float((c.depth.cpu() - h.depth).abs().max())
                ok = (errs["rgba"] <= 1e-4 and errs["depth"] <= 5e-4
                      and errs["sigma"] <= 1e-4 and errs["J"] <= 1e-4)
            ok = (ok and errs["gather_same_inputs"] <= 1e-4
                  and float(h.rgba[..., 3].max()) > 0.3)
            label = "dense bf16" if bf16 else "dense"
            out[label] = errs
            log(f"pt parity 64^3 {label} (lattice 32): "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"pt parity {label}: card and CPU differ")
    return out


def check_pt_frame(label, frame, scene, cfg, dense):
    """tests/test_pathtracer.py's frame checks: finite, rgb <= ambient;
    the MC alpha is 1 exactly on the rays that hit the box and 0
    elsewhere; the dense alpha (the composite, anti-aliased by the warp)
    in [0, 1], on the box's pixels 0.05 or more on average, off them
    below 0.02."""
    import torch
    from ovr_tpu_torch.core.sampling import intersect_box
    from ovr_tpu_torch.render.camera import generate_rays, pixel_screen_coords
    rgba = frame.rgba
    screen = pixel_screen_coords(cfg.width, cfg.height, cfg.dtype,
                                 rgba.device).reshape(-1, 2)
    org, d = generate_rays(scene.camera, screen, cfg.width, cfg.height)
    t0 = torch.zeros(org.shape[0], device=org.device)
    t0, t1 = intersect_box(org, d, scene.volume.world_lo,
                           scene.volume.world_hi, t0,
                           torch.full_like(t0, 3.4e38))
    box = (t1 > torch.clamp(t0, min=0.0)).reshape(cfg.height, cfg.width)
    a = rgba[..., 3]
    amb = float(scene.light.ambient)
    ok = (bool(torch.isfinite(rgba).all())
          and float(rgba[..., :3].max()) <= amb + 1e-5
          and float(rgba[..., :3].min()) >= 0.0)
    if dense:
        ok = ok and float(a.min()) >= 0.0 and float(a.max()) <= 1.0 \
            and float(a[~box].mean()) < 0.02 and float(a[box].mean()) > 0.05
    else:
        ok = ok and bool(torch.equal(a, box.to(a.dtype)))
    if not ok:
        raise SystemExit(f"{label} frame failed its checks")
    return float(a[box].mean())


def pt_headline(grid, smi):
    """Path tracing at the headline: the 1024^3 bf16 volume, 1920x1080,
    the bench camera, through `api.render`. Dense (BENCH_PT=dense):
    `prepare` timed once, then one checked frame (CUDA events). MC
    (BENCH_PT=mc: macrocell DDA, spp 1): a frame at 240x135 under the
    profiler, then one checked frame at 1080p, with the tracker's
    iterations per level. Each: ms, Mrays/s, peak memory, the frame
    checks; no frame runs the slice loop. The bench phase times both
    warm (BENCH_PT=dense, mc: 1 + 2 frames)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ovr_tpu_torch import api
    from ovr_tpu_torch.render import accel, pathtracer, ptdense
    scene = make_scene(grid, "bench", "persp")
    mc = accel.build_macrocells(grid, scene.tfn.alpha, scene.tfn.value_range)
    res = {}
    with NoSliceLoop():
        cfg = pt_cfg(scene, 1920, 1080, 1024.0, True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fields = ptdense.prepare(scene, cfg)
        torch.cuda.synchronize()
        prep_ms = (time.perf_counter() - t0) * 1e3
        prep_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
        frame = api.render(scene, cfg, pt_fields=fields)
        marks[1].record()
        torch.cuda.synchronize()
        ms = marks[0].elapsed_time(marks[1])
        alpha_box = check_pt_frame("pt dense", frame, scene, cfg, True)
        del frame
        res["dense"] = dict(
            prepare_ms=prep_ms, prepare_peak_bytes=prep_peak, frame_ms=ms,
            mrays_s=1920 * 1080 / (ms * 1e-3) / 1e6,
            peak_bytes=torch.cuda.max_memory_allocated(),
            lattice=tuple(fields[0].shape), n_slices=cfg.sw.n_slices,
            fan=(cfg.sw.inter_h, cfg.sw.inter_w), alpha_mean_box=alpha_box)
        log(f"pt headline dense 1920x1080 1024^3 bf16 (lattice "
            f"{fields[0].shape[0]}^3, 14 directions, 12 levels, "
            f"{cfg.sw.n_slices} planes): prepare {prep_ms:.0f} ms (peak "
            f"{prep_peak / 2**30:.2f} GiB), frame {ms:.1f} ms "
            f"(the first after prepare), "
            f"{res['dense']['mrays_s']:.2f} Mrays/s, peak memory "
            f"{res['dense']['peak_bytes'] / 2**30:.2f} GiB; {smi}")
        del fields
        # a 240x135 frame under torch.profiler: launches per tracker
        # iteration
        small = pt_cfg(scene, 240, 135, 1024.0, False)
        pathtracer.LEVEL_STEPS.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            api.render(scene, small, macrocells=mc)
            torch.cuda.synchronize()
        small_iters = sum(pathtracer.LEVEL_STEPS)
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        cfg = pt_cfg(scene, 1920, 1080, 1024.0, False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pathtracer.LEVEL_STEPS.clear()
        t0 = time.perf_counter()
        frame = api.render(scene, cfg, frame_index=1, macrocells=mc)
        torch.cuda.synchronize()
        times = [(time.perf_counter() - t0) * 1e3]
        levels = [list(pathtracer.LEVEL_STEPS)]
        check_pt_frame("pt mc", frame, scene, cfg, False)
        rgb_mean = float(frame.rgba[..., :3].mean())
        del frame
        med = times[0]
        res["mc"] = dict(frame_ms=times, mrays_s=1920 * 1080 / (med * 1e-3)
                         / 1e6, iterations_per_level=levels,
                         max_track_steps=max(cfg.max_steps * 2, 64),
                         peak_bytes=torch.cuda.max_memory_allocated(),
                         rgb_mean=rgb_mean, launches_240x135=launches,
                         iterations_240x135=small_iters,
                         launches_per_iteration=launches / max(small_iters,
                                                               1))
        log(f"pt headline mc 1920x1080 1024^3 bf16 (macrocell DDA, spp 1, "
            f"max_scatters 24): frames {', '.join(f'{t:.0f}' for t in times)}"
            f" ms, {res['mc']['mrays_s']:.3f} Mrays/s, tracker iterations "
            f"per level {levels} (bound {res['mc']['max_track_steps']}), "
            f"peak memory {res['mc']['peak_bytes'] / 2**30:.2f} GiB, mean "
            f"rgb {rgb_mean:.4f}; the 240x135 frame: {launches} kernel "
            f"launches in {small_iters} iterations "
            f"({res['mc']['launches_per_iteration']:.1f} an iteration, the "
            f"frame's setup included); {smi}")
    return res


def pt_dense_vs_mc():
    """tests/test_pathtracer.py's dense-vs-MC rule on the card: the
    smooth 64^3 field of that test with its TF and camera, 48x48, rate
    64, MC spp 32 (global majorant), max_scatters 8 (5 levels), dense
    with the default lattice (64^3 here): over the interior, mean
    |premultiplied rgb difference| < 0.035 and energy within 20%."""
    import numpy as np
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.core.scene import (Camera, Scene, StructuredVolume,
                                          TransferFunction)
    t0 = time.perf_counter()
    ax = torch.linspace(0, 1, 64, device="cuda")
    grid = (0.5 + 0.5 * torch.sin(5 * ax)[None, None, :]
            * torch.cos(4 * ax)[None, :, None]
            * torch.sin(3 * ax)[:, None, None])
    tfn = TransferFunction.create(
        np.stack([np.linspace(0.2, 1.0, 8), np.full(8, 0.6),
                  np.linspace(1.0, 0.2, 8)], -1),
        np.linspace(0, 1, 8) ** 1.5, (0.0, 1.0))
    scene = Scene.create(StructuredVolume.create(grid), tfn,
                         camera=Camera.create(from_=(0.5, 0.5, -1.8),
                                              at=(0.5, 0.5, 0.5), fovy=40.0))
    with NoSliceLoop():
        cfg = pt_cfg(scene, 48, 48, 64.0, False, spp=32, max_scatters=8,
                     use_macrocells=False)
        mc = api.render(scene, cfg, frame_index=5).rgba.cpu().numpy()
        cfg = pt_cfg(scene, 48, 48, 64.0, True, max_scatters=8)
        de = api.render(scene, cfg).rgba.cpu().numpy()
    mc_pm, de_pm = mc[..., :3] * mc[..., 3:], de[..., :3] * de[..., 3:]
    inside = mc[..., 3] > 0.999
    inside[:3] = inside[-3:] = False
    inside[:, :3] = inside[:, -3:] = False
    err = float(np.abs(de_pm - mc_pm)[inside].mean())
    energy = float(de_pm[inside].sum() / mc_pm[inside].sum())
    sec = time.perf_counter() - t0
    ok = inside.sum() > 100 and err < 0.035 and abs(energy - 1.0) < 0.2
    log(f"pt dense vs mc 64^3 48x48 (mc spp 32, max_scatters 8): mean "
        f"|premultiplied rgb difference| {err:.4f} over {inside.sum()} "
        f"interior pixels (< 0.035), dense/mc energy {energy:.4f} "
        f"(within 20%), {sec:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the dense path tracer disagrees with the MC mean")
    return dict(mean_abs_err=err, energy_ratio=energy, seconds=sec,
                pixels=int(inside.sum()))


# ---------------------------------------------------------------------------
# neural-field volumes (the baked proxy through the slice kernel)
# ---------------------------------------------------------------------------

# the small hash grid of tests/test_neural.py for the card-vs-CPU cases
NEURAL_SMALL = dict(n_levels=4, log2_table_size=12, base_resolution=4,
                    max_resolution=32)
NEURAL_FIT_STEPS = 300  # fit_to_grid steps at batch 2^14 (the headline)
NEURAL_FRAMES = 3  # timed Renderer frames per shading (after a warm-up)


def neural_small_scene(device, compute_dtype=None, scale=1e4, proxy=24):
    """A small field (NEURAL_SMALL, 16 hidden units) with its tables
    scaled by `scale` so that it varies (the ngp init is constant to
    ~1e-4), made on the CPU from seed 7 and copied to `device`, in
    tests/test_neural.py's scene."""
    import numpy as np
    import torch
    from ovr_tpu_torch.core.scene import Camera, Scene, TransferFunction
    from ovr_tpu_torch.neural import HashGridConfig, init_field
    field = init_field(7, HashGridConfig(**NEURAL_SMALL), hidden=16,
                       n_hidden=1, device="cpu",
                       compute_dtype=compute_dtype or torch.float32)
    with torch.no_grad():
        field.tables.mul_(scale)
    field = field.to(device)
    tfn = TransferFunction.create(
        np.stack([np.linspace(0, 1, 8)] * 3, -1), np.linspace(0, 0.8, 8),
        (0.0, 1.0), device=device)
    cam = Camera.create(from_=(0.5, 0.5, -1.8), at=(0.5, 0.5, 0.5),
                        fovy=45.0, device=device)
    return Scene.create(field, tfn, camera=cam, volume_sampling_rate=24.0)


def neural_parity():
    """The neural modules on the card against the same on the CPU, at
    small size: encode and the field (f32 1e-6 / 1e-5; bf16 within 1e-5
    but for rounding ties, at most 1% of values and 2e-2), the host bake
    against the chunked bake (1e-6) and across devices (1e-5), proxy
    frames (auto at a 24^3 proxy: none, diffuse, shadow; each must launch
    the slice kernel once and never run its plain version on the card)
    and the exact field march (diffuse) at rgba 1e-4 / depth 1e-3, and
    the train step's gradients of the tables and weights within 1e-3 of
    the largest element. Returns the largest differences."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.neural import field_sample, hashgrid, train
    from ovr_tpu_torch.ops import swslice
    out = {}
    t0 = time.perf_counter()
    sc, sg = neural_small_scene("cpu"), neural_small_scene("cuda")
    fc, fg = sc.volume, sg.volume
    gen = torch.Generator().manual_seed(3)
    p = torch.rand((1 << 16, 3), generator=gen) * 1.2 - 0.1
    with torch.no_grad():
        e = float((hashgrid.encode(fg.tables, fg.grid_cfg, p.cuda()).cpu()
                   - hashgrid.encode(fc.tables, fc.grid_cfg, p)).abs().max())
        f = float((field_sample(fg, p.cuda()).cpu()
                   - field_sample(fc, p)).abs().max())
        bc = neural_small_scene("cpu", torch.bfloat16).volume
        bg = neural_small_scene("cuda", torch.bfloat16).volume
        d16 = (field_sample(bg, p.cuda()).cpu() - field_sample(bc, p)).abs()
        host = train.bake_grid_host(fg, (24, 40, 32), max_slab_points=24 * 40 * 5)
        traced = train.bake_grid(fg, (24, 40, 32), chunk=1000)
        b_tr = float((host - traced).abs().max())
        b_dev = float((host.cpu() - train.bake_grid_host(
            fc, (24, 40, 32), max_slab_points=24 * 40 * 5)).abs().max())
    ties = float((d16 > 1e-5).float().mean())
    out.update(encode=e, field_f32=f, field_bf16_max=float(d16.max()),
               field_bf16_tie_share=ties, bake_host_vs_chunked=b_tr,
               bake_card_vs_cpu=b_dev)
    ok = (e <= 1e-6 and f <= 1e-5 and ties <= 0.01
          and float(d16.max()) <= 2e-2 and b_tr <= 1e-6 and b_dev <= 1e-5)
    frames = {}
    for method, shading in (("auto", "none"), ("auto", "diffuse"),
                            ("auto", "shadow"), ("march", "diffuse")):
        kw = dict(width=32, height=24, sampling_rate=24.0, method=method,
                  shading=shading, neural_proxy_res=24)
        cc = api.RenderConfig(**kw).resolved(sc)
        cg = api.RenderConfig(**kw).resolved(sg)
        n0 = swslice.LAUNCHES
        with torch.no_grad(), PlainCalls() as plain:
            a = api.render(sc, cc)
            b = api.render(sg, cg)
            torch.cuda.synchronize()
        n = swslice.LAUNCHES - n0
        want = 1 if method == "auto" else 0
        err_c = float((b.rgba.cpu() - a.rgba).abs().max())
        err_d = float((b.depth.cpu() - a.depth).abs().max())
        frames[f"{method}-{shading}"] = dict(rgba=err_c, depth=err_d,
                                             launches=n)
        ok = (ok and (cg.sw is not None) == (method == "auto")
              and n == want and plain.n == 0 and err_c <= 1e-4
              and err_d <= 1e-3 and float(b.rgba[..., 3].max()) > 0.1)
    out["frames"] = frames
    grads = []
    for scene in (sc, sg):
        cfg = api.RenderConfig(width=32, height=24, sampling_rate=24.0,
                               method="auto", shading="diffuse",
                               neural_proxy_res=24).resolved(scene)
        step, state = train.make_image_train_step(scene, cfg, lr=1e-3)
        target = torch.zeros((24, 32, 4), device=scene.device)
        _, loss = step(state, scene.camera, target)
        grads.append([float(loss)] + [q.grad.detach().cpu()
                                      for q in scene.volume.parameters()])
    g_err = max(float((g - c).abs().max() / c.abs().max())
                for c, g in zip(grads[0][1:], grads[1][1:]))
    out.update(train_loss=(grads[0][0], grads[1][0]),
               train_grad_max_norm_err=g_err,
               seconds=time.perf_counter() - t0)
    ok = ok and g_err <= 1e-3 and abs(grads[0][0] - grads[1][0]) <= (
        1e-4 * abs(grads[0][0]))
    log(f"neural parity 24^3 card vs CPU: encode {e:.2e}, field f32 "
        f"{f:.2e}, bf16 {float(d16.max()):.2e} ({100 * ties:.2f}% beyond "
        f"1e-5), host bake vs chunked {b_tr:.2e}, bake card vs CPU "
        f"{b_dev:.2e}; frames " + ", ".join(
            f"{k} rgba {v['rgba']:.2e} depth {v['depth']:.2e} launches "
            f"{v['launches']}" for k, v in frames.items())
        + f"; train step loss {grads[0][0]:.6e} / {grads[1][0]:.6e}, "
        f"gradients {g_err:.2e} of the largest element "
        f"({out['seconds']:.1f} s) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the neural modules disagree between card and CPU")
    return out


def neural_kernel(label, scene, cfg, lg, full_frame_ms):
    """The slice kernel alone on a proxy frame's inputs: its time, the
    bound from this run's samples, and its band against the plain
    version (`band_check`). These launches are not the main path's."""
    from ovr_tpu_torch.ops import swslice
    args, kw = capture(scene, cfg, light_grid=lg)
    full = swslice.slice_composite(*args, **kw)
    cnt, (staged, direct, runs) = counted(args, kw, full)
    r = dict(frame_ms=full_frame_ms)
    r["kernel_ms"] = cuda_ms(lambda: swslice.slice_composite(*args, **kw), 5)
    (r["bound_ms"], r["bound_by"], r["samples"], r["bytes"],
     r["ops_per_sample"]) = bound(args, kw, cnt["pixel_samples"])
    r["share_of_bound"] = r["bound_ms"] / r["kernel_ms"]
    r["fan"] = (args[4].shape[0], args[3].shape[0])
    r["planes"] = args[6]
    r["planes_staged"], r["planes_direct"] = staged, direct
    r["planes_runs"] = runs
    band_check(label, r, args, kw, full)
    return r


def neural_profile(field, grid):
    """Kernel launches and device time (torch.profiler) of one
    `fit_to_grid` step at batch 2^14 (on a copy of the field) and of one
    2^24-point slab of the 512^3 bake (64 planes), against their wall
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ovr_tpu_torch.neural import train
    out = {}
    spare = copy.deepcopy(field)  # the fit step must not move `field`
    work = {"fit_step": lambda: train.fit_to_grid(spare, grid, steps=1),
            "bake_slab": lambda: train.bake_grid_host(field, (512, 512, 64))}
    for name, fn in work.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
        busy = sum(e.device_time_total for e in ev) / 1e3
        top = sorted(ev, key=lambda e: -e.device_time_total)[:3]
        out[name] = dict(launches=sum(e.count for e in ev), device_ms=busy,
                         wall_ms=wall, top=[(e.key[:60], e.device_time_total
                                             / 1e3) for e in top])
        log(f"neural profile {name}: {out[name]['launches']} kernel launches, "
            f"{busy:.2f} ms of kernels in {wall:.2f} ms wall under the "
            f"profiler; top: " + ", ".join(f"{k} {v:.2f} ms"
                                           for k, v in out[name]["top"]))
    return out


def neural_headline(grid, smi):
    """BASELINE config #4 at full width on the card: the default hash
    grid (12 levels x 2 features, 2^17 entries, resolutions 16-512) and a
    24-64-64-1 MLP from seed 0, fitted to bench.py's 1024^3 field (batch
    2^14, NEURAL_FIT_STEPS steps); the 512^3 proxy baked slab by slab;
    1080p rate-1024 frames through `Renderer` (auto, diffuse and shadow;
    the main path: the slice kernel once a frame, its counts zeroed just
    before); the kernel alone and against its plain version on the
    proxy; one inverse-rendering step at a 128^3 proxy; the exact field
    march at 480x270 (shading none) against the proxy frame, by
    tests/test_neural.py's rule (mean |rgba| < 0.05); and the unfitted
    field's frame (bench.py's BENCH_NEURAL=fwd)."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.core.scene import Camera
    from ovr_tpu_torch.neural import init_field, train
    from ovr_tpu_torch.neural.losses import l2
    from ovr_tpu_torch.ops import swslice
    res = {}
    dense = make_scene(grid, "bench", "persp")
    gen = torch.Generator().manual_seed(0)
    field = init_field(gen, hidden=64, n_hidden=2, device="cuda")
    unfitted = init_field(torch.Generator().manual_seed(0), hidden=64,
                          n_hidden=2, device="cuda")
    n_par = sum(q.numel() for q in field.parameters())

    # 1. fit to the 1024^3 field
    fit_gen = torch.Generator(device="cuda")
    fit_gen.manual_seed(0)
    from ovr_tpu_torch.render.pathtracer import GeneratorDraws
    train.fit_to_grid(field, grid, steps=2, draws=GeneratorDraws(fit_gen))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, losses = train.fit_to_grid(field, grid, steps=NEURAL_FIT_STEPS,
                                  draws=GeneratorDraws(fit_gen))
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3 / NEURAL_FIT_STEPS
    losses = losses.cpu()
    res["fit"] = dict(steps=NEURAL_FIT_STEPS, batch=1 << 14,
                      ms_per_step=fit_ms, loss_first=float(losses[0]),
                      loss_last=float(losses[-1]),
                      loss_last10_mean=float(losses[-10:].mean()),
                      peak_bytes=torch.cuda.max_memory_allocated(),
                      parameters=n_par)
    log(f"neural fit 1024^3 bf16 target, batch 2^14: {fit_ms:.2f} ms a step "
        f"({NEURAL_FIT_STEPS} steps after 2 warm-up), loss "
        f"{float(losses[0]):.4e} -> {float(losses[-1]):.4e} (last 10 "
        f"{res['fit']['loss_last10_mean']:.4e}), peak "
        f"{res['fit']['peak_bytes'] / 2**30:.2f} GiB, {n_par} parameters; "
        f"{smi}")
    if not (torch.isfinite(losses).all()
            and res["fit"]["loss_last10_mean"] < 0.5 * float(losses[0])):
        raise SystemExit("fit_to_grid did not fit the field")

    res["profile"] = neural_profile(field, grid)

    # 2. the 512^3 proxy, slab by slab
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proxy = train.bake_grid_host(field, (512, 512, 512))
    torch.cuda.synchronize()
    res["bake_512"] = dict(ms=(time.perf_counter() - t0) * 1e3,
                           peak_bytes=torch.cuda.max_memory_allocated(),
                           slabs=8, min=float(proxy.min()),
                           max=float(proxy.max()))
    log(f"neural bake 512^3 (bake_grid_host, 8 slabs of 2^24 points): "
        f"{res['bake_512']['ms']:.0f} ms, peak "
        f"{res['bake_512']['peak_bytes'] / 2**30:.2f} GiB, values "
        f"[{res['bake_512']['min']:.3f}, {res['bake_512']['max']:.3f}]")

    # 3. Renderer frames: the main path
    scene = dataclasses.replace(dense, volume=field)
    frames = {}
    swslice.LAUNCHES = swslice.LAUNCHES_BF16 = 0
    for shading in ("diffuse", "shadow"):
        cfg = api.RenderConfig(width=1920, height=1080, sampling_rate=1024.0,
                               method="auto", shading=shading)
        rend = api.Renderer(scene, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rend.commit()
        torch.cuda.synchronize()
        commit_ms = (time.perf_counter() - t0) * 1e3
        if rend._cfg.sw is None or rend._proxy_grid is None:
            raise SystemExit("the neural frame does not take the proxy's "
                             "shear-warp path")
        n0 = swslice.LAUNCHES
        with PlainCalls() as plain:
            rend.render()
            torch.cuda.reset_peak_memory_stats()
            rend.render_time = 0.0
            for _ in range(NEURAL_FRAMES):
                rend.render()
        ms = rend.render_time * 1e3 / NEURAL_FRAMES
        if swslice.LAUNCHES - n0 != 1 + NEURAL_FRAMES or plain.n:
            raise SystemExit(f"neural {shading}: {swslice.LAUNCHES - n0} "
                             f"kernel launches, {plain.n} plain calls")
        check_frame(f"neural {shading}", rend._frame, 1920, 1080)
        frames[shading] = dict(
            frame_ms=ms, mrays_s=1920 * 1080 / (ms * 1e-3) / 1e6,
            commit_ms=commit_ms, peak_bytes=torch.cuda.max_memory_allocated(),
            alpha_mean=float(rend._frame.rgba[..., 3].mean()),
            proxy_vs_baked=float((rend._proxy_grid - proxy).abs().max()),
            rend=rend)
    launches = swslice.LAUNCHES
    if launches < 1 or swslice.LAUNCHES_BF16:
        raise SystemExit("the neural main path never launched the slice "
                         "kernel (or launched its bf16 variant)")
    for shading, r in frames.items():
        rend = r.pop("rend")
        pscene = api.bake_proxy_scene(scene, rend._cfg, grid=rend._proxy_grid)
        r.update(neural_kernel(f"neural {shading}", pscene, rend._cfg,
                               rend._light_grid, r["frame_ms"]))
        log(f"neural headline {shading:8s} 1920x1080, 512^3 proxy, rate "
            f"1024 (Renderer): frame {r['frame_ms']:.2f} ms "
            f"({r['mrays_s']:.2f} Mrays/s), commit (bake"
            f"{' + lattice' if shading == 'shadow' else ''}) "
            f"{r['commit_ms']:.0f} ms, kernel {r['kernel_ms']:.2f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}, "
            f"{100 * r['share_of_bound']:.1f}%), fan {r['fan']}, "
            f"{r['planes']} planes, peak {r['peak_bytes'] / 2**30:.2f} GiB, "
            f"mean alpha {r['alpha_mean']:.3f}; {smi}")
        del rend
    res["frames"] = frames
    res["launches"] = launches

    # 4. one inverse-rendering step at a 128^3 proxy (bench.py's
    # BENCH_NEURAL=train with BENCH_PROXY=128)
    cfg = api.RenderConfig(width=1920, height=1080, sampling_rate=1024.0,
                           method="auto", shading="diffuse",
                           neural_proxy_res=128).resolved(scene)
    step, state = train.make_image_train_step(scene, cfg, lr=1e-3)
    target = torch.zeros((1080, 1920, 4), device="cuda")
    n0 = swslice.LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, loss0 = step(state, scene.camera, target)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches_step = swslice.LAUNCHES - n0
    peak = torch.cuda.max_memory_allocated()
    g = [q.grad for q in field.parameters()]
    finite = all(bool(torch.isfinite(x).all()) for x in g)
    # the loss after the update: the step's forward (termination off, as
    # under grad) without the backward
    with torch.no_grad():
        loss1 = l2(api.render(scene, dataclasses.replace(
            cfg, sw=dataclasses.replace(cfg.sw, term=False)),
            camera=scene.camera).rgba, target)
    res["train_step_128"] = dict(
        ms=step_ms, peak_bytes=peak,
        loss=(float(loss0), float(loss1)), launches_per_step=launches_step,
        grad_tables_max=float(g[0].abs().max()), n_slices=cfg.sw.n_slices,
        fan=(cfg.sw.inter_h, cfg.sw.inter_w))
    log(f"neural train step 1920x1080, 128^3 proxy (differentiable bake), "
        f"rate 1024, diffuse, lr 1e-3: {step_ms:.0f} ms (one step, cold; "
        f"the bench phase times it warm), peak "
        f"{res['train_step_128']['peak_bytes'] / 2**30:.2f} GiB, loss "
        f"{float(loss0):.5e} -> {float(loss1):.5e}, kernel launches a step "
        f"{res['train_step_128']['launches_per_step']:.0f}; {smi}")
    if not finite or float(g[0].abs().max()) == 0 or not float(loss1) < float(
            loss0):
        raise SystemExit("the neural train step failed its checks")
    del state, step, g

    # 5. the exact field march against the proxy frame
    small = dict(width=480, height=270, sampling_rate=1024.0,
                 shading="none")
    with torch.no_grad():
        mcfg = api.RenderConfig(method="march", fast_math=True,
                                **small).resolved(scene)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exact = api.render(scene, mcfg)
        torch.cuda.synchronize()
        march_ms = (time.perf_counter() - t0) * 1e3
        pcfg = api.RenderConfig(method="auto", **small).resolved(scene)
        fast = api.render(scene, pcfg, proxy_grid=proxy)
    err = float((fast.rgba - exact.rgba).abs().mean())
    res["march_vs_proxy_480x270"] = dict(
        mean_abs_rgba=err, march_ms=march_ms,
        march_alpha_mean=float(exact.rgba[..., 3].mean()))
    log(f"neural exact march 480x270 rate 1024 (fast_math, shading none): "
        f"{march_ms:.0f} ms; the 512^3 proxy frame against it: mean |rgba| "
        f"{err:.4f} (< 0.05) {'ok' if err < 0.05 else 'FAIL'}")
    if not (err < 0.05 and float(exact.rgba[..., 3].max()) > 0.1):
        raise SystemExit("the proxy frame does not approximate the field")

    # 6. the unfitted field (bench.py's BENCH_NEURAL=fwd)
    uscene = dataclasses.replace(dense, volume=unfitted)
    rend = api.Renderer(uscene, api.RenderConfig(
        width=1920, height=1080, sampling_rate=1024.0, method="auto",
        shading="diffuse"))
    rend.render()
    rend.render_time = 0.0
    for _ in range(NEURAL_FRAMES):
        rend.render()
    ms = rend.render_time * 1e3 / NEURAL_FRAMES
    check_frame("neural fwd unfitted", rend._frame, 1920, 1080, 0.0)
    res["fwd_unfitted"] = dict(frame_ms=ms, mrays_s=1920 * 1080 / (
        ms * 1e-3) / 1e6, alpha_mean=float(rend._frame.rgba[..., 3].mean()))
    log(f"neural fwd (unfitted init_field(seed 0)) 1920x1080 diffuse: frame "
        f"{ms:.2f} ms ({res['fwd_unfitted']['mrays_s']:.2f} Mrays/s), mean "
        f"alpha {res['fwd_unfitted']['alpha_mean']:.3f}")
    return res


# ---------------------------------------------------------------------------
# the multi-device paths (ovr_tpu_torch.parallel)
# ---------------------------------------------------------------------------

APPS_N = 1024  # edge of the apps phase's volumes (bench.py's field, u8)
APPS_SIZE = (1920, 1080)  # render_batch's frame and the viewer's larger one
APPS_RATE = 1024.0  # samples per unit length (the box is [0, 1]^3)
APPS_DEVICE = "cuda"
APPS_STEPS = 4  # timesteps of the streamed sequence
APPS_DEADLINE = 120.0  # seconds the viewer may take to publish a frame
# the viewer's POST /set: a camera and a transfer function
VIEWER_SETTINGS = {
    "camera": {"from": [1.9, 0.9, -1.1], "at": [0.5, 0.5, 0.5]},
    "tfn": {"alphas": [[0, 0], [0.35, 0.05], [1, 0.9]],
            "colors": [[0, 0.1, 0.2, 0.9], [0.5, 0.9, 0.8, 0.2],
                       [1, 0.8, 0.1, 0.1]]}}


def sequence_files(n, steps, tmp, device):
    """bench.py's BENCH_TIMEVAR field (phase 2 pi k / steps) at n^3 as
    UNSIGNED_BYTE raws `seq_%04d.raw` in `tmp`, built on the device a
    slab at a time. Returns (the %-pattern, the paths)."""
    import math
    import torch
    ax = torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    x, y = ax[None, None, :], ax[None, :, None]
    paths = []
    for k in range(steps):
        ph = 2 * math.pi * k / steps
        path = os.path.join(tmp, f"seq_{k:04d}.raw")
        with open(path, "wb") as f:
            for z0 in range(0, n, 128):
                z = ax[z0:z0 + 128, None, None]
                g = 0.5 + 0.35 * torch.sin(12 * x + ph) * torch.cos(
                    10 * y) * torch.sin(8 * z - ph)
                f.write(quantized(g, "u8").cpu().numpy().tobytes())
        paths.append(path)
    return os.path.join(tmp, "seq_%04d.raw"), paths


class DirectSession:
    """A stand-in for the viewer's session whose queued setters run at
    once on a renderer (the same setters, without the thread)."""

    def __init__(self, renderer):
        self.renderer = renderer

    def submit(self, ops):
        for name, args in ops:
            getattr(self.renderer, name)(*args)


def http_json(url, msg=None):
    import urllib.request
    req = urllib.request.Request(
        url, data=None if msg is None else json.dumps(msg).encode(),
        method="GET" if msg is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read() or b"{}")


def viewer_session(scene, width, height, has_pil):
    """The viewer's RenderSession on the card behind its HTTP server on
    127.0.0.1:0: the first frame, POST /set (camera and TF) and the frame
    after it, which must equal a direct Renderer's frame after the same
    setters bit for bit; then accumulation on for 2 s and the fps /stats
    reads; the server and the thread shut down. Fails if any render in
    the session raised."""
    import threading
    from http.server import ThreadingHTTPServer
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.apps import viewer
    from ovr_tpu_torch.ops import swslice
    cfg = api.RenderConfig(width=width, height=height,
                           sampling_rate=APPS_RATE,
                           shading="diffuse", fast_math=True,
                           use_macrocells=True, method="auto")
    sess = viewer.RenderSession(scene, cfg)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), viewer.make_handler(sess))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    n0 = swslice.LAUNCHES
    sess.start()
    th.start()
    try:
        def wait(n):
            t0 = time.perf_counter()
            while http_json(url + "/stats")["frame"] < n:
                if time.perf_counter() - t0 > APPS_DEADLINE:
                    raise SystemExit(f"viewer {width}x{height}: no frame "
                                     f"{n} within {APPS_DEADLINE:.0f} s")
                time.sleep(0.02)
            return time.perf_counter() - t0

        first_s = wait(1)
        http_json(url + "/set", VIEWER_SETTINGS)
        set_s = wait(2)
        direct = api.Renderer(scene, cfg)
        viewer.apply_settings(DirectSession(direct), VIEWER_SETTINGS)
        direct.render()
        same = torch.equal(direct._frame.rgba, sess.renderer._frame.rgba)
        png_bytes = None
        if has_pil:
            import urllib.request
            with urllib.request.urlopen(url + "/frame.png", timeout=60) as r:
                png_bytes = len(r.read())
        http_json(url + "/set", {"accumulation": True})
        time.sleep(2.0)
        stats = http_json(url + "/stats")
    finally:
        srv.shutdown()
        srv.server_close()
        sess.stop()
    if sess._thread.is_alive():
        raise SystemExit(f"viewer {width}x{height}: the render thread did "
                         f"not stop")
    res = dict(first_frame_s=first_s, set_to_frame_s=set_s, fps=stats["fps"],
               frames=stats["frame"], errors=sess.errors,
               bit_identical=same, png_bytes=png_bytes,
               launches=swslice.LAUNCHES - n0 - 1)  # less the direct frame
    if sess.errors or not same:
        raise SystemExit(f"viewer {width}x{height}: {sess.errors} render "
                         f"errors; frame after /set equal to a direct "
                         f"Renderer's: {same}")
    return res


def held_by_spread(card, cpu, noisy, tol):
    """Card against CPU where the CPU's own answer is stable: `noisy` is
    the CPU's answer after a one-ulp perturbation of the voxels, and the
    elements it moves by no more than `tol` are held at `tol`; the
    largest difference overall must stay within the perturbation's
    largest plus `tol`. Returns (ok, numbers)."""
    spread = (noisy - cpu).abs()
    err = (card.cpu() - cpu).abs()
    stable = spread <= tol
    out = dict(stable_share=float(stable.float().mean()),
               err_stable=float(err[stable].max()), err=float(err.max()),
               cpu_spread=float(spread.max()), tol=tol,
               beyond_spread=int((err > spread + tol).sum()))
    ok = (out["stable_share"] > 0.5 and out["err_stable"] <= tol
          and out["err"] <= out["cpu_spread"] + tol)
    return ok, out


class OneUlpField:
    """While installed, every field value the neural bakes compute moves
    by one f32 ulp of its size, up or down at random (a fixed draw): the
    CPU's own spread under rounding of the proxy's values."""

    def __enter__(self):
        import torch
        from ovr_tpu_torch.neural import train
        self.orig = real = train.field_sample

        def noisy(field, p):
            out = real(field, p)
            g = torch.Generator().manual_seed(out.numel())
            sign = torch.where(torch.rand(out.shape, generator=g) < 0.5,
                               -1.0, 1.0).to(out.device)
            return out + sign * torch.finfo(torch.float32).eps * (
                out.detach().abs())

        train.field_sample = noisy
        return self

    def __exit__(self, *exc):
        from ovr_tpu_torch.neural import train
        train.field_sample = self.orig


def examples_on_card(smi):
    """Both examples at their own sizes on the card, their frames and
    gradients against the same steps on CPU copies. mini_renderer's
    frames and grid gradients depend on ties at the level of one ulp
    (its z = 0 face is flat to ~1e-5, which makes its diffuse frame
    ill-conditioned in the reference too): each is held by
    `held_by_spread` against the CPU's answer after a one-ulp
    perturbation of the voxels (frames at 1e-4, gradients at 1e-3 of the
    largest element). mini_neural is fitted on the card and copied to
    the CPU: its frame is held at 1e-4 and its unshaded weight gradients
    at 1e-3 of the largest element; its diffuse weight gradients move by
    up to ~6e-3 of the largest element on the CPU itself when the
    proxy's values move by one ulp, so each is held by `held_by_spread`
    against that (`OneUlpField`)."""
    import numpy as np
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.examples import mini_neural, mini_renderer
    from ovr_tpu_torch.ops import swslice

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    out, n0 = {}, swslice.LAUNCHES
    vol = mini_renderer.make_volume()
    noisy = (vol * (1 + 1e-7 * np.random.default_rng(0).standard_normal(
        vol.shape))).astype(np.float32)
    scenes = {"card": mini_renderer.build_scene(vol, APPS_DEVICE),
              "cpu": mini_renderer.build_scene(vol, "cpu"),
              "noisy": mini_renderer.build_scene(noisy, "cpu")}
    res, t0 = {}, time.perf_counter()
    for shading in ("diffuse", "none"):
        for k, sc in scenes.items():
            cfg, fr = mini_renderer.render_frame(sc, shading=shading)
            res[k, shading] = (fr.rgba, mini_renderer.grid_gradient(sc, cfg))
            if k == "card":
                torch.cuda.synchronize()
                check_frame(f"mini_renderer {shading}", fr, 320, 240,
                            min_alpha=0.3)
                if shading == "diffuse":
                    card_s = time.perf_counter() - t0
    r = out["mini_renderer"] = dict(seconds_card=card_s, alpha_mean=float(
        res["card", "diffuse"][0][..., 3].mean()))
    ok = True
    for shading in ("diffuse", "none"):
        (fc, gc), (fh, gh), (fn, gn) = (res[k, shading] for k in scenes)
        ok_f, r[f"{shading}_frame"] = held_by_spread(fc, fh, fn, 1e-4)
        ok_g, r[f"{shading}_grad"] = held_by_spread(
            gc, gh, gn, 1e-3 * float(gh.abs().max()))
        ok = ok and ok_f and (ok_g or shading == "diffuse")
    if not ok:
        raise SystemExit(f"mini_renderer card vs CPU: {r}")
    n1 = swslice.LAUNCHES
    target = mini_neural.make_target()
    from ovr_tpu_torch.neural.field import init_field
    field = init_field(0, mini_neural.GRID_CFG, hidden=32, n_hidden=2,
                       device=APPS_DEVICE)
    t0 = time.perf_counter()
    losses = mini_neural.fit(field, target)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    host_field = copy.deepcopy(field).cpu()
    sc_c = mini_neural.field_scene(field, target)
    sc_h = mini_neural.field_scene(host_field, target)
    cfg_c, fr_c = mini_neural.render_field(sc_c)
    check_frame("mini_neural", fr_c, 160, 120, min_alpha=0.3)
    cfg_h, fr_h = mini_neural.render_field(sc_h)
    grads = {"card": mini_neural.weight_gradients(sc_c, cfg_c),
             "cpu": mini_neural.weight_gradients(sc_h, cfg_h)}
    with OneUlpField():
        grads["noisy"] = mini_neural.weight_gradients(sc_h, cfg_h)
    none = {}
    for k, sc in (("card", sc_c), ("cpu", sc_h)):
        cfg = api.RenderConfig(width=160, height=120, sampling_rate=48.0,
                               shading="none", method="auto",
                               neural_proxy_res=64).resolved(sc)
        none[k] = mini_neural.weight_gradients(sc, cfg)

    def flat(g):
        return [g[0]] + [x for wb in g[1] for x in wb]

    names = ["tables"] + [f"{w}{i}" for i in range(len(grads["cpu"][1]))
                          for w in "Wb"]
    r = out["mini_neural"] = dict(
        fit_s=fit_s, loss_first=float(losses[0]), loss_last=float(losses[-1]),
        frame_err=float((fr_c.rgba.cpu() - fr_h.rgba).abs().max()),
        alpha_mean=float(fr_c.rgba[..., 3].mean()),
        launches=swslice.LAUNCHES - n1, diffuse_grads={},
        none_grad_rel_err=max(rel(a, b) for a, b in zip(
            flat(none["card"]), flat(none["cpu"]))))
    ok = (r["frame_err"] <= 1e-4 and r["none_grad_rel_err"] <= 1e-3
          and r["loss_last"] < r["loss_first"])
    for name, gc, gh, gn in zip(names, *(flat(grads[k]) for k in (
            "card", "cpu", "noisy"))):
        ok_g, r["diffuse_grads"][name] = held_by_spread(
            gc, gh, gn, 1e-3 * float(gh.abs().max()))
        ok = ok and ok_g
    out["mini_renderer"]["launches"] = n1 - n0
    if not ok:
        raise SystemExit(f"mini_neural card vs CPU: {r}")
    if out["mini_renderer"]["launches"] < 1 or r["launches"] < 1:
        raise SystemExit(f"an example never launched the slice kernel: "
                         f"{out}")
    m = out["mini_renderer"]

    def held(x):
        return (f"{x['err']:.2e} ({x['err_stable']:.2e} on the "
                f"{100 * x['stable_share']:.1f}% a one-ulp perturbation "
                f"moves by <= {x['tol']:.1e}; its own spread "
                f"{x['cpu_spread']:.2e})")

    log(f"examples on the card: mini_renderer 320x240 64^3 diffuse frame "
        f"and grid gradient {card_s:.2f} s; card vs CPU: diffuse frame "
        f"{held(m['diffuse_frame'])}, unshaded frame "
        f"{held(m['none_frame'])}, unshaded gradient "
        f"{held(m['none_grad'])}, diffuse gradient (reported) "
        f"{held(m['diffuse_grad'])}; mini_neural fit 200 steps "
        f"{fit_s:.2f} s (loss {r['loss_first']:.4f} -> "
        f"{r['loss_last']:.4f}), frame {r['frame_err']:.2e}, unshaded "
        f"weight gradients {r['none_grad_rel_err']:.2e} of the largest "
        f"element, diffuse ones (tol 1e-3 of the largest) " + ", ".join(
            f"{k} {held(v)}" for k, v in r["diffuse_grads"].items())
        + f"; K1 launches {m['launches']} / {r['launches']}; {smi}")
    return out


def apps_phase(smi):
    """The port's programs on the card at the headline's size (1920x1080,
    rate 1024, auto, diffuse, macrocells on) over bench.py's field as a 1
    GiB u8 1024^3 VIDI3D scene (`scene_files`, in a temporary directory
    removed after): (a) render_batch's single frame (5 + 25 frames), whose
    last frame must equal a directly built Renderer's bit for bit; (b)
    --ab (PSNR >= 35 dB); (c) the orbit (--num-frames 4: 2 frames, then
    --resume, which must launch K1 exactly twice; needs PIL); (d)
    --sequence over APPS_STEPS u8 timesteps of bench.py's phase-shifted
    field: streaming fps, each upload's ms, GB/s and overlap with the
    render against a blocking pageable .to() of the same bytes, peak
    memory, every streamed frame bit for bit the serial run's; (e) the
    viewer at 512x512 and 1080p; (f) both examples; (g) Timer.stop with
    a fence around a 1080p frame against its CUDA-event time. Returns
    (the results, K1 launches in the phase)."""
    import importlib.util
    import shutil
    import tempfile
    import numpy as np
    import torch
    from ovr_tpu_torch import api, io
    from ovr_tpu_torch.apps import render_batch
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.utils.timers import Timer
    has_pil = importlib.util.find_spec("PIL") is not None
    t_phase = time.perf_counter()
    launches = {}
    res = {"pil": has_pil}
    n = APPS_N
    dev, (w, h) = APPS_DEVICE, APPS_SIZE
    grid = quantized(field(n, "bench", dev), "u8")
    tmp = tempfile.mkdtemp(prefix="ovr_apps_")
    try:
        t0 = time.perf_counter()
        _, js, _, _, _ = scene_files(grid, tmp)
        del grid
        pattern, seq_paths = sequence_files(n, APPS_STEPS, tmp, dev)
        # the sequence's scene: set_volume_data casts the u8 counts to
        # float32 (0-255), as the JAX package does, so its TF spans them
        with open(js) as f:
            doc = json.load(f)
        vol = doc["view"]["volume"]
        del vol["scalarMappingRange"]
        vol["scalarMappingRangeUnnormalized"] = {"minimum": 0.0,
                                                 "maximum": 255.0 * 255.0}
        seq_js = os.path.join(tmp, "sequence.json")
        with open(seq_js, "w") as f:
            json.dump(doc, f)
        res["write_s"] = time.perf_counter() - t0
        common = ["--fbsize", str(w), str(h), "--sampling-rate",
                  str(APPS_RATE), "--shading", "diffuse", "--use-macrocells",
                  "--device", dev]
        no_save = [] if has_pil else ["--no-save"]

        # (a) single frame
        argv = ["--scene", js] + common + no_save + [
            "--exp", os.path.join(tmp, "single_")]
        swslice.LAUNCHES = 0
        with PlainCalls() as plain:
            a = render_batch.main(argv)
        launches["single"] = swslice.LAUNCHES
        check_frame("render_batch single", a["frame"], w, h)
        scene = io.create_scene(js, device=dev)
        direct = render_batch.make_renderer(render_batch.parse_args(argv),
                                            scene, scene.camera)
        for _ in range(30):
            direct.render()
        same = all(torch.equal(getattr(direct._frame, c),
                               getattr(a["frame"], c))
                   for c in ("rgba", "grad", "depth"))
        res["single"] = dict(fps=a["fps"], rays_s=a["rays_s"],
                             launches=launches["single"], bit_identical=same)
        if launches["single"] != 30 or plain.n or not same:
            raise SystemExit(f"render_batch single: {res['single']}, "
                             f"{plain.n} plain calls")
        log(f"apps (a) render_batch single {w}x{h} {n}^3 u8 diffuse: "
            f"fps {a['fps']:.2f}, rays/s {a['rays_s']:.4e}, "
            f"{launches['single']} K1 launches for 30 frames, last frame "
            f"bit for bit a direct Renderer's; {smi}")

        # (b) --ab
        swslice.LAUNCHES = 0
        b = render_batch.main(["--scene", js] + common + [
            "--ab", "--exp", os.path.join(tmp, "ab_")])
        launches["ab"] = swslice.LAUNCHES
        res["ab"] = dict(psnr_db=b.get("psnr"), mse=b.get("mse"),
                         seconds=b["seconds"], launches=launches["ab"])
        if b.get("psnr") is None or b["psnr"] < 35.0 or launches["ab"] != 1:
            raise SystemExit(f"render_batch --ab: {res['ab']}")
        log(f"apps (b) --ab: PSNR {b['psnr']:.2f} dB, march "
            f"{b['seconds']['march']:.2f} s, shear-warp "
            f"{b['seconds']['shearwarp']:.3f} s (first frames, commit "
            f"included); {smi}")

        # (c) orbit, resumed
        if has_pil:
            exp = os.path.join(tmp, "orbit", "orbit_")
            os.makedirs(os.path.dirname(exp))
            for i in (2, 3):  # frames 2 and 3 "done": the first run stops
                open(f"{exp}{i:05d}.png", "wb").close()
            orbit = ["--scene", js] + common + [
                "--num-frames", "4", "--resume", "--exp", exp]
            swslice.LAUNCHES = 0
            c1 = render_batch.main(orbit)
            launches["orbit_first"] = swslice.LAUNCHES
            for i in (2, 3):
                os.remove(f"{exp}{i:05d}.png")
            swslice.LAUNCHES = 0
            c2 = render_batch.main(orbit)
            launches["orbit_resumed"] = swslice.LAUNCHES
            res["orbit"] = dict(first=c1["rendered"], resumed=c2["rendered"],
                                launches_resumed=launches["orbit_resumed"],
                                camera_pos=c1["camera_pos"] + c2[
                                    "camera_pos"])
            if (c1["rendered"], c2["rendered"],
                    launches["orbit_resumed"]) != ([0, 1], [2, 3], 2):
                raise SystemExit(f"render_batch orbit: {res['orbit']}")
            log(f"apps (c) orbit: frames {c1['rendered']} then, resumed, "
                f"{c2['rendered']} with {launches['orbit_resumed']} K1 "
                f"launches")
        else:
            res["orbit"] = ("not run: no PIL on this machine (the frames "
                            "are PNGs); tests/test_torch_apps.py covers it "
                            "on the CPU")

        # (d) the streamed sequence against a serial run
        seq = ["--scene", seq_js] + common + no_save + [
            "--sequence", pattern, "--sequence-type", "UNSIGNED_BYTE",
            "--exp", os.path.join(tmp, "seq_")]
        frames = []
        swslice.LAUNCHES = 0
        with PlainCalls() as plain:
            d = render_batch.main(seq, on_frame=lambda i, r: frames.append(
                r._frame.rgba.clone()))
        launches["sequence"] = swslice.LAUNCHES
        sscene = io.create_scene(seq_js, device=dev)
        serial = render_batch.make_renderer(render_batch.parse_args(seq),
                                            sscene, sscene.camera)
        pageable, same = [], []
        for k, p in enumerate(seq_paths):
            host = np.fromfile(p, np.uint8).reshape(n, n, n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            upload = torch.from_numpy(host).to(dev)
            torch.cuda.synchronize()
            pageable.append(time.perf_counter() - t0)
            del host
            serial.set_volume_data(upload)
            del upload
            serial.render()
            check_frame(f"sequence t{k}", serial._frame, w, h)
            same.append(torch.equal(serial._frame.rgba, frames[k]))
        del frames, serial, sscene
        nbytes = n ** 3
        ups = d.get("uploads", [])
        res["sequence"] = dict(
            streaming_fps=d.get("streaming_fps"), timesteps=d["timesteps"],
            uploads=ups, pageable_ms=[s * 1e3 for s in pageable],
            pageable_gbps=[nbytes / s / 1e9 for s in pageable],
            peak_bytes=d.get("peak_bytes"), launches=launches["sequence"],
            bit_identical=same, shape=f"{n}^3 u8 timesteps "
            f"({nbytes / 2**30:.2f} GiB each), cast to float32 on the card")
        if (not all(same) or len(same) != APPS_STEPS or plain.n
                or launches["sequence"] != APPS_STEPS or len(ups) !=
                APPS_STEPS - 1):
            raise SystemExit(f"render_batch --sequence: {res['sequence']}")
        log(f"apps (d) --sequence {APPS_STEPS} x {n}^3 u8: streaming fps "
            f"{d['streaming_fps']:.3f}; uploads (pinned, side stream) "
            + ", ".join(f"{u['ms']:.2f} ms {u['gbps']:.2f} GB/s overlap "
                        f"{100 * u['overlap']:.0f}% (render "
                        f"{u['render_ms']:.2f} ms)" for u in ups)
            + "; blocking pageable .to() " + ", ".join(
                f"{s * 1e3:.2f} ms" for s in pageable)
            + f"; peak {d['peak_bytes'] / 2**30:.2f} GiB; every frame bit "
            f"for bit the serial run's; {smi}")

        # (e) the viewer
        swslice.LAUNCHES = 0
        res["viewer"] = {f"{vw}x{vh}": viewer_session(scene, vw, vh,
                                                      has_pil)
                         for vw, vh in ((512, 512), (w, h))}
        launches["viewer"] = sum(v["launches"]
                                 for v in res["viewer"].values())
        log("apps (e) viewer: " + "; ".join(
            f"{k} first frame {v['first_frame_s']:.2f} s, /set to frame "
            f"{v['set_to_frame_s']:.3f} s, fps {v['fps']}, {v['frames']} "
            f"frames, errors {v['errors']}, bit for bit a direct Renderer's"
            for k, v in res["viewer"].items()) + f"; {smi}")

        # (g) the timer's fence against CUDA events
        cfg = direct._cfg
        mc = direct._macrocells
        api.render(scene, cfg, macrocells=mc)
        ratios = []
        for _ in range(3):
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            tm = Timer()
            tm.start()
            e0.record()
            frame = api.render(scene, cfg, macrocells=mc)
            e1.record()
            host_s = tm.stop(fence=frame.rgba)
            torch.cuda.synchronize()
            ratios.append(host_s * 1e3 / e0.elapsed_time(e1))
        res["timer"] = dict(host_over_events=ratios)
        if min(ratios) < 0.9:
            raise SystemExit(f"Timer.stop(fence=) read less than 0.9x the "
                             f"frame's CUDA-event time: {ratios}")
        del scene, direct, mc, frame
    finally:
        shutil.rmtree(tmp)

    # (f) the examples
    res["examples"] = examples_on_card(smi)
    launches["examples"] = (res["examples"]["mini_renderer"]["launches"]
                            + res["examples"]["mini_neural"]["launches"])
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    return res, sum(launches.values())


# the port's bench (ovr_tpu_torch.bench): every BENCH_* mode once at the
# headline size, in process; depth cut (warm-up + timed frames or steps)
# where a frame or step takes seconds. (label, knobs)
BENCH_MODES = (
    ("none", dict(BENCH_SHADING="none")),
    ("shadow", dict(BENCH_SHADING="shadow")),
    ("bf16", dict(BENCH_BF16="1")),
    ("6 lights", dict(BENCH_EXTRA_LIGHTS="6")),
    ("u8", dict(BENCH_STORE="u8")),
    ("opaque", dict(BENCH_OPAQUE="1")),
    ("opaque noterm", dict(BENCH_OPAQUE="1", BENCH_TERM="0")),
    ("eye inside", dict(BENCH_EYE="inside")),
    ("march", dict(BENCH_METHOD="march", BENCH_WARMUP="1",
                   BENCH_FRAMES="1")),
    ("backward diffuse", dict(BENCH_BACKWARD="1", BENCH_WARMUP="1",
                              BENCH_FRAMES="1")),
    ("pt mc", dict(BENCH_PT="mc", BENCH_WARMUP="1", BENCH_FRAMES="2")),
    ("pt dense", dict(BENCH_PT="dense", BENCH_WARMUP="1", BENCH_FRAMES="2")),
    ("neural fwd", dict(BENCH_NEURAL="fwd", BENCH_WARMUP="1",
                        BENCH_FRAMES="3")),
    ("neural train 128", dict(BENCH_NEURAL="train", BENCH_PROXY="128",
                              BENCH_WARMUP="1", BENCH_FRAMES="1")),
    ("timevar 4", dict(BENCH_TIMEVAR="4")),
    ("mesh 1x2 shared", dict(BENCH_MESH="1x2")),
)
BENCH_TOL = 0.10  # the bench's headline rays/s against time_frames' frame
# modes whose K1 work bench_phase breaks down besides the headline's
BENCH_BREAKDOWN = ("eye inside", "opaque", "opaque noterm")
BENCH_TIMEOUT = 300.0  # seconds the headline bench subprocess may take
BENCH_LAUNCHES = re.compile(r"slice kernel launches (\d+) \(bf16 variant "
                            r"(\d+)\), plain-version calls (\d+)")


def bench_line(label, res, smi):
    """Log one bench run: its key, rays/s, frame ms by events and host
    clock, peak, launches, path; the value must be finite and positive."""
    import math
    t, v = res["timing"], res["line"]["value"]
    ms, host_ms = t.seconds * 1e3 / t.frames, t.host_seconds * 1e3 / t.frames
    log(f"bench {label:16s} {res['key']}: {v:.6e} rays/s, {ms:.3f} ms a "
        f"frame (CUDA events; host clock {host_ms:.3f} ms, {t.frames} "
        f"timed), peak {t.peak_bytes / 2**30:.2f} GiB, K1 launches "
        f"{t.launches} (bf16 variant {t.launches_bf16}), plain calls "
        f"{t.plain_calls} (K1 {'ran' if t.launches else 'did not run'});"
        f" {res['path']}; {smi}")
    if not (math.isfinite(v) and v > 0):
        raise SystemExit(f"bench {label}: value {v}")
    return dict(key=res["key"], value=v, metric=res["line"]["metric"],
                frame_ms=ms, host_ms=host_ms, frames=t.frames,
                peak_bytes=t.peak_bytes, launches=t.launches,
                launches_bf16=t.launches_bf16, plain_calls=t.plain_calls,
                path=res["path"], k1_ran=t.launches > 0)


def bench_breakdown(label, knobs, smi):
    """K1 on the inputs of the bench's frame 0 for `knobs` (after its
    run; these launches are not the bench's): the samples the frame
    needs and the planes its blocks composited (the counting variant,
    which must give the timed variant's bits), kernel ms and the bound."""
    import torch
    from ovr_tpu_torch import bench
    from ovr_tpu_torch.ops import swslice
    s = bench.build_setup(bench.read_knobs(knobs))
    frame = bench.forward_frame(s)
    zero = torch.zeros((), device="cuda")
    with torch.no_grad():
        args, kw = capture_call(lambda: frame(0, zero))
        full = swslice.slice_composite(*args, **kw)
        cnt, _ = counted(args, kw, full)
        kernel_ms = cuda_ms(lambda: swslice.slice_composite(*args, **kw), 5)
    bound_ms, bound_by, samples, _, _ = bound(args, kw,
                                              cnt["pixel_samples"])
    hi, wi = args[4].shape[0], args[3].shape[0]
    r = dict(fan=(hi, wi), planes=args[6], samples=samples,
             samples_per_fan_pixel=samples / (hi * wi),
             block_planes=int(cnt["block_planes"].sum()),
             kernel_ms=kernel_ms, bound_ms=bound_ms, bound_by=bound_by,
             share_of_bound=bound_ms / kernel_ms)
    log(f"bench {label} K1: fan {hi}x{wi}, {args[6]} planes, "
        f"{samples:.4e} samples needed ({r['samples_per_fan_pixel']:.1f} a "
        f"fan pixel), {r['block_planes']} block-planes composited, kernel "
        f"{kernel_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
        f"{100 * r['share_of_bound']:.1f}% of it); {smi}")
    return r


def issued_without_sync(scene, mc):
    """One headline diffuse frame issued under torch's sync debug mode
    "error": the frame must reach the card without the host waiting for
    it (a wait inside the frame serializes the host's issue time with the
    kernel). Returns the host ms the issue took."""
    import torch
    from ovr_tpu_torch import api
    cfg = headline_cfg(scene, "diffuse")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        api.render(scene, cfg, macrocells=mc)
    except RuntimeError as e:
        raise SystemExit(f"the headline frame waited for the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return issue_ms


def bench_phase(smi, grid, main_diffuse_ms):
    """The port's bench program: the headline frame issued without a
    synchronization (`issued_without_sync`); (a) `python3 -m
    ovr_tpu_torch.bench` with no knobs (the 1024^3 bf16 1080p diffuse
    headline, 3 + 10 frames) as a subprocess: exactly one stdout JSON
    line with bench.py's four keys, its value within BENCH_TOL of
    1920 * 1080 / the same frame's ms as `time_frames` times it on `grid`
    just before (the main path's measurement, `main_diffuse_ms`, minutes
    earlier, is reported beside it), K1 once a frame and no plain call;
    (b) every other mode
    of BENCH_MODES in process (a temporary book), each value finite and
    positive; (c) K1's work on the headline's and BENCH_BREAKDOWN's
    frames (`bench_breakdown`, after the counted runs). Returns
    (results, K1 launches: the subprocess's and ranks' from their
    reports, the in-process runs' counted from 0)."""
    import tempfile
    import torch
    from ovr_tpu_torch import bench
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import accel
    t0 = time.perf_counter()
    scene = make_scene(grid, "bench", "persp")
    mc = accel.build_macrocells(grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    diffuse_frame_ms = time_frames([("diffuse", scene, "diffuse", False)],
                                   mc)["diffuse"]["frame_ms"]
    issue_ms = issued_without_sync(scene, mc)
    log(f"bench: the headline frame issued with no host-device "
        f"synchronization in {issue_ms:.2f} ms of host time "
        f"(its frame {diffuse_frame_ms:.2f} ms); {smi}")
    del scene, mc
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    p = subprocess.run([sys.executable, "-m", "ovr_tpu_torch.bench"],
                       capture_output=True, text=True, cwd=root, env=env,
                       timeout=BENCH_TIMEOUT)
    out = p.stdout.strip().splitlines()
    if p.returncode != 0 or len(out) != 1:
        raise SystemExit(f"bench headline: exit {p.returncode}, "
                         f"{len(out)} stdout lines\n{p.stderr[-3000:]}")
    line = json.loads(out[0])
    counts = BENCH_LAUNCHES.findall(p.stderr)
    if set(line) != {"metric", "value", "unit", "vs_baseline"} or not counts:
        raise SystemExit(f"bench headline: malformed output {out[0]}")
    k1, k1_bf16, plain = (int(x) for x in counts[-1])
    want = 1920 * 1080 / (diffuse_frame_ms * 1e-3)
    ratio = line["value"] / want
    head = dict(line=line, launches=k1, plain_calls=plain, ratio=ratio,
                smoke_rays_s=want, smoke_frame_ms=diffuse_frame_ms,
                issue_ms=issue_ms,
                main_path_frame_ms=main_diffuse_ms,
                ratio_to_main_path=line["value"] * main_diffuse_ms
                / (1920 * 1080 * 1e3),
                stderr=[x for x in p.stderr.splitlines()
                        if x.startswith("bench")])
    log(f"bench headline (subprocess, no knobs): {line['value']:.6e} "
        f"rays/s, {ratio:.4f}x the {want:.6e} of time_frames' diffuse "
        f"frame just before ({diffuse_frame_ms:.2f} ms; "
        f"{head['ratio_to_main_path']:.4f}x the main path's, "
        f"{main_diffuse_ms:.2f} ms); K1 launches {k1}, plain "
        f"calls {plain}; metric '{line['metric']}', vs_baseline "
        f"{line['vs_baseline']}; {smi}")
    for x in head["stderr"]:
        log(f"  {x}")
    metric = ("forward rays/s (1024^3 bf16 grid, 1920x1080, diffuse "
              "shading, shear-warp compositing)")
    failed = [what for what, bad in (
        (f"rays/s {ratio:.4f}x time_frames' (limit 1 +- {BENCH_TOL})",
         abs(ratio - 1) > BENCH_TOL),
        (f"K1 launches, bf16 launches, plain calls {(k1, k1_bf16, plain)} "
         "against (13, 0, 0)", (k1, k1_bf16, plain) != (13, 0, 0)),
        (f"metric {line['metric']!r} against {metric!r}",
         line["metric"] != metric)) if bad]
    if failed:
        raise SystemExit("bench headline failed its checks: "
                         + "; ".join(failed))
    modes = {}
    launches = k1
    with tempfile.TemporaryDirectory() as tmp:
        book = os.path.join(tmp, "book.json")
        for label, knobs in BENCH_MODES:
            torch.cuda.empty_cache()
            swslice.LAUNCHES = swslice.LAUNCHES_BF16 = 0
            res = bench.run(knobs, book=book)
            n = swslice.LAUNCHES
            if res["ranks"]:  # the launches of the ranks' processes
                n = sum(r["launches"] for r in res["ranks"])
            launches += n
            modes[label] = bench_line(label, res, smi)
            modes[label]["knobs"] = knobs
            if res["ranks"]:
                modes[label]["ranks"] = [
                    {k: r[k] for k in ("rank", "device", "backend",
                                       "seconds", "host_seconds",
                                       "launches", "plain_calls",
                                       "peak_bytes")} for r in res["ranks"]]
    head["k1"] = bench_breakdown("headline", {}, smi)
    for label in BENCH_BREAKDOWN:
        modes[label]["k1"] = bench_breakdown(label, modes[label]["knobs"],
                                             smi)
    seconds = time.perf_counter() - t0
    log(f"bench phase {seconds:.0f} s, {launches} K1 launches")
    return dict(headline=head, modes=modes, seconds=seconds), launches


PAR_N = 1024  # the headline volume's edge (ranks build it, or a slab)
PAR_SHADINGS = ("none", "diffuse", "shadow")
PAR_FRAMES = 3  # timed frames per rank and shading (after one warm-up)
PAR_WORLD = 4  # ranks of the job that shares the card
PAR_TIMEOUT = 420.0  # wall limit of that job (seconds)
PAR_GROUP_TIMEOUT = 240.0  # seconds a collective may wait
# the meshes of the job's frames, in this order: bricks first, so that a
# brick rank's peak memory is read before it ever holds the whole grid
PAR_MESHES = (("bricks 1x2", (1, 2)), ("tiles x bricks 2x2", (2, 2)),
              ("tiles 2x1", (2, 1)))
# kernel against plain version on brick and band inputs: (n, dtype,
# shading, camera, fd, term, (n_tiles, tile), (n_bricks, brick), width,
# height); "persp" views the brick axis ascending, "back" descending,
# "side" across it (principal axis x)
HOOK_CASES = [
    (64, "f32", "none", "persp", True, False, (1, 0), (2, 1), 160, 96),
    (64, "bf16", "diffuse", "back", True, True, (1, 0), (4, 2), 160, 96),
    (64, "u8", "shadow", "side", True, False, (1, 0), (4, 0), 160, 96),
    (64, "f32", "shadow", "persp", False, False, (4, 3), (1, 0), 160, 96),
    (256, "f32", "diffuse", "persp", True, False, (4, 1), (1, 0), 240, 136),
    (256, "bf16", "shadow", "back", True, False, (2, 1), (1, 0), 240, 136),
    (256, "u8", "none", "side", True, True, (1, 0), (2, 1), 240, 136),
    (256, "bf16", "diffuse", "persp", False, False, (2, 0), (4, 3), 240, 136),
    (256, "f32", "diffuse", "side", True, False, (2, 1), (2, 0), 240, 136),
]


def par_cfg(scene, shading, width=1920, height=1080, rate=1024.0):
    """The parallel phase's frame: no macrocells (the multi-device paths
    pass none), planes aligned to 2 bricks."""
    from ovr_tpu_torch import api
    cfg = api.RenderConfig(width=width, height=height, sampling_rate=rate,
                           shading=shading, method="auto",
                           sw_slice_align=2).resolved(scene)
    if cfg.sw is None:
        raise SystemExit(f"{shading}: no shear-warp plan")
    return cfg


def hook_capture(scene, cfg, tiles_, bricks_, light_grid=None):
    """The slice kernel's inputs on one band (`tiles_` = (n_tiles, tile))
    of one brick (`bricks_` = (n_bricks, brick)) of a frame, as the
    multi-device paths call `render_shearwarp` with its hooks."""
    from ovr_tpu_torch.parallel import bricks, tiles
    from ovr_tpu_torch.render import shearwarp
    (n_t, t), (n_b, b) = tiles_, bricks_
    cfg = tiles.band_cfg(cfg, n_t)
    hb = cfg.height // n_t
    hooks = dict(row0=t * hb, n_rows=hb)
    if n_b > 1:
        local = bricks.brick_volume(scene.volume, n_b, only=b)
        hooks.update(bricks.brick_hooks(cfg.sw, local, n_b))
        scene = dataclasses.replace(scene, volume=dataclasses.replace(
            scene.volume, grid=local.bricks[0]))
    return capture_call(lambda: shearwarp.render_shearwarp(
        scene, cfg, scene.camera, light_grid=light_grid, fan_only=True,
        **hooks))


def hook_parity(grids):
    """(a) The kernel against its plain version on brick and band inputs
    (HOOK_CASES): the bricks' sample and clip boxes and plane ranges and
    the bands' shrunk fans reach the kernel only through its scalars.
    The counting variant must give the same bits and counts. Returns the
    largest difference and how many cases were bit-identical."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    worst, same_bits = 0.0, 0
    for (n, dt, shading, cam, fd, term, tl, br, w, h) in HOOK_CASES:
        scene = make_scene(grids[(n, dt, "bench")], "bench", cam)
        cfg = api.RenderConfig(width=w, height=h, sampling_rate=float(n),
                               shading=shading, method="shearwarp",
                               sw_term=term, sw_slice_align=4).resolved(scene)
        cfg = dataclasses.replace(cfg, sw=dataclasses.replace(
            cfg.sw, fd_grad=fd))
        lg = (api.build_light_grid(scene, cfg) if shading == "shadow"
              else None)
        args, kw = hook_capture(scene, cfg, tl, br, lg)
        name = (f"{n}^3 {dt} {shading} {cam} {w}x{h} band {tl[1]} of "
                f"{tl[0]}, brick {br[1]} of {br[0]}")
        n0 = swslice.LAUNCHES
        out = swslice.slice_composite(*args, **kw)
        torch.cuda.synchronize()
        if swslice.LAUNCHES != n0 + 1:
            raise SystemExit(f"{name}: slice_composite did not launch")
        cnt, _ = counted(args, kw, out)
        cnt_p = counts(args)
        ref = swslice.slice_composite_plain(*args, **kw, **cnt_p)
        err_c, err_a, err_d, ok = compare(out, ref, term)
        same = all(torch.equal(cnt[k], cnt_p[k]) for k in cnt)
        bits = torch.equal(out, ref)
        same_bits += int(bits)
        worst = max(worst, err_c, err_a, err_d)
        alpha_max = float(ref[7].max())
        sc = args[2]
        log(f"parity hooks {name} fd={fd:d} term={term:d}: fan "
            f"{args[4].shape[0]}x{args[3].shape[0]}, {args[6]} planes from "
            f"plane {float(sc[swslice.S_OFF]) - 0.5:.0f}, smp0 "
            f"{float(sc[swslice.S_SMP0]):.5f}"
            f", clip z [{float(sc[swslice.S_CLA]):.4f}, "
            f"{float(sc[swslice.S_CHA]):.4f}]: rgb/n {err_c:.2e} alpha "
            f"{err_a:.2e} depth {err_d:.2e}{' (bit-identical)' if bits else ''}"
            f" (max alpha {alpha_max:.3f}); counts "
            f"{'equal' if same else 'DIFFER'} {'ok' if ok and same else 'FAIL'}")
        if not ok or not same or alpha_max < 0.05:
            raise SystemExit(f"kernel disagrees with the plain version on "
                             f"the hooks' inputs, or nothing is in view: "
                             f"{name}")
    return worst, same_bits


def nccl_one_rank(grid):
    """(b) One rank over NCCL on the card: `tiles.render_sharded` and a
    1 x 1 `bricks.render_bricked` of the headline frame must give the bits
    of `api.render`'s, each with one kernel launch and no plain call."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.parallel import bricks, multihost, tiles
    from ovr_tpu_torch.parallel.mesh import make_mesh
    multihost.initialize(f"tcp://127.0.0.1:{multihost.free_port()}", 1, 0,
                         backend="nccl", timeout=PAR_GROUP_TIMEOUT)
    out = {}
    try:
        mesh = make_mesh(1, 1, device="cuda", timeout=PAR_GROUP_TIMEOUT)
        probe = torch.ones(4, device="cuda")
        dist.all_reduce(probe)  # the backend moves a CUDA tensor
        if not torch.equal(probe, torch.ones_like(probe)):
            raise SystemExit("nccl all_reduce over one rank changed a value")
        scene = make_scene(grid, "bench", "persp")
        bv = bricks.brick_volume(scene.volume, 1)
        for shading in PAR_SHADINGS:
            cfg = par_cfg(scene, shading)
            lg = (api.build_light_grid(scene, cfg) if shading == "shadow"
                  else None)
            want = api.render(scene, cfg, light_grid=lg).rgba
            swslice.LAUNCHES = 0
            with PlainCalls() as plain:
                band_t = tiles.render_sharded(scene, cfg, mesh,
                                              light_grid=lg)
                band_b = bricks.render_bricked(scene, bv, cfg, mesh,
                                               light_grid=lg)
                img = multihost.gather_frame(band_t, mesh)
                torch.cuda.synchronize()
            r = dict(tiles_bits=bool(torch.equal(band_t, want)),
                     bricks_bits=bool(torch.equal(band_b, want)),
                     gathered_bits=bool(np.array_equal(
                         img, want.cpu().numpy())),
                     launches=swslice.LAUNCHES, plain_calls=plain.n,
                     transport=mesh.transport)
            out[shading] = r
            ok = (r["tiles_bits"] and r["bricks_bits"] and r["gathered_bits"]
                  and r["launches"] == 2 and r["plain_calls"] == 0)
            log(f"parallel one rank, {mesh.transport}, {shading}: tiles 1x1 "
                f"{'=' if r['tiles_bits'] else '!='} api.render bits, bricks "
                f"1x1 {'=' if r['bricks_bits'] else '!='}, gathered "
                f"{'=' if r['gathered_bits'] else '!='}; {r['launches']} "
                f"launches for 2 frames, {plain.n} plain calls "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("the one-rank NCCL frames are not "
                                 "api.render's")
    finally:
        dist.destroy_process_group()
    return out


def premult_p95(out, ref):
    """tests/test_parallel.py's rule for banded frames: the 95th
    percentile of the largest premultiplied rgb difference over the
    frame's interior (the box of alpha > 0.01, shrunk by 2 pixels)."""
    import numpy as np
    pm_o, pm_r = out[..., :3] * out[..., 3:4], ref[..., :3] * ref[..., 3:4]
    a = ref[..., 3]
    ys, xs = np.nonzero(a > 0.01)
    inner = np.zeros_like(a, bool)
    inner[ys.min() + 2:ys.max() - 1, xs.min() + 2:xs.max() - 1] = True
    return float(np.quantile(np.abs(pm_o - pm_r).max(-1)[inner], 0.95))


def field_slab(n, rows, device, dtype, chunk=16):
    """The bench field's Z `rows` (all when None) in `dtype`, computed
    `chunk` rows at a time into one tensor: no f32 copy of the whole
    slab."""
    import torch
    if rows is None:
        rows = torch.arange(n)
    out = torch.empty((len(rows), n, n), dtype=dtype, device=device)
    for i in range(0, len(rows), chunk):
        out[i:i + chunk] = field(n, "bench", device,
                                 z_rows=rows[i:i + chunk]).to(dtype)
    return out


def rank_scene(n, rows, vr, device, dtype):
    """The bench scene on this rank: the whole field, or its Z `rows`
    (a brick's slab), with the whole field's TF value range."""
    import torch
    from ovr_tpu_torch.core.scene import Camera, simple_scene
    grid = field_slab(n, rows, device, dtype)
    scene = simple_scene(grid, value_range=torch.tensor(vr), device=device)
    return dataclasses.replace(scene, camera=Camera.create(
        **CAMERAS["persp"], device=device))


def shape_only(scene, n):
    """The scene with a stand-in n^3 grid (no memory): plans resolve over
    the global grid's shape."""
    import torch
    g = torch.zeros((), dtype=scene.volume.grid.dtype,
                    device=scene.volume.grid.device).expand(n, n, n)
    return dataclasses.replace(scene, volume=dataclasses.replace(
        scene.volume, grid=g))


def rank_frames(out_dir, smi):
    """(c) On each mesh of PAR_MESHES (this rank idle outside it): its
    volume (the slab, or the whole grid for tiles), one warm-up and
    PAR_FRAMES timed frames per shading with the launches counted, the
    kernel alone on this rank's inputs and its bound, the peak memory;
    the frame gathered and written for the parent by rank 0."""
    import numpy as np
    import torch
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.parallel import bricks, multihost, tiles
    from ovr_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda")
    vr = np.load(os.path.join(out_dir, "value_range.npy")).tolist()
    lg = torch.from_numpy(np.load(os.path.join(out_dir, "lattice.npy"))).to(
        dev)
    res = {}
    for label, shape in PAR_MESHES:
        mesh = make_mesh(*shape, device=dev, timeout=PAR_GROUP_TIMEOUT)
        if mesh is None:
            continue
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        n_b = mesh.n_bricks
        rows = (bricks.slab_rows(PAR_N, n_b, mesh.brick) if n_b > 1
                else None)
        scene = rank_scene(PAR_N, rows, vr, dev, torch.bfloat16)
        bv = None
        if n_b > 1:
            bv = bricks.from_slab(scene.volume.grid, (0.0, 0.0, 0.0),
                                  (1.0, 1.0, 1.0), PAR_N, n_b, mesh.brick)
        per = {}
        for shading in PAR_SHADINGS:
            cfg = par_cfg(shape_only(scene, PAR_N), shading)
            lat = lg if shading == "shadow" else None

            def frame():
                if bv is not None:
                    return bricks.render_bricked(scene, bv, cfg, mesh,
                                                 light_grid=lat)
                return tiles.render_sharded(scene, cfg, mesh, light_grid=lat)

            swslice.LAUNCHES = 0
            with PlainCalls() as plain:
                band = frame()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(PAR_FRAMES):
                    frame()
                torch.cuda.synchronize()
                frame_ms = (time.perf_counter() - t0) * 1e3 / PAR_FRAMES
            launches = swslice.LAUNCHES
            if plain.n or launches != 1 + PAR_FRAMES:
                raise SystemExit(f"{label} {shading}: {launches} launches and "
                                 f"{plain.n} plain calls in "
                                 f"{1 + PAR_FRAMES} frames")
            img = multihost.gather_frame(band, mesh)
            if mesh.rank == 0:
                np.save(os.path.join(out_dir, f"{shape[0]}x{shape[1]}_"
                                     f"{shading}.npy"), img)
            args, kw = capture_call(frame)
            full = swslice.slice_composite(*args, **kw)
            cnt, _ = counted(args, kw, full)
            kernel_ms = cuda_ms(lambda: swslice.slice_composite(*args, **kw),
                                3)
            b_ms, b_by, samples, _, _ = bound(args, kw, cnt["pixel_samples"])
            if (label == "bricks 1x2" and mesh.rank == 0
                    and shading == "diffuse"):
                diffuse_inputs = (args, kw, full)
            per[shading] = dict(
                frame_ms=frame_ms, kernel_ms=kernel_ms,
                launches_per_frame=launches / (1 + PAR_FRAMES),
                bound_ms=b_ms, bound_by=b_by, samples=samples,
                share_of_bound=b_ms / kernel_ms,
                fan=list(map(int, (args[4].shape[0], args[3].shape[0]))),
                planes=args[6])
            del args, kw, full, cnt, band
        peak = torch.cuda.max_memory_allocated()
        res[label] = dict(rank=mesh.rank, tile=mesh.tile, brick=mesh.brick,
                          peak_bytes=peak,
                          resident_bytes=torch.cuda.memory_allocated(),
                          volume_bytes=(
                              scene.volume.grid.numel()
                              * scene.volume.grid.element_size()),
                          transport=mesh.transport, shadings=per)
        log(f"rank {mesh.rank} of {label} ({mesh.transport}; the ranks "
            f"time-share one card): " + "; ".join(
                f"{s} frame {r['frame_ms']:.1f} ms, kernel "
                f"{r['kernel_ms']:.2f} ms ({100 * r['share_of_bound']:.1f}% "
                f"of its bound {r['bound_ms']:.3f} ms), "
                f"{r['launches_per_frame']:.0f} launch/frame"
                for s, r in per.items())
            + f"; peak memory {peak / 2**30:.2f} GiB, resident after the "
              f"frames {res[label]['resident_bytes'] / 2**30:.2f} GiB (its "
              f"volume {res[label]['volume_bytes'] / 2**30:.2f} GiB); {smi}")
        if label == "bricks 1x2" and mesh.rank == 0:
            band_check("brick 0 of 2 diffuse", res[label], *diffuse_inputs)
            del diffuse_inputs
        mesh.barrier()
        del scene, bv
    return res


def state_err(card, cpu):
    """max |card - cpu| over the largest |cpu|, per named tensor."""
    return {k: float((card[k].cpu().float() - cpu[k].float()).abs().max())
            / max(float(cpu[k].float().abs().max()), 1e-30) for k in cpu}


def rank_train(out_dir, smi):
    """(d) Train steps: the tiles step at the headline (2 x 1, none, the
    bf16 grid, target zero), and the tiles step at 64^3 (2 x 1) and the
    bricked step at 128^3 (1 x 2), each on the card and again on this
    rank's CPU, the same mesh over gloo."""
    import numpy as np
    import torch
    from ovr_tpu_torch.parallel import bricks, tiles
    from ovr_tpu_torch.parallel.mesh import make_mesh
    vr = np.load(os.path.join(out_dir, "value_range.npy")).tolist()
    res = {}
    mesh = make_mesh(2, 1, device="cuda", timeout=PAR_GROUP_TIMEOUT)
    if mesh is not None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        scene = rank_scene(PAR_N, None, vr, "cuda", torch.bfloat16)
        cfg = par_cfg(scene, "none")
        step = tiles.make_train_step(cfg, mesh, lr=1e-2)
        state = tiles.init_train_state(scene)
        target = torch.zeros((1080, 1920, 4), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, scene, scene.camera, target)
        torch.cuda.synchronize()
        res["tiles_headline"] = dict(
            loss=float(loss), ms=(time.perf_counter() - t0) * 1e3,
            peak_bytes=torch.cuda.max_memory_allocated(),
            grid_sum=float(state.grid.float().sum()),
            m_grid_max=float(state.m_grid.float().abs().max()),
            tf_alpha=state.tf_alpha.tolist(), finite=bool(
                torch.isfinite(state.m_grid.float()).all()))
        del scene, state, step
    for name, shape, n, shading in (("tiles_64", (2, 1), 64, "diffuse"),
                                    ("bricked_128", (1, 2), 128, "none"),
                                    ("bricked_128_diffuse", (1, 2), 128,
                                     "diffuse")):
        outs = {}
        for dev in ("cuda", "cpu"):
            mesh = make_mesh(*shape, device=dev, timeout=PAR_GROUP_TIMEOUT)
            if mesh is None:
                continue
            scene = make_scene(field(n, "bench", dev), "bench", "persp")
            cfg = par_cfg(scene, shading, 128, 128, float(n))
            target = torch.full((128, 128, 4), 0.25, device=dev)
            t0 = time.perf_counter()
            if shape[1] == 1:
                step = tiles.make_train_step(cfg, mesh, lr=0.5)
                st, loss = step(tiles.init_train_state(scene), scene,
                                scene.camera, target)
                out = {k: getattr(st, k) for k in ("grid", "tf_color",
                                                   "tf_alpha", "m_grid")}
            else:
                step = bricks.make_train_step_bricked(cfg, mesh, lr=0.5)
                bv = bricks.brick_volume(scene.volume, 2, only=mesh.brick)
                bv2, tfc, tfa, loss = step(bv, scene.tfn.color,
                                           scene.tfn.alpha, scene,
                                           scene.camera, target)
                out = dict(slab=bv2.bricks[0], tf_color=tfc, tf_alpha=tfa)
            out["loss"] = loss.reshape(1)
            outs[dev] = (out, (time.perf_counter() - t0) * 1e3)
        if outs:
            card_out = outs["cuda"][0]
            cpu_out = {k: v.cpu() for k, v in outs["cpu"][0].items()}
            res[name] = dict(err=state_err(card_out, cpu_out),
                             loss=float(card_out["loss"]),
                             card_ms=outs["cuda"][1], cpu_ms=outs["cpu"][1])
            if "slab" in cpu_out:  # the global Z row of the largest slab gap
                d = (card_out["slab"].cpu() - cpu_out["slab"]).abs()
                row = int(d.amax((1, 2)).argmax())
                res[name]["worst_row"] = (row - bricks.HALO
                                          + mesh.brick * (n // 2))
            if name == "bricked_128_diffuse":
                # the conditioning: the CPU step again from the slab moved
                # by +-1e-7 (uniform, seed 0)
                gen = torch.Generator().manual_seed(0)
                moved = bv.bricks[0] + (torch.rand(
                    bv.bricks[0].shape, generator=gen) - 0.5) * 2e-7
                bv2 = step(dataclasses.replace(bv, bricks=moved[None]),
                           scene.tfn.color, scene.tfn.alpha, scene,
                           scene.camera, target)[0]
                res[name]["cpu_moved_slab_err"] = state_err(
                    {"slab": bv2.bricks[0]}, {"slab": cpu_out["slab"]})["slab"]
    log(f"rank train: " + json.dumps(res) + f"; {smi}")
    return res


def parallel_rank(out_dir, init, world, rank):
    """One gloo rank of the job that shares the card (`--rank`)."""
    import torch
    import torch.distributed as dist
    from ovr_tpu_torch.parallel import multihost
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(init, world, rank, backend="gloo",
                         timeout=PAR_GROUP_TIMEOUT)
    smi = card()
    res = dict(rank=rank, frames=rank_frames(out_dir, smi),
               train=rank_train(out_dir, smi))
    print("RESULT " + json.dumps(res), flush=True)
    dist.destroy_process_group()
    return 0


def parallel_start(grids, big, smi):
    """The multi-device paths: (a) the kernel on brick and band inputs;
    (b) one rank over NCCL; then starts the job of (c) and (d), whose
    ranks run in their own processes while this one goes on
    (`parallel_finish` waits for them). Returns the job's handle."""
    import tempfile

    import numpy as np
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.parallel import multihost
    t0 = time.perf_counter()
    # a brick's slab computed alone has the bits of the whole field's rows
    from ovr_tpu_torch.parallel.bricks import slab_rows
    rows = slab_rows(64, 4, 3)
    if not torch.equal(field_slab(64, rows, "cuda", torch.bfloat16, chunk=5),
                       field(64, "bench", "cuda").to(torch.bfloat16)[
                           rows.cuda()]):
        raise SystemExit("a slab of the field differs from its rows")
    worst, bits = hook_parity(grids)
    log(f"parallel (a): {len(HOOK_CASES)} brick and band cases agree, "
        f"{bits} bit-identical, largest difference {worst:.2e} "
        f"({time.perf_counter() - t0:.0f} s)")
    one = nccl_one_rank(big)
    scene = make_scene(big, "bench", "persp")
    refs = {}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    vr = scene.tfn.value_range.cpu().numpy()
    np.save(os.path.join(tmp, "value_range.npy"), vr)
    for shading in PAR_SHADINGS:
        cfg = par_cfg(scene, shading)
        lg = (api.build_light_grid(scene, cfg) if shading == "shadow"
              else None)
        if lg is not None:
            np.save(os.path.join(tmp, "lattice.npy"), lg.cpu().numpy())
        refs[shading] = api.render(scene, cfg,
                                   light_grid=lg).rgba.cpu().numpy()
    del scene
    torch.cuda.empty_cache()
    job = dict(t0=t0, worst=worst, bits=bits, one=one, refs=refs,
               tmp_dir=tmp_dir, t_job=time.perf_counter())

    def run():
        try:
            job["outs"] = multihost.run_ranks(
                [sys.executable, os.path.abspath(__file__), "--rank", tmp],
                PAR_WORLD, PAR_TIMEOUT)
        except BaseException as e:  # raised in parallel_finish
            job["error"] = e
        job["job_s"] = time.perf_counter() - job["t_job"]

    job["thread"] = threading.Thread(target=run, name="ranks")
    job["thread"].start()
    return job


def parallel_finish(job, big, smi):
    """Waits for the job `parallel_start` began: (c) PAR_WORLD gloo ranks
    that share the card render the headline frame bricked 1 x 2, as
    tiles x bricks 2 x 2 and as tiles 2 x 1, held against the
    single-rank frame; (d) their train steps, against the same ranks on
    the CPU. Returns the phase's record."""
    import numpy as np
    job["thread"].join()
    t0, worst, bits, one, refs = (job[k] for k in ("t0", "worst", "bits",
                                                   "one", "refs"))
    job_s = job["job_s"]
    with job["tmp_dir"] as tmp:
        if "error" in job:
            raise job["error"]
        outs = job["outs"]
        ranks = []
        for r, out in enumerate(outs):
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    ranks.append(json.loads(line[7:]))
                elif line.strip():
                    log(f"  [rank {r}] {line}")
        if len(ranks) != PAR_WORLD:
            raise SystemExit("a rank printed no result")
        vs = {}
        for label, (n_t, n_b) in PAR_MESHES:
            for shading in PAR_SHADINGS:
                got = np.load(os.path.join(tmp, f"{n_t}x{n_b}_{shading}.npy"))
                ref = refs[shading]
                p95 = premult_p95(got, ref)
                err = float(np.abs(got - ref).max())
                if n_t == 1:
                    tol = 1e-3 if shading == "none" else 3e-2
                    ok = err <= tol
                    rule = f"max |rgba| {err:.2e} <= {tol:.0e}"
                else:
                    ok = p95 < 0.06
                    rule = f"interior p95 {p95:.4f} < 0.06"
                vs[f"{label} {shading}"] = dict(max_abs=err, p95=p95, ok=ok)
                log(f"parallel (c) {label} {shading} vs the single-rank "
                    f"frame: {rule} (max {err:.2e}) {'ok' if ok else 'FAIL'}")
                if not ok or got.shape != ref.shape:
                    raise SystemExit(f"{label} {shading}: the frame is off")
        # the step's forward is the tiles 2x1 frame without termination
        banded = np.load(os.path.join(tmp, "2x1_none.npy")).astype(
            np.float64)
        fwd_loss = float(np.sum(banded ** 2) / banded.size)
    train = {r["rank"]: r["train"] for r in ranks}
    head = [train[r]["tiles_headline"] for r in (0, 1)]
    ok_head = (all(head[0][k] == head[1][k]
                   for k in ("loss", "grid_sum", "tf_alpha"))
               and head[0]["finite"] and head[0]["m_grid_max"] > 0
               and abs(head[0]["loss"] - fwd_loss) <= 1e-3 * fwd_loss)
    log(f"parallel (d) tiles train step 2x1 at the headline (none, bf16 "
        f"grid): loss {head[0]['loss']:.6e} on both ranks (the forward "
        f"frame's {fwd_loss:.6e}), {head[0]['ms']:.0f} / {head[1]['ms']:.0f} "
        f"ms per rank (time-shared), peak {head[0]['peak_bytes'] / 2**30:.2f}"
        f" GiB; state the same on both ranks {'ok' if ok_head else 'FAIL'}")
    errs = {}
    for name in ("tiles_64", "bricked_128", "bricked_128_diffuse"):
        errs[name] = {k: max(train[r][name]["err"][k] for r in (0, 1))
                      for k in train[0][name]["err"]}
        rows = [train[r][name].get("worst_row") for r in (0, 1)]
        log(f"parallel (d) {name} card vs CPU ranks: largest normalised "
            f"differences " + ", ".join(f"{k} {v:.2e}" for k, v in
                                        errs[name].items())
            + (f" (slab: worst at global z rows {rows})" if rows[0] is
               not None else "")
            + (f"; the CPU slab from a grid moved by 1e-7: "
               f"{train[0][name]['cpu_moved_slab_err']:.2e}"
               if "cpu_moved_slab_err" in train[0][name] else "")
            + f" (rank 0 card {train[0][name]['card_ms']:.0f} ms, CPU "
              f"{train[0][name]['cpu_ms']:.0f} ms)")
    # the gate: every state of the unshaded steps and of diffuse's tiles
    # step, and the bricked diffuse step's loss and TF tables. Its slab is
    # reported, not gated: the bench field's diffuse grid gradient at
    # 128^3 is rounding noise where its planes are nearly flat (moving the
    # grid by 1e-7 moves the CPU's own slab as far; printed above)
    gated = [v for name in ("tiles_64", "bricked_128")
             for v in errs[name].values()]
    gated += [v for k, v in errs["bricked_128_diffuse"].items()
              if k != "slab"]
    if not ok_head or max(gated) > 1e-3:
        raise SystemExit("a parallel train step is off")
    errs = {k: max(v.values()) for k, v in errs.items()}
    frames = {r["rank"]: r["frames"] for r in ranks}
    launches = int(sum(s["launches_per_frame"] * (1 + PAR_FRAMES)
                       for f in frames.values() for m in f.values()
                       for s in m["shadings"].values()))
    grid_bytes = big.numel() * big.element_size()
    for r in (0, 1):
        m = frames[r]["bricks 1x2"]
        # resident: the slab, the lattice and the band; never the grid
        if (m["resident_bytes"] > m["volume_bytes"] + 2**28
                or m["peak_bytes"] >= grid_bytes + m["volume_bytes"]):
            raise SystemExit(f"brick rank {r} holds more than its slab")
    rec = dict(
        transport=ranks[0]["frames"]["bricks 1x2"]["transport"],
        hook_parity=dict(cases=len(HOOK_CASES), bit_identical=bits,
                         max_abs_err=worst),
        nccl_one_rank=one, ranks=frames, vs_single_rank=vs,
        train={str(k): v for k, v in train.items()},
        train_max_norm_err=errs, launches=launches,
        job_seconds=job_s, seconds=time.perf_counter() - t0, card=smi)
    log(f"parallel phase {rec['seconds']:.0f} s from start to finish (the "
        f"job of {PAR_WORLD} ranks {job_s:.0f} s)")
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # fails (ImportError) when run outside the repository
    from ovr_tpu_torch.ops import cuda_build, swslice  # noqa: F401
    if sys.argv[1:2] == ["--rank"]:  # a rank of the parallel phase's job
        return parallel_rank(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                             int(sys.argv[5]))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = card()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({torch.cuda.device_count()} visible); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    phases = {}  # seconds of each phase, in the order they ran

    @contextlib.contextmanager
    def phase(name):
        t = time.perf_counter()
        yield
        phases[name] = time.perf_counter() - t
        log(f"phase {name}: {phases[name]:.1f} s "
            f"({time.perf_counter() - t0:.0f} s so far)")

    # nvcc builds the kernel on the host's cores while the phases that
    # launch no kernel (the march and the path tracers, card against
    # CPU) run
    built = {}

    def build():
        try:
            built["regs"] = build_kernel()
        except BaseException as e:  # raised again below, in this thread
            built["error"] = e

    t_build = time.perf_counter()
    builder = threading.Thread(target=build, name="nvcc")
    builder.start()
    with phase("march parity"):
        mpar = march_parity()
    log(f"march parity: all cases agree, largest frame difference "
        f"{mpar['frame']:.2e}, gradient (float64) {mpar['grad']:.2e}")
    with phase("pt parity"):
        pt_par = pt_parity()
    with phase("pt dense vs mc"):
        pt_dvm = pt_dense_vs_mc()
    with phase("build, after the phases beside it"):
        builder.join()
    if "error" in built:
        raise built["error"]
    regs, nvcc_s = built["regs"]
    phases["nvcc, beside them"] = max(nvcc_s)
    log(f"build and the phases beside it: "
        f"{time.perf_counter() - t_build:.1f} s (nvcc "
        f"{phases['nvcc, beside them']:.1f} s)")

    with phase("grids"):
        dev = torch.device("cuda")
        grids = {}
        for n in (64, 256, 1024):
            for kind_f in ("bench", "sparse"):
                if n == 1024 and kind_f == "sparse":
                    continue
                g = field(n, kind_f, dev)
                dts = (("bf16",) if n == 1024
                       else ("f32", "bf16", "u8", "u16"))
                for dt in dts:
                    if dt == "f32":
                        grids[(n, dt, kind_f)] = g
                    elif dt == "bf16":
                        grids[(n, dt, kind_f)] = g.to(torch.bfloat16)
                    else:
                        grids[(n, dt, kind_f)] = quantized(g, dt)
                if n == 64:  # 60 rows along the views' rows (grid axis y)
                    grids[(n, "f32r60", kind_f)] = g[:, :60].contiguous()
                del g
    with phase("parity"):
        worst, worst_bf16 = parity(grids)
    log(f"parity: all cases agree, largest difference {worst:.2e}, of the "
        f"bf16 variant {worst_bf16:.2e}")
    with phase("exit-map parity"):
        worst_map, worst_map16 = parity(grids, EXIT_CASES, surfaces=True)
    worst, worst_bf16 = max(worst, worst_map), max(worst_bf16, worst_map16)
    log(f"parity with the exit map: all cases agree, largest difference "
        f"{max(worst_map, worst_map16):.2e}")
    big = grids[(1024, "bf16", "bench")]
    with phase("parallel, to its job"):
        job = parallel_start(grids, big, smi)
    # the card-vs-CPU checks at 64^3 run while the job's ranks run (their
    # frame and kernel times are time-shared in any case); two intra-op
    # threads leave the host's other cores to the ranks
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    with phase("backward parity"):
        bwd_worst = backward_parity(grids)
    log(f"backward parity: all cases agree, largest normalised difference "
        f"{bwd_worst:.2e}")
    with phase("geometry parity"):
        geo_par = geometry_parity(grids)
    with phase("geometry backward"):
        geo_bwd = geometry_backward(grids)
    with phase("multi-volume parity"):
        mv_par = multivol_parity(grids)
    torch.set_num_threads(threads)
    with phase("parallel, its job"):
        par = parallel_finish(job, big, smi)
    worst = max(worst, par["hook_parity"]["max_abs_err"],
                par["ranks"][0]["bricks 1x2"].get("band_err", 0.0))
    for key in [k for k in grids if k[0] != 1024]:
        del grids[key]

    with phase("main path"):
        results, launches, res16, launches16, vs_f32 = main_path(
            big, smi, regs)
    if launches < 1 or launches16 < 1:
        raise SystemExit("the main path never launched the slice kernel "
                         "(or its bf16 variant)")
    head, head16 = results["diffuse"], res16["diffuse bf16"]
    worst = max([worst] + [r["band_err"] for r in results.values()])
    worst_bf16 = max([worst_bf16] + [r["band_err"] for r in res16.values()])
    log(f"main path: {launches} launches of the f32 function, {launches16} "
        f"of the bf16 variant")
    with phase("u16 headline"):
        res_u16, launches_u16 = u16_headline(smi, regs)
    worst = max([worst] + [r["band_err"] for r in res_u16.values()])
    log(f"u16 headline: {launches_u16} launches of the f32 function on "
        f"16-bit storage")
    with phase("surfaces"):
        geo, geo_launches = geometry_headline(big, smi)
    worst = max([worst] + [r["band_err"] for r in geo.values()])
    with phase("multi-volume"):
        mv, mv_launches = multivol_headline(big, smi)
    log(f"surfaces and multi-volume: {geo_launches} launches with the exit "
        f"map, {mv_launches} in multi-volume frames")

    with phase("backward headline"):
        bwd, bwd_launches, scene, mc = backward_headline(big, smi)
    if bwd_launches < 1:
        raise SystemExit("the backward path never launched the slice kernel")
    with phase("backward profile"):
        prof = backward_profile(scene, mc)
    del scene, mc

    with phase("march headline"):
        mhead, mlaunch, scene, mc = march_headline(big, smi)
    with phase("march oracle"):
        oracle = march_oracle(scene, mc)
    with phase("march fallback"):
        fallback = march_fallback(big, mc, smi)
    with phase("sparse"):
        sparse = sparse_headline(big, smi)

    with phase("scene io"):
        io_res = scene_io(smi)
    with phase("scene io u16"):
        io_u16 = scene_io(smi, "u16")
    with phase("pt headline"):
        pt_head = pt_headline(big, smi)
    with phase("neural parity"):
        npar = neural_parity()
    with phase("neural headline"):
        nhead = neural_headline(big, smi)
    neural_s = phases["neural parity"] + phases["neural headline"]
    worst = max([worst] + [r["band_err"] for r in nhead["frames"].values()])
    with phase("apps"):
        apps, apps_launches = apps_phase(smi)
    log(f"apps: {apps_launches} K1 launches")
    with phase("bench"):
        bench_res, bench_launches = bench_phase(smi, big, head["frame_ms"])
    phase_s = {k: phases[k] for k in ("scene io", "scene io u16", "pt parity",
                                      "pt headline", "pt dense vs mc")}
    log("seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items())
        + f"; total {time.perf_counter() - t0:.1f} s")
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"backward": {
        "shape": "1024^3 bf16, 1920x1080, 1024 planes, macrocells on; loss "
                 "mean(rgba^2) + mean(grad^2), gradients of the grid and "
                 "the TF alpha",
        "launches": bwd_launches, "parity_64_max_norm_err": bwd_worst,
        "modes": bwd, "profile_diffuse": prof, "card": smi}}))
    print(json.dumps({"march": {
        "shape": "1024^3 bf16, 1920x1080, rate 1024, method march, "
                 "fast_math, macrocells on (no kernel: plain PyTorch)",
        "parity_64": mpar, "headline": mhead, "launches": mlaunch,
        "oracle": oracle, "fallback": fallback, "card": smi}}))
    print(json.dumps({"surfaces": {
        "geometry": {
            "shape": "1024^3 bf16, 1920x1080, rate 1024, auto, diffuse, "
                     "macrocells and termination on; sphere 64x32 "
                     "segments (3968 triangles) or isosurface 0.5",
            "cases": geo, "launches": geo_launches,
            "parity_64_max_err": geo_par,
            "backward_64_max_norm_err": geo_bwd},
        "multi_volume": {
            "shape": "1024^3 + 512^3 bf16, 1920x1080, rate 1024, auto",
            "modes": mv, "launches": mv_launches,
            "parity_64_32_max_err": mv_par},
        "sparse": dict(sparse, shape="1024^3 bf16, 1920x1080, rate 1024, "
                       "march, fast_math, diffuse, W*H/8 rays"),
        "card": smi}}))
    print(json.dumps({"scene_io_path_tracing": {
        "scene_io": dict(io_res, shape="1024^3 u8 VIDI3D / USDA files, "
                         "Renderer 1920x1080, rate 1024, auto, diffuse, "
                         "macrocells on"),
        "scene_io_u16": dict(io_u16, shape="1024^3 u16 VIDI3D file (2 GiB "
                             "UNSIGNED_SHORT raw), Renderer 1920x1080, rate "
                             "1024, auto, diffuse, macrocells on"),
        "pt_parity_64": pt_par,
        "pt_headline": dict(pt_head, shape="1024^3 bf16, 1920x1080, "
                            "max_scatters 24; dense: lattice 128, 14 "
                            "directions, auto; mc: macrocell DDA, spp 1 "
                            "(plain PyTorch, no kernel)"),
        "pt_dense_vs_mc_64": pt_dvm, "phase_seconds": phase_s,
        "card": smi}}, default=str))
    print(json.dumps({"parallel": dict(
        par, shape="1024^3 bf16, 1920x1080, rate 1024, auto, "
                   "sw_slice_align 2, no macrocells; 4 gloo ranks share one "
                   "card (frame and kernel times are time-shared)")},
        default=str))
    print(json.dumps({"neural": {
        "shape": "hash grid 12 levels x 2 features, 2^17 entries, "
                 "resolutions 16-512; MLP 24-64-64-1 f32 (init seed 0); "
                 "fitted to the 1024^3 bf16 bench field; 512^3 proxy; "
                 "1920x1080, rate 1024, auto, Renderer; train step at a "
                 "128^3 proxy",
        "parity_24": npar, "headline": nhead, "seconds": neural_s,
        "card": smi}}, default=str))
    print(json.dumps({"apps": dict(
        apps, shape="1 GiB u8 1024^3 VIDI3D scene (bench.py's field), "
                    "1920x1080, rate 1024, auto, diffuse, macrocells on; "
                    f"sequence {APPS_STEPS} x 1024^3 u8; viewer 512x512 and "
                    "1920x1080; examples at their own sizes",
        card=smi)}, default=str))
    print(json.dumps({"bench": dict(
        bench_res, shape="python3 -m ovr_tpu_torch.bench: 1024^3 bf16 "
                         "(u8 under BENCH_STORE=u8), 1920x1080, rate 1024, "
                         "auto, diffuse, macrocells on, 3 + 10 frames "
                         "unless the knobs say otherwise",
        card=smi)}, default=str))
    keys = ("kernel_ms", "frame_ms", "mrays_s", "bound_ms", "bound_by",
            "samples", "ops_per_sample", "share_of_bound", "band_plain_ms",
            "band_kernel_ms", "band_err", "peak_bytes", "registers",
            "spill_bytes", "threads", "smem_bytes", "blocks_per_sm",
            "planes_staged", "planes_direct", "planes_runs", "axis",
            "lights")
    entry = {
        "name": "swslice",
        "route": "cuda",
        "source": "ovr_tpu_torch/csrc/swslice.cu",
        "replaces": "ovr_tpu/ops/swslice.py:660",
        "also_replaces": "ovr_tpu/ops/swslice.py:561",
        "launches": launches,
        "launches_with_exit_map": geo_launches,
        "launches_multi_volume": mv_launches,
        "launches_scene_io": io_res["launches"],
        "launches_u16": launches_u16,
        "launches_scene_io_u16": io_u16["launches"],
        "launches_neural": nhead["launches"],
        "launches_neural_train_step": nhead["train_step_128"][
            "launches_per_step"],
        "launches_parallel_ranks": par["launches"],
        "launches_apps": apps_launches,
        "launches_bench": bench_launches,
        "launches_parallel_one_rank": sum(
            r["launches"] for r in par["nccl_one_rank"].values()),
        "parallel_brick_0_of_2_diffuse": {
            k: par["ranks"][0]["bricks 1x2"]["shadings"]["diffuse"][k]
            for k in ("kernel_ms", "frame_ms", "bound_ms", "bound_by",
                      "share_of_bound", "launches_per_frame")},
        "neural_proxy_diffuse": {k: nhead["frames"]["diffuse"][k] for k in (
            "kernel_ms", "frame_ms", "bound_ms", "bound_by", "band_err",
            "band_plain_ms", "band_kernel_ms", "share_of_bound")},
        "max_abs_err": worst,
        "ms": head["kernel_ms"],
        "plain_ms": head["band_plain_ms"],
        "plain_shape": f"headline diffuse inputs, {head['band']}",
        "kernel_ms_at_plain_shape": head["band_kernel_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": "1024^3 bf16, 1920x1080, 1024 planes, diffuse",
        "modes": {s: {k: r[k] for k in keys} for s, r in results.items()},
        "u16": {
            "shape": "1024^3 u16 (round(field * 65535), 2.15 GB), "
                     "1920x1080, 1024 planes",
            "ms": res_u16["diffuse u16"]["kernel_ms"],
            "plain_ms": res_u16["diffuse u16"]["band_plain_ms"],
            "bound_ms": res_u16["diffuse u16"]["bound_ms"],
            "bound_by": res_u16["diffuse u16"]["bound_by"],
            "modes": {s: {k: r[k] for k in keys}
                      for s, r in res_u16.items()}},
        "card": smi,
    }
    entry16 = {
        "name": "swslice_bf16",
        "route": "cuda",
        "source": "ovr_tpu_torch/csrc/swslice.cu",
        "replaces": "ovr_tpu/ops/swslice.py:660 (bf16=True)",
        "also_replaces": "ovr_tpu/ops/swslice.py:561 (bf16=True)",
        "launches": launches16,
        "launches_neural": 0,
        "max_abs_err": worst_bf16,
        "ms": head16["kernel_ms"],
        "plain_ms": head16["band_plain_ms"],
        "plain_shape": f"headline diffuse sw_bf16 inputs, {head16['band']}",
        "kernel_ms_at_plain_shape": head16["band_kernel_ms"],
        "bound_ms": head16["bound_ms"],
        "bound_by": head16["bound_by"],
        "library_ms": None,
        "shape": "1024^3 bf16, 1920x1080, 1024 planes, diffuse, sw_bf16",
        "modes": {s: {k: r[k] for k in keys} for s, r in res16.items()},
        "vs_f32_frame": vs_f32,
        "card": smi,
    }
    print(json.dumps({"phases_s": phases, "total_s": time.perf_counter() - t0,
                      "card": smi}))
    log(f"total {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"kernels": [entry, entry16]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
