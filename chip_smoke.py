"""Drive the PyTorch + CUDA port (ovr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit);
2. builds csrc/swslice.cu with nvcc and prints the ptxas summary;
3. holds the slice kernel against its plain PyTorch version on the card
   for modes 0/1/2, both gradient stencils, skipping and termination on
   and off, f32/bf16/u8 grids, perspective and orthographic cameras, at
   64^3 and 256^3 and on the 1024^3 headline volume at 240x135;
4. renders the headline frame through `api.render`: a 1024^3 bf16 volume
   (bench.py's synthetic field, built on the card), 1920x1080, 1024
   planes, macrocell skipping on, in diffuse, none and shadow shading;
   checks each frame, counts kernel launches, and times frames and the
   kernel alone with CUDA events; then holds the kernel against its plain
   version on each headline frame's own inputs, cut to a band of 64 fan
   rows with all 2048 columns, and times both there;
5. prints one JSON line of kernel measurements, then, last, the device
   line {"ok": true, "device": {...}}.

Exits non-zero without a CUDA device, without the repository beside it,
or when any phase fails. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
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
# term and normal (18), the primary light (7) and 10 per extra light,
# the shade (10), the camera-space normal (24) and compositing three
# more channels (6); mode 2 adds the z-lerped bilinear lattice read (21)
# and the shadow factor (4).
OPS_SAMPLE, OPS_COMPOSITE = 21 + 28 + 20, 12
OPS_GRAD = {True: 7, False: 12}
OPS_SHADE, OPS_LIGHT, OPS_SHADOW = 18 + 7 + 10 + 24 + 6, 10, 21 + 4


def ops_per_sample(mode, fd, n_extra):
    ops = OPS_SAMPLE + OPS_COMPOSITE
    if mode >= 1:
        ops += OPS_GRAD[fd] + OPS_SHADE + OPS_LIGHT * n_extra
    if mode == 2:
        ops += OPS_SHADOW
    return ops


H100_BYTES_PER_S = 3.35e12  # HBM3, SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
FRAMES, WARMUP = 10, 3  # timed and warm-up frames per headline shading
BAND_ROWS = 64  # headline fan rows held against the plain version


def log(*a):
    print(*a, flush=True)


def field(n, kind, device):
    """bench.py's synthetic volume ("bench"), or a blob in one octant
    ("sparse"), as f32 on the device."""
    import torch
    ax = torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    x, y, z = ax[None, None, :], ax[None, :, None], ax[:, None, None]
    if kind == "sparse":
        return torch.exp(-((x - 0.7) ** 2 + (y - 0.3) ** 2
                           + (z - 0.6) ** 2) * 120)
    g = 0.5 + 0.35 * torch.sin(12 * x) * torch.cos(10 * y) * torch.sin(8 * z)
    return g + 0.15 * torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2
                                  + (z - 0.5) ** 2) * 40)


CAMERAS = {
    "persp": dict(from_=(0.5, 0.5, -1.6), at=(0.5, 0.5, 0.5), fovy=45.0),
    "ortho": dict(from_=(0.5, 0.5, -2.0), at=(0.5, 0.5, 0.5), height=1.3,
                  kind="orthographic"),
    "back": dict(from_=(0.45, 0.6, 2.3), at=(0.5, 0.5, 0.5), fovy=40.0),
}


def make_scene(grid, kind, cam, n_lights=0):
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
    return dataclasses.replace(scene, lights=lights, camera=Camera.create(
        **CAMERAS[cam], device=grid.device))


def capture(scene, cfg, **render_kw):
    """Render one frame and return the arguments the renderer passed to
    the slice kernel's wrapper."""
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    seen = {}
    orig = swslice.slice_composite

    def spy(*args, **kw):
        seen.update(args=args, kw=kw)
        return orig(*args, **kw)

    swslice.slice_composite = spy
    try:
        api.render(scene, cfg, **render_kw)
    finally:
        swslice.slice_composite = orig
    return seen["args"], seen["kw"]


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


def build_kernel():
    from ovr_tpu_torch.ops import cuda_build
    built = cuda_build.load("swslice")
    log(f"swslice build: {built.seconds:.1f} s -> {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())
    return built


def parity(grids):
    """Kernel vs plain on the card; returns the largest error seen."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import accel

    # (n, dtype, kind, shading, fd, skip, term, cam, width, height, lights)
    cases = [
        (64, "f32", "bench", "none", True, False, False, "persp", 160, 90, 0),
        (64, "u8", "sparse", "none", True, True, True, "ortho", 160, 90, 0),
        (64, "bf16", "bench", "diffuse", True, False, False, "persp", 240,
         135, 0),
        (64, "f32", "sparse", "diffuse", False, True, True, "ortho", 240,
         135, 0),
        (64, "u8", "sparse", "shadow", True, True, False, "persp", 160, 90,
         2),
        (64, "bf16", "opaque", "shadow", False, False, True, "back", 160, 90,
         0),
        (64, "f32", "opaque", "diffuse", True, False, True, "back", 160, 90,
         4),
        (256, "bf16", "sparse", "diffuse", True, True, False, "persp", 480,
         270, 0),
        (256, "u8", "opaque", "shadow", True, False, True, "ortho", 480, 270,
         0),
        (256, "f32", "sparse", "none", True, True, True, "back", 480, 270, 0),
        (1024, "bf16", "bench", "diffuse", True, True, True, "persp", 240,
         135, 0),
        (1024, "bf16", "bench", "none", True, True, False, "persp", 240, 135,
         0),
        (1024, "bf16", "bench", "shadow", True, True, True, "persp", 240, 135,
         0),
    ]
    worst = 0.0
    for (n, dt, kind, shading, fd, skip, term, cam, w, h, nl) in cases:
        grid = grids[(n, dt, "sparse" if kind == "sparse" else "bench")]
        scene = make_scene(grid, kind, cam, nl)
        cfg = api.RenderConfig(
            width=w, height=h, sampling_rate=float(n), shading=shading,
            method="shearwarp", base_rate=n / 4.0 if kind == "opaque" else 1.0,
            sw_term=term).resolved(scene)
        cfg = dataclasses.replace(cfg, sw=dataclasses.replace(
            cfg.sw, fd_grad=fd))
        mc = (accel.build_macrocells(grid, scene.tfn.alpha,
                                     scene.tfn.value_range) if skip else None)
        args, kw = capture(scene, cfg, macrocells=mc)
        n0 = swslice.LAUNCHES
        out = swslice.slice_composite(*args, **kw)
        torch.cuda.synchronize()
        if swslice.LAUNCHES != n0 + 1:
            raise SystemExit("slice_composite did not launch the kernel")
        ref = swslice.slice_composite_plain(*args, **kw)
        err_c, err_a, err_d, ok = compare(out, ref, term)
        worst = max(worst, err_c, err_a, err_d)
        alpha_max = float(ref[7].max())
        log(f"parity {n}^3 {dt:4s} {kind:6s} {shading:7s} fd={fd:d} "
            f"skip={skip:d} term={term:d} {cam:5s} {w}x{h} lights={nl}: "
            f"rgb/n {err_c:.2e} alpha {err_a:.2e} depth {err_d:.2e} "
            f"(max alpha {alpha_max:.3f}) {'ok' if ok else 'FAIL'}")
        if not ok or alpha_max < 0.05:
            raise SystemExit(f"kernel disagrees with the plain version "
                             f"(or nothing in view) in case {n}^3 {dt} "
                             f"{kind} {shading}")
    return worst


def bound(args, kw, planes):
    """Least time for the slice function on these inputs: each input read
    once and the output written once at the HBM rate, against the
    operations of the samples this run needs at the f32 rate. The samples
    are those of the planes each block composited (skipping and
    termination as the function defines them), plus, with the FD
    gradient, the two halo rows beyond the fan's first and last row."""
    import torch
    from ovr_tpu_torch.ops import swslice
    grid, _, _, pg, qg = args[:5]
    hi, wi = qg.shape[0], pg.shape[0]
    nbr, nbc = -(-hi // swslice.BLOCK_ROWS), -(-wi // swslice.BLOCK_COLS)
    rows = torch.tensor([min(swslice.BLOCK_ROWS, hi - r * swslice.BLOCK_ROWS)
                         for r in range(nbr)], dtype=torch.float64)
    cols = torch.tensor([min(swslice.BLOCK_COLS, wi - c * swslice.BLOCK_COLS)
                         for c in range(nbc)], dtype=torch.float64)
    p = planes.view(nbr, nbc).double().cpu()
    samples = float((p * rows[:, None] * cols[None, :]).sum())
    if kw["mode"] >= 1 and kw["fd"]:
        samples += float((p[0] * cols).sum() + (p[-1] * cols).sum())
    inputs = [t for t in (*args, *kw.values()) if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in inputs) + 8 * hi * wi * 4
    ops = ops_per_sample(kw["mode"], kw["fd"], kw.get("n_extra", 0))
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


def main_path(grid, card):
    """The headline frame through api.render, per shading."""
    import torch
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import swslice
    from ovr_tpu_torch.render import accel

    scene = make_scene(grid, "bench", "persp")
    mc = accel.build_macrocells(grid, scene.tfn.alpha,
                                scene.tfn.value_range)
    width, height, frames, warm = 1920, 1080, FRAMES, WARMUP
    results = {}
    swslice.LAUNCHES = 0
    for shading in ("diffuse", "none", "shadow"):
        cfg = api.RenderConfig(
            width=width, height=height, spp=1, sampling_rate=1024.0,
            shading=shading, method="auto", fast_math=True,
            use_macrocells=True).resolved(scene)
        if cfg.sw is None:
            raise SystemExit(f"{shading}: the headline does not take the "
                             "kernel's shear-warp path")
        lg = (api.build_light_grid(scene, cfg) if shading == "shadow"
              else None)
        n0 = swslice.LAUNCHES
        frame = api.render(scene, cfg, macrocells=mc, light_grid=lg)
        torch.cuda.synchronize()
        rgba = frame.rgba
        finite = bool(torch.isfinite(rgba).all() and torch.isfinite(
            frame.grad).all() and torch.isfinite(frame.depth).all())
        a = rgba[..., 3]
        if not (finite and float(a.min()) >= 0.0 and float(a.max()) <= 1.0
                and float(a.max()) > 0.5
                and tuple(rgba.shape) == (height, width, 4)):
            raise SystemExit(f"{shading} frame failed its checks")
        for _ in range(warm):
            api.render(scene, cfg, macrocells=mc, light_grid=lg)
        torch.cuda.reset_peak_memory_stats()
        frame_ms = cuda_ms(lambda: api.render(scene, cfg, macrocells=mc,
                                              light_grid=lg), frames)
        peak = torch.cuda.max_memory_allocated()
        if swslice.LAUNCHES - n0 != 1 + warm + frames:
            raise SystemExit(f"{shading}: {swslice.LAUNCHES - n0} kernel "
                             f"launches for {1 + warm + frames} frames")
        results[shading] = dict(frame_ms=frame_ms, peak_bytes=peak,
                                cfg=cfg, lg=lg,
                                alpha_mean=float(a.mean()))
    launches = swslice.LAUNCHES
    breakdown(scene, results["diffuse"]["cfg"], mc)

    # the kernel alone, and against its plain version, on the inputs of
    # each headline frame (these launches are not the main path's)
    for shading, r in results.items():
        args, kw = capture(scene, r["cfg"], macrocells=mc,
                           light_grid=r["lg"])
        hi, wi = args[4].shape[0], args[3].shape[0]
        planes = torch.zeros(-(-hi // swslice.BLOCK_ROWS)
                             * -(-wi // swslice.BLOCK_COLS),
                             dtype=torch.int32, device=grid.device)
        full = swslice.slice_composite(*args, **dict(kw, block_planes=planes))
        r["kernel_ms"] = cuda_ms(
            lambda: swslice.slice_composite(*args, **kw), 5)
        (r["bound_ms"], r["bound_by"], r["samples"], r["bytes"],
         r["ops_per_sample"]) = bound(args, kw, planes)
        r["fan"] = (hi, wi)
        r["planes"] = args[6]
        band_check(shading, r, args, kw, full)
        mrays = width * height / (r["frame_ms"] * 1e-3) / 1e6
        log(f"headline {shading:7s} 1920x1080 1024^3 bf16: frame "
            f"{r['frame_ms']:.2f} ms ({mrays:.2f} Mrays/s), kernel "
            f"{r['kernel_ms']:.2f} ms, bound {r['bound_ms']:.2f} ms "
            f"({r['bound_by']}; {r['samples']:.3e} samples needed of "
            f"{hi * wi * args[6]:.3e}, {r['ops_per_sample']} ops each), "
            f"peak memory {r['peak_bytes'] / 2**30:.2f} GiB, fan {hi}x{wi}, "
            f"{args[6]} planes, mean alpha {r['alpha_mean']:.3f}; {card}")
        r["mrays_s"] = mrays
    return results, launches


def band_check(shading, r, args, kw, full):
    """The kernel against its plain version on the headline frame's own
    inputs, cut to a band of BAND_ROWS fan rows (all columns) that starts
    on a block boundary in the middle of the fan; times both there."""
    import torch
    from ovr_tpu_torch.ops import swslice
    hi = args[4].shape[0]
    r0 = (hi // 2 - BAND_ROWS // 2) // swslice.BLOCK_ROWS * swslice.BLOCK_ROWS
    band = list(args)
    band[4] = args[4][r0:r0 + BAND_ROWS]
    out = swslice.slice_composite(*band, **kw)
    ref = swslice.slice_composite_plain(*band, **kw)
    err_c, err_a, err_d, ok = compare(out, ref, kw["term"])
    alpha_max = float(ref[7].max())
    r["band"] = f"fan rows {r0}-{r0 + BAND_ROWS - 1} of {hi}, all columns"
    r["band_err"] = max(err_c, err_a, err_d)
    r["band_plain_ms"] = cuda_ms(
        lambda: swslice.slice_composite_plain(*band, **kw), 1)
    r["band_kernel_ms"] = cuda_ms(
        lambda: swslice.slice_composite(*band, **kw), 5)
    # the band's FD rows lie on its own row lattice, so it matches the
    # full frame's rows closely but not bit for bit
    vs_full = float((out - full[:, r0:r0 + BAND_ROWS]).abs().max())
    log(f"parity headline {shading:7s} {r['band']}: rgb/n {err_c:.2e} "
        f"alpha {err_a:.2e} depth {err_d:.2e} (max alpha {alpha_max:.3f}; "
        f"{vs_full:.2e} from the full frame's rows); plain "
        f"{r['band_plain_ms']:.1f} ms, kernel {r['band_kernel_ms']:.3f} ms "
        f"{'ok' if ok else 'FAIL'}")
    if not ok or alpha_max < 0.05 or not torch.isfinite(out).all():
        raise SystemExit("kernel disagrees with the plain version on the "
                         "headline frame's inputs")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # fails (ImportError) when run outside the repository
    from ovr_tpu_torch.ops import swslice  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({torch.cuda.device_count()} visible); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    build_kernel()

    dev = torch.device("cuda")
    grids = {}
    for n in (64, 256, 1024):
        for kind_f in ("bench", "sparse"):
            if n == 1024 and kind_f == "sparse":
                continue
            g = field(n, kind_f, dev)
            dts = ("bf16",) if n == 1024 else ("f32", "bf16", "u8")
            for dt in dts:
                if dt == "f32":
                    grids[(n, dt, kind_f)] = g
                elif dt == "bf16":
                    grids[(n, dt, kind_f)] = g.to(torch.bfloat16)
                else:
                    grids[(n, dt, kind_f)] = torch.clamp(
                        torch.round(g * 255), 0, 255).to(torch.uint8)
            del g
    worst = parity(grids)
    log(f"parity: all cases agree, largest difference {worst:.2e} "
        f"({time.perf_counter() - t0:.0f} s so far)")

    results, launches = main_path(grids[(1024, "bf16", "bench")], smi)
    if launches < 1:
        raise SystemExit("the main path never launched the slice kernel")
    head = results["diffuse"]
    worst = max([worst] + [r["band_err"] for r in results.values()])
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    entry = {
        "name": "swslice",
        "route": "cuda",
        "source": "ovr_tpu_torch/csrc/swslice.cu",
        "replaces": "ovr_tpu/ops/swslice.py:660",
        "also_replaces": "ovr_tpu/ops/swslice.py:561",
        "launches": launches,
        "max_abs_err": worst,
        "ms": head["kernel_ms"],
        "plain_ms": head["band_plain_ms"],
        "plain_shape": f"headline diffuse inputs, {head['band']}",
        "kernel_ms_at_plain_shape": head["band_kernel_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": "1024^3 bf16, 1920x1080, 1024 planes, diffuse",
        "modes": {s: {k: r[k] for k in ("kernel_ms", "frame_ms", "mrays_s",
                                         "bound_ms", "bound_by", "samples",
                                         "ops_per_sample", "band_plain_ms",
                                         "band_kernel_ms", "band_err",
                                         "peak_bytes")}
                  for s, r in results.items()},
        "card": smi,
    }
    log(f"total {time.perf_counter() - t0:.0f} s")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
