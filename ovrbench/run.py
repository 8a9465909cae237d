"""Run one cell of the port's benchmark once.

    python3 -m ovrbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `ovrbench/` and
the program, `ovr_tpu_torch/`. The cell, its configuration, its traffic
mix and its metrics are found by the names in `BENCHMARK.json`: the
configuration's data file names its seeded volume generator
(`content/<name>.py`), the mix is `traffic/<mix>.json` (read by
`frames.py`), each metric is read by `metrics/<metric>.py`, and the
limits of the comparison are in `limits/<cell>.json`.

A configuration names its pipeline. Its "render" block holds the
harness's own keys (`fovy`, `eye_distance`, `up`, `light_direction`),
and every other key goes to the field of that name of
`api.RenderConfig` (`width`, `height`, `spp`, `sampling_rate`,
`method`, `use_macrocells`, and as a pipeline needs them
`path_tracing`, `max_scatters`, `ray_chunk`, `pt_dense`, ...); a key
that names no field stops the run, so a misspelt key can never fall
back to shear-warp. `shading` and `base_rate` are the mix's. The
optional key `check` names the comparison and the roofline's count,
`checks/<check>.py` (`shearwarp` where the key is absent), loaded from
the checkout by path as `content/` modules are. A check module has
  compare(held, ctx) -> {"rgba_err", "checked_px", "errs"}
over the held frames (`check.Held`: eye, alpha, rgba, k, n_accumulated)
and, optionally,
  bound(ctx, views) -> {view: (seconds, "bytes" | "operations")}
the slice kernel's least time for each traced view (`views`: the
record of each view's first traced frame, rgba None), which
`k1_roofline_pct` reads; a module without `bound` leaves that metric
out. `ctx` holds the run's inputs: `grid` (on the run's device),
`config` (with the test's overrides), `render` (its block), `mix`,
`shading`, `color`, `base_rate`, `center`, `value_range`, `seed`,
`device` and `render_fields` (the `RenderConfig` keywords the run built
the Renderer with).

A run: the volume made on the card from the seed; the program's
`api.Renderer` over it (with frame accumulation switched on first where
the mix says `accumulate`); the cell's views rendered once (set-up,
which builds the slice kernel the first time in a checkout); then a
closed loop with one user, each frame as the viewer does it: the mix's
setter calls, `commit()`, `render()` and `mapframe()["rgba"]`, for
`--seconds` (frames begun before the deadline finish). With `--trace 1`
a fixed set of the mix's frames runs instead, under torch.profiler,
with every span synchronized. After the window the program's state is
freed and frames drawn from the seed are held against the plain
reference by the check module (`check.py`).

The last line of stdout is one JSON object: correct, attempted (frames),
failed (held frames beyond the limit), metrics, device and, traced, the
breakdown, with the numbers compared last. Without a card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded, the
run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ovr_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def process_start() -> float:
    """Wall-clock time at which this process started (Linux /proc), or
    the time this module was first imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        ticks = os.sysconf("SC_CLK_TCK")
        return time.time() - uptime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---- the benchmark's files, found by name ----------------------------------

def load_json(root: Path, rel: str) -> dict:
    with open(root / rel) as f:
        return json.load(f)


def load_module(root: Path, rel: str) -> types.ModuleType:
    path = root / rel
    name = "ovrbench_file_" + rel.replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with its configuration, mix, limits and
    the metrics it reports."""

    def __init__(self, root: Path, name: str):
        bench = load_json(root, "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
        self.root, self.name = root, name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        cfg_entry = {c["name"]: c for c in bench["configs"]}[
            self.entry["config"]]
        self.config = load_json(root, cfg_entry["file"])
        self.mix = load_json(root, f"ovrbench/traffic/"
                                   f"{self.entry['traffic']}.json")
        self.limits = load_json(root, f"ovrbench/limits/{name}.json")

        def mine(m):
            return m.get("workloads") is None or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def readers(self, traced: bool) -> list:
        out = []
        for m in (self.per_layer if traced else self.end_to_end):
            mod = load_module(self.root, f"ovrbench/metrics/{m['name']}.py")
            out.append((m, mod))
        return out


# ---- one run ---------------------------------------------------------------

HARNESS_RENDER_KEYS = ("fovy", "eye_distance", "up", "light_direction")
MIX_RENDER_FIELDS = ("shading", "base_rate")


def render_fields(render: dict, shading: str, base_rate: float,
                  render_options: dict | None = None) -> dict:
    """The `api.RenderConfig` keywords of a run: every key of the
    configuration's "render" block but the harness's own
    (`HARNESS_RENDER_KEYS`), the mix's shading and opacity-correction
    base, then `render_options` over them. A render key that names no
    field of `RenderConfig`, or one of the mix's, stops the run."""
    import dataclasses

    from ovr_tpu_torch import api

    names = {f.name for f in dataclasses.fields(api.RenderConfig)}
    out = {}
    for k, v in render.items():
        if k in HARNESS_RENDER_KEYS:
            continue
        if k in MIX_RENDER_FIELDS:
            raise SystemExit(f"render key {k!r}: the traffic mix sets it")
        if k not in names:
            raise SystemExit(f"render key {k!r} is no field of "
                             "api.RenderConfig")
        out[k] = v
    out.update(base_rate=base_rate, shading=shading)
    out.update(render_options or {})
    return out


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             overrides: dict | None = None, render_options: dict | None = None,
             t_start: float | None = None) -> tuple:
    """Run the cell once on `device`. `overrides` replaces keys of the
    configuration and of its "render" settings (small sizes for tests on
    the CPU); `render_options` are `RenderConfig` fields over the
    configuration's (a lower precision for the control). Returns (result
    dict, stderr lines of the numbers compared)."""
    import torch

    from ovr_tpu_torch import api
    from ovr_tpu_torch.core.scene import (Camera, Light, Scene,
                                          StructuredVolume, TransferFunction)

    from ovrbench import check, frames, trace

    t_start = process_start() if t_start is None else t_start
    config = json.loads(json.dumps(cell.config))
    for k, v in (overrides or {}).items():
        if k == "render":
            config["render"].update(v)
        else:
            config[k] = v
    render = config["render"]
    mix = cell.mix
    shading = mix["shading"]
    traffic = frames.Traffic(config, mix)
    base_rate = traffic.base_rate()
    fields = render_fields(render, shading, base_rate, render_options)
    checker = load_module(cell.root, f"ovrbench/checks/"
                                     f"{config.get('check', 'shearwarp')}.py")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    content = load_module(cell.root, f"ovrbench/content/"
                                     f"{config['content']}.py")
    dtype = {"uint16": torch.uint16, "float32": torch.float32,
             "bfloat16": torch.bfloat16, "uint8": torch.uint8}[
        config["dtype"]]
    nx, ny, nz = config["dims_xyz"]

    torch.manual_seed(seed)
    with torch.no_grad():
        grid = content.make((nz, ny, nx), dtype, seed, dev)
    if cuda:
        torch.cuda.synchronize()
        peak_before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    color, base_alpha = traffic.color(), traffic.base_alpha()
    center = traffic.center
    vr = tuple(config["value_range"])
    vol = StructuredVolume.create(grid, world_lo=config["world_lo"],
                                  world_hi=config["world_hi"],
                                  data_range=vr, device=dev)
    scene = Scene.create(
        vol, TransferFunction.create(color, base_alpha, vr, device=dev),
        light=Light.create(direction=render["light_direction"], device=dev),
        camera=Camera.create(from_=traffic.first_eye(), at=center,
                             up=render["up"], fovy=render["fovy"],
                             device=dev))
    renderer = api.Renderer(scene, api.RenderConfig(**fields))
    if traffic.accumulate:
        renderer.set_frame_accumulation(True)
    spans = trace.Spans(traced, dev)
    # the scene as the Renderer holds it; "n" counts the frames rendered
    # since the last camera or TF call (the frames a mean accumulates)
    state = {"eye": traffic.first_eye(), "alpha": base_alpha, "n": 0}

    def frame(spec):
        with spans.span("setters"):
            if spec.eye is not None:
                renderer.set_camera(from_=spec.eye, at=center,
                                    up=render["up"])
                state["eye"], state["n"] = spec.eye, 0
            if spec.alpha is not None:
                renderer.set_transfer_function(color, spec.alpha, vr)
                state["alpha"], state["n"] = spec.alpha, 0
        with spans.span("commit"):
            renderer.commit()
        with spans.span("render"):
            renderer.render()
        state["n"] += 1
        with spans.span("mapframe"):
            rgba = renderer.mapframe()["rgba"]
        return rgba

    def record(k, rgba):
        return check.Held(state["eye"], state["alpha"], rgba, k, state["n"])

    for spec in traffic.warmup():
        frame(spec)
    if cuda:
        torch.cuda.synchronize()
    spans.items.clear()

    held = check.Reservoir(int(mix["check_frames"]), seed)
    times, tdata, counts = [], None, None
    if not traced:
        setup_s = time.time() - t_start
        deadline = time.perf_counter() + seconds
        for k, spec in enumerate(traffic.window()):
            t0 = time.perf_counter()
            if t0 >= deadline and k:
                break
            rgba = frame(spec)
            times.append((t0, time.perf_counter()))
            held.offer(k, record(k, rgba))
    else:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        plan = traffic.traced()
        setup_s = time.time() - t_start
        views = {}
        with profile(activities=acts) as prof:
            for k, (spec, view) in enumerate(plan):
                t0 = time.perf_counter()
                with spans.span("frame"):
                    rgba = frame(spec)
                times.append((t0, time.perf_counter()))
                held.offer(k, record(k, rgba))
                views.setdefault(view, record(k, None))
        tdata = trace.TraceData(prof, len(plan))
        counts = (plan, views)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    lat = sorted((t1 - t0) * 1e3 for t0, t1 in times)
    log("frame ms: " + ", ".join(
        f"p{q} {lat[min(len(lat) - 1, int(q / 100 * len(lat)))]:.2f}"
        for q in (5, 25, 50, 75, 90, 95, 99)) + f", max {lat[-1]:.2f}; "
        "span ms, mean: " + ", ".join(
            f"{n} {1e3 * sum(d) / len(d):.2f}" for n in
            ("setters", "commit", "render", "mapframe")
            if (d := spans.durations(n))))
    del renderer, scene, vol
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    run = types.SimpleNamespace(
        width=render["width"], height=render["height"], spp=render["spp"],
        frame_times=times, spans=spans, setup_s=setup_s, peak_bytes=peak,
        trace=tdata, bound_s=None, bound_by=None)
    ctx = types.SimpleNamespace(
        grid=grid, config=config, render=render, mix=mix, shading=shading,
        color=color, base_rate=base_rate, center=center, value_range=vr,
        seed=seed, device=dev, render_fields=fields)
    t_ref = time.perf_counter()
    if traced and cuda and hasattr(checker, "bound"):
        plan, views = counts
        per_view = checker.bound(ctx, views)
        run.bound_s = sum(per_view[v][0] for _, v in plan)
        binds = [per_view[v][1] for _, v in plan]
        run.bound_by = max(set(binds), key=binds.count)
        log(f"k1 bound over {len(plan)} traced frames: {run.bound_s * 1e3:.3f}"
            f" ms, bound by {run.bound_by}; counted in "
            f"{time.perf_counter() - t_ref:.1f} s")
        t_ref = time.perf_counter()

    with torch.no_grad():
        numbers = checker.compare(held.items, ctx)
    correct, rows = check.verdict(numbers, cell.limits)
    log(f"reference: {len(held.items)} held frames in "
        f"{time.perf_counter() - t_ref:.1f} s")
    metrics = {}
    for m, mod in cell.readers(traced):
        value = mod.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": int(max(peak, peak_before))
                if cuda else 0}
    result = {"correct": bool(correct), "attempted": len(times),
              "failed": sum(e > cell.limits["rgba_err"]["max"]
                            for e in numbers["errs"]),
              "metrics": metrics, "device": dev_info}
    if tdata is not None:
        dev_info["busy_s"] = tdata.busy_s
        dev_info["window_s"] = tdata.window_s
        result["breakdown"] = {"device_ops": tdata.top_ops(),
                               "idle_gaps": tdata.idle_gaps()}
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim, _ in rows}
    lines = [f"compared {name} {v!r} limit {lim!r} "
             f"({'holds' if ok else 'FAILS'})" for name, v, lim, ok in rows]
    lines.append(f"held frames' rgba_err: {numbers['errs']!r}")
    return result, lines


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = ROOT
    if not (root / "ovr_tpu_torch").is_dir():
        log("the program (ovr_tpu_torch/) is not in this checkout")
        return 2
    cell = Cell(root, args.workload)
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " available")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)  # one process, one host thread of load
    log(f"{cell.name} seed {args.seed} seconds {args.seconds} trace "
        f"{args.trace}; card {card()}")
    result, lines = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), "cuda", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}; no result")
        return 4
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
