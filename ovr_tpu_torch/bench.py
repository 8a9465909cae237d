"""Rays/s benchmark of the port (port of the repository's `bench.py`).

    python3 -m ovr_tpu_torch.bench                       # on the card
    BENCH_DEVICE=cpu BENCH_GRID=16 BENCH_WIDTH=48 BENCH_HEIGHT=32 \\
        BENCH_FRAMES=2 BENCH_WARMUP=1 python3 -m ovr_tpu_torch.bench

Reads bench.py's BENCH_* knobs with its defaults and meanings, builds its
scenes and renders its frames through `api.render`, and prints ONE JSON
line on stdout: {"metric", "value", "unit", "vs_baseline"}, the value
rays/s = width * height * spp * frames / time, the metric text and the
config key built as bench.py builds them (the key's platform `cuda` or
`cpu`). Everything else goes to stderr: the key, the card's name and
power limit (nvidia-smi), which path rendered (cfg.sw), frame ms by CUDA
events and by the host clock, peak device memory, and the slice kernel's
launches and plain-version calls, which must match the frames: a frame
that should launch the kernel on the card launches it once, and no frame
on the card runs the plain version.

The headline (no knobs, on the card): bench.py's synthetic field at
1024^3 as bf16, 1920x1080, rate 1024, `auto`, diffuse, macrocells on, 3
warm-up and 10 timed frames. `BENCH_DEVICE=cpu` (bench.py's
JAX_PLATFORMS=cpu) runs on the CPU (default grid 256); without it and
without a CUDA device the bench exits non-zero and prints no result.

Timing: the warm-up frames, a synchronize, then the timed frames between
two CUDA events on the current stream, each frame chained on the last
through a live input (the camera or the TF alpha, + mean * 1e-9 kept on
the device); the host clock beside them. On the CPU, the host clock.

Modes, in bench.py's order of precedence: BENCH_NEURAL=train (the
inverse-rendering step on a zero target), BENCH_MESH=TxB (T*B ranks of
`parallel.multihost.run_ranks`: this module with `--rank`; one card per
rank over NCCL where there are enough cards, else gloo ranks that share
the card, keyed `-mesh<TxB>-shared`; every rank times its window after
a barrier and the slowest window counts), BENCH_BACKWARD=1 (the
gradients of mean(rgba^2) + mean(grad^2) in the grid and the TF alpha),
BENCH_TIMEVAR=K (K host timesteps in pinned memory, t+1 copied on a side
stream before t renders), else the forward frame. BENCH_COLWIN and
BENCH_PERSIST chose TPU kernel variants; here the same kernel runs, and
they change only the key.

`vs_baseline`: against the first run of the same key in this package's
own book, `BASELINE_PATH` (never the JAX package's BASELINE_SELF.json);
the first run of a key writes it there and reports null.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ovr_tpu_torch import api
from ovr_tpu_torch.core.scene import Camera, Light, Scene, simple_scene
from ovr_tpu_torch.ops import swslice

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BASELINE_SELF.json")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_TIMEOUT_S = 900.0  # wall limit of a BENCH_MESH job of ranks
CHAIN_SCALE = 1e-9  # each frame's input moves by its predecessor's mean x


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


# ---- the scene -------------------------------------------------------------

def field_on_device(n: int, device, z_rows=None) -> torch.Tensor:
    """bench.py's synthetic field built with torch on `device`, as bench.py
    builds it on the accelerator for n >= 512 (`jnp`); `z_rows` (an index
    tensor) keeps those Z rows only, computed alone (a brick's slab)."""
    ax = torch.linspace(0, 1, n, dtype=torch.float32, device=device)
    x, y, z = ax[None, None, :], ax[None, :, None], ax[:, None, None]
    if z_rows is not None:
        z = z[z_rows.to(ax.device)]
    g = 0.5 + 0.35 * torch.sin(12 * x) * torch.cos(10 * y) * torch.sin(8 * z)
    return g + 0.15 * torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2
                                  + (z - 0.5) ** 2) * 40)


def field_on_host(n: int) -> np.ndarray:
    """bench.py's synthetic field with numpy, as bench.py builds it for
    n < 512: the same bits."""
    z, y, x = np.meshgrid(*([np.linspace(0, 1, n, dtype=np.float32)] * 3),
                          indexing="ij")
    g = 0.5 + 0.35 * np.sin(12 * x) * np.cos(10 * y) * np.sin(8 * z)
    g += 0.15 * np.exp(
        -((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) * 40)
    return g.astype(np.float32)


def build_scene(n: int = 256, device="cuda") -> Scene:
    """bench.py's scene: the field (on the device for n >= 512, else from
    numpy), the default TF, camera (0.5, 0.5, -1.6) -> the centre, fovy
    45."""
    g = (field_on_device(n, device) if n >= 512
         else torch.from_numpy(field_on_host(n)))
    scene = simple_scene(g, device=device)
    cam = Camera.create(from_=(0.5, 0.5, -1.6), at=(0.5, 0.5, 0.5),
                        fovy=45.0, device=device)
    return dataclasses.replace(scene, camera=cam)


def neural_field(device):
    """BENCH_NEURAL's field: `init_field` with hidden 64 and 2 hidden
    layers from a CPU generator seeded 0 (the same field on every
    device)."""
    from ovr_tpu_torch.neural.field import init_field
    return init_field(0, hidden=64, n_hidden=2, device=device)


def timevar_steps(n: int, k_steps: int, store: str) -> list:
    """BENCH_TIMEVAR's K host timesteps in the storage type, as CPU
    tensors: bench.py's formula, bit for bit (its small factors with
    numpy, the volume-sized product and sum, which IEEE rounds alike
    everywhere, with torch's threads; bf16 rounded to nearest even, u8
    as clip(round(g * 255)))."""
    ax = np.linspace(0, 1, n, dtype=np.float32)
    x, y, zz = ax[None, None, :], ax[None, :, None], ax[:, None, None]
    steps = []
    for k in range(k_steps):
        ph = 2 * np.pi * k / k_steps
        xy = 0.35 * np.sin(12 * x + ph) * np.cos(10 * y)
        gk = torch.from_numpy(xy) * torch.from_numpy(np.sin(8 * zz - ph))
        gk.add_(0.5)
        if store == "bf16":
            gk = gk.to(torch.bfloat16)
        elif store == "u8":
            gk = torch.clamp(torch.round(gk * 255), 0, 255).to(torch.uint8)
        steps.append(gk)
    return steps


# ---- the knobs -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Knobs:
    """bench.py's BENCH_* settings, read from an environment mapping."""

    device: torch.device
    grid: int
    width: int
    height: int
    rate: float
    frames: int
    warmup: int
    shading: str
    method: str
    store: str
    eye_inside: bool
    opaque: bool
    opaque_base: Optional[float]
    n_lights: int
    neural: str
    proxy: Optional[int]
    ray_chunk: str
    adaptive: float
    pt: str
    bf16: bool
    term: bool
    skip: bool
    colwin: bool
    persist: bool
    mesh: str
    backward: bool
    timevar: int
    timevar_key: str  # BENCH_TIMEVAR as given (the key spells it)

    @property
    def platform(self) -> str:
        return self.device.type


def read_knobs(env: Mapping[str, str]) -> Knobs:
    """The knobs of `env` with bench.py's defaults (`bench.py:77-158`);
    the device is the card unless BENCH_DEVICE=cpu."""
    device = torch.device(env.get("BENCH_DEVICE", "cuda"))
    n = int(env.get("BENCH_GRID", 1024 if device.type == "cuda" else 256))
    rate = float(env.get("BENCH_RATE", n))
    base = env.get("BENCH_OPAQUE_BASE")
    proxy = env.get("BENCH_PROXY")
    return Knobs(
        device=device, grid=n,
        width=int(env.get("BENCH_WIDTH", 1920)),
        height=int(env.get("BENCH_HEIGHT", 1080)), rate=rate,
        frames=int(env.get("BENCH_FRAMES", 10 if n >= 512 else 25)),
        warmup=int(env.get("BENCH_WARMUP", 3 if n >= 512 else 5)),
        shading=env.get("BENCH_SHADING", "diffuse"),
        method=env.get("BENCH_METHOD", "auto"),
        store=env.get("BENCH_STORE", "bf16" if n >= 512 else "f32"),
        eye_inside=env.get("BENCH_EYE", "") == "inside",
        opaque=env.get("BENCH_OPAQUE", "") == "1",
        opaque_base=None if base is None else float(base),
        n_lights=int(env.get("BENCH_EXTRA_LIGHTS", 0)),
        neural=env.get("BENCH_NEURAL", ""),
        proxy=None if proxy is None else int(proxy),
        ray_chunk=env.get("BENCH_RAY_CHUNK", ""),
        adaptive=float(env.get("BENCH_ADAPTIVE", 1.0)),
        pt=env.get("BENCH_PT", ""),
        bf16=env.get("BENCH_BF16", "") == "1",
        term=env.get("BENCH_TERM", "1") == "1",
        skip=env.get("BENCH_SKIP", "1") == "1",
        colwin=env.get("BENCH_COLWIN", "") == "1",
        persist=env.get("BENCH_PERSIST", "1") == "1",
        mesh=env.get("BENCH_MESH", ""),
        backward=env.get("BENCH_BACKWARD", "") == "1",
        timevar=int(env.get("BENCH_TIMEVAR", 0)),
        timevar_key=env.get("BENCH_TIMEVAR", ""))


def mesh_shape(k: Knobs) -> tuple[int, int]:
    t, b = (int(v) for v in k.mesh.lower().split("x"))
    return t, b


def mesh_shared(k: Knobs) -> bool:
    """Whether BENCH_MESH's ranks share a card (more ranks than cards)."""
    if not k.mesh or k.platform != "cuda":
        return False
    t, b = mesh_shape(k)
    return t * b > torch.cuda.device_count()


# ---- scene and config setup -----------------------------------------------

@dataclasses.dataclass
class Setup:
    """The scene, resolved config, macrocells and neural proxy of a run."""

    knobs: Knobs
    scene: Scene
    cfg: api.RenderConfig
    macrocells: object = None
    proxy: Optional[torch.Tensor] = None


def build_setup(k: Knobs) -> Setup:
    """bench.py's scene edits and config (`bench.py:87-179`), on the
    knobs' device: the eye inside, the opaque TF and its base rate, the
    storage type, the extra lights, the neural field; the RenderConfig;
    the neural proxy's bake and the macrocells."""
    dev = k.device
    with torch.no_grad():
        scene = build_scene(k.grid, dev)
        if k.eye_inside:
            scene = dataclasses.replace(scene, camera=Camera.create(
                from_=(0.5, 0.45, 0.3), at=(0.55, 0.5, 1.6), fovy=45.0,
                device=dev))
        base_rate = 1.0
        if k.opaque:
            scene = dataclasses.replace(scene, tfn=dataclasses.replace(
                scene.tfn, alpha=torch.linspace(0.6, 1.0, 16, device=dev)))
            base_rate = (k.opaque_base if k.opaque_base is not None
                         else k.rate / 4)
        vol = scene.volume
        if k.store == "bf16":
            vol = dataclasses.replace(vol, grid=vol.grid.to(torch.bfloat16))
        elif k.store == "u8":
            vol = dataclasses.replace(vol, grid=torch.clamp(
                torch.round(vol.grid * 255), 0, 255).to(torch.uint8))
        scene = dataclasses.replace(scene, volume=vol)
        if k.n_lights:
            scene = dataclasses.replace(scene, lights=tuple(
                Light.create(direction=(0.4 * i - 0.6, 0.3, -1.0),
                             intensity=0.5 + 0.1 * i, device=dev)
                for i in range(k.n_lights)))
        if k.neural:
            scene = dataclasses.replace(scene, volume=neural_field(dev))
        cfg = api.RenderConfig(
            width=k.width, height=k.height, spp=1, sampling_rate=k.rate,
            base_rate=base_rate, shading=k.shading, fast_math=True,
            use_macrocells=True, method=k.method,
            ray_chunk=int(k.ray_chunk) if k.ray_chunk else None,
            adaptive_scale=k.adaptive, sw_bf16=k.bf16, sw_term=k.term,
            sw_skip=k.skip, sw_col_win=k.colwin, sw_persist=k.persist,
            path_tracing=bool(k.pt), pt_dense=k.pt == "dense",
        ).resolved(scene)
        proxy = None
        if k.neural:
            from ovr_tpu_torch.neural.train import bake_grid_host
            r = k.proxy if k.proxy is not None else cfg.neural_proxy_res
            cfg = dataclasses.replace(cfg, neural_proxy_res=r).resolved(scene)
            if cfg.sw is not None:
                proxy = bake_grid_host(scene.volume, (r, r, r))
            # no proxy (the march): the field has no grid to partition
            mc_grid = proxy
        else:
            mc_grid = scene.volume.grid
        from ovr_tpu_torch.render import accel
        mc = (None if mc_grid is None else accel.build_macrocells(
            mc_grid, scene.tfn.alpha, scene.tfn.value_range))
    return Setup(k, scene, cfg, mc, proxy)


def moved(scene: Scene, chain: torch.Tensor) -> Camera:
    """The scene's camera with its eye moved by `chain`."""
    cam = scene.camera
    return dataclasses.replace(cam, from_=cam.from_ + chain)


def slice_loops_per_frame(cfg: api.RenderConfig) -> int:
    """Slice-loop runs (kernel launches on the card) of one frame or
    step: one on the shear-warp path, none on the march or a path
    tracer."""
    return int(cfg.sw is not None and not cfg.path_tracing)


# ---- the frames ------------------------------------------------------------

def forward_frame(s: Setup) -> Callable:
    """bench.py's default frame (`bench.py:303-327`): the shadow lattice
    and the dense path tracer's fields built once; chained through the
    camera where a lattice, PT fields or a proxy exist, else through the
    TF alpha."""
    scene, cfg = s.scene, s.cfg
    with torch.no_grad():
        lg = (api.build_light_grid(scene, cfg)
              if api._wants_light_grid(cfg) else None)
        ptf = None
        if cfg.path_tracing and cfg.pt_dense and cfg.sw is not None:
            from ovr_tpu_torch.render import ptdense
            ptf = ptdense.prepare(scene, cfg)

    def frame(i, chain):
        if lg is not None or ptf is not None or s.proxy is not None:
            return api.render(scene, cfg, camera=moved(scene, chain),
                              frame_index=i, macrocells=s.macrocells,
                              light_grid=lg, pt_fields=ptf,
                              proxy_grid=s.proxy)
        tfn = dataclasses.replace(scene.tfn, alpha=scene.tfn.alpha + chain)
        return api.render(dataclasses.replace(scene, tfn=tfn), cfg,
                          frame_index=i, macrocells=s.macrocells)

    return frame


def make_grad_step(s: Setup) -> Callable:
    """BENCH_BACKWARD's step (`bench.py:233-262`): (grid, alpha) ->
    gradients of mean(rgba^2) + mean(grad^2) in both, through the slice
    kernel's forward and the adjoint (the grid in its storage type)."""
    scene, cfg = s.scene, s.cfg
    with torch.no_grad():
        lgb = (api.build_light_grid(scene, cfg)
               if api._wants_light_grid(cfg) else None)

    def grad_step(grid, alpha):
        g = grid.detach().requires_grad_(True)
        a = alpha.detach().requires_grad_(True)
        sc = dataclasses.replace(
            scene, volume=dataclasses.replace(scene.volume, grid=g),
            tfn=dataclasses.replace(scene.tfn, alpha=a))
        with torch.enable_grad():
            f = api.render(sc, cfg, light_grid=lgb)
            loss = torch.mean(f.rgba ** 2) + torch.mean(f.grad ** 2)
            return torch.autograd.grad(loss, (g, a))

    return grad_step


def backward_frame(s: Setup) -> Callable:
    grad_step = make_grad_step(s)
    grid, alpha = s.scene.volume.grid, s.scene.tfn.alpha

    def frame(i, chain):
        # the chain in the grid's storage type: no f32 copy of a bf16 grid
        gg, ga = grad_step(grid + chain.to(grid.dtype), alpha)
        return gg.float().mean() + ga.mean()

    return frame


def timevar_frame(s: Setup) -> Callable:
    """BENCH_TIMEVAR (`bench.py:268-302`): K host timesteps in pinned
    memory (`apps.render_batch.HostStaging`, one slot each); the copy of
    step t+1 goes out on a side stream before step t renders, and the
    default stream waits on that copy's event before it reads the grid.
    Chained through the camera."""
    from ovr_tpu_torch.apps.render_batch import HostStaging
    k, scene, cfg = s.knobs, s.scene, s.cfg
    k_steps = k.timevar
    steps = timevar_steps(k.grid, k_steps, k.store)
    stage = HostStaging(steps[0], k.device, slots=k_steps)
    for t, step in enumerate(steps):
        stage.fill(t, step)
    del steps
    pending = {0: stage.upload(0)}

    def frame(i, chain):
        # the warm-up and timed loops both start at i = 0: upload on
        # demand when the prefetched step is missing
        cur = pending.pop(i % k_steps, None)
        if cur is None:
            cur = stage.upload(i % k_steps)
        pending[(i + 1) % k_steps] = stage.upload((i + 1) % k_steps)
        grid, events = cur
        stage.ready(events)
        sc = dataclasses.replace(scene, volume=dataclasses.replace(
            scene.volume, grid=grid))
        return api.render(sc, cfg, camera=moved(scene, chain),
                          frame_index=i, macrocells=s.macrocells)

    return frame


def train_frame(s: Setup) -> Callable:
    """BENCH_NEURAL=train (`bench.py:183-200`): the inverse-rendering step
    at lr 1e-3 against a zero target, chained through the camera."""
    from ovr_tpu_torch.neural.train import make_image_train_step
    k, scene = s.knobs, s.scene
    target = torch.zeros((k.height, k.width, 4), dtype=torch.float32,
                         device=k.device)
    step, state = make_image_train_step(scene, s.cfg, lr=1e-3)
    box = [state]

    def frame(i, chain):
        box[0], loss = step(box[0], moved(scene, chain), target)
        return loss

    return frame


def make_frame(s: Setup) -> Callable:
    """frame(i, chain) -> an `api.Frame` (its rgba) or a device tensor
    whose mean chains the next frame, for the knobs' mode (BENCH_MESH runs
    in ranks: `rank_main`)."""
    k = s.knobs
    if k.neural == "train":
        return train_frame(s)
    if k.backward:
        return backward_frame(s)
    if k.timevar:
        return timevar_frame(s)
    return forward_frame(s)


# ---- timing ----------------------------------------------------------------

@dataclasses.dataclass
class Timing:
    seconds: float  # the timed frames: CUDA events on the card, else host
    host_seconds: float
    frames: int
    launches: int  # slice kernel launches over warm-up and timed frames
    launches_bf16: int
    plain_calls: int  # runs of the slice loop's plain version
    peak_bytes: Optional[int]


def chained(out) -> torch.Tensor:
    """The next frame's chain from a frame's output (bench.py's
    `rgba.mean() * 1e-9`), on the device."""
    x = out.rgba if isinstance(out, api.Frame) else out
    return x.mean().float() * CHAIN_SCALE


def timed_run(frame: Callable, warmup: int, frames: int, device,
              barrier: Callable = lambda: None) -> Timing:
    """The warm-up frames, a synchronize (and `barrier`), then `frames`
    frames between two CUDA events on the current stream, each chained on
    the last; synchronized at the end, with the host clock beside the
    events. No value comes to the host inside the loop."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    n0, b0, p0 = (swslice.LAUNCHES, swslice.LAUNCHES_BF16,
                  swslice.PLAIN_CALLS)
    with torch.no_grad():
        chain = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(warmup):
            chain = chained(frame(i, chain))
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        barrier()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for i in range(frames):
            chain = chained(frame(i, chain))
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
        host = time.perf_counter() - t0
    return Timing(
        seconds=start.elapsed_time(end) * 1e-3 if cuda else host,
        host_seconds=host, frames=frames,
        launches=swslice.LAUNCHES - n0,
        launches_bf16=swslice.LAUNCHES_BF16 - b0,
        plain_calls=swslice.PLAIN_CALLS - p0,
        peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else None)


def check_slice_loop(t: Timing, cfg: api.RenderConfig, bf16: bool,
                     rendered: int, device) -> None:
    """The slice loop ran once a frame where the frame takes it: on the
    card as a kernel launch (the bf16 variant under sw_bf16) and never as
    the plain version; on the CPU as the plain version."""
    n = rendered * slice_loops_per_frame(cfg)
    if torch.device(device).type == "cuda":
        want = (n, n if bf16 else 0, 0)
    else:
        want = (0, 0, n)
    got = (t.launches, t.launches_bf16, t.plain_calls)
    if got != want:
        raise SystemExit(
            f"bench: {got[0]} kernel launches ({got[1]} of the bf16 "
            f"variant) and {got[2]} plain calls for {rendered} frames; "
            f"expected {want}")


# ---- key, metric, book -----------------------------------------------------

def config_key(k: Knobs, cfg: api.RenderConfig) -> str:
    """bench.py's config key (`bench.py:346-370`), platform `cuda` or
    `cpu`; ranks that share a card add `-shared` after the mesh."""
    store_sfx = ("" if k.store == ("bf16" if k.grid >= 512 else "f32")
                 else f"-s{k.store}")
    return (f"{k.platform}-{k.grid}-{k.width}x{k.height}-{k.rate}-"
            f"{cfg.shading}-{k.method}" + store_sfx
            + ("-bwd" if k.backward else "")
            + (f"-l{k.n_lights}" if k.n_lights else "")
            + (f"-rc{k.ray_chunk}" if k.ray_chunk else "")
            + ("-mm16" if k.bf16 else "")
            + ("" if k.term else "-noterm") + ("" if k.skip else "-noskip")
            + ("" if k.persist else "-legacy")
            + ("-cw" if k.colwin else "")
            + ("-opq" if k.opaque else "")
            + ("-eyein" if k.eye_inside else "")
            + (f"-as{k.adaptive:g}" if k.adaptive != 1.0 else "")
            + (f"-pt{k.pt}" if k.pt else "")
            + (f"-tv{k.timevar_key}" if k.timevar_key else "")
            + (f"-mesh{k.mesh}" if k.mesh else "")
            + ("-shared" if mesh_shared(k) else "")
            + (f"-nf{k.neural}{cfg.neural_proxy_res}" if k.neural else ""))


def metric_text(k: Knobs, cfg: api.RenderConfig) -> str:
    """bench.py's metric text (`bench.py:389-404`)."""
    if k.neural:
        desc = (f"neural hash-grid MLP via baked {cfg.neural_proxy_res}^3 "
                f"proxy" + (", full train step" if k.neural == "train"
                            else ""))
    elif k.pt == "dense":
        desc = "dense discrete-ordinates path tracer + shear-warp gather"
    elif k.pt:
        desc = "delta-tracking path tracer, macrocell DDA"
    else:
        desc = ("shear-warp compositing" if cfg.sw is not None
                else "march, macrocell skipping")
    kind = "backward" if k.backward else "forward"
    if k.backward:
        desc += ", grid+TF grads via bounded-memory adjoint"
    return (f"{kind} rays/s ({k.grid}^3 {k.store} grid, {k.width}x"
            f"{k.height}, {cfg.shading} shading, {desc})")


def vs_baseline(key: str, value: float, path: str) -> Optional[float]:
    """value / the book's entry for `key`; the first run of a key writes
    it to the book and returns None (`bench.py:371-388`)."""
    book = {}
    if os.path.exists(path):
        with open(path) as f:
            book = json.load(f)
    if key in book:
        return value / book[key]
    book[key] = value
    with open(path, "w") as f:
        json.dump(book, f, indent=2, sort_keys=True)
    return None


# ---- reporting -------------------------------------------------------------

def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out[0] if out else "nvidia-smi printed nothing"


def path_of(cfg: api.RenderConfig) -> str:
    """Which path a frame of `cfg` takes."""
    if cfg.path_tracing:
        dense = cfg.pt_dense and cfg.sw is not None
        return ("dense path tracer (shear-warp gather, no slice kernel)"
                if dense else "Monte-Carlo path tracer (no slice kernel)")
    if cfg.sw is None:
        return "march (no slice kernel)"
    return (f"shear-warp, slice kernel: principal axis {cfg.sw.axis}, "
            f"{cfg.sw.n_slices} planes")


def report_timing(t: Timing, k: Knobs, label: str = "") -> None:
    ms, host_ms = t.seconds * 1e3 / t.frames, t.host_seconds * 1e3 / t.frames
    clock = "CUDA events" if k.platform == "cuda" else "host clock"
    peak = ("not measured (CPU)" if t.peak_bytes is None
            else f"{t.peak_bytes / 2**30:.3f} GiB")
    log(f"bench{label}: {t.frames} timed frames, {ms:.3f} ms a frame by "
        f"{clock}, {host_ms:.3f} ms by the host clock; peak device memory "
        f"{peak}; slice kernel launches {t.launches} (bf16 variant "
        f"{t.launches_bf16}), plain-version calls {t.plain_calls}")


# ---- BENCH_MESH ------------------------------------------------------------

def mesh_frame(s: Setup, mesh) -> tuple[Callable, api.RenderConfig]:
    """bench.py's mesh frame (`bench.py:202-232`): the config without step
    caps or jitter, slices aligned to the bricks; this rank's band through
    `tiles.render_sharded` (B = 1) or `bricks.render_bricked` over its
    own brick. Chained through the camera."""
    from ovr_tpu_torch.parallel import bricks, tiles
    scene = s.scene
    cfg = dataclasses.replace(
        s.cfg, sw_slice_align=mesh.n_bricks, max_steps=None,
        shadow_max_steps=None, jitter_rays=False).resolved(scene)
    with torch.no_grad():
        lgm = (api.build_light_grid(scene, cfg)
               if api._wants_light_grid(cfg) else None)
        bv = (bricks.brick_volume(scene.volume, mesh.n_bricks,
                                  only=mesh.brick)
              if mesh.n_bricks > 1 else None)

    def frame(i, chain):
        cam = moved(scene, chain)
        if bv is not None:
            return bricks.render_bricked(scene, bv, cfg, mesh, camera=cam,
                                         light_grid=lgm)
        return tiles.render_sharded(scene, cfg, mesh, camera=cam,
                                    light_grid=lgm)

    return frame, cfg


def rank_main(init: str, world: int, rank: int) -> int:
    """One rank of a BENCH_MESH job (the knobs from the environment): its
    frames timed after a barrier; prints `RESULT {json}`."""
    import torch.distributed as dist

    from ovr_tpu_torch.parallel import multihost
    from ovr_tpu_torch.parallel.mesh import make_mesh
    k = read_knobs(os.environ)
    t_n, b_n = mesh_shape(k)
    if k.platform == "cuda":
        own = world <= torch.cuda.device_count()
        dev = torch.device("cuda", rank if own else 0)
        torch.cuda.set_device(dev)
        backend = "nccl" if own else "gloo"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    k = dataclasses.replace(k, device=dev)
    multihost.initialize(init, world, rank, backend=backend)
    try:
        mesh = make_mesh(t_n, b_n, device=dev)
        s = build_setup(k)
        frame, cfg = mesh_frame(s, mesh)
        t = timed_run(frame, k.warmup, k.frames, dev, barrier=mesh.barrier)
        check_slice_loop(t, cfg, k.bf16, k.warmup + k.frames, dev)
        print("RESULT " + json.dumps(dict(
            dataclasses.asdict(t), rank=rank, backend=backend,
            device=str(dev), key=config_key(k, cfg),
            metric=metric_text(k, cfg), path=path_of(cfg))), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_mesh(k: Knobs, env: Mapping[str, str]) -> tuple[dict, list]:
    """BENCH_MESH's job: T*B ranks of this module (`rank_main`); returns
    (rank 0's result, every rank's result)."""
    from ovr_tpu_torch.parallel import multihost
    t_n, b_n = mesh_shape(k)
    child = dict(os.environ)
    child.update(env)
    child["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, child.get("PYTHONPATH", "")) if p)
    outs = multihost.run_ranks(
        [sys.executable, "-m", "ovr_tpu_torch.bench", "--rank"],
        t_n * b_n, MESH_TIMEOUT_S, env=child, cwd=ROOT)
    results = []
    for r, out in enumerate(outs):
        lines = [x for x in out.splitlines() if x.startswith("RESULT ")]
        if len(lines) != 1:
            raise SystemExit(f"bench: rank {r} printed no result:\n"
                             f"{out[-3000:]}")
        results.append(json.loads(lines[0][len("RESULT "):]))
    return results[0], results


# ---- the run ---------------------------------------------------------------

def run(env: Optional[Mapping[str, str]] = None,
        book: Optional[str] = None) -> dict:
    """One bench run on the knobs of `env` (default os.environ): the
    stderr report, and {"line": the stdout JSON object, "key", "timing",
    "path", "card", "ranks"}. `book`: the baseline book (default
    `BASELINE_PATH`)."""
    env = os.environ if env is None else env
    k = read_knobs(env)
    if k.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (BENCH_DEVICE=cpu runs on "
                         "the CPU)")
    smi = card() if k.platform == "cuda" else "cpu (no card)"
    log(f"bench: device {k.device}"
        + (f" ({torch.cuda.get_device_name(k.device)})"
           if k.platform == "cuda" else "")
        + f"; card {smi}")
    if k.colwin or not k.persist:
        log("bench: BENCH_COLWIN / BENCH_PERSIST chose TPU kernel variants; "
            "the same slice kernel runs here (they change the key only)")
    ranks = None
    if k.mesh and k.neural != "train":
        first, ranks = run_mesh(k, env)
        timings = [Timing(**{f: r[f] for f in Timing.__dataclass_fields__})
                   for r in ranks]
        for r, tr in zip(ranks, timings):
            log(f"bench: rank {r['rank']} on {r['device']} "
                f"({r['backend']}):")
            report_timing(tr, k, f" rank {r['rank']}")
        t = max(timings, key=lambda tr: tr.seconds)  # the slowest window
        key, metric, path = first["key"], first["metric"], first["path"]
    else:
        s = build_setup(k)
        frame = make_frame(s)
        t = timed_run(frame, k.warmup, k.frames, k.device)
        check_slice_loop(t, s.cfg, k.bf16, k.warmup + k.frames, k.device)
        key, metric, path = (config_key(k, s.cfg), metric_text(k, s.cfg),
                             path_of(s.cfg))
        report_timing(t, k)
    log(f"bench: key {key}")
    log(f"bench: path {path}")
    value = k.width * k.height * 1 * k.frames / t.seconds
    line = {"metric": metric, "value": value, "unit": "rays/s",
            "vs_baseline": vs_baseline(key, value,
                                       BASELINE_PATH if book is None
                                       else book)}
    return dict(line=line, key=key, timing=t, path=path, card=smi,
                ranks=ranks)


def main(env: Optional[Mapping[str, str]] = None) -> int:
    """Run the bench and print its one JSON line on stdout; non-zero
    without a device to run on (no line then)."""
    try:
        res = run(env)
    except SystemExit as e:
        if isinstance(e.code, str):
            log(e.code)
            return 1
        raise
    print(json.dumps(res["line"]), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    sys.exit(main())
