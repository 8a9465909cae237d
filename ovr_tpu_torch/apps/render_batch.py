"""Offline batch renderer + fps benchmark (port of `apps.render_batch`).

CLI mirror of the reference's `renderbatch` (`apps/main_batch.cpp:44-111`):

    python -m ovr_tpu_torch.apps.render_batch --scene scene.json
        [--device cuda|cpu] [--num-frames N] [--fbsize W H] [--spp N]
        [--pt] [--sampling-rate R] [--exp NAME]
        [--camera fx fy fz ax ay az ux uy uz] [--camera-speed S]
        [--shading none|diffuse|shadow] [--use-macrocells]

Single-frame mode renders 5 warmup + 25 timed frames and prints `fps = ...`
(`main_batch.cpp:278-289`); multi-frame mode flies the same Lissajous orbit
around the point of interest and writes a PNG sequence
(`main_batch.cpp:296-313`), resumable with `--resume`; `--ab` renders the
march against shear-warp and prints their PSNR; `--sequence` streams a
time-varying volume. `main(argv)` returns a dict of what it printed.

Streaming on a CUDA device: a prefetch thread reads timestep t+2 from
disk in its file type into one of two reused pinned host buffers, the
copy of t+1 to the card is issued on a side stream before the render of
t, and the default stream waits for that copy before the volume swap
(`Renderer.set_volume_data`, which casts to float32 on the card). On the
CPU (`--device cpu`) the same loop runs without pinning or streams.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ovr_tpu_torch import api
from ovr_tpu_torch.core.scene import Camera
from ovr_tpu_torch.io.image import save_exr, save_image
from ovr_tpu_torch.io.raw import load_raw_volume, sequence_paths
from ovr_tpu_torch.io.vidi3d import create_scene
from ovr_tpu_torch.utils.checkpoint import FrameCheckpointer


def parse_args(argv=None):
    p = argparse.ArgumentParser("Batch Renderer")
    p.add_argument("--scene", required=True)
    p.add_argument("--num-frames", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:N or cpu)")
    p.add_argument("--fbsize", type=int, nargs=2, default=[1920, 1080])
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--pt", action="store_true", help="path tracing")
    p.add_argument("--sampling-rate", type=float, default=None)
    p.add_argument("--exp", default="frame_", dest="expname")
    p.add_argument("--camera", type=float, nargs=9, default=None,
                   metavar=("FX", "FY", "FZ", "AX", "AY", "AZ", "UX", "UY", "UZ"))
    p.add_argument("--camera-speed", type=float, default=1.0)
    p.add_argument("--shading", default="shadow",
                   choices=["none", "diffuse", "shadow"])
    p.add_argument("--use-macrocells", action="store_true")
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--timed", type=int, default=25)
    p.add_argument("--sequence", default=None,
                   help="time-varying volume sequence: %%-pattern "
                        "(vol_%%04d.raw) or glob; dims/shape from the "
                        "scene's volume")
    p.add_argument("--sequence-type", default="FLOAT")
    p.add_argument("--sequence-endian", default="LITTLE",
                   choices=["LITTLE", "BIG"])
    p.add_argument("--sequence-offset", type=int, default=0)
    p.add_argument("--no-save", action="store_true",
                   help="skip PNG writes of single frames and sequences "
                        "(pure fps measurement)")
    p.add_argument("--ab", action="store_true",
                   help="A/B oracle harness: render march vs shear-warp "
                        "to EXRs and print PSNR (the reference's disabled "
                        "cross-backend comparison, main_batch.cpp:121-222)")
    p.add_argument("--resume", action="store_true",
                   help="skip frames whose output PNG already exists")
    p.add_argument("--method", default="auto",
                   choices=["auto", "march", "shearwarp"],
                   help="integration method (auto: dense shear-warp fast "
                        "path when eligible, else per-ray march)")
    return p.parse_args(argv)


def orbit_camera(camera: Camera, t: float) -> Camera:
    """Lissajous orbit around the poi (`main_batch.cpp:296-313`), formed
    in float64 on the host; the camera lands on the input's device."""
    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)

    from_, poi, up = host(camera.from_), host(camera.at), host(camera.up)
    R = np.linalg.norm(from_ - poi)
    z = (from_ - poi) / max(R, 1e-12)
    x = np.cross(up, z)
    x /= max(np.linalg.norm(x), 1e-12)
    y = np.cross(z, x)
    theta = np.sin(13.0 * t) * np.pi
    phi = np.cos(5.0 * t) * np.pi
    r = R * (0.6 + 0.1 * np.sin(6.0 * t))
    local = np.array([
        r * np.cos(phi) * np.sin(theta),
        r * np.sin(phi) * np.sin(theta),
        r * np.cos(theta),
    ])
    c = local[0] * x + local[1] * y + local[2] * z
    return Camera.create(from_=c + poi, at=poi, up=up, fovy=camera.fovy,
                         height=camera.height, kind=camera.kind,
                         device=camera.from_.device)


class HostStaging:
    """Reused host buffers (two by default) between the prefetch thread
    and the device.

    On a CUDA device the buffers are pinned and `upload` copies one to the
    card on a side stream. `fill` (the prefetch thread) first waits for
    the copy out of that buffer to finish; `upload` allocates the
    destination on the default stream (so the caching allocator never
    hands its memory to another stream's pool) after that stream's
    earlier work, and returns it with the copy's end event, which the
    default stream waits on (`ready`) before it reads the tensor. On the
    CPU each timestep keeps its own array and nothing is copied. Arrays
    are numpy arrays or CPU tensors (a bf16 timestep).
    """

    def __init__(self, first, device, slots: int = 2):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._slots: list = [None] * slots
        if self.cuda:
            like = torch.as_tensor(first)
            self._slots = [torch.empty(like.shape, dtype=like.dtype,
                                       pin_memory=True) for _ in range(slots)]
            self._freed = [None] * slots  # the copy out of each buffer
            self.stream = torch.cuda.Stream(self.device)

    def fill(self, slot: int, array) -> None:
        if not self.cuda:
            self._slots[slot] = array
            return
        if self._freed[slot] is not None:
            self._freed[slot].synchronize()
        self._slots[slot].copy_(torch.as_tensor(array))

    def upload(self, slot: int):
        """(device tensor, its copy's start and end events or None)."""
        if not self.cuda:
            return torch.as_tensor(self._slots[slot]), None
        src = self._slots[slot]
        dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
        self._freed[slot] = end
        return dst, (start, end)

    def ready(self, events) -> None:
        if events is not None:
            torch.cuda.current_stream(self.device).wait_event(events[1])


def _overlap(copy, render) -> float:
    """The share of the copy's interval (start, end ms) inside the
    render's."""
    lo, hi = max(copy[0], render[0]), min(copy[1], render[1])
    span = copy[1] - copy[0]
    return max(0.0, hi - lo) / span if span > 0 else 0.0


def stream_sequence(renderer, args, shape, on_frame=None) -> dict:
    """The `--sequence` loop: every timestep's file through `renderer`,
    the next one's upload in flight under the current render. Returns
    {"streaming_fps", "timesteps", and on a CUDA device "uploads": per
    upload after the first {"ms", "gbps", "overlap"} (the share of the
    copy's event interval inside the previous timestep's render interval
    on the default stream), "peak_bytes"}."""
    paths = sequence_paths(args.sequence)
    z, y, x = shape

    def load(p):
        g, _ = load_raw_volume(p, (x, y, z), args.sequence_type,
                               args.sequence_offset,
                               args.sequence_endian == "BIG")
        return g

    first = load(paths[0])
    stage = HostStaging(first, renderer._device)
    cuda = stage.cuda
    if cuda:
        torch.cuda.reset_peak_memory_stats(stage.device)
        base = torch.cuda.Event(enable_timing=True)
        base.record()
    stage.fill(0, first)
    del first
    cur, cur_ev = stage.upload(0)
    copies, renders = [], []
    t_first, n_done = None, 0
    with ThreadPoolExecutor(1) as ex:
        fut = (ex.submit(lambda: stage.fill(1, load(paths[1])))
               if len(paths) > 1 else None)
        for idx in range(len(paths)):
            stage.ready(cur_ev)
            renderer.set_volume_data(cur)
            del cur
            if fut is not None:
                fut.result()
                cur, cur_ev = stage.upload((idx + 1) % 2)
                copies.append(cur_ev)
                fut = (ex.submit(lambda p=paths[idx + 2], s=idx % 2:
                                 stage.fill(s, load(p)))
                       if idx + 2 < len(paths) else None)
            if cuda:
                rs = torch.cuda.Event(enable_timing=True)
                rs.record()
            renderer.render()
            if cuda:
                re_ = torch.cuda.Event(enable_timing=True)
                re_.record()
                renders.append((rs, re_))
            if on_frame is not None:
                on_frame(idx, renderer)
            if not args.no_save:
                save_image(f"{args.expname}t{idx:05d}.png",
                           renderer.mapframe()["rgba"])
            if idx == 0:
                t_first = time.perf_counter()  # exclude the first frame
            else:
                n_done += 1
    out = {"timesteps": len(paths)}
    if n_done:
        fps = n_done / (time.perf_counter() - t_first)
        print(f"streaming fps = {fps:f}  ({n_done} timesteps)")
        out["streaming_fps"] = fps
    if cuda:
        torch.cuda.synchronize(stage.device)
        nbytes = stage._slots[0].numel() * stage._slots[0].element_size()
        out["uploads"] = []
        for (cs, ce), (rs, re_) in zip(copies, renders):
            c = (base.elapsed_time(cs), base.elapsed_time(ce))
            r = (base.elapsed_time(rs), base.elapsed_time(re_))
            ms = c[1] - c[0]
            out["uploads"].append({"ms": ms, "gbps": nbytes / ms / 1e6,
                                   "bytes": nbytes,
                                   "overlap": _overlap(c, r),
                                   "render_ms": r[1] - r[0]})
        out["peak_bytes"] = torch.cuda.max_memory_allocated(stage.device)
    return out


def ab_compare(scene, renderer, camera, expname) -> dict:
    """Both integrators on the same scene and camera, EXRs for offline
    inspection, PSNR of the premultiplied rgb printed — the working
    version of the reference's #if 0 harness (OSPRay-vs-OptiX EXR dumps,
    apps/main_batch.cpp:121-222)."""
    outs, seconds = {}, {}
    for meth in ("march", "shearwarp"):
        try:
            r2 = api.Renderer(scene, dataclasses.replace(
                renderer._cfg, method=meth, sw=None,
                max_steps=None, shadow_max_steps=None))
            r2.set_camera(camera=camera)
            t0 = time.perf_counter()
            r2.render()
            seconds[meth] = time.perf_counter() - t0
            outs[meth] = r2.mapframe()["rgba"]
            save_exr(f"{expname}{meth}.exr", outs[meth])
        except ValueError as e:
            print(f"{meth}: ineligible ({e})")
    res = {"seconds": seconds}
    if len(outs) == 2:
        a, b = outs["march"], outs["shearwarp"]

        def pm(im):
            return im[..., :3] * im[..., 3:4]

        mse = float(np.mean((pm(a) - pm(b)) ** 2))
        psnr = 10.0 * np.log10(1.0 / max(mse, 1e-12))
        print(f"psnr = {psnr:.2f} dB  (mse = {mse:.3e})")
        res.update(psnr=float(psnr), mse=mse)
    return res


def make_renderer(args, scene, camera) -> api.Renderer:
    """The committed Renderer the CLI drives for these arguments."""
    rate = args.sampling_rate or float(scene.volume_sampling_rate.cpu())
    renderer = api.Renderer(scene, api.RenderConfig(
        width=args.fbsize[0], height=args.fbsize[1], spp=args.spp,
        sampling_rate=rate, shading=args.shading, path_tracing=args.pt,
        use_macrocells=args.use_macrocells or args.pt, fast_math=not args.pt,
        method=args.method,
    ))
    renderer.set_volume_sampling_rate(rate)
    renderer.set_frame_accumulation(True)
    renderer.set_camera(camera=camera)
    renderer.commit()
    return renderer


def main(argv=None, on_frame=None) -> dict:
    """Run the CLI; returns what it printed as numbers (and, in
    single-frame mode, the last `Frame` under "frame"). `on_frame(idx,
    renderer)` is called after each timestep's render in sequence mode."""
    args = parse_args(argv)
    scene = create_scene(args.scene, device=args.device)
    camera = scene.camera
    if args.camera is not None:
        c = args.camera
        camera = Camera.create(from_=c[0:3], at=c[3:6], up=c[6:9],
                               fovy=camera.fovy, device=args.device)

    renderer = make_renderer(args, scene, camera)

    if args.ab:
        return dict(ab_compare(scene, renderer, camera, args.expname),
                    mode="ab")

    if args.sequence:
        # Time-varying streaming (BASELINE config #3)
        return dict(stream_sequence(renderer, args, scene.volume.grid.shape,
                                    on_frame), mode="sequence")

    if args.num_frames == 1:
        for _ in range(args.warmup):
            renderer.render()
        t0 = time.perf_counter()
        for _ in range(args.timed):
            renderer.render()
        tot = time.perf_counter() - t0
        fps = args.timed / tot
        print(f"fps = {fps:f}")
        rays = args.fbsize[0] * args.fbsize[1] * args.spp * args.timed
        print(f"rays/s = {rays / tot:.3e}")
        if not args.no_save:
            save_image(f"{args.expname}{0:05d}.png",
                       renderer.mapframe()["rgba"])
        return {"mode": "single", "fps": fps, "rays_s": rays / tot,
                "frame": renderer._frame}

    directory, prefix = os.path.split(args.expname)
    ck = FrameCheckpointer(directory, prefix)
    dt = (args.camera_speed * math.pi) / args.num_frames
    rendered, positions = [], []
    for idx in range(args.num_frames):
        t = idx * dt
        if args.resume and ck.done(idx):
            continue
        cam = orbit_camera(camera, t)
        p = cam.from_.cpu().numpy()
        print(f"camera pos ({p[0]:f},{p[1]:f},{p[2]:f})")
        renderer.set_camera(camera=cam)
        renderer.render()
        save_image(ck.frame_path(idx), renderer.mapframe()["rgba"])
        ck.commit(idx, meta={"t": t, "camera": p.tolist()})
        rendered.append(idx)
        positions.append(p.tolist())
    return {"mode": "orbit", "rendered": rendered, "camera_pos": positions}


if __name__ == "__main__":
    main()
