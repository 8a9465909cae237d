"""Time the slice kernel alone on the headline inputs, on one NVIDIA card.

    python3 kernel_times.py [PACKAGE_ROOT [LABEL]]

Imports `ovr_tpu_torch` from PACKAGE_ROOT (default: this file's
directory), so that two versions of the kernel, each unpacked into its
own directory, can be timed in turns in one process run each. Builds the
kernel there, prints the registers ptxas gave the bf16 variants, builds
chip_smoke.py's 1024^3 bf16 headline volume on the card and, for the
1920x1080 headline frame in diffuse, none and shadow shading and in
diffuse from the principal x axis ("diffuse-x"), prints the fastest of
three means of three kernel launches (CUDA events), in ms. Checks
nothing: chip_smoke.py holds the kernel against its plain version.
"""

from __future__ import annotations

import importlib.util
import os
import sys


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else here
    label = sys.argv[2] if len(sys.argv) > 2 else root
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1

    # this directory's chip_smoke.py (its scenes and timing), whatever
    # PACKAGE_ROOT holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ovr_tpu_torch import api
    from ovr_tpu_torch.ops import cuda_build, swslice
    from ovr_tpu_torch.render import accel

    if not swslice.__file__.startswith(root):
        raise SystemExit(f"imported {swslice.__file__}, not from {root}")
    built = cuda_build.load("swslice")
    regs = {(*k[1:3], k[6]): v[0]
            for k, v in cs.ptxas_summary(built.log).items()
            if k[0] == "bf16" and not k[3] and not k[5]}
    print(f"{label}: build {built.seconds:.1f} s; bf16 registers by (mode, "
          f"fd, runs) {regs}", flush=True)
    grid = cs.field(1024, "bench", "cuda").to(torch.bfloat16)
    times = {}
    for label_h, shading, cam in cs.HEADLINES:
        scene = cs.make_scene(grid, "bench", cam)
        mc = accel.build_macrocells(grid, scene.tfn.alpha,
                                    scene.tfn.value_range)
        cfg = cs.headline_cfg(scene, shading)
        lg = api.build_light_grid(scene, cfg) if shading == "shadow" else None
        args, kw = cs.capture(scene, cfg, macrocells=mc, light_grid=lg)
        swslice.slice_composite(*args, **kw)
        times[label_h] = min(
            cs.cuda_ms(lambda: swslice.slice_composite(*args, **kw), 3)
            for _ in range(3))
    print(f"{label}: kernel ms " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in times.items()))
    print(cs.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
