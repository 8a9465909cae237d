"""Jobs of several processes (port of `ovr_tpu.parallel.multihost`).

One process per device, each a rank of a `torch.distributed` job:

    from ovr_tpu_torch.parallel import multihost, tiles
    multihost.initialize("tcp://host0:29500", world_size, rank,
                         backend="nccl")
    mesh = multihost.global_mesh(n_bricks=ranks_per_host)
    band = tiles.render_sharded(scene, cfg, mesh)    # tiles across hosts
    img = multihost.gather_frame(band, mesh)         # host numpy, all ranks

The caller names the backend: `nccl` for one card per rank, `gloo` for
CPU ranks and for ranks that share one card (NCCL refuses two ranks on
one device; gloo moves CUDA tensors through host copies, `mesh.Mesh`).
`run_ranks` starts a job of local processes with a wall limit, and tears
it down when one rank fails.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ovr_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, Mesh, make_mesh


def initialize(init_method: str, world_size: int, rank: int, *,
               backend: str, timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """`torch.distributed.init_process_group` for this rank (a second
    call with the same job is a no-op). `init_method`: e.g.
    "tcp://127.0.0.1:29500"; `timeout`: seconds any collective may
    wait before it fails."""
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank(),
                str(dist.get_backend())) != (world_size, rank, backend):
            raise RuntimeError("another process group is initialized")
        return
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))


def global_mesh(n_bricks: int = 1, local_size: Optional[int] = None,
                device="cuda",
                timeout: float = DEFAULT_TIMEOUT_S) -> Optional[Mesh]:
    """The (tiles, bricks) mesh over every rank of the job. Ranks are
    host-major, so the bricks of a tile (n_bricks consecutive ranks) stay
    on one host, where the ring's hops are cheapest, and tiles span
    hosts. `local_size`: ranks per host (default the launcher's
    LOCAL_WORLD_SIZE, else the whole job); it must divide by n_bricks."""
    if local_size is None:
        local_size = int(os.environ.get(
            "LOCAL_WORLD_SIZE",
            dist.get_world_size() if dist.is_initialized() else 1))
    if local_size % n_bricks:
        raise ValueError(f"{local_size} ranks per host do not divide into "
                         f"{n_bricks} bricks")
    return make_mesh(None, n_bricks, device=device, timeout=timeout)


def gather_frame(band: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """Every band of the frame (H, W, 4) as host numpy, on every rank."""
    return mesh.all_gather_raw(band, "tiles").reshape(
        -1, *band.shape[1:]).cpu().numpy()


def free_port() -> int:
    """A free TCP port on this host's loopback."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: Sequence[str], world_size: int, timeout: float,
              env: Optional[dict] = None, cwd: Optional[str] = None
              ) -> list[str]:
    """Run `argv + [init_method, world_size, rank]` once per rank, as local
    processes of one job on a free loopback port, and return each rank's
    output (stdout and stderr). If a rank exits non-zero or the job runs
    past `timeout` seconds, every rank is killed and RuntimeError
    raised."""
    init = f"tcp://127.0.0.1:{free_port()}"
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world_size)]
    procs = [subprocess.Popen(
        [*argv, init, str(world_size), str(r)], stdout=logs[r],
        stderr=subprocess.STDOUT, env=env, cwd=cwd, text=True)
        for r in range(world_size)]

    def outputs():
        out = []
        for f in logs:
            f.seek(0)
            out.append(f.read())
        return out

    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = f"the job ran past its {timeout:.0f} s limit"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    out = outputs()
    for f in logs:
        f.close()
    if failed:
        tails = "\n".join(f"--- rank {r} ---\n{o[-3000:]}"
                          for r, o in enumerate(out))
        raise RuntimeError(f"{failed}\n{tails}")
    return out
