"""The (tiles, bricks) rank mesh and its collectives (port of
`ovr_tpu.parallel.mesh`).

The JAX package lays its devices out as a 2D `jax.sharding.Mesh`: a
`tiles` axis (screen-row bands, no communication in the forward) and a
`bricks` axis (Z-slabs of the volume whose partial ray segments are
composited around a ring). Here every rank of a `torch.distributed` job
drives one device, and `Mesh` is that rank's place in a T x B grid of
ranks, row-major as JAX reshapes its devices: rank r is tile r // B,
brick r % B. `axis_index(axis)` is the rank's coordinate on an axis.

The mesh holds one process group per brick row (its ring) and per tile
column (the sums over tiles), and one over the whole mesh. Its
collectives are what the multi-device modules call in place of JAX's
`psum`, `ppermute` and `all_gather`; `shift` and `gather` are
differentiable (their backward sends the cotangents the other way), as
JAX transposes those inside `value_and_grad`.

The caller names the backend when it initializes the job (`multihost.
initialize`): `nccl` for one card per rank, `gloo` for CPU ranks and for
ranks that share one card (NCCL refuses two ranks on one device). Gloo
moves host memory: with gloo, a CUDA tensor crosses through an explicit
host copy (`Mesh.transport` says so). Nothing here picks a backend or a
device on its own; a tensor on another device than the mesh's raises.
Every group carries a timeout, so a collective that cannot complete
fails instead of waiting forever.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"
BRICK_AXIS = "bricks"
DEFAULT_TIMEOUT_S = 300.0  # seconds a collective may wait


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (tiles, bricks) grid of ranks, its device
    and the groups of its axes (None for a job of one rank)."""

    n_tiles: int
    n_bricks: int
    tile: int
    brick: int
    device: torch.device
    backend: Optional[str] = None
    tile_group: object = None  # the ranks of my brick index (over tiles)
    brick_group: object = None  # the ranks of my tile index (the ring)
    mesh_group: object = None  # every rank of the mesh

    @property
    def size(self) -> int:
        return self.n_tiles * self.n_bricks

    @property
    def rank(self) -> int:
        return self.tile * self.n_bricks + self.brick

    def axis_index(self, axis: str) -> int:
        return {TILE_AXIS: self.tile, BRICK_AXIS: self.brick}[axis]

    @property
    def transport(self) -> str:
        """How tensors cross between ranks: the backend, and for gloo
        with CUDA tensors the host copy each way."""
        if self.backend is None:
            return "none (one rank)"
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo, staged through host memory"
        return self.backend

    # -- plumbing --------------------------------------------------------

    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _check(self, t: torch.Tensor) -> None:
        if t.device != self.device:
            raise ValueError(f"collective on {t.device}; the mesh's ranks "
                             f"run on {self.device}")

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """What the backend moves: a contiguous tensor, in host memory
        for gloo; reduced types widened to f32."""
        self._check(t)
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        t = t.contiguous()
        return t.cpu() if self._staged() else t

    def _group(self, axes) -> tuple[object, int]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if set(axes) == {TILE_AXIS, BRICK_AXIS}:
            return self.mesh_group, self.size
        if axes == (TILE_AXIS,):
            return self.tile_group, self.n_tiles
        if axes == (BRICK_AXIS,):
            return self.brick_group, self.n_bricks
        raise ValueError(f"unknown mesh axes {axes}")

    # -- collectives -----------------------------------------------------

    def all_reduce(self, t: torch.Tensor,
                   axes=(TILE_AXIS, BRICK_AXIS)) -> torch.Tensor:
        """The sum of `t` over the ranks of `axes` (JAX's `psum`), a new
        tensor of t's dtype; bf16/f16 are summed in f32."""
        group, n = self._group(axes)
        if n == 1:
            return t
        w = self._wire(t)
        if w is t:
            w = t.clone()
        dist.all_reduce(w, group=group)
        return w.to(device=t.device, dtype=t.dtype)

    def all_gather_raw(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(n, *t.shape): every rank's `t` along `axis`, in axis order."""
        group, n = self._group(axis)
        if n == 1:
            return t[None]
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=group)
        return torch.stack(parts).to(device=t.device, dtype=t.dtype)

    def shift_raw(self, t: torch.Tensor, step: int) -> torch.Tensor:
        """JAX's `ppermute` by a ring step on the brick axis: send `t` to
        the brick `step` ahead (cyclically), return what the brick `step`
        behind sent."""
        n = self.n_bricks
        if n == 1 or step % n == 0:
            return t
        row = self.tile * n
        dst, src = row + (self.brick + step) % n, row + (self.brick - step) % n
        w = self._wire(t)
        buf = torch.empty_like(w)
        reqs = [dist.isend(w, dst=dst), dist.irecv(buf, src=src)]
        for r in reqs:
            r.wait()
        return buf.to(device=t.device, dtype=t.dtype)

    def shift(self, t: torch.Tensor, step: int) -> torch.Tensor:
        """`shift_raw`, differentiable: the cotangent goes back around the
        ring (-step), as JAX transposes a `ppermute`."""
        return _Shift.apply(t, self, step)

    def gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """`all_gather_raw`, differentiable: each rank's cotangent of its
        own entry is the sum of every rank's cotangent of that entry."""
        return _Gather.apply(t, self, axis)

    def barrier(self) -> None:
        if self.mesh_group is not None and self.size > 1:
            dist.barrier(group=self.mesh_group)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, step):
        ctx.mesh, ctx.step = mesh, step
        return mesh.shift_raw(t, step)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shift_raw(g, -ctx.step), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_gather_raw(t, axis)

    @staticmethod
    def backward(ctx, g):
        me = ctx.mesh.axis_index(ctx.axis)
        return ctx.mesh.all_reduce(g, ctx.axis)[me], None, None


def make_mesh(n_tiles: Optional[int] = None, n_bricks: int = 1,
              device="cuda",
              timeout: float = DEFAULT_TIMEOUT_S) -> Optional[Mesh]:
    """This rank's place in a (n_tiles, n_bricks) mesh over the first
    n_tiles * n_bricks ranks of the job (all of them by default), as
    JAX's `make_mesh` takes the first devices. Every rank of the job must
    call it (it creates the axis groups); a rank outside the mesh gets
    None. Without an initialized job the mesh is the one rank, 1 x 1.
    `device`: the device this rank's tensors live on (the card unless the
    caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if (n_tiles or 1) * n_bricks != 1:
            raise ValueError("a mesh of more than one rank needs an "
                             "initialized job (multihost.initialize)")
        return Mesh(1, 1, 0, 0, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = str(dist.get_backend())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("nccl moves CUDA tensors; CPU ranks take gloo")
    if n_tiles is None:
        n_tiles = world // n_bricks
    if n_tiles < 1 or n_tiles * n_bricks > world:
        raise ValueError(f"need {n_tiles}x{n_bricks} ranks, have {world}")
    to = datetime.timedelta(seconds=timeout)

    def grid(t, b):
        return t * n_bricks + b

    # every rank creates every group, in the same order
    tile_groups = [dist.new_group([grid(t, b) for t in range(n_tiles)],
                                  timeout=to) for b in range(n_bricks)]
    brick_groups = [dist.new_group([grid(t, b) for b in range(n_bricks)],
                                   timeout=to) for t in range(n_tiles)]
    mesh_group = dist.new_group(list(range(n_tiles * n_bricks)), timeout=to)
    if rank >= n_tiles * n_bricks:
        return None
    t, b = divmod(rank, n_bricks)
    return Mesh(n_tiles, n_bricks, t, b, device, backend, tile_groups[b],
                brick_groups[t], mesh_group)
