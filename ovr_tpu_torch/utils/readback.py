"""Reused host buffers for a frame's device-to-host copies.

A copy from the card into fresh pageable memory is slow three ways: the
host tensor is new mmap pages that fault on first touch, CUDA stages
the bytes through a bounce buffer of its own, and the copy blocks the
host. Into page-locked memory the card writes directly, at the link's
speed, and the copy can be issued without waiting. Pinning pages is
itself slow, so the buffers are made once and reused.

`HostBuffers` keeps page-locked host tensors by (shape, dtype). `copy(t)`
issues `t`'s copy into a free buffer of its shape and returns the
buffer as a numpy array that the caller owns; `wait()` then ends the
copies issued. A buffer is free again only once that array is gone, and
with it every view of it: a view's `base` is the array (numpy stops the
chain at an array whose base is not an array, here the tensor), so a
`weakref.finalize` on the array runs only after the last view is
dropped. The caller may keep a frame's arrays for as long as it likes.

The buffers made stay under a fixed budget (`BUDGET`). Past it `copy`
returns None and the caller copies the pageable way, so a caller that
keeps thousands of frames pins no more than the budget. `keep_only`
releases the free buffers of shapes no longer asked for (a new frame
size); one still held goes at the first call after it is free.
Released buffers go back to PyTorch's cache of page-locked blocks.
"""

from __future__ import annotations

import math
import weakref
from typing import Optional

import numpy as np
import torch

BUDGET = 1 << 30  # bytes of buffers a pool holds at most


class _Slot:
    __slots__ = ("buf", "free")

    def __init__(self, buf: torch.Tensor):
        self.buf, self.free = buf, False


def _release(slot: _Slot) -> None:
    # may run on any thread (the one dropping the last view): it only
    # sets a flag, which the pool's owner reads
    slot.free = True


class HostBuffers:
    """A pool of host buffers for device-to-host copies.

    `pin_memory`: page-locked buffers (the default; False gives plain
    host tensors, which the CPU tests use in their place). A page-locked
    pool copies only tensors that are not already in host memory: `copy`
    returns None for a CPU tensor. `made` counts the buffers made and
    `held_bytes` is the bytes of those still in the pool."""

    def __init__(self, budget: int = BUDGET, pin_memory: bool = True):
        self.budget, self.pin_memory = int(budget), bool(pin_memory)
        self._slots: dict[tuple, list[_Slot]] = {}
        self._devices: set = set()
        self.made = 0
        self.held_bytes = 0

    def keep_only(self, keys) -> None:
        """Release the free buffers whose (shape, dtype) is not in `keys`."""
        for key in [k for k in self._slots if k not in keys]:
            kept = []
            for s in self._slots[key]:
                if s.free:
                    self.held_bytes -= s.buf.nbytes
                else:
                    kept.append(s)
            if kept:
                self._slots[key] = kept
            else:
                del self._slots[key]

    def _take(self, key) -> Optional[_Slot]:
        slots = self._slots.setdefault(key, [])
        for s in slots:
            if s.free:
                s.free = False
                return s
        shape, dtype = key
        nbytes = math.prod(shape) * dtype.itemsize
        if self.held_bytes + nbytes > self.budget:
            return None
        s = _Slot(torch.empty(shape, dtype=dtype, pin_memory=self.pin_memory))
        slots.append(s)
        self.held_bytes += nbytes
        self.made += 1
        return s

    def copy(self, t: torch.Tensor) -> Optional[np.ndarray]:
        """Issue `t`'s copy into a free buffer and return the buffer as an
        array the caller owns (valid once `wait()` has returned), or None
        (a host tensor for a page-locked pool, or past the budget)."""
        if self.pin_memory and t.device.type == "cpu":
            return None
        s = self._take((tuple(t.shape), t.dtype))
        if s is None:
            return None
        s.buf.copy_(t.detach(), non_blocking=True)
        if t.is_cuda:
            self._devices.add(t.device)
        out = s.buf.numpy()
        weakref.finalize(out, _release, s)
        return out

    def wait(self) -> None:
        """Wait for the copies issued since the last wait."""
        for d in self._devices:
            torch.cuda.current_stream(d).synchronize()
        self._devices.clear()
