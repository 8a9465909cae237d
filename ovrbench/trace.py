"""Spans the harness records around its calls into the program, and the
reduction of a torch.profiler trace to device times.

Untraced runs keep host-clock spans only. In the traced run each span is
also a `record_function` range named "ovrbench:<span>" and ends with a
`torch.cuda.synchronize()`, so that it holds the device work it issued;
the profiler's kernel, copy and fill events are then read against those
ranges (both on the profiler's clock).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

PREFIX = "ovrbench:"
K1_NAME = "swslice_kernel"  # the slice kernel's symbol in csrc/swslice.cu


class Spans:
    """Host-clock spans (name, start s, end s); `traced` adds the
    profiler ranges and the synchronize at each span's end."""

    def __init__(self, traced: bool, device):
        self.traced = traced
        self.sync = traced and device.type == "cuda"
        self.items: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = (torch.profiler.record_function(PREFIX + name) if self.traced
               else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            yield
            if self.sync:
                torch.cuda.synchronize()
            self.items.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> list:
        return [t1 - t0 for n, t0, t1 in self.items if n == name]


def _end(e) -> int:
    if hasattr(e, "end_ns"):
        return e.end_ns()
    return e.start_ns() + e.duration_ns()


def _is_device(e) -> bool:
    """A device operation (not a harness range mirrored on the device's
    timeline)."""
    return (e.device_type() != torch.autograd.DeviceType.CPU
            and not e.name().startswith(PREFIX))


def _kind(e) -> str:
    name = e.name().lower()
    if name.startswith("memcpy"):
        return "copy"
    if name.startswith("memset"):
        return "fill"
    return "kernel"


class TraceData:
    """Device operations and harness ranges of one profiled frame loop,
    in nanoseconds on the profiler's clock."""

    def __init__(self, prof, n_frames: int):
        evs = prof.profiler.kineto_results.events()
        self.n_frames = n_frames
        self.ranges = sorted(
            (e.name()[len(PREFIX):], e.start_ns(), _end(e))
            for e in evs if e.device_type() == torch.autograd.DeviceType.CPU
            and e.name().startswith(PREFIX))
        self.ops = sorted((e.start_ns(), _end(e), e.name(), _kind(e))
                          for e in evs if _is_device(e))
        frames = [r for r in self.ranges if r[0] == "frame"]
        self.t0 = min(r[1] for r in frames)
        self.t1 = max(r[2] for r in frames)
        self.ops = [o for o in self.ops if o[1] > self.t0 and o[0] < self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self) -> list:
        out = []
        for s, e, _, _ in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_s(self, k1: Optional[bool] = None, inside: Optional[str] = None
                 ) -> float:
        """Seconds of kernels (k1: only the slice kernel's, or only the
        others'), counting those that start inside a range `inside`."""
        spans = [(s, e) for n, s, e in self.ranges if n == inside]
        tot = 0
        for s, e, name, kind in self.ops:
            if kind != "kernel":
                continue
            if k1 is not None and (K1_NAME in name) != k1:
                continue
            if inside is not None and not any(a <= s < b for a, b in spans):
                continue
            tot += e - s
        return tot * 1e-9

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for s, e, name, _ in self.ops:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with no device operation, each named by
        the harness range (not the frame itself) around its middle."""
        gaps, t = [], self.t0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            gaps.append((t, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inner = [r for r in self.ranges
                     if r[0] != "frame" and r[1] <= mid < r[2]]
            name = inner[-1][0] if inner else "between spans"
            out.append([name, (b - a) * 1e-9])
        return out
