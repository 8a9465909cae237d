"""Spans and counters at the layer boundaries of a Renderer frame.

`span(name, device)` is a context manager around one layer's work: the
setters, `commit` and its plan, macrocells and shadow lattice, `render`
and its stages (`stage`: frame setup, K1, warp, the wait for the card)
and `mapframe`'s copies. Names nest by dots under the enclosing span
(`commit.macrocells.value_ranges`); a span's frame id is shared by the
setters, commit, render and mapframe of one frame and advances after
`mapframe` (`end_frame`).

On and off. A span records only while a torch profiler is active in
the process (`torch._C._autograd._profiler_enabled()`, checked once at
each span's entry). Nothing else turns it on: no environment variable,
argument or setting. Off, `span()` returns one shared no-op context and
`stage()` returns at once: nothing is allocated, no clock is read and no
CUDA event is recorded.

A record (`Span`) holds the name, its id and its parent's, the frame id,
host start and end (`time.perf_counter_ns`), on a CUDA device a pair of
timing events recorded on the current stream at entry and exit (they
bound the span's device work on the device's timeline, also where that
work runs after the host has left the span), and the deltas over the
span of the registered counters (`register_counter`: module ints such as
`ops.swslice.LAUNCHES`, read by name, never copied). Records live in a
ring of `CAPACITY` spans (`spans()`, `clear()`); nothing is written out.

The spans are deliberately not `torch.profiler.record_function` ranges.
The profiler mirrors such a range onto the device's timeline as a user
annotation, and a reader of the trace that takes every device-side event
for an operation would count the program's ranges as kernels: device
busy and idle time, kernel time by span and the list of operations
would change whenever the program added a span. Kept here, the spans
leave the profiler's trace as it is; a reader places them on the
profiler's clocks itself (host: against ranges it opened around the
same calls; device: the events against a kernel of the trace).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Callable, NamedTuple, Optional

import torch

CAPACITY = 1 << 16  # spans kept; the oldest go first

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_counters: dict[str, Callable[[], int]] = {}
_ids = itertools.count(1)
_local = threading.local()
_frame = 0


class Span(NamedTuple):
    """One recorded span. `parent` is 0 at the top; `start` and `end` are
    CUDA events (None off the card); `counts` the non-zero deltas of the
    registered counters over the span."""

    name: str
    id: int
    parent: int
    frame: int
    t0_ns: int
    t1_ns: int
    start: Optional[torch.cuda.Event]
    end: Optional[torch.cuda.Event]
    counts: dict


def register_counter(name: str, read: Callable[[], int]) -> None:
    """Record the change of `read()` over every span under `name`."""
    _counters[name] = read


def counters() -> list:
    """The names of the registered counters."""
    return list(_counters)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event(device) -> Optional[torch.cuda.Event]:
    if device is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _Open:
    """A span being recorded (on the thread's stack until it closes);
    `device` is None unless the span's work runs on a CUDA device."""

    __slots__ = ("name", "id", "parent", "frame", "device", "is_stage",
                 "t0", "ev0", "c0")

    def __init__(self, name: str, device, is_stage: bool = False):
        if device is not None:
            device = torch.device(device)
            if device.type != "cuda":
                device = None
        self.name, self.device, self.is_stage = name, device, is_stage

    def open(self) -> None:
        stack = _stack()
        up = stack[-1] if stack else None
        self.name = self.name if up is None else f"{up.name}.{self.name}"
        self.parent = 0 if up is None else up.id
        self.id, self.frame = next(_ids), _frame
        stack.append(self)
        self.c0 = {k: read() for k, read in _counters.items()}
        self.ev0 = _event(self.device)
        self.t0 = time.perf_counter_ns()

    def close(self) -> None:
        """Close this span and whatever is still open inside it."""
        stack = _stack()
        while stack and stack[-1] is not self:
            stack[-1].close()
        t1 = time.perf_counter_ns()
        ev1 = _event(self.device)
        counts = {k: d for k, c in self.c0.items()
                  if (d := _counters[k]() - c)}
        if stack:
            stack.pop()
        _ring.append(Span(self.name, self.id, self.parent, self.frame,
                          self.t0, t1, self.ev0, ev1, counts))

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def span(name: str, device=None):
    """A span named `name` under the open one; `device`: where its work
    runs (a CUDA device adds the pair of events)."""
    if not _profiling():
        return _OFF
    return _Open(name, device)


def stage(name: str, device=None) -> None:
    """Start the stage `name` of the innermost open span, ending the stage
    of that span still open. A stage ends at the next stage or with its
    span; with no span open, nothing is recorded."""
    if not _profiling():
        return
    stack = _stack()
    if stack and stack[-1].is_stage:
        stack[-1].close()
    if stack:
        _Open(name, device, is_stage=True).open()


def end_frame() -> None:
    """The frame's last span has closed: later spans get the next id."""
    global _frame
    _frame += 1


def spans() -> list:
    """The recorded spans, oldest first by their end."""
    return list(_ring)


def clear() -> None:
    _ring.clear()
