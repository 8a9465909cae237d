"""Timing / throughput / logging utilities (port of `ovr_tpu.utils.timers`).

Equivalents of the reference's measurement apparatus (SURVEY.md §5.1):
`vidi::details::HighPerformanceTimer` (+Bandwidth/Stack variants),
`FPSCounter`/`HistoryFPSCounter` (`vidi_fps_counter.h`), and `CsvLogger`
(`vidi_logger.h` -> benchmarks/log_<timestamp>.csv). `Timer.stop` can
fence on a CUDA tensor or device (it synchronizes that device's current
stream before reading the clock), the analogue of CUDA_SYNC_CHECK before
the reference's timer stop. Kernel times on the card come from CUDA
events, not from these host clocks.
"""

from __future__ import annotations

import csv
import os
import time
from collections import deque
from typing import Any, Optional

import torch


def _fence(x: Any) -> None:
    """Wait for the current stream of the device of `x` (a tensor or a
    `torch.device`); a CPU tensor or device needs no wait."""
    dev = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class Timer:
    """start/stop/milliseconds accumulator (vidi_highperformance_timer.h:17)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._total = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, fence: Any = None) -> float:
        """Stop; if `fence` is a CUDA tensor or device, wait for the
        device's current stream first."""
        if fence is not None:
            _fence(fence)
        assert self._t0 is not None, "start() first"
        dt = time.perf_counter() - self._t0
        self._total += dt
        self._t0 = None
        return dt

    def milliseconds(self) -> float:
        return self._total * 1e3

    def seconds(self) -> float:
        return self._total


class BandwidthTimer(Timer):
    """Timer + bytes accounting (HighPerformanceBandwidth, :133)."""

    def __init__(self) -> None:
        super().__init__()
        self.nbytes = 0

    def add_bytes(self, n: int) -> None:
        self.nbytes += int(n)

    def gbps(self) -> float:
        s = self.seconds()
        return (self.nbytes / 1e9) / s if s > 0 else 0.0


class ScopedTimer:
    """Context-manager timer (StackTimer, :190)."""

    def __init__(self, name: str = "", fence_fn=None, verbose: bool = True):
        self.name = name
        self.fence_fn = fence_fn
        self.verbose = verbose
        self.timer = Timer()

    def __enter__(self) -> "ScopedTimer":
        self.timer.start()
        return self

    def __exit__(self, *exc) -> None:
        self.timer.stop(self.fence_fn() if self.fence_fn else None)
        if self.verbose:
            print(f"[timer] {self.name}: {self.timer.milliseconds():.3f} ms")


class FPSCounter:
    """10-frame windowed fps (vidi_fps_counter.h:9)."""

    def __init__(self, window: int = 10):
        self.window = window
        self._stamps: deque[float] = deque(maxlen=window + 1)

    def frame(self) -> float:
        self._stamps.append(time.perf_counter())
        return self.fps

    @property
    def fps(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        dt = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / dt if dt > 0 else 0.0


class HistoryFPSCounter(FPSCounter):
    """FPSCounter + ring history for plotting (vidi_fps_counter.h:32)."""

    def __init__(self, window: int = 10, history: int = 240):
        super().__init__(window)
        self.history: deque[float] = deque(maxlen=history)

    def frame(self) -> float:
        f = super().frame()
        self.history.append(f)
        return f


class CsvLogger:
    """Append-only CSV performance log -> benchmarks/log_<timestamp>.csv
    (vidi_logger.h:61-82)."""

    def __init__(self, fields: list[str], directory: str = "benchmarks",
                 prefix: str = "log_"):
        os.makedirs(directory, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.path = os.path.join(directory, f"{prefix}{stamp}.csv")
        self.fields = fields
        with open(self.path, "w", newline="") as f:
            csv.writer(f).writerow(fields)

    def log(self, *values) -> None:
        assert len(values) == len(self.fields)
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(values)
