"""The one generator of traffic: it reads a mix's data file
(`traffic/<mix>.json`) and the configuration's, and yields each frame's
setter calls.

A mix file holds:
- `shading`: none | diffuse | shadow;
- `camera`: {"kind": "orbit", "deg_per_frame": d} (the eye circles the
  box centre about the vertical axis at the configuration's eye
  distance, d degrees a frame, from 0 degrees, the eye on the -z side,
  bench.py's eye) or {"kind": "fixed"} (bench.py's eye, no camera call);
- `tf`: null (the configuration's TF) or {"alpha": [...], and optionally
  "base_rate_per_sampling_rate": the opacity-correction base as a share
  of the sampling rate};
- `tf_edit`: null or {"ramp_lo", "ramp_hi", "steps"}: every frame sets
  the TF, the configuration's colours and the alpha ramp
  clip((x - c) / (1 - c), 0, 1) over the node positions x, its start c
  walking from ramp_lo to ramp_hi and back in `steps` steps;
- `warmup_degrees`: the views rendered in set-up (degrees on the orbit;
  with a fixed camera, one TF step per entry);
- `trace_views`, `trace_repeats`: the traced run's fixed frames: that many
  views spread evenly over the orbit (or the ramp), cycled that often;
- `check_frames`: frames of the window held against the reference;
- `frames_per_view` (orbit only; default 1): the eye moves by
  `deg_per_frame` every that many frames, and the frames between make
  no camera call, so that a Renderer accumulating frames keeps
  accumulating; the traced run holds each of its views for that many
  frames, the first of them with the camera call;
- `accumulate` (default false): the run calls
  `Renderer.set_frame_accumulation(True)` once, after the Renderer is
  made and before set-up, so that each frame shows the mean of the
  frames rendered since the last camera or TF call.

Every seed gets the same views and TF steps in the same order, so that
the work of a window does not depend on the seed: the seed changes the
volume (`content/`), the frames held for the check and the reference's
tiles.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class FrameSpec:
    """One frame's setter calls: a camera eye (None: no call) and a TF
    alpha table (None: no call)."""

    eye: Optional[tuple]
    alpha: Optional[np.ndarray]


class Traffic:
    def __init__(self, config: dict, mix: dict):
        self.config, self.mix = config, mix
        lo = np.array(config["world_lo"], np.float64)
        hi = np.array(config["world_hi"], np.float64)
        self.center = tuple(float(c) for c in (lo + hi) / 2)
        self.distance = float(config["render"]["eye_distance"])
        cam = mix["camera"]
        self.per_view = int(mix.get("frames_per_view", 1))
        if cam["kind"] == "orbit":
            self.step = float(cam["deg_per_frame"])
        elif cam["kind"] != "fixed":
            raise ValueError(f"unknown camera kind {cam['kind']!r}")
        if self.per_view < 1 or (self.per_view > 1
                                 and cam["kind"] != "orbit"):
            raise ValueError("frames_per_view is a whole number >= 1, "
                             "above 1 only on an orbit")
        self.accumulate = bool(mix.get("accumulate", False))
        edit = mix.get("tf_edit")
        self.period = 0
        if edit:
            n = int(edit["steps"])
            self.ramp = np.linspace(edit["ramp_lo"], edit["ramp_hi"], n)
            self.period = 2 * n - 2

    # ---- the scene's state before the first frame ----
    def base_alpha(self) -> np.ndarray:
        tf = self.mix.get("tf") or {}
        return np.asarray(tf.get("alpha", self.config["tf"]["alpha"]),
                          np.float32)

    def color(self) -> np.ndarray:
        return np.asarray(self.config["tf"]["color"], np.float32)

    def base_rate(self) -> float:
        tf = self.mix.get("tf") or {}
        share = tf.get("base_rate_per_sampling_rate")
        if share is None:
            return 1.0
        return float(share) * float(self.config["render"]["sampling_rate"])

    def eye_at(self, degrees: float) -> tuple:
        th = math.radians(degrees)
        cx, cy, cz = self.center
        return (cx + math.sin(th) * self.distance, cy,
                cz - math.cos(th) * self.distance)

    def first_eye(self) -> tuple:
        return self.eye_at(0.0)

    def ramp_alpha(self, k: int) -> np.ndarray:
        i = k % self.period
        n = len(self.ramp)
        c = float(self.ramp[i if i < n else self.period - i])
        x = np.linspace(0.0, 1.0, len(self.base_alpha()))
        return np.clip((x - c) / (1.0 - c), 0.0, 1.0).astype(np.float32)

    # ---- frames ----
    def spec(self, k: int, degrees: Optional[float] = None) -> FrameSpec:
        """Frame k of the window; `degrees` places the eye there (set-up
        and the traced views) instead of on the window's orbit."""
        eye = alpha = None
        if self.mix["camera"]["kind"] == "orbit":
            if degrees is not None:
                eye = self.eye_at(degrees)
            elif k % self.per_view == 0:
                eye = self.eye_at(k // self.per_view * self.step)
        if self.period:
            alpha = self.ramp_alpha(k)
        return FrameSpec(eye, alpha)

    def window(self) -> Iterator[FrameSpec]:
        k = 0
        while True:
            yield self.spec(k)
            k += 1

    def warmup(self) -> list:
        if self.mix["camera"]["kind"] == "orbit":
            return [self.spec(0, float(d))
                    for d in self.mix["warmup_degrees"]]
        return [self.spec(k) for k in range(len(self.mix["warmup_degrees"]))]

    def traced(self) -> list:
        """The traced run's frames and, for each, the index of its view
        among the distinct ones: each view held for `frames_per_view`
        frames, the first with the camera call and the rest with none."""
        n, reps = int(self.mix["trace_views"]), int(self.mix["trace_repeats"])
        views = []
        for i in range(n):
            if self.mix["camera"]["kind"] == "orbit":
                views.append(self.spec(0, 360.0 * i / n))
            else:
                views.append(self.spec(i * max(self.period, 1) // n))
        held = FrameSpec(None, None)
        return [(views[i] if j == 0 else held, i) for _ in range(reps)
                for i in range(n) for j in range(self.per_view)]
