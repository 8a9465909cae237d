"""Framebuffer post-processing (port of `ovr_tpu.render.imageops`).

An image op is a function Frame -> Frame, and `chain` composes them
left to right: exposure, Reinhard and ACES tonemaps, gamma, composite
over a constant background, and `denoise`, a hook for any Frame ->
Frame model (a denoiser or an upscaler).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _with_rgb(frame, rgb):
    return dataclasses.replace(
        frame, rgba=torch.cat([rgb, frame.rgba[..., 3:]], dim=-1))


def exposure(stops: float) -> Callable:
    """Scale radiance by 2**stops."""
    k = 2.0 ** stops

    def op(frame):
        return _with_rgb(frame, frame.rgba[..., :3] * k)
    return op


def reinhard_tonemap() -> Callable:
    """x / (1 + x) per channel."""
    def op(frame):
        rgb = frame.rgba[..., :3]
        return _with_rgb(frame, rgb / (1.0 + rgb))
    return op


def aces_tonemap() -> Callable:
    """Narkowicz's fit of the ACES filmic curve, clipped to [0, 1]."""
    def op(frame):
        x = frame.rgba[..., :3]
        out = (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14)
        return _with_rgb(frame, torch.clamp(out, 0.0, 1.0))
    return op


def gamma(g: float = 2.2) -> Callable:
    def op(frame):
        rgb = torch.clamp(frame.rgba[..., :3], min=0.0)
        return _with_rgb(frame, rgb ** (1.0 / g))
    return op


def composite_background(bg_color=(0.0, 0.0, 0.0)) -> Callable:
    """Straight alpha over a constant background; the alpha becomes 1."""
    def op(frame):
        bg = torch.as_tensor(bg_color, dtype=torch.float32,
                             device=frame.rgba.device)
        a = frame.rgba[..., 3:4]
        rgb = frame.rgba[..., :3] * a + bg * (1.0 - a)
        return dataclasses.replace(
            frame, rgba=torch.cat([rgb, torch.ones_like(a)], dim=-1))
    return op


def denoise(model_fn: Callable) -> Callable:
    """Hook any Frame -> Frame model (a denoiser or an upscaler) into a
    chain."""
    return model_fn


def chain(*ops: Callable) -> Callable:
    """Compose image ops left to right into one Frame -> Frame function."""
    def run(frame):
        for op in ops:
            frame = op(frame)
        return frame
    return run
