"""Training losses (port of `ovr_tpu.neural.losses`: the L1, L2 and
relative-L2 objectives of the reference's evaluation kernels)."""

from __future__ import annotations

import torch


def l1(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(prediction - target))


def l2(prediction: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((prediction - target) ** 2)


def relative_l2(prediction: torch.Tensor, target: torch.Tensor,
                eps: float = 0.01) -> torch.Tensor:
    """(pred - ref)^2 / (pred^2 + eps), the tiny-cuda-nn RelativeL2."""
    d = prediction - target
    return torch.mean(d * d / (prediction * prediction + eps))


LOSSES = {"l1": l1, "l2": l2, "relative_l2": relative_l2}
