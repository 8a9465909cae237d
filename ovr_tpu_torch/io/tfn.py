"""Transfer-function data model + JSON (de)serialization; the port's
own copy of `ovr_tpu.io.tfn` (numpy only).

Re-implements the reference's `tfn::TransferFunctionCore` rasterization and
its JSON schema (`extern/tfn/core.h:560-790`):

- `colorControls`: [(position, {r,g,b})] — piecewise-linear RGB rasterized at
  sample positions (i + 0.5) / resolution, clamped at the ends.
- `alphaArray`: base64-encoded little-endian float32 table (its length sets
  the resolution).
- `opacityControl`: [(x, y)] control points rasterized at i / (resolution-1),
  max-combined into the alpha table.
- `gaussianObjects`: [(mean, sigma, heightFactor)] — gaussian bumps
  heightFactor/(sigma*sqrt(2π)) * exp(-(x-mean)²/(2σ²)), clamped to [0,1],
  max-combined.
"""

from __future__ import annotations

import base64
import json as jsonlib
from dataclasses import dataclass, field

import numpy as np

DEFAULT_RESOLUTION = 1024


@dataclass
class TransferFunctionData:
    """Host-side TF description (editable); `rasterize()` gives the tables."""

    resolution: int = DEFAULT_RESOLUTION
    color_controls: list = field(default_factory=list)  # [(pos, (r,g,b))]
    alpha_array: np.ndarray | None = None  # (resolution,) float32
    alpha_controls: list = field(default_factory=list)  # [(x, y)]
    gaussians: list = field(default_factory=list)  # [(mean, sigma, height)]

    def rasterize(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (color (N, 3), alpha (N,)) float32 tables."""
        n = self.resolution
        color = _rasterize_color(self.color_controls, n)
        alpha = (
            np.zeros(n, np.float32)
            if self.alpha_array is None
            else np.asarray(self.alpha_array, np.float32).copy()
        )
        for mean, sigma, height in self.gaussians:
            x = (np.arange(n, dtype=np.float32) + 0.5) / n
            g = height / (sigma * np.sqrt(2.0 * np.pi)) * np.exp(
                -((x - mean) ** 2) / (2.0 * sigma * sigma))
            alpha = np.maximum(alpha, np.clip(g, 0.0, 1.0))
        if self.alpha_controls:
            alpha = np.maximum(alpha, _rasterize_alpha(self.alpha_controls, n))
        return color, alpha


def _rasterize_color(controls, n: int) -> np.ndarray:
    if not controls:
        controls = [(0.0, (0.0, 0.0, 0.0))]
    controls = sorted(controls, key=lambda c: c[0])
    pos = np.array([c[0] for c in controls], np.float32)
    rgb = np.array([c[1] for c in controls], np.float32)
    x = (np.arange(n, dtype=np.float32) + 0.5) / n
    out = np.empty((n, 3), np.float32)
    for ch in range(3):
        out[:, ch] = np.interp(x, pos, rgb[:, ch])
    return out


def _rasterize_alpha(controls, n: int) -> np.ndarray:
    controls = sorted(controls, key=lambda c: c[0])
    pos = np.array([c[0] for c in controls], np.float32)
    val = np.array([c[1] for c in controls], np.float32)
    x = np.arange(n, dtype=np.float32) / (n - 1)
    return np.interp(x, pos, val).astype(np.float32)


def load_tfn_json(jstfn: dict) -> TransferFunctionData:
    """Parse the reference's TF JSON object (`loadTransferFunction`,
    extern/tfn/core.h:710-790)."""
    tf = TransferFunctionData()
    if "resolution" in jstfn:
        tf.resolution = int(jstfn["resolution"])

    arr = jstfn.get("alphaArray")
    if arr and "data" in arr and arr.get("encoding", "BASE64") == "BASE64":
        raw = base64.b64decode(arr["data"])
        tf.alpha_array = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        tf.resolution = tf.alpha_array.shape[0]

    for cc in jstfn.get("colorControls", []):
        if "position" not in cc or "color" not in cc:
            continue
        c = cc["color"]
        rgb = (float(c.get("r", 0)), float(c.get("g", 0)), float(c.get("b", 0)))
        tf.color_controls.append((float(cc["position"]), rgb))

    for oc in jstfn.get("opacityControl", []):
        if "position" not in oc:
            continue
        p = oc["position"]
        tf.alpha_controls.append((float(p["x"]), float(p["y"])))

    for go in jstfn.get("gaussianObjects", []):
        if not all(k in go for k in ("mean", "sigma", "heightFactor")):
            continue
        tf.gaussians.append(
            (float(go["mean"]), float(go["sigma"]), float(go["heightFactor"])))
    return tf


def save_tfn_json(color: np.ndarray, alpha: np.ndarray) -> dict:
    """Serialize rasterized tables the way the reference widget does
    (`saveTransferFunction`, extern/tfn/core.h:688-708): base64 alpha +
    color control points at node positions."""
    alpha = np.asarray(alpha, np.float32)
    color = np.asarray(color, np.float32)
    n = alpha.shape[0]
    controls = []
    for i in range(color.shape[0]):
        p = i / max(color.shape[0] - 1, 1)
        controls.append({
            "position": p,
            "color": {"r": float(color[i, 0]), "g": float(color[i, 1]),
                      "b": float(color[i, 2])},
        })
    return {
        "resolution": n,
        "alphaArray": {
            "encoding": "BASE64",
            "data": base64.b64encode(alpha.astype("<f4").tobytes()).decode(),
        },
        "colorControls": controls,
    }


def load_tfn_file(path: str) -> TransferFunctionData:
    """Load a standalone TF JSON file (either the widget layout
    `{view:{volume:{transferFunction:...}}}` or a bare TF object;
    extern/tfn/widget.h:645-655)."""
    with open(path) as f:
        root = jsonlib.load(f)
    if "view" in root:
        return load_tfn_json(root["view"]["volume"]["transferFunction"])
    if "transferFunction" in root:
        return load_tfn_json(root["transferFunction"])
    return load_tfn_json(root)
