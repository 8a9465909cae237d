"""Checkpoint / resume (port of `ovr_tpu.utils.checkpoint`).

- `save_pytree` / `load_pytree` / `latest_step`: training-state snapshots
  as a flat `.npz` (key path -> array), written to a temporary file and
  renamed into place. The keys are spelled as `jax.tree_util.keystr`
  spells them (`['params']['w']` for a dict entry, `[0]` for a sequence
  element, `.grid` for a dataclass field, `.weights[0][1]` for a neural
  field's first bias), so each package reads the other's `.npz` files.
- `FrameCheckpointer`: frame-granular resume for long batch renders — a
  render loop skips work whose output already exists and atomically
  records per-frame metadata (camera, accumulation index).

The trees are dicts, lists and tuples of tensors, numpy arrays and
scalars; dataclasses (every field a node, as `parallel.tiles.TrainState`);
a `NeuralFieldVolume` (the data fields of the JAX package's
`register_dataclass`: `.tables`, `.weights[i][j]`, `.world_lo`,
`.world_hi`, `.data_range`); and a `torch.optim.Optimizer`, whose state
is kept per parameter (`.state[i]['exp_avg']`, `['exp_avg_sq']` and
`['step']` for Adam; i counts the parameters of all groups in order). Loading returns a
new tree for plain tensors and arrays, but restores parameters, neural
fields and optimizers in place: the optimizer holds its parameters by
reference, so a resumed step continues from the same objects.

The JAX package writes orbax directories where orbax imports; the port
cannot read those without JAX and says so.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch

from ovr_tpu_torch.neural.field import NeuralFieldVolume


def field_arrays(field: NeuralFieldVolume) -> list:
    """[(key path, tensor)] of a neural field's arrays: the parameters
    and buffers themselves, in JAX's flattening order."""
    out = [(".tables", field.tables)]
    for i, (w, b) in enumerate(field.weights):
        out += [(f".weights[{i}][0]", w), (f".weights[{i}][1]", b)]
    return out + [(f".{k}", getattr(field, k))
                  for k in ("world_lo", "world_hi", "data_range")]


def _params(opt: torch.optim.Optimizer) -> list:
    return [p for g in opt.param_groups for p in g["params"]]


def _children(node) -> Optional[list]:
    """[(key, child)] of a tree node in JAX's flattening order (dict keys
    sorted), or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{k}", getattr(node, k)) for k in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    if isinstance(node, NeuralFieldVolume):
        return field_arrays(node)
    if isinstance(node, torch.optim.Optimizer):
        return [(".state", [dict(node.state.get(p, {}))
                            for p in _params(node)])]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16: exact in f32
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{key path: host array} of every leaf of `tree`."""
    kids = _children(tree)
    if kids is None:
        return {prefix: _host(tree)}
    out = {}
    for k, child in kids:
        out.update(flatten(child, prefix + k))
    return out


def save_pytree(directory: str, step: int, tree: Any) -> str:
    """Snapshot `tree` at `step` as `step_<8 digits>.npz` (written to a
    temporary file, then renamed). Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flatten(tree))
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The largest step saved in `directory` (`.npz` files and the JAX
    package's orbax directories alike), or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.match(r"step_(\d+)(\.npz)?$", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _array(stored: np.ndarray, like) -> Any:
    """`stored` in the dtype, shape and (for a tensor) device of `like`."""
    if isinstance(like, torch.Tensor):
        if stored.dtype.name == "bfloat16" or stored.dtype == np.dtype("V2"):
            t = torch.from_numpy(np.array(stored).view(np.uint16)).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(stored))
        return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)
    if isinstance(like, (int, float, bool)) and not isinstance(
            like, np.generic):
        return type(like)(stored)
    return np.asarray(stored).astype(np.asarray(like).dtype).reshape(
        np.shape(like))


def _restore(like, flat: dict, prefix: str):
    if isinstance(like, (NeuralFieldVolume, torch.optim.Optimizer)):
        _restore_in_place(like, flat, prefix)
        return like
    kids = _children(like)
    if kids is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint has no entry {prefix!r}")
        value = _array(flat[prefix], like)
        if isinstance(like, torch.nn.Parameter):
            with torch.no_grad():
                like.copy_(value)
            return like
        return value
    vals = [_restore(c, flat, prefix + k) for k, c in kids]
    if isinstance(like, dict):
        return dict(zip(sorted(like), vals))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    if isinstance(like, (list, tuple)):
        return type(like)(vals)
    return dataclasses.replace(
        like, **{f.name: v for f, v in zip(dataclasses.fields(like), vals)})


def _restore_in_place(obj, flat: dict, prefix: str) -> None:
    if isinstance(obj, NeuralFieldVolume):
        for k, t in field_arrays(obj):
            with torch.no_grad():
                t.copy_(_array(flat[prefix + k], t))
        return
    for i, p in enumerate(_params(obj)):
        pre = f"{prefix}.state[{i}]"
        state = {}
        for key in flat:
            m = re.fullmatch(re.escape(pre) + r"\['(\w+)'\]", key)
            if m is None:
                continue
            like = obj.state.get(p, {}).get(m.group(1))
            if like is None:  # a fresh optimizer: Adam's own layout
                like = (torch.empty((), dtype=torch.float32)
                        if m.group(1) == "step" else p.detach())
            state[m.group(1)] = _array(flat[key], like)
        if state:
            obj.state[p] = state


def load_pytree(directory: str, step: int, like: Any) -> Any:
    """Restore the snapshot at `step` into the structure of `like` (its
    dtypes, shapes and devices)."""
    path = os.path.join(directory, f"step_{step:08d}")
    if os.path.isdir(path) and not os.path.exists(path + ".npz"):
        raise ValueError(
            f"{path} is an orbax checkpoint (written by the JAX package with "
            f"orbax installed); the port reads only .npz checkpoints. Save "
            f"it again from the JAX package without orbax to get one")
    with np.load(path + ".npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    return _restore(like, flat, "")


class FrameCheckpointer:
    """Frame-granular resume for batch renders.

    >>> ck = FrameCheckpointer("out", "frame_")
    >>> for idx in range(n):
    ...     if ck.done(idx):
    ...         continue
    ...     ...render...
    ...     ck.commit(idx, meta={"t": t})
    """

    def __init__(self, directory: str, prefix: str, ext: str = "png"):
        self.directory = directory or "."
        self.prefix = prefix
        self.ext = ext
        os.makedirs(self.directory, exist_ok=True)
        self._meta_path = os.path.join(self.directory,
                                       f"{prefix}progress.json")
        self.meta: dict[str, Any] = {}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self.meta = json.load(f)

    def frame_path(self, idx: int) -> str:
        return os.path.join(self.directory,
                            f"{self.prefix}{idx:05d}.{self.ext}")

    def done(self, idx: int) -> bool:
        return os.path.exists(self.frame_path(idx))

    def commit(self, idx: int, meta: Optional[dict] = None) -> None:
        """Record completion metadata (the frame file itself is the
        completion marker; callers write it before commit)."""
        self.meta[str(idx)] = meta or {}
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.meta, f)
        os.replace(tmp, self._meta_path)
