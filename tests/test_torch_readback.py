"""The readback's pool of reused host buffers (`ovr_tpu_torch.utils.
readback`) and `Renderer.mapframe` on top of it.

On the CPU the pool holds plain host tensors in place of page-locked
ones (`pin_memory=False`), and a Renderer given such a pool copies its
CPU frames through it: a buffer goes back into use only once the array
and every view of it are gone, a held frame keeps its values over later
frames, past the budget the pageable copy gives the same values, a new
frame size makes new buffers and releases the old ones, and the counters
add up. Marked `cuda` (each test skips itself without a card): over three
frames on the card `mapframe`'s arrays equal `t.cpu().numpy()` bit for
bit, sit in page-locked memory, and a held rgba keeps its values. The
module imports neither JAX nor `ovr_tpu`:

    python -m pytest tests/test_torch_readback.py
    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_readback.py -m cuda      # on the card
"""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch
from torch.profiler import profile

from ovr_tpu_torch import api
from ovr_tpu_torch.core.scene import (Camera, Light, Scene, StructuredVolume,
                                      TransferFunction)
from ovr_tpu_torch.utils import readback, trace

W, H = 48, 32
FRAME_BYTES = W * H * (4 + 3 + 1) * 4  # rgba, grad, depth as f32
EYES = [(0.5, 0.5, -2.0), (0.9, 0.6, -1.8), (0.1, 0.3, -1.9)]


def renderer(device="cpu", host=None):
    g = torch.Generator().manual_seed(5)
    grid = torch.rand((20, 18, 22), generator=g)
    alpha = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    color = np.linspace(0.0, 1.0, 24, dtype=np.float32).reshape(8, 3)
    vol = StructuredVolume.create(grid, world_lo=[0, 0, 0],
                                  world_hi=[1, 1, 1], data_range=(0.0, 1.0),
                                  device=device)
    scene = Scene.create(
        vol, TransferFunction.create(color, alpha, (0.0, 1.0), device=device),
        light=Light.create(direction=[0.2, 1.0, 0.3], device=device),
        camera=Camera.create(from_=EYES[0], at=(0.5, 0.5, 0.5),
                             up=(0, 1, 0), fovy=45.0, device=device))
    r = api.Renderer(scene, api.RenderConfig(
        width=W, height=H, sampling_rate=24.0, shading="diffuse",
        use_macrocells=True))
    if host is not None:
        r._host = host
    return r


def frame(r, eye):
    r.set_camera(from_=eye)
    r.commit()
    r.render()
    return r.mapframe()


def counters():
    return (api.READBACK_BYTES, api.READBACK_PINNED_BYTES,
            api.READBACK_PINNED_ALLOCS)


def delta(before):
    return tuple(b - a for a, b in zip(before, counters()))


def plain_pool(budget=readback.BUDGET):
    return readback.HostBuffers(budget=budget, pin_memory=False)


# ---- the pool --------------------------------------------------------------

def test_buffer_reused_only_once_the_array_and_its_views_are_gone():
    pool = plain_pool()
    src = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    a = pool.copy(src)
    pool.wait()
    row = a[1:]
    cell = row[:, :2].T  # a view of a view
    del a, row
    gc.collect()
    b = pool.copy(src + 100)
    assert pool.made == 2 and not np.shares_memory(b, cell)
    assert cell.tolist() == [[4.0, 8.0], [5.0, 9.0]]
    del cell
    gc.collect()
    c = pool.copy(src + 200)
    assert pool.made == 2  # the first buffer, free again
    assert np.array_equal(c, (src + 200).numpy())
    assert np.array_equal(b, (src + 100).numpy())
    assert pool.held_bytes == 2 * src.nbytes


def test_page_locked_pool_leaves_host_tensors_alone():
    pool = readback.HostBuffers()
    assert pool.copy(torch.ones(3)) is None
    assert pool.made == 0 and pool.held_bytes == 0


def test_cpu_frame_takes_the_host_path():
    """A default Renderer on the CPU returns its frame's own memory and
    pools nothing."""
    r = renderer()
    before = counters()
    out = frame(r, EYES[1])
    assert delta(before) == (FRAME_BYTES, 0, 0)
    assert r._host.made == 0
    assert np.shares_memory(out["rgba"], r._frame.rgba.numpy())


# ---- mapframe through the pool ---------------------------------------------

def test_held_frame_unchanged_after_two_more_frames():
    r = renderer(host=plain_pool())
    first = frame(r, EYES[0])
    kept = {k: v.copy() for k, v in first.items()}
    later = [frame(r, e) for e in EYES[1:]]
    for k, v in first.items():
        assert np.array_equal(v, kept[k]), k
        # the later frames differ, so a reused buffer would show
        assert not np.array_equal(later[-1][k], kept[k]), k
    assert r._host.made == 3 * 3  # every frame is still held


def test_counters_add_up_and_buffers_are_reused():
    trace.clear()
    r = renderer(host=plain_pool())
    before = counters()
    with profile():
        for e in EYES:
            out = frame(r, e)
            assert set(out) == {"rgba", "grad", "depth"}
            rgba = out["rgba"]  # held into the next frame, as a viewer does
            del out
    # rgba, grad, depth once, and a second rgba for the one held
    assert delta(before) == (3 * FRAME_BYTES, 3 * FRAME_BYTES, 4)
    assert r._host.made == 4
    spans = [s for s in trace.spans() if s.name == "mapframe"]
    assert len(spans) == 3
    assert sum(s.counts["api.READBACK_PINNED_BYTES"] for s in spans) \
        == 3 * FRAME_BYTES
    assert [s.counts.get("api.READBACK_PINNED_ALLOCS", 0)
            for s in spans] == [3, 1, 0]
    assert rgba.shape == (H, W, 4)
    trace.clear()


def test_past_the_budget_the_pageable_copy_gives_the_same_values():
    r = renderer(host=plain_pool(budget=FRAME_BYTES))
    first = frame(r, EYES[0])  # fills the budget, and is held
    before = counters()
    second = frame(r, EYES[1])
    assert delta(before) == (FRAME_BYTES, 0, 0)
    for k, v in second.items():
        want = getattr(r._frame, k).numpy()
        assert np.array_equal(v, want), k
        assert not np.shares_memory(v, first[k]), k
    del first, second
    gc.collect()
    before = counters()
    frame(r, EYES[2])  # the first frame's buffers, free again
    assert delta(before) == (FRAME_BYTES, FRAME_BYTES, 0)


def test_new_frame_size_makes_new_buffers_and_releases_the_old():
    r = renderer(host=plain_pool())
    old = frame(r, EYES[0])["rgba"]  # held over the change
    frame(r, EYES[1])
    made = r._host.made
    assert r._host.held_bytes == FRAME_BYTES + old.nbytes
    r.set_fbsize((40, 24))
    out = frame(r, EYES[2])
    assert out["rgba"].shape == (24, 40, 4)
    del out
    assert r._host.made == made + 3
    small = 40 * 24 * 8 * 4
    # the free buffers of 48x32 went; the held rgba stays until dropped
    assert r._host.held_bytes == small + old.nbytes
    del old
    gc.collect()
    frame(r, EYES[1])
    assert r._host.made == made + 3 and r._host.held_bytes == small
    assert {k[0] for k in r._host._slots} == {(24, 40, 4), (24, 40, 3),
                                              (24, 40)}


# ---- on the card -----------------------------------------------------------

def check_card_frame(r, out):
    """Each array is `t.cpu().numpy()`'s bits, in page-locked memory."""
    for k, v in out.items():
        want = getattr(r._frame, k).cpu().numpy()
        assert v.dtype == want.dtype and v.shape == want.shape, k
        assert np.array_equal(v.view(np.uint32), want.view(np.uint32)), k
        assert v.base.is_pinned(), k


@pytest.mark.cuda
def test_card_mapframe_is_the_plain_copy_in_page_locked_memory():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = renderer("cuda")
    before = counters()
    held = None
    for e in EYES:
        out = frame(r, e)
        check_card_frame(r, out)
        if held is None:
            held, kept = out["rgba"], out["rgba"].copy()
        del out
    assert np.array_equal(held.view(np.uint32), kept.view(np.uint32))
    assert not np.array_equal(r._frame.rgba.cpu().numpy(), kept)
    total = 3 * FRAME_BYTES
    assert delta(before) == (total, total, r._host.made)
    # rgba, grad and depth once, and one more rgba for the frame held
    assert r._host.made == 4
