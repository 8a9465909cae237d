"""The `k1_direct_pct` reader on fake counters, and the program's
registration of the slice kernel's path counters it reads."""

from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest

from ovrbench import program_spans, run

ROOT = Path(__file__).resolve().parents[2]


def test_k1_direct_pct_over_the_render_spans(monkeypatch):
    """The share of K1 launches over the `render` spans that read every
    tap from the grid; None without the counter (an older program) or
    without a launch. The program registers the launcher's path
    counters."""
    from ovr_tpu_torch.ops import swslice  # noqa: F401 (registers them)
    from ovr_tpu_torch.utils import trace
    assert {"swslice.LAUNCHES_RUNS", "swslice.LAUNCHES_DIRECT"} <= set(
        trace.counters())
    counts = {"swslice.LAUNCHES": 8, "swslice.LAUNCHES_DIRECT": 2}
    placed = types.SimpleNamespace(
        count=lambda span, c: counts[c] if span == "render" else 7)
    monkeypatch.setattr(program_spans, "placed", lambda run: placed)
    read = run.load_module(ROOT, "ovrbench/metrics/k1_direct_pct.py").read
    for names, want in ((trace.counters(), 25.0),
                        (["swslice.LAUNCHES"], None)):
        monkeypatch.setitem(sys.modules, program_spans.MODULE,
                            types.SimpleNamespace(counters=lambda: names))
        assert read(None) == (want and pytest.approx(want))
    monkeypatch.setitem(sys.modules, program_spans.MODULE,
                        types.SimpleNamespace(counters=trace.counters))
    counts["swslice.LAUNCHES"] = counts["swslice.LAUNCHES_DIRECT"] = 0
    assert read(None) is None
    monkeypatch.delitem(sys.modules, program_spans.MODULE)
    assert read(None) is None
