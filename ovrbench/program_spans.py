"""The program's own spans, placed on the profiler's clocks, for the
metrics whose source is `program_span` and that read inside the frame.

The program (`ovr_tpu_torch/utils/trace.py`) records spans while a torch
profiler runs: host start and end on `time.perf_counter_ns`, a pair of
CUDA events around each span's device work, and counter deltas. This
file does not import the program: it reads the record of the module the
run has already loaded (`sys.modules`). A checkout whose program has no
such module, or records nothing, gives None, and so does every reader.

- Host. The harness's spans (`run.spans.items`, on `perf_counter`) and
  its profiler ranges (`run.trace.ranges`) are the same calls on both
  clocks: the median of their start differences maps the program's host
  times onto the profiler's clock (its spread is printed on stderr).
- Device. Each frame's CUDA events are placed by their elapsed time
  from one of the frame's spans, anchored on that span's one device
  operation in the trace: the slice-kernel launch of its `render.k1`
  span (the shear-warp pipeline; the counts of K1 kernels and
  `render.k1` spans must match), or its `mapframe.rgba` readback, the
  first device-to-host copy that starts after that span's host start
  (every pipeline has one). The anchor puts the span's end event on the
  operation's end; the start event, placed by the same anchor, has to
  fall on the operation's start within `TOLERANCE_NS`. A host pause
  between the start event and the launch, or between the launch and the
  end event past the operation's end, makes the two disagree. A frame
  takes its K1 anchor where that holds, else its readback where that
  holds, else it is left out of the device readings (they are taken a
  frame over the frames placed); the counts are printed on stderr in
  the anchor line.
- Operations. Each device operation of `run.trace.ops` is put down to the
  innermost span whose device interval holds its middle.
- Idle. Each idle stretch of `run.trace.busy_intervals()` is split at the
  program's host spans and each piece put down to the innermost one
  around it ("(no span)" outside them); the table, in ms a frame, is
  printed on stderr.
"""

from __future__ import annotations

import bisect
import statistics
import sys
from typing import Optional

from ovrbench.trace import K1_NAME

MODULE = "ovr_tpu_torch.utils.trace"
K1_SPAN = "render.k1"
RGBA_SPAN = "mapframe.rgba"
READBACK = "api.READBACK_BYTES"
NO_SPAN = "(no span)"
# the most by which a frame's anchored start event may miss its
# operation's start (see PERF.md section 3 for the gaps it was set from)
TOLERANCE_NS = 1_500_000


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Levels:
    """Intervals (a, b, name) of a span tree, by depth (the dots in the
    name): the spans of one depth do not overlap, so the innermost span
    holding a time is found by bisection, deepest level first."""

    def __init__(self, intervals):
        by = {}
        for a, b, name in intervals:
            by.setdefault(name.count("."), []).append((a, b, name))
        self.levels = []
        for d in sorted(by, reverse=True):
            rows = sorted(by[d])
            self.levels.append(([r[0] for r in rows], [r[1] for r in rows],
                                [r[2] for r in rows]))
        self.cuts = sorted({t for a, b, _ in intervals for t in (a, b)})

    def innermost(self, t) -> Optional[str]:
        for starts, ends, names in self.levels:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ends[i]:
                return names[i]
        return None

    def split(self, gaps) -> dict:
        """ns of each gap (a, b) by the innermost span around each piece
        between the spans' boundaries."""
        out = {}
        for a, b in gaps:
            lo = bisect.bisect_right(self.cuts, a)
            hi = bisect.bisect_left(self.cuts, b)
            edges = [a] + self.cuts[lo:hi] + [b]
            for x, y in zip(edges, edges[1:]):
                name = self.innermost((x + y) / 2) or NO_SPAN
                out[name] = out.get(name, 0) + (y - x)
        return out


def host_offset(items, ranges):
    """ns to add to a perf_counter time to place it on the profiler's
    clock (median over the harness's spans; None without a pair), and the
    spread of the differences (their quartiles' distance, ns)."""
    mine, theirs = {}, {}
    for name, t0, _ in items:
        mine.setdefault(name, []).append(t0)
    for name, s, _ in ranges:
        theirs.setdefault(name, []).append(s)
    diffs = []
    for name, starts in theirs.items():
        t0s = sorted(mine.get(name, []))
        if len(t0s) == len(starts):
            diffs += [s - t * 1e9 for s, t in zip(sorted(starts), t0s)]
    if len(diffs) < 2:
        return None, None
    q1, _, q3 = statistics.quantiles(diffs, n=4)
    return statistics.median(diffs), q3 - q1


class Placed:
    """The run's program spans on the profiler's clock: `host` (name, a,
    b, span) inside the traced window; where the trace has device
    operations, `op_span` (the span of each of `run.trace.ops`, None
    where the K1 kernels do not pair with the spans) and `idle` (ns by
    span)."""

    def __init__(self, run, spans):
        tr = run.trace
        self.n, self.ops = tr.n_frames, tr.ops
        off, spread = host_offset(run.spans.items, tr.ranges)
        self.host = [] if off is None else [
            (s.name, s.t0_ns + off, s.t1_ns + off, s) for s in spans
            if tr.t0 <= s.t0_ns + off and s.t1_ns + off <= tr.t1]
        self.op_span = self.idle = None
        self.n_dev = self.n
        if off is None:
            log("program spans: no harness span to place them by")
            return
        log(f"program spans: {len(self.host)} in the traced window; host "
            f"clock offset spread {spread / 1e3:.1f} us over "
            f"{len(tr.ranges)} harness spans")
        if not tr.ops:
            return
        mine = [h[3] for h in self.host]
        dev = self.device_times(mine, tr.ops,
                                {h[3].id: h[1] for h in self.host})
        if dev is not None:
            placed = {s.frame for s in mine if s.id in dev}
            self.n_dev = self.n - len({s.frame for s in mine
                                       if s.start is not None} - placed)
            by_id = {h[3].id: h for h in self.host}
            lv = Levels([(a, b, by_id[i][0]) for i, (a, b) in dev.items()])
            self.op_span = [lv.innermost((s + e) / 2)
                            for s, e, _, _ in tr.ops]
            # a span's device start follows its host start; a negative
            # lead is the profiler's device clock set early against its
            # host clock
            lead = min(a - by_id[i][1] for i, (a, _) in dev.items())
            log(f"program spans: least lead of a device start over its host"
                f" start {lead / 1e3:.1f} us")
        self.idle = Levels([(a, b, n) for n, a, b, _ in self.host]).split(
            idle_gaps(tr))
        total = sum(self.idle.values())
        log("idle ms a frame by program span: " + ", ".join(
            f"{k} {v / 1e6 / self.n:.3f}" for k, v in
            sorted(self.idle.items(), key=lambda kv: -kv[1])) +
            f"; sum {total / 1e6 / self.n:.3f} of "
            f"{(tr.window_s - tr.busy_s) * 1e3 / self.n:.3f} idle")

    @staticmethod
    def device_times(spans, ops, host_t0=None):
        """span id -> (a, b) on the profiler's clock for the spans of each
        frame whose anchor holds, or None where the K1 kernels and the
        `render.k1` spans do not pair up or no frame is placed.
        `host_t0`: span id -> host start on the profiler's clock, which
        finds a frame's readback copy (frames without K1 are left out
        without it)."""
        k1_ops = [o for o in ops if o[3] == "kernel" and K1_NAME in o[2]]
        k1_spans = sorted((s for s in spans if s.name == K1_SPAN
                           and s.end is not None), key=lambda s: s.t0_ns)
        if len(k1_spans) != len(k1_ops):
            log(f"program spans: {len(k1_spans)} {K1_SPAN} spans against "
                f"{len(k1_ops)} K1 kernels; device times not placed")
            return None
        timed = sorted((s for s in spans if s.start is not None),
                       key=lambda s: s.t0_ns)
        if not timed:
            return None
        ref = timed[0].start

        def rel(ev):
            return ref.elapsed_time(ev) * 1e6  # ns after ref

        def offsets(s, op):
            """The anchor by the end event, and the start event's miss."""
            off = op[1] - rel(s.end)
            return off, op[0] - rel(s.start) - off

        k1 = {s.frame: offsets(s, op) for s, op in zip(k1_spans, k1_ops)}
        copies = [o for o in ops if o[3] == "copy" and "DtoH" in o[2]]
        starts = [o[0] for o in copies]
        rb = {}
        for s in spans:
            if (s.name == RGBA_SPAN and s.end is not None and host_t0
                    and s.id in host_t0):
                i = bisect.bisect_left(starts, host_t0[s.id])
                if i < len(copies):
                    rb[s.frame] = offsets(s, copies[i])
        # K1 where it holds, else the readback where that holds
        kept, refused = {}, []
        for f in set(k1) | set(rb):
            for by, cand in (("K1", k1.get(f)), ("readback", rb.get(f))):
                if cand is not None and abs(cand[1]) <= TOLERANCE_NS:
                    kept[f] = (by, *cand)
                    break
                if by == "K1" and cand is not None:
                    refused.append(abs(cand[1]) / 1e3)
        out = {s.id: (rel(s.start) + kept[s.frame][1],
                      rel(s.end) + kept[s.frame][1])
               for s in timed if s.frame in kept}
        frames = {s.frame for s in timed}
        on_k1 = sum(by == "K1" for by, _, _ in kept.values())
        worst = max((abs(m) for _, _, m in kept.values()), default=0.0)
        both = [abs(k1[f][0] - rb[f][0]) / 1e3 for f in k1 if f in rb]
        log(f"program spans: device events anchored on {on_k1} K1 kernels "
            f"and {len(kept) - on_k1} readback copies; "
            f"{len(frames) - len(kept)} of {len(frames)} frames left out; "
            f"{len(refused)} K1 anchors refused, their start events off by "
            f"more than {TOLERANCE_NS / 1e3:.0f} us "
            f"({[round(m, 1) for m in sorted(refused)[-5:]]} us at most); "
            f"largest miss of an anchor kept {worst / 1e3:.1f} us"
            + (f"; readback anchors within {max(both):.1f} us of the K1 "
               f"anchors over {len(both)} frames" if both else ""))
        return out or None

    # ---- readings, per traced frame ----
    def host_ms(self, name: str) -> float:
        return sum(b - a for n, a, b, _ in self.host if n == name) \
            / 1e6 / self.n

    def count(self, name: str, counter: str) -> int:
        return sum(s.counts.get(counter, 0) for n, _, _, s in self.host
                   if n == name)

    def device_ms(self, names, kinds=("kernel", "copy", "fill")):
        """Device ms a frame of the operations of `kinds` put down to a
        span in `names` (or None without device times)."""
        if self.op_span is None:
            return None
        return sum(e - s for (s, e, _, kind), n in
                   zip(self.ops, self.op_span)
                   if n in names and kind in kinds) / 1e6 / self.n_dev

    def idle_ms(self, names):
        if self.idle is None:
            return None
        return sum(v for k, v in self.idle.items() if k in names) \
            / 1e6 / self.n


def idle_gaps(tr) -> list:
    """The traced window's stretches with no device operation."""
    gaps, t = [], tr.t0
    for s, e in tr.busy_intervals():
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if tr.t1 > t:
        gaps.append((t, tr.t1))
    return gaps


def placed(run) -> Optional[Placed]:
    """The run's program spans on the profiler's clock (computed once a
    run), or None: no trace, or no spans from the program."""
    if "_program_spans" not in vars(run):
        mod = sys.modules.get(MODULE)
        spans = mod.spans() if mod is not None and run.trace else []
        p = Placed(run, spans) if spans else None
        run._program_spans = p if p is not None and p.host else None
    return run._program_spans
