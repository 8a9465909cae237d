"""Share of the traced frames whose shear-warp setup replayed a captured
CUDA graph: 100 x the program's counter `shearwarp.SETUP_REPLAYS` over
the sum of it, `shearwarp.SETUP_CAPTURES` and `shearwarp.SETUP_EAGER`,
each over its `render` spans (`program_spans.py`). None for a program
that does not register the counters."""

import sys

from ovrbench import program_spans

NAMES = ("shearwarp.SETUP_REPLAYS", "shearwarp.SETUP_CAPTURES",
         "shearwarp.SETUP_EAGER")


def read(run):
    p = program_spans.placed(run)
    counters = getattr(sys.modules.get(program_spans.MODULE), "counters",
                       None)
    if p is None or counters is None or not set(NAMES) <= set(counters()):
        return None
    replays, captures, eager = (p.count("render", n) for n in NAMES)
    total = replays + captures + eager
    if not total:
        return None
    return 100.0 * replays / total
