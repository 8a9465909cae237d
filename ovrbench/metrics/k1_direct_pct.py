"""Share of the traced frames' slice-kernel launches that read every tap
straight from the grid: 100 x the program's counter
`swslice.LAUNCHES_DIRECT` over `swslice.LAUNCHES`, both over its `render`
spans (`program_spans.py`). None for a program that does not register
the first counter, or that launched no kernel."""

import sys

from ovrbench import program_spans

DIRECT, LAUNCHES = "swslice.LAUNCHES_DIRECT", "swslice.LAUNCHES"


def read(run):
    p = program_spans.placed(run)
    counters = getattr(sys.modules.get(program_spans.MODULE), "counters",
                       None)
    if p is None or counters is None or DIRECT not in counters():
        return None
    total = p.count("render", LAUNCHES)
    if not total:
        return None
    return 100.0 * p.count("render", DIRECT) / total
