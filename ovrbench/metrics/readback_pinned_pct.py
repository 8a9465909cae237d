"""Share of the readback's bytes that landed in a page-locked host buffer
the program reuses: 100 x the program's counter
`api.READBACK_PINNED_BYTES` over `api.READBACK_BYTES`, both over its
`mapframe` spans (`program_spans.py`). None for a program that does not
register the first counter."""

import sys

from ovrbench import program_spans

PINNED = "api.READBACK_PINNED_BYTES"


def read(run):
    p = program_spans.placed(run)
    counters = getattr(sys.modules.get(program_spans.MODULE), "counters",
                       None)
    if p is None or counters is None or PINNED not in counters():
        return None
    total = p.count("mapframe", program_spans.READBACK)
    if not total:
        return None
    return 100.0 * p.count("mapframe", PINNED) / total
