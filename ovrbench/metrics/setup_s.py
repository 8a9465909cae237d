"""Seconds from the process's start to the first timed frame: imports,
the card's context, the volume made from the seed, the first commit and
the cell's views rendered once (the slice kernel's build, the first time
in a checkout)."""


def read(run):
    if run.trace is not None:
        return None
    return run.setup_s
