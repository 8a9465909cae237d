"""Host ms a frame of the program's `render` span less its `render.wait`
stage: the host's time to issue a frame's work, without the wait for
the card (`program_spans.py`)."""

from ovrbench import program_spans


def read(run):
    p = program_spans.placed(run)
    if p is None:
        return None
    return p.host_ms("render") - p.host_ms("render.wait")
