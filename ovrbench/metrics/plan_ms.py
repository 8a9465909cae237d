"""Host ms a frame of the program's `commit.plan` span: `RenderConfig.resolved`
-> `shearwarp.resolve_static` after a camera change, with its host reads
of the world box and the camera basis (`program_spans.py`)."""

from ovrbench import program_spans


def read(run):
    p = program_spans.placed(run)
    return None if p is None else p.host_ms("commit.plan")
