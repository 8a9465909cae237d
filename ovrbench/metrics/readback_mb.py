"""MB a frame that `Renderer.mapframe` returned to the host: the program's
counter `api.READBACK_BYTES` over its `mapframe` spans, / 1e6
(`program_spans.py`)."""

from ovrbench import program_spans


def read(run):
    p = program_spans.placed(run)
    if p is None:
        return None
    return p.count("mapframe", program_spans.READBACK) / p.n / 1e6
