"""GB/s of the readback: the bytes `Renderer.mapframe` returned
(`api.READBACK_BYTES`) over the device time of the copies put down to its
`mapframe` span and each buffer's span under it (`program_spans.py`)."""

from ovrbench import program_spans

SPANS = {"mapframe", "mapframe.rgba", "mapframe.grad", "mapframe.depth",
         "mapframe.flow"}


def read(run):
    p = program_spans.placed(run)
    if p is None:
        return None
    ms = p.device_ms(SPANS, ("copy",))
    if not ms:
        return None
    return p.count("mapframe", program_spans.READBACK) / p.n / ms / 1e6
