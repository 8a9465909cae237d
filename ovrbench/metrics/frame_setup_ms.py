"""Device ms a frame of the kernels put down to the program's
`render.setup` stage: `shearwarp.render_shearwarp` up to the slice
kernel (fan, plane schedule, RGBA table, kernel scalars)
(`program_spans.py`)."""

from ovrbench import program_spans


def read(run):
    p = program_spans.placed(run)
    return None if p is None else p.device_ms({"render.setup"}, ("kernel",))
