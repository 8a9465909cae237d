"""Device ms a frame of the kernels put down to the program's
`render.warp` stage: `shearwarp._sw_warp_out` to the screen, then
`integrator.finalize` and the frame's buffers (`program_spans.py`)."""

from ovrbench import program_spans


def read(run):
    p = program_spans.placed(run)
    return None if p is None else p.device_ms({"render.warp"}, ("kernel",))
