"""Device-idle ms a frame while the host is in the program's
`set_camera` or `set_transfer_function` span: `Camera.create` and
`TransferFunction.create` making card tensors from host numbers
(`program_spans.py`)."""

from ovrbench import program_spans


def read(run):
    p = program_spans.placed(run)
    if p is None:
        return None
    return p.idle_ms({"set_camera", "set_transfer_function"})
