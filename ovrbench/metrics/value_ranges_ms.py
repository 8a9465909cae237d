"""Device ms a frame of the operations put down to the program's
`commit.macrocells.value_ranges` span: `accel.compute_value_ranges` (the
grid's cast, the pads and the two `max_pool3d`) (`program_spans.py`)."""

from ovrbench import program_spans


def read(run):
    p = program_spans.placed(run)
    return (None if p is None
            else p.device_ms({"commit.macrocells.value_ranges"}))
