"""Device ms a frame of the operations put down to the program's
`commit.macrocells.majorants` span: `accel.compute_majorants`, the TF's
range-max table over each macrocell's value range (`program_spans.py`)."""

from ovrbench import program_spans


def read(run):
    p = program_spans.placed(run)
    return (None if p is None
            else p.device_ms({"commit.macrocells.majorants"}))
