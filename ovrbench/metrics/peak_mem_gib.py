"""Peak device memory the program allocated, in GiB:
`torch.cuda.max_memory_allocated`, reset once the volume is on the card
and before the Renderer's first commit, read after the window."""


def read(run):
    if run.peak_bytes is None or run.trace is not None:
        return None
    return run.peak_bytes / float(1 << 30)
