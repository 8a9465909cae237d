"""Mean ms of the harness's span around `Renderer.mapframe()` over the
traced frames: the frame's rgba, grad and depth copied to pageable host
memory."""


def read(run):
    if run.trace is None:
        return None
    d = run.spans.durations("mapframe")
    return 1e3 * sum(d) / len(d) if d else None
