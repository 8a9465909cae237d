"""rays/s: width x height x spp x frames completed in the window, over the
window's seconds (from the first frame's first setter call to the last
frame's rgba in host memory; frames begun before the deadline finish)."""


def read(run):
    if not run.frame_times or run.trace is not None:
        return None
    span = run.frame_times[-1][1] - run.frame_times[0][0]
    return run.width * run.height * run.spp * len(run.frame_times) / span
