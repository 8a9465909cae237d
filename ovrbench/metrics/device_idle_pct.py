"""The share of the traced frame loop, in %, in which no device operation
(kernel, copy or fill) runs, from the profiler's trace."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
