"""Device ms a frame of every kernel but the slice kernel that starts
inside the harness's `render()` span: the frame's setup (fan, schedule,
RGBA table, scalars), the warp and finalize."""


def read(run):
    if run.trace is None or run.trace.k1_count() == 0:
        return None
    return 1e3 * run.trace.kernel_s(k1=False, inside="render") / \
        run.trace.n_frames
