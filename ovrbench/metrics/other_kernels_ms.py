"""Device ms a frame of every kernel but the slice kernel that starts
inside the harness's `render()` span: on the shear-warp pipeline the
frame's setup (fan, schedule, RGBA table, scalars), the warp and
finalize; on a pipeline without the slice kernel, all of its frame's
kernels."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 1e3 * run.trace.kernel_s(k1=False, inside="render") / \
        run.trace.n_frames
