"""Mean ms of the harness's span around `Renderer.commit()` over the traced
frames, which ends with a synchronize: the plan (`RenderConfig.resolved`
-> `shearwarp.resolve_static`) after a camera change, the macrocells
(`accel.build_macrocells`) and the shadow lattice after a TF change."""


def read(run):
    if run.trace is None:
        return None
    d = run.spans.durations("commit")
    return 1e3 * sum(d) / len(d) if d else None
